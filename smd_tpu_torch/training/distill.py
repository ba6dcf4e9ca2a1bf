"""Progressive distillation for few-step sampling (port of
``smd_tpu/training/distill.py``).

Salimans & Ho (ICLR 2022) on the repo's sqrt(alpha-bar)-conditioned epsilon
models: each stage trains a student's one DDIM jump to land where the
teacher's two jumps land, halving the sampler's steps, down to 2.

- The grids nest exactly across stages: one dense grid uniform in
  half-log-SNR (its clean end capped at ``lam_max``, its last boundary
  clean) is made once, in JAX's float32, and each stage takes every other
  boundary of the last, so each teacher is queried only at the levels it
  was trained on.
- The teacher is a frozen copy of the model that runs without a gradient;
  the student is another copy, trained in a ``TrainState`` (clip, Adam on
  optax's warmup-cosine schedule, optional EMA). A step launches the
  teacher twice and the student once. The JAX package scans ``scan_chunk``
  steps in one dispatch; here the chunk (``make_distill_step(...,
  chunk=True)``) is one step captured in a CUDA graph and replayed
  ``scan_chunk`` times on the card, run eagerly on the CPU
  (``training/graphs.py``), one graph a stage, freed at the stage's end;
  the loss is read at the same chunk boundaries.
- Sampling with a stage is ``samplers.distilled_ddim_dynamics``.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from smd_tpu_torch.diffusion import schedules
from smd_tpu_torch.diffusion.losses import reduce_fn
from smd_tpu_torch.training import graphs
from smd_tpu_torch.training.optimizer import (Optimizer,
                                              warmup_cosine_decay_schedule)
from smd_tpu_torch.training.state import TrainState

__all__ = [
    "distill_grid",
    "halve_grid",
    "ddim_jump",
    "progressive_distillation_loss",
    "make_distill_step",
    "progressive_distill",
    "run_steps",
]

f32 = np.float32


def distill_grid(betas, num_steps: int, lam_max: Optional[float] = 2.5,
                 constants: Optional[schedules.DDPMConstants] = None
                 ) -> np.ndarray:
    """Signal-level boundaries for a ``num_steps``-step distilled sampler.

    Returns ``(num_steps + 1,)`` float32 alpha-bar values ascending in
    cleanliness: index 0 is the init level (``alphas_prod[T-1]``), indices
    up to ``num_steps - 1`` are uniform in half-log-SNR up to the
    ``lam_max`` cap, and the final boundary is clean (1 - 1e-6).
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    lam = schedules.half_log_snr(c.alphas_prod)
    lam_hi = lam[0] if lam_max is None else np.minimum(lam[0], f32(lam_max))
    lam_grid = schedules.linspace_f32(lam[-1], lam_hi, num_steps)
    # abar = sigmoid(2*lam); torch's float32 sigmoid rounds as XLA's does.
    bounds = torch.sigmoid(torch.from_numpy(f32(2.0) * lam_grid)).numpy()
    return np.concatenate([bounds, np.full(1, 1.0 - 1e-6, f32)])


def halve_grid(grid):
    """Split a ``(2N+1,)`` boundary grid into the student grid (every other
    boundary, both ends kept) and the ``(N,)`` midpoints the teacher
    passes through inside each student step."""
    if (grid.shape[0] - 1) % 2:
        raise ValueError(f"Grid with {grid.shape[0] - 1} steps cannot halve")
    return grid[::2], grid[1::2]


def _bb(values, like):
    """(B,) -> (B, 1, ..., 1) matching ``like``'s rank."""
    return values.reshape(like.shape[0], *([1] * (like.dim() - 1)))


def ddim_jump(model_fn, z, abar_from, abar_to, clip_x0: bool = True):
    """One DDIM jump between signal levels broadcastable to ``z``, in the
    (clipped x0, raw eps) basis; the model is conditioned on
    sqrt(abar_from)."""
    a_f, s_f = torch.sqrt(abar_from), torch.sqrt(1.0 - abar_from)
    a_t, s_t = torch.sqrt(abar_to), torch.sqrt(1.0 - abar_to)
    eps = model_fn(z, a_f)
    x0 = (z - s_f * eps) / a_f
    if clip_x0:
        x0 = x0.clamp(-1.0, 1.0)
    return a_t * x0 + s_t * eps


def _levels(grid, device):
    """A grid (ndarray or tensor) as a float32 tensor on ``device``."""
    if torch.is_tensor(grid):
        return grid.to(device, torch.float32)
    return torch.from_numpy(np.asarray(grid, f32)).to(device)


def _index_and_noise(batch, num_levels, generator, draws):
    """Per-example level indices in [0, num_levels) and a normal of the
    batch's shape, drawn in that order, or ``draws = (i, eps)`` replayed."""
    if draws is not None:
        return tuple(torch.as_tensor(d, device=batch.device) for d in draws)
    i = torch.randint(0, num_levels, (batch.shape[0],), generator=generator,
                      device=batch.device)
    eps = torch.randn(batch.shape, generator=generator, device=batch.device)
    return i, eps


def progressive_distillation_loss(batch, student_fn, teacher_fn, grid, mids,
                                  generator: Optional[torch.Generator] = None,
                                  reduction: str = "mean",
                                  clip_x0: bool = True, draws=None):
    """One student step == two teacher steps, matched in z-space.

    Per example: a random student step i, the clean ``batch``
    forward-diffused to grid[i], the teacher's two jumps grid[i] -> mids[i]
    -> grid[i+1] without a gradient, the student's one jump (its sampler
    step, clip included), and the squared landing gap weighted by
    max(1, SNR_t) / denom^2, denom = alpha_s - (sigma_s/sigma_t)·alpha_t
    (Salimans & Ho's truncated-SNR x-space loss where the clip is idle).
    ``draws``: optional pre-drawn ``(i, eps)``, JAX's ``split(rng)``
    draws; else both come from ``generator``.
    """
    grid, mids = _levels(grid, batch.device), _levels(mids, batch.device)
    i, eps = _index_and_noise(batch, grid.shape[0] - 1, generator, draws)
    abar_t = _bb(grid[i], batch)
    abar_m = _bb(mids[i], batch)
    abar_s = _bb(grid[i + 1], batch)
    a_t, s_t = torch.sqrt(abar_t), torch.sqrt(1.0 - abar_t)
    a_s, s_s = torch.sqrt(abar_s), torch.sqrt(1.0 - abar_s)
    z_t = a_t * batch + s_t * eps

    with torch.no_grad():
        z_m = ddim_jump(teacher_fn, z_t, abar_t, abar_m, clip_x0=clip_x0)
        z_tgt = ddim_jump(teacher_fn, z_m, abar_m, abar_s, clip_x0=clip_x0)
    z_pred = ddim_jump(student_fn, z_t, abar_t, abar_s, clip_x0=clip_x0)

    denom = a_s - (s_s / s_t) * a_t
    w = (abar_t / (1.0 - abar_t)).clamp_min(1.0) / denom.square()
    err = (z_tgt - z_pred).square().reshape(batch.shape[0], -1)
    loss = (w.reshape(batch.shape[0], -1)[:, :1] * err).mean(dim=-1)
    return reduce_fn(loss, reduction)


def frozen_copy(model: nn.Module, params) -> nn.Module:
    """A copy of ``model`` holding ``params`` ({name: tensor}, cast to each
    parameter's dtype) that records no gradient: the teacher, or the
    consistency target network."""
    copied = copy.deepcopy(model)
    copied.load_state_dict(params)
    return copied.requires_grad_(False)


def trainable_copy(model: nn.Module, params) -> nn.Module:
    """A copy of ``model`` holding ``params``, to train: the student."""
    return frozen_copy(model, params).requires_grad_(True)


def _distill_loss_fn(model, teacher_params, grid, mids, clip_x0):
    """``loss_fn(state, batch, draws)``: the student's distillation loss
    against the teacher, a frozen copy of ``model`` holding
    ``teacher_params``."""
    teacher = frozen_copy(model, teacher_params)
    device = next(model.parameters()).device
    grid, mids = _levels(grid, device), _levels(mids, device)

    def loss_fn(state: TrainState, batch, draws=None):
        return progressive_distillation_loss(
            batch, state.model, teacher, grid, mids, state.generator,
            clip_x0=clip_x0, draws=draws)

    return loss_fn


def descending(loss_fn):
    """``step(state, batch, draws=None) -> (state, metrics)``: the loss,
    then ``TrainState.descend``."""
    def step(state: TrainState, batch, draws=None):
        return state, state.descend(loss_fn(state, batch, draws))

    return step


def make_distill_step(model, teacher_params, grid, mids,
                      clip_x0: bool = True, chunk: bool = False):
    """``distill_step(state, batch, draws=None) -> (state, metrics)``: the
    teacher (a frozen copy of ``model`` holding ``teacher_params``) twice
    without a gradient, then the student's loss, gradient, clip, Adam and
    EMA (``TrainState.descend``); metrics ``loss``, ``grad`` and ``lr``.
    With ``chunk`` the same steps K at a time (JAX's
    ``make_distill_scan``): ``distill_chunk(state, batches, draws=None) ->
    (state, (K,) metrics)``, a ``graphs.TrainChunk``."""
    loss_fn = _distill_loss_fn(model, teacher_params, grid, mids, clip_x0)
    if chunk:
        return graphs.TrainChunk(loss_fn, "progressive distillation step")
    return descending(loss_fn)


def _to_device(batch, device):
    if torch.is_tensor(batch):
        return batch.to(device)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


def run_steps(state: TrainState, step_fn, batches: Iterator, steps: int,
              log_every: Optional[int] = None,
              log_fn: Optional[Callable[[int, float], None]] = None):
    """``steps`` steps on ``next(batches)`` (moved to the model's device).

    ``step_fn`` is a step, ``step_fn(state, batch)``, or a chunk
    (``graphs.TrainChunk``), which takes ``log_every`` batches at a time
    (fewer in the last chunk) and is closed at the end, freeing its graph.
    ``log_fn(step, loss)`` reads the loss back where the JAX package's
    loops log: after every ``log_every``-th step and the last (its
    ``scan_chunk`` boundaries; a chunk's last row), or with
    ``log_every=None`` at every 500th step and the last."""
    if isinstance(step_fn, graphs.TrainChunk):
        try:
            done = 0
            while done < steps:
                k = min(log_every, steps - done)
                state, metrics = step_fn(state, [next(batches)
                                                 for _ in range(k)])
                done += k
                if log_fn is not None:
                    log_fn(done - 1, float(metrics["loss"][-1]))
        finally:
            step_fn.close()
        return state
    device = next(state.model.parameters()).device
    for step in range(steps):
        batch = _to_device(next(batches), device)
        state, metrics = step_fn(state, batch)
        if log_fn is None:
            continue
        last = step == steps - 1
        if (log_every is None and (step % 500 == 0 or last)) or \
                (log_every is not None and
                 ((step + 1) % log_every == 0 or last)):
            log_fn(step, float(metrics["loss"]))
    return state


def _optimizer(learning_rate, warmup_steps, steps):
    """clip 1.0, then Adam on warmup-cosine from 0 to ``learning_rate`` and
    down to a hundredth of it, as every distillation driver of the JAX
    package builds it."""
    return Optimizer(warmup_cosine_decay_schedule(
        learning_rate, warmup_steps, steps), grad_clip=1.0)


def _snapshot(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in params.items()}


def progressive_distill(model: nn.Module,
                        params: Dict[str, torch.Tensor],
                        betas,
                        batches: Iterator,
                        *,
                        start_steps: int = 8,
                        end_steps: int = 2,
                        steps_per_stage: int = 3000,
                        learning_rate: float = 1e-4,
                        warmup_steps: int = 100,
                        lam_max: Optional[float] = 2.5,
                        ema: bool = False,
                        ema_mu: float = 0.999,
                        seed: int = 0,
                        clip_x0: bool = True,
                        scan_chunk: int = 50,
                        log_fn: Optional[Callable] = None
                        ) -> Dict[int, dict]:
    """Distill a trained model down to ``end_steps`` sampler steps.

    ``model`` is the architecture, on the device to train on (its own
    params are not used); ``params`` ({name: tensor}) the trained model's.
    Stages halve: start_steps, start_steps/2, ..., end_steps; each stage's
    student starts from, and is taught by, the last stage's sampling params
    (the first teacher is ``params`` on the dense grid's midpoints).
    ``batches``: an endless iterator of clean batches (numpy or tensors),
    shared across stages. ``ema``: an EMA of the student within each stage
    (off by default, as in the JAX package). ``log_fn(stage_steps, step,
    loss)``: progress, at the JAX loop's boundaries. One generator seeded
    with ``seed`` draws every step's levels and noise.

    Returns {num_steps: {"params": {name: tensor}, "grid": (num_steps+1,)
    float32 ndarray}} for every stage.
    """
    ratio = start_steps // max(end_steps, 1)
    if start_steps < end_steps or start_steps % max(end_steps, 1) \
            or ratio & (ratio - 1):
        raise ValueError(f"start_steps={start_steps} must be a power-of-2 "
                         f"multiple of end_steps={end_steps} (the halving "
                         f"loop otherwise never produces the "
                         f"{end_steps}-step stage)")
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    grid = distill_grid(betas, 2 * start_steps, lam_max)
    teacher = params
    results: Dict[int, dict] = {}
    num_steps = start_steps
    while num_steps >= end_steps:
        student_grid, mids = halve_grid(grid)
        tx = _optimizer(learning_rate, min(warmup_steps,
                                           steps_per_stage // 10),
                        steps_per_stage)
        state = TrainState.create(trainable_copy(model, teacher), tx,
                                  generator, ema=ema, ema_mu=ema_mu)
        step_fn = make_distill_step(model, teacher, student_grid, mids,
                                    clip_x0=clip_x0, chunk=scan_chunk > 1)
        stage_log = None if log_fn is None else \
            (lambda step, loss, n=num_steps: log_fn(n, step, loss))
        run_steps(state, step_fn, batches, steps_per_stage,
                  scan_chunk if scan_chunk > 1 else None, stage_log)
        teacher = _snapshot(state.sampling_params)
        results[num_steps] = {"params": teacher, "grid": student_grid}
        grid = student_grid
        num_steps //= 2
    return results
