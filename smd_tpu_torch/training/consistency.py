"""Consistency distillation and consistency training for 1-2 step sampling
(port of ``smd_tpu/training/consistency.py``).

Song et al., "Consistency Models" (ICML 2023), with the pseudo-Huber metric
and the lognormal level sampling of "Improved Techniques for Training
Consistency Models" (iCT, 2023), on the repo's sqrt(alpha-bar)-conditioned
epsilon models:

- The consistency function is the model's clipped x0 prediction
  ``f(z, abar) = clip((z - sigma·eps(z, alpha)) / alpha)``.
- Distillation (CD): the teacher's ODE step from grid[i] to grid[i+1] is two
  DDIM jumps through the dense grid's midpoint; the student's f at grid[i]
  is matched to the target network's f at grid[i+1], under pseudo-Huber.
- Training (CT): no teacher; both points share one Gaussian draw; the
  segment comes from a discretized lognormal, weighted 1/(sigma_n -
  sigma_{n+1}); a doubling curriculum of grids.
- The target network theta^- is the state's EMA (mu=0.95 for CD, 0 for CT:
  the previous iterate), loaded into a frozen copy of the model at each
  step. A CD step launches the teacher twice, the target once and the
  student once; a CT step the target once and the student once.
- With ``scan_chunk`` K > 1 the steps run K at a time, as JAX's
  ``make_cd_scan`` and ``make_ct_scan``: one step captured in a CUDA graph
  and replayed K times on the card, eagerly on the CPU
  (``training/graphs.py``); the EMA and the target's copy of it are
  written in place inside the graph.

Sampling is ``samplers.consistency_dynamics``.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from smd_tpu_torch.training import graphs
from smd_tpu_torch.training.distill import (_bb, _index_and_noise, _levels,
                                            _optimizer, _snapshot,
                                            ddim_jump, descending,
                                            distill_grid, frozen_copy,
                                            halve_grid, run_steps,
                                            trainable_copy)
from smd_tpu_torch.training.state import TrainState

__all__ = [
    "consistency_f",
    "consistency_distillation_loss",
    "consistency_training_loss",
    "make_cd_step",
    "make_ct_step",
    "consistency_distill",
    "consistency_train",
]


def consistency_f(model_fn, z, abar, clip_x0: bool = True):
    """The consistency function: the model's (clipped) x0 prediction, the
    model conditioned on sqrt(abar); ``abar`` broadcasts to ``z``."""
    a = torch.sqrt(abar)
    s = torch.sqrt(1.0 - abar)
    eps = model_fn(z, a)
    x0 = (z - s * eps) / a
    if clip_x0:
        x0 = x0.clamp(-1.0, 1.0)
    return x0


def _pseudo_huber(d, huber_c):
    """Per-example sqrt(||d||^2 + c^2) - c, c = 0.00054·sqrt(D) by
    default (iCT's scaling), in float32 as JAX computes it."""
    d = d.reshape(d.shape[0], -1)
    c = float(np.float32(0.00054) * np.sqrt(np.float32(d.shape[-1]))) \
        if huber_c is None else huber_c
    return torch.sqrt(d.square().sum(dim=-1) + c * c) - c


def consistency_distillation_loss(batch, student_fn, target_fn, teacher_fn,
                                  grid, mids,
                                  generator: Optional[torch.Generator] = None,
                                  huber_c: Optional[float] = None,
                                  clip_x0: bool = True, draws=None):
    """One CD step's loss: self-consistency along the teacher's trajectory.

    Per example: a random segment i, the clean ``batch`` forward-diffused to
    grid[i], the teacher's step grid[i] -> mids[i] -> grid[i+1] and the
    target's f there, both without a gradient, against the student's f at
    grid[i], under pseudo-Huber. ``draws``: optional pre-drawn ``(i,
    eps)``, JAX's ``split(rng)`` draws; else both come from ``generator``.
    """
    grid, mids = _levels(grid, batch.device), _levels(mids, batch.device)
    i, eps = _index_and_noise(batch, grid.shape[0] - 1, generator, draws)
    abar_t = _bb(grid[i], batch)
    abar_m = _bb(mids[i], batch)
    abar_s = _bb(grid[i + 1], batch)
    z_t = torch.sqrt(abar_t) * batch + torch.sqrt(1.0 - abar_t) * eps

    with torch.no_grad():
        z_m = ddim_jump(teacher_fn, z_t, abar_t, abar_m, clip_x0=clip_x0)
        z_s = ddim_jump(teacher_fn, z_m, abar_m, abar_s, clip_x0=clip_x0)
        tgt = consistency_f(target_fn, z_s, abar_s, clip_x0=clip_x0)
    pred = consistency_f(student_fn, z_t, abar_t, clip_x0=clip_x0)
    return _pseudo_huber(pred - tgt, huber_c).mean()


def _segment_masses(grid, p_mean, p_std):
    """(EDM sigma of each boundary, mass of each segment): the lognormal's
    CDF mass between the segments' boundary log-sigmas, in float32, floored
    at 0 and offset by 1e-12."""
    sig = torch.sqrt((1.0 - grid) / grid)
    cdf = torch.special.erf(
        (torch.log(sig) - p_mean) /
        float(np.sqrt(np.float32(2.0)) * np.float32(p_std)))
    return sig, (cdf[:-1] - cdf[1:]).clamp_min(0.0) + 1e-12


def consistency_training_loss(batch, student_fn, target_fn, grid,
                              generator: Optional[torch.Generator] = None,
                              huber_c: Optional[float] = None,
                              clip_x0: bool = True, p_mean: float = -1.1,
                              p_std: float = 2.0, draws=None):
    """One consistency-training step's loss (teacher-free, iCT).

    The noisier and cleaner points share one Gaussian draw; the student's f
    at the noisier level is matched to the target's f at the cleaner one,
    under pseudo-Huber weighted 1/(sigma_n - sigma_{n+1}). The segment is
    drawn from the lognormal's masses over the grid's segments
    (``torch.multinomial``, JAX's ``categorical`` over their logs), then
    the noise; ``draws`` replays ``(i, eps)``.
    """
    grid = _levels(grid, batch.device)
    sig, mass = _segment_masses(grid, p_mean, p_std)
    if draws is None:
        i = torch.multinomial(mass, batch.shape[0],
                              replacement=True, generator=generator)
        eps = torch.randn(batch.shape, generator=generator,
                          device=batch.device)
    else:
        i, eps = (torch.as_tensor(d, device=batch.device) for d in draws)
    abar_n = _bb(grid[i], batch)
    abar_s = _bb(grid[i + 1], batch)
    z_n = torch.sqrt(abar_n) * batch + torch.sqrt(1.0 - abar_n) * eps
    z_s = torch.sqrt(abar_s) * batch + torch.sqrt(1.0 - abar_s) * eps

    with torch.no_grad():
        tgt = consistency_f(target_fn, z_s, abar_s, clip_x0=clip_x0)
    pred = consistency_f(student_fn, z_n, abar_n, clip_x0=clip_x0)
    lam = 1.0 / (sig[i] - sig[i + 1])
    return (lam * _pseudo_huber(pred - tgt, huber_c)).mean()


def _cd_loss_fn(model, teacher_params, grid, mids, huber_c, clip_x0):
    """``loss_fn(state, batch, draws)``: the CD loss, the target network
    loaded (in place) with the state's EMA before the step."""
    teacher = frozen_copy(model, teacher_params)
    target = copy.deepcopy(model).requires_grad_(False)
    device = next(model.parameters()).device
    grid, mids = _levels(grid, device), _levels(mids, device)

    def loss_fn(state: TrainState, batch, draws=None):
        target.load_state_dict(state.ema_params)
        return consistency_distillation_loss(
            batch, state.model, target, teacher, grid, mids, state.generator,
            huber_c=huber_c, clip_x0=clip_x0, draws=draws)

    return loss_fn


def _ct_loss_fn(model, grid, huber_c, clip_x0, p_mean, p_std):
    """``loss_fn(state, batch, draws)``: the CT loss, the target loaded as
    ``_cd_loss_fn``'s."""
    target = copy.deepcopy(model).requires_grad_(False)
    grid = _levels(grid, next(model.parameters()).device)

    def loss_fn(state: TrainState, batch, draws=None):
        target.load_state_dict(state.ema_params)
        return consistency_training_loss(
            batch, state.model, target, grid, state.generator,
            huber_c=huber_c, clip_x0=clip_x0, p_mean=p_mean, p_std=p_std,
            draws=draws)

    return loss_fn


def make_cd_step(model, teacher_params, grid, mids,
                 huber_c: Optional[float] = None, clip_x0: bool = True,
                 chunk: bool = False):
    """``cd_step(state, batch, draws=None) -> (state, metrics)``: the
    teacher (a frozen copy of ``model`` holding ``teacher_params``) twice
    and the target (the state's EMA before the step) once, without a
    gradient, then the student's loss, gradient, clip, Adam and EMA. With
    ``chunk`` the same steps K at a time (JAX's ``make_cd_scan``):
    ``cd_chunk(state, batches, draws=None) -> (state, (K,) metrics)``, a
    ``graphs.TrainChunk``."""
    loss_fn = _cd_loss_fn(model, teacher_params, grid, mids, huber_c,
                          clip_x0)
    if chunk:
        return graphs.TrainChunk(loss_fn, "consistency distillation step")
    return descending(loss_fn)


def make_ct_step(model, grid, huber_c: Optional[float] = None,
                 clip_x0: bool = True, p_mean: float = -1.1,
                 p_std: float = 2.0, chunk: bool = False):
    """``ct_step(state, batch, draws=None) -> (state, metrics)``: the
    target (the state's EMA before the step; with ``ema_mu=0`` the last
    iterate) once without a gradient, then the student's loss, gradient,
    clip, Adam and EMA. With ``chunk`` K at a time, as ``make_cd_step``
    (JAX's ``make_ct_scan``)."""
    loss_fn = _ct_loss_fn(model, grid, huber_c, clip_x0, p_mean, p_std)
    if chunk:
        return graphs.TrainChunk(loss_fn, "consistency training step")
    return descending(loss_fn)


def consistency_distill(model: nn.Module,
                        params: Dict[str, torch.Tensor],
                        betas,
                        batches: Iterator,
                        *,
                        num_segments: int = 32,
                        steps: int = 4000,
                        learning_rate: float = 1e-4,
                        warmup_steps: int = 100,
                        lam_max: Optional[float] = 2.5,
                        ema_mu: float = 0.95,
                        huber_c: Optional[float] = None,
                        seed: int = 0,
                        clip_x0: bool = True,
                        scan_chunk: int = 50,
                        log_fn: Optional[Callable] = None) -> Dict:
    """Consistency-distill a trained eps model for 1-2 step sampling.

    One stage: the student starts from ``params`` ({name: tensor}); its EMA
    (mu=``ema_mu``) is both the target network and the shipped params. The
    teacher is ``params`` on a dense grid of 2·``num_segments`` steps.
    ``model`` is the architecture on the device to train on;
    ``log_fn(num_segments, step, loss)`` as ``progressive_distill``'s.

    Returns {"params": {name: tensor} (the EMA), "grid": (N+1,) float32
    segment boundaries for ``samplers.consistency_dynamics``}.
    """
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    grid, mids = halve_grid(distill_grid(betas, 2 * num_segments, lam_max))
    tx = _optimizer(learning_rate, min(warmup_steps, max(steps // 10, 1)),
                    steps)
    state = TrainState.create(trainable_copy(model, params), tx, generator,
                              ema=True, ema_mu=ema_mu)
    step_fn = make_cd_step(model, params, grid, mids, huber_c=huber_c,
                           clip_x0=clip_x0, chunk=scan_chunk > 1)
    run_steps(state, step_fn, batches, steps,
              scan_chunk if scan_chunk > 1 else None,
              None if log_fn is None else
              (lambda step, loss: log_fn(num_segments, step, loss)))
    return {"params": _snapshot(state.sampling_params), "grid": grid}


def consistency_train(model: nn.Module,
                      params: Dict[str, torch.Tensor],
                      betas,
                      batches: Iterator,
                      *,
                      steps: int = 20000,
                      learning_rate: float = 1e-4,
                      warmup_steps: int = 500,
                      lam_max: Optional[float] = 2.5,
                      seg_schedule: tuple = (16, 32, 64, 128),
                      ema_mu: float = 0.0,
                      huber_c: Optional[float] = None,
                      p_mean: float = -1.1,
                      p_std: float = 2.0,
                      seed: int = 0,
                      clip_x0: bool = True,
                      scan_chunk: int = 50,
                      log_fn: Optional[Callable] = None) -> Dict:
    """Teacher-free consistency training (iCT) from a trained eps model.

    The student starts from ``params``; the target is its own previous
    iterate (``ema_mu=0``). ``steps`` are split evenly over the
    ``seg_schedule`` curriculum, each stage on ``distill_grid(betas, N)``,
    the last stage taking the remainder. ``log_fn(num_segments, step,
    loss)`` after each chunk of ``scan_chunk`` steps, with the step counted
    over all stages.

    Returns {"params", "grid"} as ``consistency_distill`` does, the grid the
    last (finest) stage's.
    """
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    tx = _optimizer(learning_rate, min(warmup_steps, max(steps // 10, 1)),
                    steps)
    state = TrainState.create(trainable_copy(model, params), tx, generator,
                              ema=True, ema_mu=ema_mu)
    per_stage = max(1, steps // len(seg_schedule))
    done = 0
    grid = None
    for si, num_segments in enumerate(seg_schedule):
        grid = distill_grid(betas, num_segments, lam_max)
        step_fn = make_ct_step(model, grid, huber_c=huber_c,
                               clip_x0=clip_x0, p_mean=p_mean, p_std=p_std,
                               chunk=scan_chunk > 1)
        stage_steps = (steps - per_stage * (len(seg_schedule) - 1)
                       if si == len(seg_schedule) - 1 else per_stage)
        stage_steps = max(stage_steps, 0)
        run_steps(state, step_fn, batches, stage_steps, max(scan_chunk, 1),
                  None if log_fn is None else
                  (lambda step, loss, n=num_segments, d=done:
                   log_fn(n, d + step, loss)))
        done += stage_steps
    ship = state.sampling_params if ema_mu > 0 else state.params
    return {"params": _snapshot(ship), "grid": grid}
