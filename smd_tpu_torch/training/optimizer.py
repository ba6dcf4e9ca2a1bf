"""Optimizer and learning-rate schedule (port of
``smd_tpu/training/optimizer.py``).

Global-norm gradient clipping, then Adam, on a stepped exponential LR
lr·γ^(step//interval) with optional linear warmup (training) or optax's
warmup-cosine decay (distillation): the JAX package's
``optax.chain(clip_by_global_norm, adam(schedule))``, written out over the
parameter tensors with ``torch._foreach_*`` so that each step is optax's
arithmetic:

- clip: g is kept where ‖g‖ < max, else g / ‖g‖ · max;
- Adam: m = (1-b1)·g + b1·m, v = (1-b2)·g² + b2·v, both unrounded in the
  update; bias correction with count + 1, m̂ = m · (1/bc1), v̂ likewise
  (the reciprocal rounded to float32, as PyTorch's CUDA division by a
  scalar takes it); update m̂ / (sqrt(v̂) + eps), eps = 1e-8 outside the
  root;
- the LR at the count before the increment; with warmup the decay counts
  from the end of warmup (``optax.join_schedules`` hands it ``step -
  warmup``).

The state is ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``,
keyed by parameter name as optax's trees are keyed by path, so a JAX
optimizer state carries over by name. ``adam_m_bf16`` stores the first
moment in bfloat16 after the update has used it in float32, as optax's
``mu_dtype`` does.

Every tensor of the params and the state is written in place, so a step
captured in a CUDA graph (``training/graphs.py``) updates the same memory
at each replay. The host values of a step (the LR and the two bias
corrections, from the count) are ``hyperparams``; a captured step takes
them as 0-d device tensors from ``tables``, staged per step, instead, and
rounds as the eager step does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["stepped_exponential_schedule", "warmup_cosine_decay_schedule",
           "Optimizer", "global_norm", "make_optimizer"]


def stepped_exponential_schedule(base_lr: float, interval: int, gamma: float,
                                 warmup_steps: int = 0
                                 ) -> Callable[[int], float]:
    """count -> lr, float32 arithmetic as optax's: base_lr *
    gamma^(count // interval), after ``warmup_steps`` of linear warmup from
    0."""
    f32 = np.float32

    def decay(count):
        if count <= 0:
            return float(f32(base_lr))
        p = np.floor(f32(count) / f32(interval))
        return float(f32(base_lr) * np.power(f32(gamma), p, dtype=f32))

    if warmup_steps <= 0:
        return decay

    def schedule(count):
        if count >= warmup_steps:
            return decay(count - warmup_steps)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
            warmup_steps)
        return float((f32(0) - f32(base_lr)) * frac + f32(base_lr))

    return schedule


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_fraction: float = 0.01
                                 ) -> Callable[[int], float]:
    """count -> lr, optax's ``warmup_cosine_decay_schedule(0.0, peak_value,
    warmup_steps, decay_steps, end_value=peak_value * end_fraction)`` in its
    float32 arithmetic: linear from 0 to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_fraction`` of it at
    ``decay_steps`` (warmup included), constant after. The JAX package's
    distillation trainers end at 0.01 (the default), its codec trainer
    (``scripts/train_musicvae.py``) at 0.02."""
    f32 = np.float32
    # optax's end_value / peak_value, which need not round to end_fraction.
    alpha = 0.0 if peak_value == 0.0 else \
        peak_value * end_fraction / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={cosine_steps}.")

    def warmup(count):
        if warmup_steps <= 0:
            return f32(0)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
            warmup_steps)
        return f32(-peak_value) * frac + f32(peak_value)

    def cosine(count):
        count = min(f32(count), f32(cosine_steps))
        decay = f32(0.5) * (f32(1) + np.cos(
            f32(np.pi) * count / f32(cosine_steps)))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count):
        return float(warmup(count) if count < warmup_steps
                     else cosine(count - warmup_steps))

    return schedule


@dataclasses.dataclass
class Optimizer:
    """clip_by_global_norm(grad_clip), then Adam on ``schedule``."""
    schedule: Callable[[int], float]
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    mu_dtype: Optional[torch.dtype] = None

    @staticmethod
    def tensors(params: Dict[str, torch.Tensor], state: dict):
        """The tensors a step writes: ``params`` and the moments."""
        return [*(p.detach() for p in params.values()),
                *state["mu"].values(), *state["nu"].values()]

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def hyperparams(self, count: int):
        """(LR, 1 / bc1, 1 / bc2) of the step taken at ``count``: the LR at
        ``count`` and the reciprocals, in double, of the bias corrections
        bc = 1 - b^(count+1), each in optax's float32 arithmetic. The step
        multiplies by the reciprocals, which each operation rounds to
        float32: what PyTorch's CUDA foreach division by a Python scalar
        computes (it multiplies by the reciprocal), so the step's rounding
        is the same whether the values come as Python floats (an eager
        step) or as staged float32 tensors (a captured one)."""
        f32 = np.float32
        bc1 = f32(1) - np.power(f32(self.b1), f32(count + 1), dtype=f32)
        bc2 = f32(1) - np.power(f32(self.b2), f32(count + 1), dtype=f32)
        return self.schedule(count), 1.0 / float(bc1), 1.0 / float(bc2)

    def tables(self, count: int, steps: int) -> Dict[str, np.ndarray]:
        """``hyperparams`` of the ``steps`` steps from ``count`` on, as the
        float32 rows ``lr``, ``inv_bc1``, ``inv_bc2`` that the step's
        operations use (each value rounded to float32 as an operation
        rounds a Python float)."""
        rows = np.asarray([self.hyperparams(count + j)
                           for j in range(steps)], np.float32)
        return {"lr": rows[:, 0], "inv_bc1": rows[:, 1],
                "inv_bc2": rows[:, 2]}

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: dict,
              grad_norm: Optional[torch.Tensor] = None,
              hyper: Optional[Dict[str, torch.Tensor]] = None):
        """One step, in place on ``params`` and ``state``; returns the LR
        it used. ``grad_norm`` is the grads' global norm when the caller
        has it already. ``hyper``: the step's ``lr``, ``inv_bc1`` and
        ``inv_bc2`` as 0-d float32 tensors (a row of ``tables``); then the
        count is left to the caller, and the LR returned is the tensor."""
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if grad_norm is None:
            grad_norm = global_norm(g)
        # select(norm < max, g, g / norm * max), on the device.
        keep = grad_norm < self.grad_clip
        one = torch.ones((), device=grad_norm.device)
        g = torch._foreach_div(g, torch.where(keep, one, grad_norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * self.grad_clip))

        mu_old = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        # b1·m in m's dtype, b1 rounded to it (bf16 with adam_m_bf16: optax's
        # weakly typed b1 takes the moment's type), then the sum in the
        # gradients' dtype.
        b1 = float(torch.tensor(self.b1, dtype=mu_old[0].dtype))
        mu = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(mu, [m.to(x.dtype) for m, x in zip(
            torch._foreach_mul(mu_old, b1), g)])
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - self.b2))
        if hyper is None:
            lr, inv_bc1, inv_bc2 = self.hyperparams(state["count"])
            state["count"] += 1
        else:
            lr, inv_bc1, inv_bc2 = (hyper["lr"], hyper["inv_bc1"],
                                    hyper["inv_bc2"])
        den = torch._foreach_sqrt(_scaled(nu, inv_bc2))
        torch._foreach_add_(den, self.eps)
        update = _scaled(torch._foreach_div(_scaled(mu, inv_bc1), den), -lr)
        torch._foreach_add_(p, update)
        # The moment kept in place (rounded to mu_dtype by the copy).
        torch._foreach_copy_(mu_old, mu)
        return lr


def _scaled(tensors, scale):
    """``tensors`` times ``scale`` (a float, or a 0-d float32 tensor of a
    captured step), each product rounded as an eager step rounds it: in
    float32, then once to the tensor's dtype. (With a 0-d tensor PyTorch
    would first round ``scale`` itself to a bf16 list's dtype.)"""
    if not torch.is_tensor(scale) or \
            all(t.dtype == torch.float32 for t in tensors):
        return torch._foreach_mul(tensors, scale)
    out = torch._foreach_mul([t.float() for t in tensors], scale)
    return [o.to(t.dtype) for o, t in zip(out, tensors)]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors), 2, dtype=torch.float32)))


def make_optimizer(learning_rate: float = 1e-3,
                   grad_clip: float = 1.0,
                   lr_gamma: float = 0.98,
                   lr_schedule_interval: int = 10000,
                   warmup_steps: int = 0,
                   adam_m_bf16: bool = False) -> Optimizer:
    """``adam_m_bf16`` stores Adam's first moment in bfloat16; the EMA of
    the train state stays float32 either way."""
    schedule = stepped_exponential_schedule(learning_rate,
                                            lr_schedule_interval, lr_gamma,
                                            warmup_steps)
    return Optimizer(schedule, grad_clip,
                     mu_dtype=torch.bfloat16 if adam_m_bf16 else None)
