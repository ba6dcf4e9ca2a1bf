"""The DDPM ancestral sampler (port of ``smd_tpu/diffusion/samplers.py``).

``diffusion_dynamics`` with infill masks, snapshot collection and per-step
metrics, written in the (clipped x0, raw eps) basis as the JAX package is.
The JAX sampler is one ``lax.scan`` program; here the T steps are a Python
loop that enqueues each step's kernels without waiting for the device (the
per-step constants are host floats and nothing is read back inside the
loop). Capturing the step in a CUDA graph is queued in ``ROADMAP.md``.

Randomness comes from a ``torch.Generator``, or from pre-drawn noise so a
test can replay the JAX package's draws: the JAX step splits its key into
(carry, infill, noise) and draws the infill noise, then the step noise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smd_tpu_torch.diffusion import schedules

__all__ = ["SamplerOutput", "diffusion_dynamics"]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SamplerOutput(NamedTuple):
    state: torch.Tensor
    collection: Optional[torch.Tensor]   # (num_snapshots+1, *state.shape)
    metrics: Optional[torch.Tensor]      # (4, T, 1)


def _per_example_norm(x):
    """Mean over batch of per-example L2 norms (all non-batch axes)."""
    sq = x.square().reshape(x.shape[0], -1).sum(-1)
    return torch.sqrt(sq + 1e-10).mean()


def _collection_indices(total_steps, collect_steps):
    """Evenly spaced 1-based step indices whose LAST entry is always the
    final step (identical to ``linspace(1, total, c)`` for c >= 2)."""
    return np.linspace(total_steps, 1, max(collect_steps, 1))[::-1] \
        .round().astype(np.int32)


def _collection_slots(total_steps, collect_steps) -> dict:
    """Step index -> collection slot: the first matching entry, plus one."""
    slots = {}
    for slot, idx in enumerate(_collection_indices(total_steps,
                                                   collect_steps)):
        slots.setdefault(int(idx), slot + 1)
    return slots


def _init_collection(collect_steps, start):
    if collect_steps <= 0:
        return None
    buf = torch.zeros((collect_steps + 1, *start.shape), dtype=start.dtype,
                      device=start.device)
    buf[0] = start
    return buf


def diffusion_dynamics(generator: Optional[torch.Generator],
                       model_fn: ModelFn,
                       betas,
                       init: torch.Tensor,
                       infill_samples: Optional[torch.Tensor] = None,
                       infill_masks: Optional[torch.Tensor] = None,
                       collect_steps: int = 40,
                       collect_metrics: bool = True,
                       constants: Optional[schedules.DDPMConstants] = None,
                       noise: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
                       ) -> SamplerOutput:
    """DDPM ancestral sampler (reverse-process decoder).

    Per step t = T-1..0: predict eps with the model conditioned on
    sqrt(abar_t) (shape (B, 1, ..., 1)), reconstruct x0 clipped to [-1, 1],
    form the posterior mean mu1*x0 + mu2*x_t, add clipped-variance noise
    (zero at t=0), and overwrite masked elements with the forward-diffused
    infill content at the matching noise level.

    ``noise``: optional pre-drawn ``(infill_noise, step_noise)``, each
    (T, *init.shape), indexed by loop step (step i is t = T-1-i); then
    ``generator`` is not used. Without infill masks the infill noise is
    neither drawn nor read: it would be multiplied by a zero mask.
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    T = c.num_steps
    collect_steps = min(collect_steps, T)
    infill = infill_masks is not None
    if infill:
        if infill_samples is None:
            infill_samples = torch.zeros_like(init)
        infill_samples = infill_samples.to(init)
        infill_masks = infill_masks.to(init)
        keep = 1 - infill_masks
        start = init * keep + infill_samples * infill_masks
    else:
        start = init

    collection = _init_collection(collect_steps, start)
    slots = _collection_slots(T, collect_steps)
    consts = {k: getattr(c, k).numpy() for k in (
        "alphas_prod", "sqrt_alphas_prod", "sqrt_recip_alphas_prod",
        "sqrt_alphas_prod_m1", "posterior_mu1", "posterior_mu2",
        "posterior_log_var")}
    one = np.float32(1.0)
    alphas_prod = c.alphas_prod.to(init.device) if collect_metrics else None
    cond_shape = (init.shape[0], *([1] * (init.dim() - 1)))
    metrics = []

    def draw(i, which):
        if noise is not None:
            return noise[which][i].to(init)
        return torch.randn(init.shape, generator=generator,
                           dtype=init.dtype, device=init.device)

    state = start
    for i, t in enumerate(range(T - 1, -1, -1)):
        sqrt_ap = float(consts["sqrt_alphas_prod"][t])
        if infill:
            infill_noise = draw(i, 0)
            if t > 0:
                y = sqrt_ap * infill_samples + float(np.sqrt(
                    one - consts["alphas_prod"][t])) * infill_noise
            else:
                y = infill_samples
        step_noise = draw(i, 1)
        if t > 0:
            step_noise = step_noise * float(np.exp(
                np.float32(0.5) * consts["posterior_log_var"][t]))
        else:
            step_noise = torch.zeros_like(step_noise)

        cond = torch.full(cond_shape, sqrt_ap, dtype=init.dtype,
                          device=init.device)
        eps_recon = model_fn(state, cond)
        state_recon = (float(consts["sqrt_recip_alphas_prod"][t]) * state -
                       float(consts["sqrt_alphas_prod_m1"][t]) * eps_recon)
        state_recon = state_recon.clamp(-1.0, 1.0)
        posterior_mu = (float(consts["posterior_mu1"][t]) * state_recon +
                        float(consts["posterior_mu2"][t]) * state)
        next_state = posterior_mu + step_noise
        if infill:
            next_state = next_state * keep + y * infill_masks

        slot = slots.get(T - t) if collection is not None else None
        if slot is not None:
            collection[slot] = next_state
        if collect_metrics:
            metrics.append(torch.stack([
                _per_example_norm(eps_recon),
                _per_example_norm(state - next_state),
                alphas_prod[t],
                _per_example_norm(step_noise)]))
        state = next_state

    out_metrics = torch.stack(metrics, dim=1)[:, :, None] \
        if collect_metrics else None
    return SamplerOutput(state, collection, out_metrics)
