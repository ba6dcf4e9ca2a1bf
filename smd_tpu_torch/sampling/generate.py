"""Generation entry point (port of ``smd_tpu/sampling/generate.py``).

``sample`` with ``sampling="ddpm"``; the other samplers of the JAX package
raise and point at ``ROADMAP.md``. ``sample`` takes a ``model_fn(x, cond)``
closure over a model, as the JAX one does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smd_tpu_torch.device import resolve_device
from smd_tpu_torch.diffusion import samplers

__all__ = ["sample", "make_init", "SAMPLERS"]

SAMPLERS = ("ald", "cas", "ddpm", "ddim", "dpmpp", "distilled", "consistency")
_PORTED = ("ddpm",)


def make_init(generator: Optional[torch.Generator], num_samples: int,
              sample_shape, sampling: str, device=None) -> torch.Tensor:
    """Initial state: N(0,1) for DDPM/DDIM, U(-sqrt(12)/2, sqrt(12)/2)
    otherwise (both mean 0, var 1)."""
    device = resolve_device(device)
    shape = (num_samples, *sample_shape)
    if sampling in ("ddpm", "ddim", "dpmpp", "distilled", "consistency"):
        return torch.randn(shape, generator=generator, device=device)
    rho = float(np.sqrt(12) / 2)
    u = torch.rand(shape, generator=generator, device=device)
    return u * (2 * rho) - rho


def sample(model_fn,
           sigmas,
           generator: Optional[torch.Generator],
           sample_shape,
           num_samples=2400,
           sampling="ald",
           epsilon=1e-3,
           steps=100,
           denoise=True,
           infill_samples=None,
           infill_masks=None,
           collect_steps: Optional[int] = None,
           collect_metrics: bool = True,
           ddim_steps: int = 50,
           ddim_eta: float = 0.0,
           distill_grid=None,
           ensure_snapshots: bool = False,
           *,
           device=None):
    """Generate samples with the chosen dynamics on ``device``.

    The JAX package's signature, parameters and defaults in its order, then
    ``device``: ``cuda`` unless the caller passes ``"cpu"``. ``sigmas`` are
    the DDPM betas for ``sampling="ddpm"``. ``generator`` (on ``device``)
    draws the initial state, then the sampler's noise. ``epsilon``,
    ``steps``, ``denoise``, ``ddim_steps``, ``ddim_eta``, ``distill_grid``
    and ``ensure_snapshots`` belong to the samplers not ported yet, which
    raise (the default ``"ald"`` among them).

    Returns (generated, collection, metrics), the JAX package's 3-tuple.
    """
    if sampling not in SAMPLERS:
        raise ValueError(f"Unknown sampling algorithm: {sampling}")
    if sampling not in _PORTED:
        raise NotImplementedError(
            f"sampling={sampling!r} is not ported to smd_tpu_torch yet: see "
            "ROADMAP.md, queue A")
    device = resolve_device(device)
    init = make_init(generator, num_samples, sample_shape, sampling, device)
    if infill_masks is not None:
        infill_samples = torch.as_tensor(infill_samples, dtype=torch.float32,
                                         device=device)
        infill_masks = torch.as_tensor(infill_masks, dtype=torch.float32,
                                       device=device)
    if collect_steps is None:
        collect_steps = 40
    out = samplers.diffusion_dynamics(generator, model_fn, sigmas, init,
                                      infill_samples=infill_samples,
                                      infill_masks=infill_masks,
                                      collect_steps=collect_steps,
                                      collect_metrics=collect_metrics)
    return out.state, out.collection, out.metrics
