"""Generation drivers: unconditional, infilling, interpolation (port of
``smd_tpu/sampling/generate.py``).

``sample`` serves the NCSN family's annealed and consistent Langevin
samplers (``ald``, the default, and ``cas``) and the DDPM, DDIM,
DPM-Solver++, distilled and consistency samplers. Every driver takes a
``model_fn(x, cond)`` closure over a model, as the JAX ones do. On the card
each chain is one step captured in a CUDA graph and replayed once a step
(``diffusion/samplers.py``, ``utils/graphs.py``), kept for the next call
with the same ``model_fn``, sampler, sizes and options: ``interpolate``'s
chains replay one graph. ``utils.graphs.release()`` frees the kept graphs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smd_tpu_torch.device import resolve_device
from smd_tpu_torch.diffusion import samplers, schedules

__all__ = ["sample", "make_init", "SAMPLERS", "infill_edge_mask",
           "interpolation_endpoints", "interpolate"]

SAMPLERS = ("ald", "cas", "ddpm", "ddim", "dpmpp", "distilled", "consistency")


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
    the noise levels for ``ald`` and ``cas`` and the DDPM betas for the
    diffusion samplers. ``generator`` (on ``device``) draws the initial
    state, then the sampler's noise. ``epsilon``, ``steps`` (ALD's steps
    a level) and ``denoise`` belong to ``ald`` and ``cas``. ``ddim_steps``
    is DDIM's and DPM++'s step budget and the consistency sampler's k;
    ``distill_grid`` is the bundle's grid for ``distilled`` and
    ``consistency``. ``ensure_snapshots`` opts DPM++, collection-free by
    default, into a DDIM-sized collection.

    Returns (generated, collection, metrics), the JAX package's 3-tuple.
    """
    if sampling not in SAMPLERS:
        raise ValueError(f"Unknown sampling algorithm: {sampling}")
    if sampling in ("distilled", "consistency") and distill_grid is None:
        raise ValueError(f"sampling={sampling!r} needs the bundle's grid "
                         "(see training.distill / training.consistency)")
    device = resolve_device(device)
    init = make_init(generator, num_samples, sample_shape, sampling, device)
    if infill_masks is not None:
        infill_samples = torch.as_tensor(infill_samples, dtype=torch.float32,
                                         device=device)
        infill_masks = torch.as_tensor(infill_masks, dtype=torch.float32,
                                       device=device)
    infill = dict(infill_samples=infill_samples, infill_masks=infill_masks)

    if sampling == "ddpm":
        out = samplers.diffusion_dynamics(
            generator, model_fn, sigmas, init, **infill,
            collect_steps=40 if collect_steps is None else collect_steps,
            collect_metrics=collect_metrics)
    elif sampling == "ddim":
        out = samplers.ddim_dynamics(
            generator, model_fn, sigmas, init, num_steps=ddim_steps,
            eta=ddim_eta, **infill,
            collect_steps=40 if collect_steps is None else collect_steps,
            collect_metrics=collect_metrics)
    elif sampling == "distilled":
        out = samplers.distilled_ddim_dynamics(generator, model_fn,
                                               distill_grid, init, **infill)
    elif sampling == "consistency":
        out = samplers.consistency_dynamics(generator, model_fn,
                                            distill_grid, init,
                                            num_steps=ddim_steps, **infill)
    elif sampling == "dpmpp":   # snapshots off unless asked for
        if collect_steps is None:
            collect_steps = 40 if ensure_snapshots else 0
        out = samplers.dpmpp_dynamics(
            generator, model_fn, sigmas, init, num_steps=ddim_steps,
            **infill, collect_steps=collect_steps,
            collect_metrics=collect_metrics)
    else:   # ald, cas
        fn = samplers.annealed_langevin_dynamics if sampling == "ald" \
            else samplers.consistent_langevin_dynamics
        out = fn(generator, model_fn, sigmas, init, epsilon, steps,
                 denoise=denoise, **infill,
                 collect_steps=100 if collect_steps is None
                 else collect_steps, collect_metrics=collect_metrics)
    return out.state, out.collection, out.metrics


def infill_edge_mask(real, problem="vae", fixed_edge=8):
    """The reference's infilling inputs (numpy): toy 2-D data fixes dim 0
    and infills dim 1; sequences hold the first and last ``fixed_edge``
    latents and regenerate the middle."""
    samples = np.copy(np.asarray(real))
    masks = np.zeros(samples.shape, np.float32)
    if problem == "toy" and samples.shape[-1] == 2 and samples.ndim == 2:
        samples[:, 1] = 0
        masks[:, 0] = 1
    else:
        seq_len = samples.shape[1]
        idx = list(range(seq_len))
        fixed_idx = idx[:fixed_edge] + idx[-fixed_edge:]
        infilled_idx = idx[fixed_edge:-fixed_edge]
        samples[:, infilled_idx] = 0
        masks[:, fixed_idx] = 1
    return samples, masks


def interpolation_endpoints(real):
    """Pair each sample with its roll-by-one neighbor (numpy)."""
    starts = np.asarray(real)
    goals = np.roll(starts, shift=1, axis=0)
    return starts, goals


def interpolate(model_fn, betas, generator: Optional[torch.Generator], real,
                num_alphas=9, collect_steps=0, collect_metrics=False, *,
                device=None, noise=None):
    """DDPM latent interpolation: encode q(x_T|x_0) at both endpoints,
    interpolate linearly in x_T, decode each interpolant with the DDPM
    chain on ``device`` (``cuda`` unless ``"cpu"``).

    ``generator`` draws the two encodings' noise, then each chain's.
    ``noise``: optional pre-drawn ``(start_noise, goal_noise,
    chain_noises)``, ``chain_noises[a]`` the a-th chain's ``noise`` (see
    ``samplers.diffusion_dynamics``).

    Returns (generated (A, N, ...), collections, metrics_list).
    """
    device = resolve_device(device)
    starts, goals = interpolation_endpoints(real)
    enc = [samplers.diffusion_stochastic_encoder(
        generator, torch.as_tensor(x, dtype=torch.float32, device=device),
        betas, None if noise is None else noise[k])
        for k, x in enumerate((starts, goals))]
    consts = schedules.ddpm_constants(betas)
    gen, collects, metrics_list = [], [], []
    for a, alpha in enumerate(np.linspace(0.0, 1.0, num_alphas)):
        z = (float(np.float32(1 - alpha)) * enc[0] +
             float(np.float32(alpha)) * enc[1])
        out = samplers.diffusion_dynamics(
            generator, model_fn, betas, z, collect_steps=collect_steps,
            collect_metrics=collect_metrics, constants=consts,
            noise=None if noise is None else noise[2][a])
        gen.append(out.state)
        collects.append(out.collection)
        metrics_list.append(out.metrics)
    return torch.stack(gen), collects, metrics_list
