"""Langevin, DDPM, DDIM, DPM-Solver++ and few-step samplers (port of
``smd_tpu/diffusion/samplers.py``).

The NCSN family's ``annealed_langevin_dynamics`` (ALD) and
``consistent_langevin_dynamics`` (CAS); ``diffusion_dynamics`` (the
1000-step ancestral chain), ``ddim_dynamics``, ``dpmpp_dynamics``,
``distilled_ddim_dynamics`` and ``consistency_dynamics``; with infill
masks, and snapshot collection and per-step metrics where the JAX samplers
have them; the DDPM family in the (clipped x0, raw eps) basis as the JAX
package is. A JAX sampler is one ``lax.scan`` program; here the steps are a
Python loop that enqueues each step's kernels without waiting for the device
(the per-step constants are host floats, computed once in float32 as JAX
computes them, and nothing is read back inside the loop). Capturing the step
in a CUDA graph is queued in ``ROADMAP.md``.

Randomness comes from a ``torch.Generator``, or from pre-drawn noise so a
test can replay the JAX package's draws (each sampler's docstring gives the
JAX order). Draws that JAX multiplies by zero (the infill noise without
masks, the step noise of the last step or of DDIM at eta=0) are not made.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smd_tpu_torch.diffusion import schedules

__all__ = ["SamplerOutput", "annealed_langevin_dynamics",
           "consistent_langevin_dynamics", "diffusion_dynamics",
           "ddim_dynamics", "ddim_taus", "dpmpp_dynamics", "dpmpp_taus",
           "distilled_ddim_dynamics", "consistency_dynamics",
           "diffusion_stochastic_encoder", "collate_sampling_metrics"]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
f32 = np.float32


class SamplerOutput(NamedTuple):
    state: torch.Tensor
    collection: Optional[torch.Tensor]   # (num_snapshots+1[, +1], *shape)
    metrics: Optional[torch.Tensor]      # (4, num_sigmas or steps, T or 1)


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


def _init_collection(collect_steps, start, extra_slots: int = 0):
    """The snapshot buffer: ``start``, then ``collect_steps`` slots, then
    ``extra_slots`` (the Langevin samplers' final denoise step)."""
    if collect_steps <= 0:
        return None
    buf = torch.zeros((collect_steps + 1 + extra_slots, *start.shape),
                      dtype=start.dtype, device=start.device)
    buf[0] = start
    return buf


def _resolve_infill(init, infill_samples, infill_masks):
    """(samples, masks, keep = 1 - masks) on ``init``'s device and dtype,
    samples zero when not given; all None without masks, where every infill
    term would be multiplied by a zero mask."""
    if infill_masks is None:
        return None, None, None
    if infill_samples is None:
        infill_samples = torch.zeros_like(init)
    infill_samples = infill_samples.to(init)
    infill_masks = infill_masks.to(init)
    return infill_samples, infill_masks, 1 - infill_masks


def _drawer(generator, init, noise):
    """draw(which, i): ``noise[which][i]`` when pre-drawn, else a fresh
    normal of ``init``'s shape from ``generator``."""
    def draw(which, i):
        if noise is not None:
            return noise[which][i].to(init)
        return torch.randn(init.shape, generator=generator,
                           dtype=init.dtype, device=init.device)
    return draw


def _cond(state, value):
    """The model's noise-level input: ``value`` broadcast to (B, 1, ..., 1)."""
    return torch.full((state.shape[0], *([1] * (state.dim() - 1))),
                      float(value), dtype=state.dtype, device=state.device)


def _metric_row(eps, state, next_state, level, noise_norm):
    """(eps norm, step norm, noise level, noise norm); ``level`` is a 0-d
    tensor on the device (a host scalar would be a copy per step)."""
    return torch.stack([_per_example_norm(eps),
                        _per_example_norm(state - next_state), level,
                        noise_norm])


def _levels(values, init, collect_metrics):
    """The per-step noise levels on ``init``'s device, for the metrics."""
    return torch.as_tensor(values).to(init.device) if collect_metrics \
        else None


def _stack_metrics(metrics):
    return torch.stack(metrics, dim=1)[:, :, None] if metrics else None


def _langevin_chain(generator, model_fn, sigmas, init, epsilon, T,
                    denoise, infill_samples, infill_masks, collect_steps,
                    collect_metrics, noise, consistent):
    """ALD (``consistent=False``: T steps at each of the L levels) or CAS
    (one step a level), as the two JAX samplers compute them."""
    sig = np.asarray(torch.as_tensor(sigmas, dtype=torch.float32).cpu())
    L = sig.shape[0]
    eps32 = f32(epsilon)
    sig_last2 = sig[-1] * sig[-1]
    # α = ε (σ/σ_L)² per level, and CAS's β, in float32 as JAX computes them.
    alphas = eps32 * np.square(sig / sig[-1])
    beta = np.sqrt(f32(1) - np.square(f32(1) - eps32 / sig_last2))
    steps = L if consistent else L * T
    infill_samples, infill_masks, keep = _resolve_infill(
        init, infill_samples, infill_masks)
    infill = infill_masks is not None
    start = init * keep + infill_samples * infill_masks if infill else init
    collect_steps = min(collect_steps, steps)
    collection = _init_collection(collect_steps, start, int(denoise))
    slots = _collection_slots(steps, collect_steps)
    draw = _drawer(generator, init, noise)
    # The model's sigma: a 0-d float32 tensor on the device, as JAX passes
    # sigmas[i]; indexed, not copied from the host each step.
    levels = torch.as_tensor(sig).to(init.device)
    alpha_levels = _levels(alphas, init, collect_metrics)
    zero_norm = None
    metrics = []

    state = start
    for n in range(steps):
        level = n if consistent else n // T
        sigma, alpha = sig[level], float(alphas[level])
        if infill:
            y = infill_samples + float(sigma) * draw(1, n)
        grad = model_fn(state, levels[level])
        if consistent:
            amp = beta * sig[level + 1] if level < L - 1 else None
        else:
            amp = np.sqrt(f32(2) * alphas[level])
        next_state = state + alpha * grad
        step_noise = None
        if amp is not None:
            step_noise = float(amp) * draw(0, n)
            next_state = next_state + step_noise
        if infill:
            next_state = next_state * keep + y * infill_masks
        slot = slots.get(n + 1) if collection is not None else None
        if slot is not None:
            collection[slot] = next_state
        if collect_metrics:
            if step_noise is None and zero_norm is None:
                zero_norm = _per_example_norm(torch.zeros_like(state))
            metrics.append(torch.stack([
                _per_example_norm(grad), _per_example_norm(alpha * grad),
                alpha_levels[level], zero_norm if step_noise is None
                else _per_example_norm(step_noise)]))
        state = next_state

    if denoise:
        state = state + float(sig_last2) * model_fn(state, levels[L - 1])
        if collection is not None:
            collection[-1] = state
    if not metrics:
        return SamplerOutput(state, collection, None)
    stacked = torch.stack(metrics, dim=1)
    stacked = stacked[:, :, None] if consistent else \
        stacked.reshape(4, L, T)
    return SamplerOutput(state, collection, stacked)


def annealed_langevin_dynamics(generator: Optional[torch.Generator],
                               model_fn: ModelFn,
                               sigmas,
                               init: torch.Tensor,
                               epsilon: float,
                               T: int,
                               denoise: bool = True,
                               infill_samples: Optional[torch.Tensor] = None,
                               infill_masks: Optional[torch.Tensor] = None,
                               collect_steps: int = 100,
                               collect_metrics: bool = True,
                               noise: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None
                               ) -> SamplerOutput:
    """Annealed Langevin dynamics (Song & Ermon).

    T steps at each of the L noise levels, noisiest first: step size α =
    ε·(σ/σ_L)²; x += α·s(x, σ) + sqrt(2α)·z; the infill overwrite
    (samples + σ·z') each step; then, with ``denoise``, x += σ_L²·s(x,
    σ_L) into the collection's extra last slot. The model gets σ as a 0-d
    tensor. Metrics (4, L, T): |s|, |α s|, α, |noise| (per-example norms,
    batch mean).

    ``noise``: optional pre-drawn ``(step_noise, infill_noise)``, each
    (L·T, *init.shape), indexed by step l·T + t; then ``generator`` is not
    used. The JAX step splits its key into (carry, noise, infill) and draws
    the infill noise, then the step noise.
    """
    return _langevin_chain(generator, model_fn, sigmas, init, epsilon, T,
                           denoise, infill_samples, infill_masks,
                           collect_steps, collect_metrics, noise,
                           consistent=False)


def consistent_langevin_dynamics(generator: Optional[torch.Generator],
                                 model_fn: ModelFn,
                                 sigmas,
                                 init: torch.Tensor,
                                 epsilon: float,
                                 T: int = 1,
                                 denoise: bool = True,
                                 infill_samples: Optional[torch.Tensor] = None,
                                 infill_masks: Optional[torch.Tensor] = None,
                                 collect_steps: int = 100,
                                 collect_metrics: bool = True,
                                 noise: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]] = None
                                 ) -> SamplerOutput:
    """Consistent annealed sampling (Jolicoeur-Martineau et al.).

    One step a level (``T`` is taken and unused, as in JAX): x += α·s(x,
    σ_i) + β·σ_{i+1}·z with β = sqrt(1 - (1 - ε/σ_L²)²) and no noise after
    the last level; infill and the final denoise as ALD. Metrics (4, L, 1).
    ``noise``: optional ``(step_noise, infill_noise)``, each (L,
    *init.shape); the JAX step splits its key as ALD's.
    """
    del T
    return _langevin_chain(generator, model_fn, sigmas, init, epsilon, 1,
                           denoise, infill_samples, infill_masks,
                           collect_steps, collect_metrics, noise,
                           consistent=True)


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
    ``generator`` is not used. The JAX step splits its key into (carry,
    infill, noise) and draws the infill noise, then the step noise.
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    T = c.num_steps
    collect_steps = min(collect_steps, T)
    infill_samples, infill_masks, keep = _resolve_infill(
        init, infill_samples, infill_masks)
    infill = infill_masks is not None
    start = init * keep + infill_samples * infill_masks if infill else init

    collection = _init_collection(collect_steps, start)
    slots = _collection_slots(T, collect_steps)
    consts = {k: getattr(c, k).numpy() for k in (
        "alphas_prod", "sqrt_alphas_prod", "sqrt_recip_alphas_prod",
        "sqrt_alphas_prod_m1", "posterior_mu1", "posterior_mu2",
        "posterior_log_var")}
    one = f32(1.0)
    levels = _levels(c.alphas_prod, init, collect_metrics)
    draw = _drawer(generator, init, noise)
    metrics = []

    state = start
    for i, t in enumerate(range(T - 1, -1, -1)):
        sqrt_ap = float(consts["sqrt_alphas_prod"][t])
        if infill:
            infill_noise = draw(0, i)
            if t > 0:
                y = sqrt_ap * infill_samples + float(np.sqrt(
                    one - consts["alphas_prod"][t])) * infill_noise
            else:
                y = infill_samples
        step_noise = draw(1, i)
        if t > 0:
            step_noise = step_noise * float(np.exp(
                f32(0.5) * consts["posterior_log_var"][t]))
        else:
            step_noise = torch.zeros_like(step_noise)

        eps_recon = model_fn(state, _cond(state, sqrt_ap))
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
            metrics.append(_metric_row(eps_recon, state, next_state,
                                       levels[t],
                                       _per_example_norm(step_noise)))
        state = next_state

    return SamplerOutput(state, collection, _stack_metrics(metrics))


def ddim_taus(num_timesteps: int, num_steps: int) -> np.ndarray:
    """DDIM's strided subset of [0, T), ascending:
    ``jnp.linspace(0, T - 1, num_steps).round()`` in JAX's float32."""
    return np.round(schedules.linspace_f32(0, num_timesteps - 1,
                                           num_steps)).astype(np.int64)


def ddim_dynamics(generator: Optional[torch.Generator],
                  model_fn: ModelFn,
                  betas,
                  init: torch.Tensor,
                  num_steps: int = 50,
                  eta: float = 0.0,
                  infill_samples: Optional[torch.Tensor] = None,
                  infill_masks: Optional[torch.Tensor] = None,
                  collect_steps: int = 0,
                  collect_metrics: bool = False,
                  constants: Optional[schedules.DDPMConstants] = None,
                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> SamplerOutput:
    """DDIM sampling over a strided timestep subset (Song et al., 2021).

    eta=0 gives the deterministic DDIM ODE; eta=1 ancestral-like noise.
    ``noise``: optional pre-drawn ``(step_noise, infill_noise)``, each
    (num_steps, *init.shape), indexed by loop step (step j is i =
    num_steps-1-j). The JAX step splits its key into (carry, noise, infill)
    and draws the step noise, then the infill noise.
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    abar = c.alphas_prod.numpy()[ddim_taus(c.num_steps, num_steps)]
    abar_prev = np.concatenate([np.ones(1, f32), abar[:-1]])
    one = f32(1.0)
    infill_samples, infill_masks, keep = _resolve_infill(
        init, infill_samples, infill_masks)
    infill = infill_masks is not None
    start = init * keep + infill_samples * infill_masks if infill else init
    collect_steps = min(collect_steps, num_steps)
    collection = _init_collection(collect_steps, start)
    slots = _collection_slots(num_steps, collect_steps)
    draw = _drawer(generator, init, noise)
    levels = _levels(abar, init, collect_metrics)
    zero_norm = None
    metrics = []

    state = start
    for j, i in enumerate(range(num_steps - 1, -1, -1)):
        a, a_prev = abar[i], abar_prev[i]
        sqrt_a = np.sqrt(a)
        eps = model_fn(state, _cond(state, sqrt_a))
        x0 = ((state - float(np.sqrt(one - a)) * eps) / float(sqrt_a)) \
            .clamp(-1.0, 1.0)
        sigma = (f32(eta) * np.sqrt((one - a_prev) / (one - a)) *
                 np.sqrt(one - a / a_prev))
        dir_coeff = np.sqrt(np.maximum(one - a_prev - sigma ** 2, f32(0)))
        next_state = float(np.sqrt(a_prev)) * x0 + float(dir_coeff) * eps
        step_noise = None
        if i > 0 and sigma != 0:
            step_noise = float(sigma) * draw(0, j)
            next_state = next_state + step_noise
        if infill:
            if i > 0:
                y = (float(np.sqrt(a_prev)) * infill_samples +
                     float(np.sqrt(one - a_prev)) * draw(1, j))
            else:
                y = infill_samples
            next_state = next_state * keep + y * infill_masks

        slot = slots.get(num_steps - i) if collection is not None else None
        if slot is not None:
            collection[slot] = next_state
        if collect_metrics:
            if step_noise is None and zero_norm is None:
                zero_norm = _per_example_norm(torch.zeros_like(state))
            metrics.append(_metric_row(
                eps, state, next_state, levels[i], zero_norm
                if step_noise is None else _per_example_norm(step_noise)))
        state = next_state

    return SamplerOutput(state, collection, _stack_metrics(metrics))


def dpmpp_taus(alphas_prod, num_steps: int,
               lam_max: Optional[float] = 2.5) -> np.ndarray:
    """DPM-Solver++'s timesteps, ascending: the indices nearest a grid
    uniform in half-log-SNR from the ``lam_max``-capped clean end to t=T-1
    (the first on ties), forced strictly increasing (cummax of taus - k,
    plus k) and clamped to T-1, in JAX's float32."""
    lam_all = schedules.half_log_snr(alphas_prod)
    T = lam_all.shape[0]
    lam_hi = lam_all[0] if lam_max is None else \
        np.minimum(lam_all[0], f32(lam_max))
    lam_grid = schedules.linspace_f32(lam_hi, lam_all[T - 1], num_steps)
    taus = np.argmin(np.abs(lam_all[None, :] - lam_grid[:, None]), axis=1)
    k = np.arange(num_steps)
    taus = np.maximum.accumulate(taus - k) + k
    return np.minimum(taus, T - 1)


def dpmpp_dynamics(generator: Optional[torch.Generator],
                   model_fn: ModelFn,
                   betas,
                   init: torch.Tensor,
                   num_steps: int = 20,
                   infill_samples: Optional[torch.Tensor] = None,
                   infill_masks: Optional[torch.Tensor] = None,
                   lam_max: Optional[float] = 2.5,
                   collect_steps: int = 0,
                   collect_metrics: bool = False,
                   constants: Optional[schedules.DDPMConstants] = None,
                   noise: Optional[torch.Tensor] = None) -> SamplerOutput:
    """DPM-Solver++(2M): 2nd-order multistep ODE sampler (Lu et al., 2022).

    Steps on the ``dpmpp_taus`` grid, Euler on the first and last steps and
    where duplicate taus give h == 0 (their r is replaced by 1), the
    update written in the (clipped x0, raw eps) basis. Deterministic but
    for the infill forward-diffusion; the noise-norm metric row is zero.
    ``noise``: optional pre-drawn infill noise (num_steps, *init.shape),
    indexed by loop step (step j is k = num_steps-1-j); the JAX step splits
    its key into (carry, infill).
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    abar = c.alphas_prod.numpy()[dpmpp_taus(c.alphas_prod, num_steps,
                                            lam_max)]
    one = f32(1.0)
    abar_next = np.minimum(np.concatenate([np.ones(1, f32), abar[:-1]]),
                           f32(1.0 - 1e-6))
    alpha_cur, sigma_cur = np.sqrt(abar), np.sqrt(one - abar)
    alpha_next, sigma_next = np.sqrt(abar_next), np.sqrt(one - abar_next)
    h = np.log(alpha_next / sigma_next) - np.log(alpha_cur / sigma_cur)
    # Step k's predecessor is k+1 (the loop runs k descending): r[k] =
    # h[k+1] / h[k]; duplicate taus give h == 0, where r is replaced by 1
    # and the step is Euler.
    h_zero = h == 0
    h_prev = np.concatenate([h[1:], np.ones(1, f32)])
    r = np.where(h_zero | (h_prev == 0), one,
                 h_prev / np.where(h_zero, one, h))

    infill_samples, infill_masks, keep = _resolve_infill(
        init, infill_samples, infill_masks)
    infill = infill_masks is not None
    start = init * keep + infill_samples * infill_masks if infill else init
    collect_steps = min(collect_steps, num_steps)
    collection = _init_collection(collect_steps, start)
    slots = _collection_slots(num_steps, collect_steps)
    draw = _drawer(generator, init, None if noise is None else (noise,))
    levels = _levels(abar, init, collect_metrics)
    zero = torch.zeros((), device=init.device)
    metrics = []

    state, prev_x0 = start, None
    for j, k in enumerate(range(num_steps - 1, -1, -1)):
        eps = model_fn(state, _cond(state, alpha_cur[k]))
        x0 = ((state - float(sigma_cur[k]) * eps) / float(alpha_cur[k])) \
            .clamp(-1.0, 1.0)
        next_state = float(alpha_next[k]) * x0 + float(sigma_next[k]) * eps
        if not (k == num_steps - 1 or k == 0 or h_zero[k]):
            corr = float(one / (f32(2.0) * r[k])) * (x0 - prev_x0)
            next_state = next_state - float(
                alpha_next[k] * (np.exp(-h[k]) - one)) * corr
        if infill:
            if k > 0:
                y = (float(alpha_next[k]) * infill_samples +
                     float(sigma_next[k]) * draw(0, j))
            else:
                y = infill_samples
            next_state = next_state * keep + y * infill_masks
        slot = slots.get(num_steps - k) if collection is not None else None
        if slot is not None:
            collection[slot] = next_state
        if collect_metrics:
            metrics.append(_metric_row(eps, state, next_state, levels[k],
                                       zero))
        state, prev_x0 = next_state, x0

    return SamplerOutput(state, collection, _stack_metrics(metrics))


def _grid_f32(grid) -> np.ndarray:
    if torch.is_tensor(grid):
        grid = grid.detach().cpu().numpy()
    return np.asarray(grid, f32)


def distilled_ddim_dynamics(generator: Optional[torch.Generator],
                            model_fn: ModelFn,
                            grid,
                            init: torch.Tensor,
                            infill_samples: Optional[torch.Tensor] = None,
                            infill_masks: Optional[torch.Tensor] = None,
                            clip_x0: bool = True,
                            noise: Optional[torch.Tensor] = None
                            ) -> SamplerOutput:
    """Few-step sampler for a progressively distilled model.

    ``grid`` is the ``(N+1,)`` alpha-bar boundary array the student was
    distilled on (``training.distill.distill_grid``): one DDIM jump per
    boundary pair, noisiest to clean, x0 clipped as in distillation.
    ``noise``: optional pre-drawn infill noise (N, *init.shape); the JAX
    step splits its key into (carry, infill).
    """
    grid = _grid_f32(grid)
    num_steps = grid.shape[0] - 1
    alphas, sigmas = np.sqrt(grid), np.sqrt(f32(1.0) - grid)
    infill_samples, infill_masks, keep = _resolve_infill(
        init, infill_samples, infill_masks)
    draw = _drawer(generator, init, None if noise is None else (noise,))

    state = init if infill_masks is None else \
        init * keep + infill_samples * infill_masks
    for i in range(num_steps):
        eps = model_fn(state, _cond(state, alphas[i]))
        x0 = (state - float(sigmas[i]) * eps) / float(alphas[i])
        if clip_x0:
            x0 = x0.clamp(-1.0, 1.0)
        next_state = float(alphas[i + 1]) * x0 + float(sigmas[i + 1]) * eps
        if infill_masks is not None:
            y = (float(alphas[i + 1]) * infill_samples +
                 float(sigmas[i + 1]) * draw(0, i)) \
                if i < num_steps - 1 else infill_samples
            next_state = next_state * keep + y * infill_masks
        state = next_state
    return SamplerOutput(state, None, None)


def consistency_dynamics(generator: Optional[torch.Generator],
                         model_fn: ModelFn,
                         grid,
                         init: torch.Tensor,
                         num_steps: int = 1,
                         infill_samples: Optional[torch.Tensor] = None,
                         infill_masks: Optional[torch.Tensor] = None,
                         clip_x0: bool = True,
                         noise: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                         ) -> SamplerOutput:
    """1-to-k-step sampler for a consistency-distilled model.

    ``grid`` is the ``(N+1,)`` segment-boundary array of the bundle. Step j
    evaluates the consistency function (the clipped x0) at the level
    ``grid[j * N // k]``, re-noising the previous step's x0 to it for j > 0.
    ``noise``: optional pre-drawn ``(step_noise, infill_noise)``, each
    (num_steps, *init.shape); the JAX step splits its key into (carry,
    noise, infill) and draws the re-noising noise, then the infill noise.
    """
    grid = _grid_f32(grid)
    num_seg = grid.shape[0] - 1
    if not 1 <= num_steps <= num_seg:
        raise ValueError(f"num_steps={num_steps} outside [1, {num_seg}] "
                         f"for a {num_seg}-segment consistency grid")
    levels = grid[np.arange(num_steps) * num_seg // num_steps]
    alphas, sigmas = np.sqrt(levels), np.sqrt(f32(1.0) - levels)
    infill_samples, infill_masks, keep = _resolve_infill(
        init, infill_samples, infill_masks)
    draw = _drawer(generator, init, noise)

    state = init
    for j in range(num_steps):
        z = state if j == 0 else \
            float(alphas[j]) * state + float(sigmas[j]) * draw(0, j)
        if infill_masks is not None:
            y = (float(alphas[j]) * infill_samples +
                 float(sigmas[j]) * draw(1, j))
            z = z * keep + y * infill_masks
        eps = model_fn(z, _cond(z, alphas[j]))
        state = (z - float(sigmas[j]) * eps) / float(alphas[j])
        if clip_x0:
            state = state.clamp(-1.0, 1.0)
    if infill_masks is not None:
        state = state * keep + infill_samples * infill_masks
    return SamplerOutput(state, None, None)


def diffusion_stochastic_encoder(generator: Optional[torch.Generator],
                                 samples: torch.Tensor, betas,
                                 noise: Optional[torch.Tensor] = None):
    """Estimate q(x_T | x_0): forward-diffuse real samples to the final
    level. ``noise``: an optional pre-drawn normal of ``samples``' shape."""
    betas = np.asarray(torch.as_tensor(betas, dtype=torch.float32).cpu())
    abar = schedules._cumprod_f32(f32(1.0) - betas)[-1]
    if noise is None:
        noise = torch.randn(samples.shape, generator=generator,
                            dtype=samples.dtype, device=samples.device)
    return (float(np.sqrt(abar)) * samples +
            float(np.sqrt(f32(1.0) - abar)) * noise.to(samples))


def collate_sampling_metrics(ld_metrics):
    """Convert stacked (4, num_sigmas, T) metrics into per-level dict lists."""
    if ld_metrics is None:
        return []
    if torch.is_tensor(ld_metrics):
        ld_metrics = ld_metrics.detach().cpu().numpy()
    ld_metrics = np.asarray(ld_metrics)
    _, num_sigmas, num_steps = ld_metrics.shape
    out = [[] for _ in range(num_sigmas)]
    for i in range(num_sigmas):
        grad_norm, step_norm, alpha, noise_norm = ld_metrics[:, i, :]
        for j in range(num_steps):
            out[i].append({
                "slope": grad_norm[j],
                "step": step_norm[j],
                "alpha": alpha[j],
                "noise": noise_norm[j],
            })
    return out
