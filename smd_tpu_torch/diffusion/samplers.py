"""Langevin, DDPM, DDIM, DPM-Solver++ and few-step samplers (port of
``smd_tpu/diffusion/samplers.py``).

The NCSN family's ``annealed_langevin_dynamics`` (ALD) and
``consistent_langevin_dynamics`` (CAS); ``diffusion_dynamics`` (the
1000-step ancestral chain), ``ddim_dynamics``, ``dpmpp_dynamics``,
``distilled_ddim_dynamics`` and ``consistency_dynamics``; with infill
masks, and snapshot collection and per-step metrics where the JAX samplers
have them; the DDPM family in the (clipped x0, raw eps) basis as the JAX
package is.

A JAX sampler is one ``lax.scan`` program. Here each sampler is one step
body that reads its per-step constants from a float32 table (computed on
the host in numpy float32 as JAX computes them, staged once a call) through
a device index, and writes its state, snapshot slot and metrics in place;
``utils/graphs.py`` captures that step in a CUDA graph on the card and
replays it once a step, and runs it eagerly on the CPU (the plain version).
Nothing of a chain's values is baked into a graph: a second call with the
same model function, sampler, shapes and options replays the first call's
graph with its own schedule, start and infill. The rules that make the
eager and the captured step compute the same bits:

- every per-step value, the model's noise-level input included, is a 0-d
  device tensor from the table, never a Python float;
- ``x0 = (x - sigma·eps) / alpha`` divides by a tensor, as the CPU and JAX
  do (CUDA multiplies by the reciprocal of a Python float divisor);
- a step-dependent branch is arithmetic on table entries where no draw
  depends on it (DDPM's last step, DPM++'s Euler steps, CAS's last noise
  amplitude, each a 0 in the table), else a variant of the step with a graph
  of its own (a draw made before the last step only, consistency's first
  step); the snapshot collection writes every step, into its slot or into
  a spare row that is never returned; ALD's and CAS's final denoise and
  consistency's final infill overwrite are calls of their own.

Randomness comes from a ``torch.Generator``, or from pre-drawn noise so a
test can replay the JAX package's draws (each sampler's docstring gives the
JAX order). Draws that JAX multiplies by zero (the infill noise without
masks, the step noise of the last step of DDIM at eta>0, CAS's after its
last level, the infill noise of the few-step samplers' last step) are not
made, as in the eager loop this replaces; DDPM draws its last step's noise
and multiplies it by the table's 0.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smd_tpu_torch.diffusion import schedules
from smd_tpu_torch.utils import graphs

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


def _slot_table(total_steps, collect_steps, spare) -> np.ndarray:
    """Step j's collection slot (``_collection_slots`` of j + 1), or
    ``spare``, the row past the returned ones, where no slot matches."""
    slots = _collection_slots(total_steps, collect_steps)
    return np.asarray([slots.get(j + 1, spare) for j in range(total_steps)],
                      f32)


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


def _cond(state, value):
    """The model's noise-level input: the 0-d ``value`` broadcast to (B, 1,
    ..., 1)."""
    return value.to(state.dtype).expand(
        state.shape[0], *([1] * (state.dim() - 1))).contiguous()


def _metric_row(eps, state, next_state, level, noise_norm):
    """(eps norm, step norm, noise level, noise norm), 0-d device tensors
    each."""
    return torch.stack([_per_example_norm(eps),
                        _per_example_norm(state - next_state), level,
                        noise_norm])


def _draw(s, generator, which, like):
    """The step's pre-drawn ``noise{which}`` row when the call passed
    noise, else a fresh normal of ``like``'s shape from ``generator``."""
    name = f"noise{which}"
    if name in s:
        return s[name]
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _collect(s, next_state):
    """Write the step's state into its collection slot (or the spare
    row)."""
    s["collection"].index_copy_(0, s["slot"].long().reshape(1),
                                next_state.unsqueeze(0))


def _statics(start, infill, collect_rows, metrics, extra=()):
    """The per-call buffers: the state ``x``, the infill samples, masks and
    keep, the collection (``collect_rows`` rows with the spare, zero),
    the zero noise norm of the metrics, and ``extra`` (name, value)."""
    out = {"x": start}
    if infill[1] is not None:
        out.update(samples=infill[0], masks=infill[1], keep=infill[2])
    if collect_rows:
        out["collection"] = graphs.zeros((collect_rows, *start.shape),
                                         start.dtype, start.device)
    if metrics:
        out["zero_norm"] = _per_example_norm(torch.zeros_like(start))
    out.update(extra)
    return out


def _run(label, model_fn, flags, make_step, generator, start, tables,
         statics, noise, variants):
    """Run the chain's steps, one a variant, through the kept chain of
    ``label`` over ``model_fn``; ``noise`` (pre-drawn stacks, indexed by
    loop step) goes in as per-step inputs. Returns (per-call buffers,
    metrics rows)."""
    k = len(variants)
    inputs = {}
    for j, n in enumerate(noise or ()):
        if n is not None and k:
            inputs[f"noise{j}"] = n[:k].to(start)
    run = graphs.chain(label, model_fn, flags + (tuple(inputs),),
                       start.device, make_step)
    return run(generator, inputs, tables, statics, variants)


def _outputs(bufs, rows, start, collect_rows, metrics_shape=None):
    """(state, collection without its spare row, metrics (4, ...)) as
    tensors of their own, the collection's slot 0 the chain's start."""
    collection = None
    if collect_rows:
        collection = bufs["collection"][:collect_rows - 1].clone()
        collection[0] = start
    metrics = None
    if "m" in rows:
        metrics = rows["m"].t()
        metrics = metrics[:, :, None] if metrics_shape is None else \
            metrics.reshape(4, *metrics_shape)
    return bufs["x"].clone(), collection, metrics


def _start(init, infill):
    """The chain's start: ``init`` with the infill samples where masked."""
    samples, masks, keep = infill
    return init if masks is None else init * keep + samples * masks


def _collect_rows(collect_steps, extra_slots=0):
    """Rows of a chain's collection buffer: the start, ``collect_steps``
    slots, ``extra_slots``, and the spare row; 0 without collection."""
    return collect_steps + 2 + extra_slots if collect_steps > 0 else 0


def _langevin_step(model_fn, generator, infill, collect, metrics,
                   consistent):
    def step(s):
        x = s["x"]
        if infill:
            y = s["samples"] + s["sigma"] * _draw(s, generator, 1, x)
        grad = model_fn(x, s["sigma"])
        next_state = x + s["alpha"] * grad
        noise_norm = s.get("zero_norm")
        if not consistent or s["variant"]:
            step_noise = s["amp"] * _draw(s, generator, 0, x)
            next_state = next_state + step_noise
            if metrics:
                noise_norm = _per_example_norm(step_noise)
        if infill:
            next_state = next_state * s["keep"] + y * s["masks"]
        if collect:
            _collect(s, next_state)
        out = {}
        if metrics:
            out["m"] = torch.stack([
                _per_example_norm(grad), _per_example_norm(s["alpha"] * grad),
                s["alpha"], noise_norm])
        x.copy_(next_state)
        return out
    return step


def langevin_tables(sigmas, epsilon, T, consistent, collect_steps=0,
                    spare=0):
    """ALD's (``consistent=False``, T steps a level) or CAS's (one step a
    level) per-step table, in float32 as JAX computes it: ``sigma`` (the
    model's input and the infill noise's scale), ``alpha`` = ε (σ/σ_L)²,
    ``amp`` (ALD √(2α); CAS β·σᵢ₊₁, 0 after the last level) and the
    collection ``slot`` (``spare`` where none); with σ_L² for the final
    denoise."""
    sig = np.asarray(torch.as_tensor(sigmas, dtype=torch.float32).cpu())
    L = sig.shape[0]
    eps32 = f32(epsilon)
    sig_last2 = sig[-1] * sig[-1]
    alphas = eps32 * np.square(sig / sig[-1])
    beta = np.sqrt(f32(1) - np.square(f32(1) - eps32 / sig_last2))
    steps = L if consistent else L * T
    level = np.arange(steps) if consistent else np.arange(steps) // T
    if consistent:
        amp = [beta * sig[i + 1] if i < L - 1 else f32(0) for i in level]
    else:
        amp = [np.sqrt(f32(2) * alphas[i]) for i in level]
    tables = {"sigma": sig[level], "alpha": alphas[level],
              "amp": np.asarray(amp, f32)}
    if collect_steps > 0:
        tables["slot"] = _slot_table(steps, collect_steps, spare)
    return tables, sig, sig_last2


def _langevin_chain(generator, model_fn, sigmas, init, epsilon, T,
                    denoise, infill_samples, infill_masks, collect_steps,
                    collect_metrics, noise, consistent):
    """ALD (``consistent=False``: T steps at each of the L levels) or CAS
    (one step a level), as the two JAX samplers compute them."""
    L = int(torch.as_tensor(sigmas).shape[0])
    steps = L if consistent else L * T
    collect_steps = min(collect_steps, steps)
    rows = _collect_rows(collect_steps, int(denoise))
    tables, sig, sig_last2 = langevin_tables(sigmas, epsilon, T, consistent,
                                             collect_steps, rows - 1)
    infill = _resolve_infill(init, infill_samples, infill_masks)
    start = _start(init, infill)
    flags = (infill[1] is not None, rows > 0, collect_metrics, consistent)
    variants = [bool(i < L - 1) for i in range(L)] if consistent else \
        [True] * steps
    bufs, metric_rows = _run(
        "CAS" if consistent else "ALD", model_fn, flags,
        lambda gen: _langevin_step(model_fn, gen, *flags), generator, start,
        tables, _statics(start, infill, rows, collect_metrics), noise,
        variants)
    state, collection, metrics = _outputs(
        bufs, metric_rows, start, rows, None if consistent else (L, T))
    if denoise:
        with torch.no_grad():
            level = torch.as_tensor(sig).to(init.device)[L - 1]
            state = state + float(sig_last2) * model_fn(state, level)
        if collection is not None:
            collection[-1] = state
    return SamplerOutput(state, collection, metrics)


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


def _ddpm_step(model_fn, generator, infill, collect, metrics):
    def step(s):
        x = s["x"]
        if infill:
            y = s["y_a"] * s["samples"] + s["y_b"] * _draw(s, generator, 0,
                                                           x)
        step_noise = _draw(s, generator, 1, x) * s["noise_scale"]
        eps_recon = model_fn(x, _cond(x, s["cond"]))
        state_recon = (s["recip"] * x - s["m1"] * eps_recon).clamp(-1.0, 1.0)
        next_state = s["mu1"] * state_recon + s["mu2"] * x + step_noise
        if infill:
            next_state = next_state * s["keep"] + y * s["masks"]
        if collect:
            _collect(s, next_state)
        out = {}
        if metrics:
            out["m"] = _metric_row(eps_recon, x, next_state, s["level"],
                                   _per_example_norm(step_noise))
        x.copy_(next_state)
        return out
    return step


def ddpm_tables(constants: schedules.DDPMConstants, collect_steps=0,
                spare=0) -> dict:
    """DDPM's per-step table in loop order (step i is t = T-1-i), float32:
    ``cond`` √ᾱ_t (the model's input), the infill's ``y_a`` √ᾱ_t and ``y_b``
    √(1-ᾱ_t) (1 and 0 at t = 0: the samples themselves), ``noise_scale``
    exp(½ log var_t) (0 at t = 0), ``recip`` √(1/ᾱ_t), ``m1`` √(1/ᾱ_t - 1),
    the posterior's ``mu1`` and ``mu2``, the metrics' ``level`` ᾱ_t and the
    collection ``slot`` (``spare`` where none)."""
    c = {k: getattr(constants, k).numpy() for k in (
        "alphas_prod", "sqrt_alphas_prod", "sqrt_recip_alphas_prod",
        "sqrt_alphas_prod_m1", "posterior_mu1", "posterior_mu2",
        "posterior_log_var")}
    T = constants.num_steps
    one = f32(1.0)
    rows = {n: [] for n in ("y_a", "y_b", "noise_scale")}
    for t in range(T - 1, -1, -1):
        rows["y_a"].append(c["sqrt_alphas_prod"][t] if t > 0 else one)
        rows["y_b"].append(np.sqrt(one - c["alphas_prod"][t]) if t > 0
                           else f32(0))
        rows["noise_scale"].append(
            np.exp(f32(0.5) * c["posterior_log_var"][t]) if t > 0
            else f32(0))
    rev = slice(None, None, -1)
    tables = {n: np.asarray(v, f32) for n, v in rows.items()}
    tables.update(cond=c["sqrt_alphas_prod"][rev],
                  recip=c["sqrt_recip_alphas_prod"][rev],
                  m1=c["sqrt_alphas_prod_m1"][rev],
                  mu1=c["posterior_mu1"][rev], mu2=c["posterior_mu2"][rev],
                  level=c["alphas_prod"][rev])
    if collect_steps > 0:
        tables["slot"] = _slot_table(T, collect_steps, spare)
    return tables


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
    infill content at the matching noise level. One step body for every t
    (``ddpm_tables``): one graph on the card.

    ``noise``: optional pre-drawn ``(infill_noise, step_noise)``, each
    (T, *init.shape), indexed by loop step (step i is t = T-1-i); then
    ``generator`` is not used. The JAX step splits its key into (carry,
    infill, noise) and draws the infill noise, then the step noise.
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    T = c.num_steps
    collect_steps = min(collect_steps, T)
    rows = _collect_rows(collect_steps)
    infill = _resolve_infill(init, infill_samples, infill_masks)
    start = _start(init, infill)
    flags = (infill[1] is not None, rows > 0, collect_metrics)
    bufs, metric_rows = _run(
        "DDPM", model_fn, flags,
        lambda gen: _ddpm_step(model_fn, gen, *flags), generator, start,
        ddpm_tables(c, collect_steps, rows - 1),
        _statics(start, infill, rows, False), noise, [None] * T)
    return SamplerOutput(*_outputs(bufs, metric_rows, start, rows))


def ddim_taus(num_timesteps: int, num_steps: int) -> np.ndarray:
    """DDIM's strided subset of [0, T), ascending:
    ``jnp.linspace(0, T - 1, num_steps).round()`` in JAX's float32."""
    return np.round(schedules.linspace_f32(0, num_timesteps - 1,
                                           num_steps)).astype(np.int64)


def _ddim_step(model_fn, generator, infill, collect, metrics):
    def step(s):
        x = s["x"]
        draw_noise, draw_infill = s["variant"]
        eps = model_fn(x, _cond(x, s["cond"]))
        x0 = ((x - s["sqrt_1ma"] * eps) / s["sqrt_a"]).clamp(-1.0, 1.0)
        next_state = s["sqrt_a_prev"] * x0 + s["dir_coeff"] * eps
        noise_norm = s.get("zero_norm")
        if draw_noise:
            step_noise = s["sigma"] * _draw(s, generator, 0, x)
            next_state = next_state + step_noise
            if metrics:
                noise_norm = _per_example_norm(step_noise)
        if infill:
            y = s["sqrt_a_prev"] * s["samples"] + s["y_b"] * _draw(
                s, generator, 1, x) if draw_infill else s["samples"]
            next_state = next_state * s["keep"] + y * s["masks"]
        if collect:
            _collect(s, next_state)
        out = {}
        if metrics:
            out["m"] = _metric_row(eps, x, next_state, s["level"],
                                   noise_norm)
        x.copy_(next_state)
        return out
    return step


def ddim_tables(constants: schedules.DDPMConstants, num_steps: int,
                eta: float, collect_steps=0, spare=0):
    """DDIM's per-step table in loop order (step j is i = num_steps-1-j),
    float32, and each step's variant (step noise drawn, infill noise
    drawn): ``cond`` and ``sqrt_a`` √ᾱ_i, ``sqrt_1ma`` √(1-ᾱ_i),
    ``sqrt_a_prev`` √ᾱ_{i-1}, ``dir_coeff``, ``sigma`` (eta's noise scale),
    ``y_b`` √(1-ᾱ_{i-1}), the metrics' ``level`` ᾱ_i and the collection
    ``slot``."""
    abar = constants.alphas_prod.numpy()[ddim_taus(constants.num_steps,
                                                   num_steps)]
    abar_prev = np.concatenate([np.ones(1, f32), abar[:-1]])
    one = f32(1.0)
    names = ("cond", "sqrt_1ma", "sqrt_a", "sqrt_a_prev", "dir_coeff",
             "sigma", "y_b", "level")
    rows, variants = {n: [] for n in names}, []
    for i in range(num_steps - 1, -1, -1):
        a, a_prev = abar[i], abar_prev[i]
        sqrt_a = np.sqrt(a)
        sigma = (f32(eta) * np.sqrt((one - a_prev) / (one - a)) *
                 np.sqrt(one - a / a_prev))
        values = (sqrt_a, np.sqrt(one - a), sqrt_a, np.sqrt(a_prev),
                  np.sqrt(np.maximum(one - a_prev - sigma ** 2, f32(0))),
                  sigma, np.sqrt(one - a_prev), a)
        for n, v in zip(names, values):
            rows[n].append(v)
        variants.append((bool(i > 0 and sigma != 0), i > 0))
    tables = {n: np.asarray(v, f32) for n, v in rows.items()}
    if collect_steps > 0:
        tables["slot"] = _slot_table(num_steps, collect_steps, spare)
    return tables, variants


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
    The last step draws neither noise (a variant of its own).
    ``noise``: optional pre-drawn ``(step_noise, infill_noise)``, each
    (num_steps, *init.shape), indexed by loop step (step j is i =
    num_steps-1-j). The JAX step splits its key into (carry, noise, infill)
    and draws the step noise, then the infill noise.
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    collect_steps = min(collect_steps, num_steps)
    rows = _collect_rows(collect_steps)
    infill = _resolve_infill(init, infill_samples, infill_masks)
    start = _start(init, infill)
    tables, variants = ddim_tables(c, num_steps, eta, collect_steps, rows - 1)
    if infill[1] is None:
        variants = [(v[0], False) for v in variants]
    flags = (infill[1] is not None, rows > 0, collect_metrics)
    bufs, metric_rows = _run(
        "DDIM", model_fn, flags,
        lambda gen: _ddim_step(model_fn, gen, *flags), generator, start,
        tables, _statics(start, infill, rows, collect_metrics), noise,
        variants)
    return SamplerOutput(*_outputs(bufs, metric_rows, start, rows))


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


def dpmpp_tables(constants: schedules.DDPMConstants, num_steps: int,
                 lam_max: Optional[float] = 2.5, collect_steps=0, spare=0):
    """DPM++'s per-step table in loop order (step j is k = num_steps-1-j),
    float32: ``cond`` and ``alpha`` α_k, ``sigma`` σ_k, ``alpha_next`` and
    ``sigma_next``, the second-order correction's ``corr`` 1/(2r) and
    ``corr_coeff`` α_next (e^-h - 1), both 0 on the Euler steps (the first,
    the last and h = 0), the metrics' ``level`` ᾱ_k and the collection
    ``slot``."""
    abar = constants.alphas_prod.numpy()[dpmpp_taus(
        constants.alphas_prod, num_steps, lam_max)]
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
    corr, corr_coeff = [], []
    for k in range(num_steps - 1, -1, -1):
        euler = k == num_steps - 1 or k == 0 or h_zero[k]
        corr.append(f32(0) if euler else one / (f32(2.0) * r[k]))
        corr_coeff.append(f32(0) if euler else
                          alpha_next[k] * (np.exp(-h[k]) - one))
    rev = slice(None, None, -1)
    tables = {"cond": alpha_cur[rev], "alpha": alpha_cur[rev],
              "sigma": sigma_cur[rev], "alpha_next": alpha_next[rev],
              "sigma_next": sigma_next[rev], "corr": np.asarray(corr, f32),
              "corr_coeff": np.asarray(corr_coeff, f32),
              "level": abar[rev]}
    if collect_steps > 0:
        tables["slot"] = _slot_table(num_steps, collect_steps, spare)
    return tables


def _dpmpp_step(model_fn, generator, infill, collect, metrics):
    def step(s):
        x, prev_x0 = s["x"], s["prev_x0"]
        eps = model_fn(x, _cond(x, s["cond"]))
        x0 = ((x - s["sigma"] * eps) / s["alpha"]).clamp(-1.0, 1.0)
        next_state = s["alpha_next"] * x0 + s["sigma_next"] * eps
        next_state = next_state - s["corr_coeff"] * (
            s["corr"] * (x0 - prev_x0))
        if infill:
            y = s["alpha_next"] * s["samples"] + s["sigma_next"] * _draw(
                s, generator, 0, x) if s["variant"] else s["samples"]
            next_state = next_state * s["keep"] + y * s["masks"]
        if collect:
            _collect(s, next_state)
        out = {}
        if metrics:
            out["m"] = _metric_row(eps, x, next_state, s["level"],
                                   s["zero"])
        x.copy_(next_state)
        prev_x0.copy_(x0)
        return out
    return step


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
    where duplicate taus give h == 0 (their r is replaced by 1; the table's
    correction is 0 there), the update written in the (clipped x0, raw eps)
    basis. Deterministic but for the infill forward-diffusion; the
    noise-norm metric row is zero. ``noise``: optional pre-drawn infill
    noise (num_steps, *init.shape), indexed by loop step (step j is k =
    num_steps-1-j); the JAX step splits its key into (carry, infill).
    """
    c = constants if constants is not None else \
        schedules.ddpm_constants(betas)
    collect_steps = min(collect_steps, num_steps)
    rows = _collect_rows(collect_steps)
    infill = _resolve_infill(init, infill_samples, infill_masks)
    start = _start(init, infill)
    extra = {"prev_x0": graphs.zeros(start.shape, start.dtype,
                                     start.device)}
    if collect_metrics:
        extra["zero"] = torch.zeros((), device=init.device)
    flags = (infill[1] is not None, rows > 0, collect_metrics)
    variants = [infill[1] is not None and k > 0
                for k in range(num_steps - 1, -1, -1)]
    bufs, metric_rows = _run(
        "DPM++", model_fn, flags,
        lambda gen: _dpmpp_step(model_fn, gen, *flags), generator, start,
        dpmpp_tables(c, num_steps, lam_max, collect_steps, rows - 1),
        _statics(start, infill, rows, False, extra.items()),
        None if noise is None else (noise,), variants)
    return SamplerOutput(*_outputs(bufs, metric_rows, start, rows))


def _grid_f32(grid) -> np.ndarray:
    if torch.is_tensor(grid):
        grid = grid.detach().cpu().numpy()
    return np.asarray(grid, f32)


def _distilled_step(model_fn, generator, infill, clip_x0):
    def step(s):
        x = s["x"]
        eps = model_fn(x, _cond(x, s["cond"]))
        x0 = (x - s["sigma"] * eps) / s["alpha"]
        if clip_x0:
            x0 = x0.clamp(-1.0, 1.0)
        next_state = s["alpha_next"] * x0 + s["sigma_next"] * eps
        if infill:
            y = s["alpha_next"] * s["samples"] + s["sigma_next"] * _draw(
                s, generator, 0, x) if s["variant"] else s["samples"]
            next_state = next_state * s["keep"] + y * s["masks"]
        x.copy_(next_state)
        return {}
    return step


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
    infill = _resolve_infill(init, infill_samples, infill_masks)
    start = _start(init, infill)
    tables = {"cond": alphas[:-1], "alpha": alphas[:-1],
              "sigma": sigmas[:-1], "alpha_next": alphas[1:],
              "sigma_next": sigmas[1:]}
    flags = (infill[1] is not None, bool(clip_x0))
    variants = [infill[1] is not None and i < num_steps - 1
                for i in range(num_steps)]
    bufs, _ = _run(
        "distilled DDIM", model_fn, flags,
        lambda gen: _distilled_step(model_fn, gen, *flags), generator,
        start, tables, _statics(start, infill, 0, False),
        None if noise is None else (noise,), variants)
    return SamplerOutput(bufs["x"].clone(), None, None)


def _consistency_step(model_fn, generator, infill, clip_x0):
    def step(s):
        x = s["x"]
        z = x if s["variant"] else \
            s["alpha"] * x + s["sigma"] * _draw(s, generator, 0, x)
        if infill:
            y = s["alpha"] * s["samples"] + s["sigma"] * _draw(s, generator,
                                                               1, x)
            z = z * s["keep"] + y * s["masks"]
        eps = model_fn(z, _cond(z, s["cond"]))
        next_state = (z - s["sigma"] * eps) / s["alpha"]
        if clip_x0:
            next_state = next_state.clamp(-1.0, 1.0)
        x.copy_(next_state)
        return {}
    return step


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
    ``grid[j * N // k]``, re-noising the previous step's x0 to it for j > 0
    (step 0 is a variant of its own). ``noise``: optional pre-drawn
    ``(step_noise, infill_noise)``, each (num_steps, *init.shape); the JAX
    step splits its key into (carry, noise, infill) and draws the
    re-noising noise, then the infill noise.
    """
    grid = _grid_f32(grid)
    num_seg = grid.shape[0] - 1
    if not 1 <= num_steps <= num_seg:
        raise ValueError(f"num_steps={num_steps} outside [1, {num_seg}] "
                         f"for a {num_seg}-segment consistency grid")
    levels = grid[np.arange(num_steps) * num_seg // num_steps]
    alphas, sigmas = np.sqrt(levels), np.sqrt(f32(1.0) - levels)
    infill = _resolve_infill(init, infill_samples, infill_masks)
    flags = (infill[1] is not None, bool(clip_x0))
    bufs, _ = _run(
        "consistency", model_fn, flags,
        lambda gen: _consistency_step(model_fn, gen, *flags), generator,
        init, {"cond": alphas, "alpha": alphas, "sigma": sigmas},
        _statics(init, infill, 0, False), noise,
        [j == 0 for j in range(num_steps)])
    state = bufs["x"].clone()
    if infill[1] is not None:
        state = state * infill[2] + infill[0] * infill[1]
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
