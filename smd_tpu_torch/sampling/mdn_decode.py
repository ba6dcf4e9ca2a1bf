"""Autoregressive MDN decoding (port of ``smd_tpu/sampling/mdn_decode.py``).

``ar_decode`` keeps the reference's decode semantics, its final step
included: each step runs the model over the whole token buffer (no
teacher-forcing shift; slot 0 is the zero start token), and for steps
i < S-1 the sample at position i is written into slot i+1; the last step
replaces the whole buffer with the per-position samples, which removes the
start token. ``ar_decode_cached`` is clean ancestral sampling over a
``KVCache``, one position a model call. The JAX package runs each decode as
one ``lax.scan``; here each is one step body that reads its position through
the chain's device index and writes the token buffer (or the KV cache and
the output) in place, captured in a CUDA graph on the card and replayed
once a position (``utils/graphs.py``), run eagerly on the CPU; the draws
come from a ``torch.Generator``. ``ar_decode``'s final step, which replaces
the whole buffer, is a call of its own. A second call with the same model
(function), sizes and options replays the first call's graph.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from smd_tpu_torch.device import resolve_device
from smd_tpu_torch.models.attention import KVCache
from smd_tpu_torch.utils import graphs

__all__ = ["sample_mixture", "ar_decode", "ar_decode_cached"]


def sample_mixture(generator: Optional[torch.Generator], pi, mu, log_sigma,
                   channels: int, log_sigma_cap=None) -> torch.Tensor:
    """Sample from an MDN head output.

    Shapes: pi (..., K); mu, log_sigma (..., K*channels). Returns (...,
    channels): a component drawn from the categorical over the ``pi``
    logits (Gumbel-max, as ``jax.random.categorical`` draws it), then a
    diagonal normal around its mean.

    ``log_sigma_cap`` clamps each component's log stddev from above before
    sampling: a serving-side guard against the huge-variance components the
    NLL never bounds, which detonate free-running decode; components below
    the cap are untouched. None leaves log_sigma as it is.
    """
    k = pi.shape[-1]
    lead = pi.shape[:-1]
    u = torch.rand(pi.shape, generator=generator, device=pi.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    comp = torch.argmax(pi.float() + gumbel, dim=-1)
    if log_sigma_cap is not None:
        log_sigma = log_sigma.clamp(max=log_sigma_cap)
    index = comp[..., None, None].expand(*lead, 1, channels)
    mu_sel = mu.reshape(*lead, k, channels).gather(-2, index).squeeze(-2)
    sig_sel = torch.exp(log_sigma.reshape(*lead, k, channels)
                        .gather(-2, index).squeeze(-2))
    eps = torch.randn(mu_sel.shape, generator=generator, device=pi.device,
                      dtype=mu_sel.dtype)
    return mu_sel + sig_sel * eps


def _full_step(model_fn, generator, channels, log_sigma_cap):
    def step(s):
        tokens, i = s["tokens"], s["step"]
        pi, mu, log_sigma = (o.index_select(1, i)[:, 0]
                             for o in model_fn(tokens))
        z = sample_mixture(generator, pi, mu, log_sigma, channels,
                           log_sigma_cap)
        tokens.index_copy_(1, i + 1, z.unsqueeze(1).to(tokens.dtype))
        return {}
    return step


@torch.no_grad()
def ar_decode(generator: Optional[torch.Generator],
              model_fn: Callable,
              num_samples: int,
              steps: int = 32,
              channels: int = 42,
              log_sigma_cap=None,
              device=None) -> torch.Tensor:
    """Generate (N, S, D) sequences by ancestral MDN decoding, one full
    forward a step.

    ``model_fn``: ``tokens -> (pi, mu, log_sigma)`` applied WITHOUT the
    teacher-forcing shift (the zero start token is explicit here).
    ``device`` is ``cuda`` unless the caller passes ``"cpu"``. Steps
    0..S-2 write slot i+1 through the captured step; the last step, which
    samples every position, is one call after them.
    """
    device = resolve_device(device)
    tokens = graphs.zeros((num_samples, steps, channels), device=device)
    if steps > 1:
        run = graphs.chain(
            "ar_decode", model_fn, (channels, log_sigma_cap), device,
            lambda gen: _full_step(model_fn, gen, channels, log_sigma_cap))
        bufs, _ = run(generator, {}, {}, {"tokens": tokens},
                      [None] * (steps - 1))
        tokens = bufs["tokens"].clone()
    else:
        tokens = tokens.contiguous()
    return sample_mixture(generator, *model_fn(tokens), channels,
                          log_sigma_cap)


def _cached_step(model, generator, channels, log_sigma_cap, layers):
    def step(s):
        i, token = s["step"], s["token"]
        cache = KVCache(tuple(s[f"keys{j}"] for j in range(layers)),
                        tuple(s[f"values{j}"] for j in range(layers)), i)
        (pi, mu, log_sigma), _ = model.decode(token, cache)
        z = sample_mixture(generator, pi[:, 0], mu[:, 0], log_sigma[:, 0],
                           channels, log_sigma_cap)
        s["out"].index_copy_(1, i, z.unsqueeze(1))
        token.copy_(z.unsqueeze(1))
        return {}
    return step


@torch.no_grad()
def ar_decode_cached(generator: Optional[torch.Generator],
                     model,
                     num_samples: int,
                     steps: int = 32,
                     channels: int = 42,
                     log_sigma_cap=None) -> torch.Tensor:
    """Ancestral MDN decoding with a KV cache: each step feeds one position
    through ``model`` (a TransformerMDN, standard layout) over the keys and
    values cached so far. Clean ancestral sampling y_t ~ p(.|y_<t), without
    ``ar_decode``'s final-step resample. Runs on the model's device;
    returns (N, S, D) float32. The cache's index is the chain's device
    index, so the capacity is checked here, on the step count.
    """
    max_len = model.max_decode_length
    if steps > max_len:
        raise ValueError(
            f"steps={steps} exceeds the model's KV-cache capacity "
            f"max_decode_length={max_len}; construct the model with "
            f"max_decode_length>={steps} (decoding past the cache would "
            f"silently attend over truncated history)")
    device = next(model.parameters()).device
    statics = {"token": graphs.zeros((num_samples, 1, channels),
                                     device=device),
               "out": graphs.zeros((num_samples, steps, channels),
                                   device=device)}
    spec = model.TransformerEncoder_0.cache_spec(num_samples)
    for j, (shape, dtype, _) in enumerate(spec):
        statics[f"keys{j}"] = graphs.zeros(shape, dtype, device)
        statics[f"values{j}"] = graphs.zeros(shape, dtype, device)
    layers = len(spec)
    run = graphs.chain(
        "ar_decode_cached", model, (channels, log_sigma_cap), device,
        lambda gen: _cached_step(model, gen, channels, log_sigma_cap,
                                 layers))
    bufs, _ = run(generator, {}, {}, statics, [None] * steps)
    return bufs["out"].clone()
