"""Training objectives (port of ``smd_tpu/diffusion/losses.py``).

``diffusion_loss``, the DDPM epsilon-MSE with continuous ᾱ conditioning,
and ``reduce_fn``. The score-matching objectives (``dsm``, ``ssm``) and the
MDN NLL belong to the NCSN family and the MDN baseline, still to port
(``ROADMAP.md`` queue A, items 8 and 9).

The objective takes the model as a plain callable ``model_fn(x, cond)``, as
the JAX one does. Its draws come from a ``torch.Generator``, or from
pre-drawn ``(labels, u, eps)`` so that a test can replay the JAX package's
``split(rng, 4)`` draws.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smd_tpu_torch.diffusion import schedules

__all__ = ["reduce_fn", "padded_alphas_prod", "diffusion_loss"]


def reduce_fn(x, mode):
    if mode == "none" or mode is None:
        return x
    if mode == "sum":
        return x.sum()
    if mode == "mean":
        return x.mean()
    raise ValueError("Unsupported reduction option.")


def padded_alphas_prod(betas) -> torch.Tensor:
    """(T+1,) float32: 1, then the cumulative product of 1 - betas in XLA's
    order (``schedules._cumprod_f32``), as ``diffusion_loss`` indexes it.
    Build it once per schedule."""
    betas = np.asarray(torch.as_tensor(betas, dtype=torch.float32).cpu())
    prod = schedules._cumprod_f32(np.float32(1.0) - betas)
    return torch.from_numpy(np.concatenate([np.ones(1, np.float32), prod]))


def diffusion_loss(batch, model_fn, betas,
                   generator: Optional[torch.Generator] = None,
                   continuous_noise: bool = False, reduction: str = "mean",
                   *, alphas_prod: Optional[torch.Tensor] = None,
                   draws: Optional[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]] = None):
    """DDPM epsilon-prediction MSE with continuous ᾱ conditioning.

    Per example: a label in [c, T + c) with c = int(continuous_noise); ᾱ
    between ``alphas_prod[label - 1]`` and ``alphas_prod[label]``; x_t =
    sqrt(ᾱ)·x + sqrt(1 - ᾱ)·ε; the model, conditioned on sqrt(ᾱ) of shape
    (B, 1, ..., 1), predicts ε. The loss is the mean square error over
    each example, reduced over the batch by ``reduction``.

    ᾱ is ``jax.random.uniform``'s arithmetic, ``max(lo, lo + u·(hi -
    lo))``, on the pair (lo, hi) = (``alphas_prod[label - 1]``,
    ``alphas_prod[label]``). The pair decreases, so hi - lo < 0 and the
    clamp returns lo: the JAX package conditions on ᾱ at the level before
    the label, not on a value between two levels. The port keeps that
    arithmetic, so the two packages train the same model
    (``ROADMAP.md`` C).

    ``alphas_prod``: ``padded_alphas_prod(betas)``, made once by the caller
    (built here when None). ``draws``: optional ``(labels, u, eps)`` with
    labels (B,) int, u (B,) in [0, 1) and eps ``batch.shape``; then
    ``generator`` is not used. Otherwise the labels, u and eps are drawn
    from ``generator`` in that order, on the batch's device.
    """
    T = betas.shape[0]
    c = int(continuous_noise)
    B = batch.shape[0]
    device = batch.device
    if alphas_prod is None:
        alphas_prod = padded_alphas_prod(betas)
    alphas_prod = alphas_prod.to(device)
    if draws is None:
        labels = torch.randint(c, T + c, (B,), generator=generator,
                               device=device)
        u = torch.rand(B, generator=generator, device=device)
        eps = torch.randn(batch.shape, generator=generator, device=device)
    else:
        labels, u, eps = (torch.as_tensor(d, device=device) for d in draws)
    lo, hi = alphas_prod[labels - 1], alphas_prod[labels]
    used = torch.maximum(lo, u * (hi - lo) + lo)
    used = used.reshape(B, *([1] * (batch.dim() - 1)))

    perturbed = torch.sqrt(used) * batch + torch.sqrt(1 - used) * eps
    pred = model_fn(perturbed, torch.sqrt(used))
    loss = (eps - pred).square()
    loss = loss.mean(dim=tuple(range(1, loss.dim())))
    return reduce_fn(loss, reduction)
