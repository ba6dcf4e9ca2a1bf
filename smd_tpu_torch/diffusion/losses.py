"""Training objectives (port of ``smd_tpu/diffusion/losses.py``).

``diffusion_loss``, the DDPM epsilon-MSE with continuous ᾱ conditioning;
the NCSN family's denoising and sliced score matching
(``denoising_score_matching_loss``, ``sliced_score_matching_loss``); the
small losses (``mean_squared_error``, ``series_loss``,
``binary_cross_entropy_with_logits``, ``sigmoid_cross_entropy``,
``kl_divergence_std_normal``) and ``reduce_fn``; the mixture NLLs of the
MDN baseline (``mdn_nll``, ``gaussian_mixture_loss``), each a log-softmax
and a logsumexp over the components.

An objective takes the model as a plain callable ``model_fn(x, cond)``, as
the JAX one does. Its draws come from a ``torch.Generator``, or from
pre-drawn ``draws`` so that a test can replay the JAX package's splits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smd_tpu_torch.diffusion import schedules

__all__ = ["reduce_fn", "padded_alphas_prod", "diffusion_draws",
           "score_draws", "draws_for", "diffusion_loss",
           "denoising_score_matching_loss", "sliced_score_matching_loss",
           "gaussian_mixture_loss", "mdn_nll",
           "mean_squared_error", "series_loss",
           "binary_cross_entropy_with_logits", "sigmoid_cross_entropy",
           "kl_divergence_std_normal"]


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


def diffusion_draws(shape, num_levels: int, continuous_noise: bool,
                    generator, device):
    """``diffusion_loss``'s draws for a batch of ``shape``, from
    ``generator`` in this order: labels (B,) in [c, T + c) with c =
    int(continuous_noise), u (B,) in [0, 1), eps of ``shape``."""
    B, c = shape[0], int(continuous_noise)
    labels = torch.randint(c, num_levels + c, (B,), generator=generator,
                           device=device)
    u = torch.rand(B, generator=generator, device=device)
    eps = torch.randn(shape, generator=generator, device=device)
    return labels, u, eps


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
    B = batch.shape[0]
    device = batch.device
    if alphas_prod is None:
        alphas_prod = padded_alphas_prod(betas)
    alphas_prod = alphas_prod.to(device)
    if draws is None:
        labels, u, eps = diffusion_draws(batch.shape, T, continuous_noise,
                                         generator, device)
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


def _sample_sigmas(sigmas, batch, continuous_noise, labels, u):
    """Per-example noise levels, (B, 1, ..., 1).

    Discrete: sigma[label] with label in [0, L). Continuous: label in
    [1, L), then ``jax.random.uniform(minval=sigma[label-1],
    maxval=sigma[label])``'s arithmetic, ``max(lo, lo + u·(hi - lo))``.
    The schedule decreases, so hi - lo < 0 and the clamp returns lo:
    continuous noise conditions on the level before the label, as
    ``diffusion_loss`` does (``ROADMAP.md`` C.4).
    """
    if continuous_noise:
        lo, hi = sigmas[labels - 1], sigmas[labels]
        used = torch.maximum(lo, u * (hi - lo) + lo)
    else:
        used = sigmas[labels]
    return used.reshape(batch.shape[0], *([1] * (batch.dim() - 1)))


def score_draws(shape, num_levels: int, continuous_noise: bool, generator,
                device, probes: bool = False, dtype=torch.float32):
    """The score-matching objectives' draws for a batch of ``shape``, from
    ``generator`` in this order: labels (B,) in [c, L) with c =
    int(continuous_noise), u (B,) for continuous noise (else None), eps of
    ``shape``, and for SSM (``probes``) the Rademacher probes of
    ``shape`` in ``dtype``."""
    B, c = shape[0], int(continuous_noise)
    labels = torch.randint(c, num_levels, (B,), generator=generator,
                           device=device)
    u = torch.rand(B, generator=generator, device=device) if c else None
    eps = torch.randn(shape, generator=generator, device=device)
    if not probes:
        return labels, u, eps
    vectors = torch.randint(0, 2, shape, generator=generator,
                            device=device).to(dtype) * 2 - 1
    return labels, u, eps, vectors


def draws_for(objective, shape, sigmas, generator, continuous_noise: bool,
              device, dtype=torch.float32):
    """What ``objective`` draws from ``generator`` for a batch of ``shape``,
    drawn as it draws it: pass them back through its ``draws=``. A data
    axis draws the global batch's and keeps each rank's rows, so that the
    ranks together draw what one rank draws for the whole batch."""
    levels = len(sigmas)
    if objective is diffusion_loss:
        return diffusion_draws(shape, levels, continuous_noise, generator,
                               device)
    return score_draws(shape, levels, continuous_noise, generator, device,
                       probes=objective is sliced_score_matching_loss,
                       dtype=dtype)


def _score_draws(sigmas, batch, generator, continuous_noise, draws,
                 probes: bool):
    """(labels, u, eps[, vectors]) on the batch's device: ``draws`` as
    given, or from ``generator`` (``score_draws``)."""
    device = batch.device
    if draws is not None:
        return tuple(None if d is None else torch.as_tensor(d, device=device)
                     for d in draws)
    return score_draws(batch.shape, sigmas.shape[0], continuous_noise,
                       generator, device, probes, batch.dtype)


def denoising_score_matching_loss(batch, model_fn, sigmas,
                                  generator: Optional[torch.Generator] = None,
                                  continuous_noise: bool = False,
                                  reduction: str = "mean", *,
                                  draws=None):
    """DSM for NCSNs: 0.5 ||s(x + σε, σ) + ε/σ||² σ² per example.

    ``draws``: optional ``(labels, u, eps)``, the JAX package's (label,
    uniform, normal) draws of ``split(rng)`` then ``split`` of the first
    half (u ignored, may be None, for discrete noise); then ``generator``
    is not used.
    """
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32).to(batch.device)
    labels, u, eps = _score_draws(sigmas, batch, generator,
                                  continuous_noise, draws, probes=False)
    used = _sample_sigmas(sigmas, batch, continuous_noise, labels, u)
    noise = eps * used
    target = -1.0 / (used ** 2) * noise
    scores = model_fn(batch + noise, used)
    B = batch.shape[0]
    loss = 0.5 * (scores.reshape(B, -1) - target.reshape(B, -1)) \
        .square().sum(-1)
    return reduce_fn(loss * used.reshape(B) ** 2, reduction)


def sliced_score_matching_loss(batch, model_fn, sigmas,
                               generator: Optional[torch.Generator] = None,
                               continuous_noise: bool = False,
                               reduction: str = "mean", *, draws=None):
    """Sliced score matching with Rademacher probes v:
    (0.5 ||s||² + v·(∂(s·v)/∂x)) σ² per example.

    The vector-Jacobian product is ``torch.autograd.grad`` with
    ``create_graph=True``, so a training step differentiates through it (a
    double backward). ``draws``: optional ``(labels, u, eps, vectors)``,
    the JAX package's draws of ``split(rng, 3)``.
    """
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32).to(batch.device)
    labels, u, eps, vectors = _score_draws(sigmas, batch, generator,
                                           continuous_noise, draws,
                                           probes=True)
    used = _sample_sigmas(sigmas, batch, continuous_noise, labels, u)
    perturbed = (batch + eps * used).detach().requires_grad_(True)
    # Outside a gradient (an eval step) the product is taken and dropped.
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        first_grad = model_fn(perturbed, used)
        second_grad, = torch.autograd.grad(
            (first_grad * vectors).sum(), perturbed,
            create_graph=create_graph)
    if not create_graph:
        first_grad = first_grad.detach()
    B = batch.shape[0]
    score_loss = 0.5 * first_grad.reshape(B, -1).square().sum(-1)
    hessian_loss = (vectors * second_grad).reshape(B, -1).sum(-1)
    return reduce_fn((score_loss + hessian_loss) * used.reshape(B) ** 2,
                     reduction)


# log(sqrt(2*pi)) in float32, as the JAX package computes it.
_LOG_SQRT_2PI = float(np.log(np.sqrt(np.float32(2.0 * np.pi))))


def _log_gaussian_pdf(y, mu, log_sigma):
    return -0.5 * ((y - mu) / torch.exp(log_sigma)).square() - log_sigma - \
        _LOG_SQRT_2PI


def gaussian_mixture_loss(log_pi, mu, log_sigma, data, reduction="mean"):
    """NLL of data under a diagonal Gaussian mixture (toy MDN head).

    Shapes: log_pi (B, K); mu, log_sigma (B, K, D); data (B, D).
    """
    loglik = _log_gaussian_pdf(data[:, None, :], mu, log_sigma).sum(dim=2)
    loss = torch.logsumexp(log_pi + loglik, dim=1)
    return -reduce_fn(loss, reduction)


def mdn_nll(pi, mu, log_sigma, x, reduction="mean"):
    """Sequence MDN negative log-likelihood: per position, -logsumexp over
    the K components of log_softmax(pi) plus the diagonal Gaussian's log
    density of x.

    Shapes: pi (..., K); mu, log_sigma (..., K*D); x (..., D). With
    ``reduction="none"`` the result is flat, one value per position.
    """
    channels = x.shape[-1]
    k = pi.shape[-1]
    log_mix = torch.log_softmax(pi.reshape(-1, k), dim=-1)       # (N, K)
    comp_ll = _log_gaussian_pdf(
        x.reshape(-1, 1, channels), mu.reshape(-1, k, channels),
        log_sigma.reshape(-1, k, channels)).sum(-1)              # (N, K)
    ll = torch.logsumexp(log_mix + comp_ll, dim=-1)
    return reduce_fn(-ll, reduction)


def mean_squared_error(logits, labels, reduction="mean"):
    loss = (logits - labels).square().mean(dim=1)
    return reduce_fn(loss, reduction)


def series_loss(context, true_target, pred_target, reduction="mean"):
    """Self-similarity + MSE loss over a sequence context."""
    ss = context @ true_target.T
    ss_hat = context @ pred_target.T
    loss = (mean_squared_error(ss.T, ss_hat.T) +
            mean_squared_error(true_target, pred_target))
    return reduce_fn(loss, reduction)


def binary_cross_entropy_with_logits(logits, labels):
    F = torch.nn.functional
    return labels * F.softplus(-logits) + (1 - labels) * F.softplus(logits)


def sigmoid_cross_entropy(logits, labels, reduction="sum"):
    F = torch.nn.functional
    loss = -labels * F.logsigmoid(logits) - \
        (1.0 - labels) * F.logsigmoid(-logits)
    return reduce_fn(loss, reduction)


def kl_divergence_std_normal(mu, var):
    return 0.5 * (mu.square() + var - 1 - torch.log(var)).sum()
