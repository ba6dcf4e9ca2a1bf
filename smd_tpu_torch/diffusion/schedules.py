"""Noise schedules and DDPM constants (port of ``smd_tpu/diffusion/schedules.py``).

Everything is computed once on the host with numpy in float32 and returned as
float32 tensors on the CPU; the samplers stage the per-step constants as one
float32 table a call, which a step reads through a device index.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "noise_schedule",
    "DDPMConstants",
    "ddpm_constants",
    "linspace_f32",
    "half_log_snr",
]


def noise_schedule(sigma_begin: float = 1.0,
                   sigma_end: float = 1e-2,
                   num: int = 10,
                   kind: str = "geometric") -> torch.Tensor:
    """Create a 1-D noise schedule of shape ``(num,)``, float32.

    ``kind``: ``geometric`` (log-space linspace), ``linear``, ``fibonacci``
    or ``cosine`` (Nichol & Dhariwal 2021 betas; ``cosine`` ignores both
    ends, ``fibonacci`` ignores ``sigma_end``).
    """
    if kind == "geometric":
        sig = np.exp(np.linspace(np.log(sigma_begin), np.log(sigma_end), num))
    elif kind == "linear":
        sig = np.linspace(sigma_begin, sigma_end, num)
    elif kind == "cosine":
        s = 0.008
        t = np.arange(num + 1) / num
        abar = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
        sig = np.clip(1.0 - abar[1:] / abar[:-1], 0.0, 0.999)
    elif kind == "fibonacci":
        vals = [1e-6, 2e-6]
        for _ in range(num - 2):
            vals.append(vals[-1] + vals[-2])
        sig = np.asarray(vals)
    else:
        raise ValueError(f"Unsupported schedule: {kind}")
    return torch.from_numpy(np.asarray(sig, dtype=np.float32))


@dataclasses.dataclass(frozen=True)
class DDPMConstants:
    """Forward/reverse-process constants for a beta schedule, each ``(T,)``."""
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_prod: torch.Tensor             # cumprod of alphas
    alphas_prod_prev: torch.Tensor        # shifted, alphas_prod_prev[0] = 1
    sqrt_alphas_prod: torch.Tensor
    sqrt_recip_alphas_prod: torch.Tensor  # 1/sqrt(alpha_prod)
    sqrt_alphas_prod_m1: torch.Tensor     # sqrt(1-a_prod)/sqrt(a_prod)
    posterior_mu1: torch.Tensor           # beta*sqrt(a_prod_prev)/(1-a_prod)
    posterior_mu2: torch.Tensor           # (1-a_prod_prev)*sqrt(alpha)/(1-a_prod)
    posterior_log_var: torch.Tensor       # log of clipped posterior variance

    @property
    def num_steps(self) -> int:
        return int(self.betas.shape[0])


def _cumprod_f32(a: np.ndarray) -> np.ndarray:
    """float32 inclusive cumulative product, associated as XLA does it.

    XLA rewrites a long cumulative reduction into scans over blocks of 16,
    recursively over the block totals. The late alphas_prod differ by ~1e-6
    relative between that order and a sequential product, and 1 - alphas_prod
    turns that into 5e-5 in posterior_mu1; taking XLA's order keeps the
    constants bit-equal to the JAX package's.
    """
    base = 16
    n = a.shape[0]
    if n <= base:
        return np.cumprod(a, dtype=np.float32)
    blocks = -(-n // base)
    padded = np.concatenate([a, np.ones(blocks * base - n, np.float32)])
    inner = np.cumprod(padded.reshape(blocks, base), axis=1, dtype=np.float32)
    totals = _cumprod_f32(np.ascontiguousarray(inner[:, -1]))
    before = np.concatenate([np.ones(1, np.float32), totals[:-1]])
    return (before[:, None] * inner).reshape(-1)[:n]


def ddpm_constants(betas) -> DDPMConstants:
    """Precompute every constant the DDPM ancestral sampler needs."""
    betas = np.asarray(torch.as_tensor(betas, dtype=torch.float32).cpu())
    one = np.float32(1.0)
    alphas = one - betas
    alphas_prod = _cumprod_f32(alphas)
    alphas_prod_prev = np.concatenate([np.ones(1, np.float32),
                                       alphas_prod[:-1]])
    posterior_var = betas * (one - alphas_prod_prev) / (one - alphas_prod)
    posterior_var = np.maximum(posterior_var, np.float32(1e-20))
    fields = dict(
        betas=betas,
        alphas=alphas,
        alphas_prod=alphas_prod,
        alphas_prod_prev=alphas_prod_prev,
        sqrt_alphas_prod=np.sqrt(alphas_prod),
        sqrt_recip_alphas_prod=np.sqrt(one / alphas_prod),
        sqrt_alphas_prod_m1=np.sqrt(one - alphas_prod) *
        np.sqrt(one / alphas_prod),
        posterior_mu1=betas * np.sqrt(alphas_prod_prev) / (one - alphas_prod),
        posterior_mu2=(one - alphas_prod_prev) * np.sqrt(alphas) /
        (one - alphas_prod),
        posterior_log_var=np.log(posterior_var),
    )
    return DDPMConstants(**{k: torch.from_numpy(
        np.ascontiguousarray(v, dtype=np.float32)) for k, v in fields.items()})


def linspace_f32(start, stop, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32, as XLA computes it.

    JAX evaluates ``start*(1 - i/d) + stop*(i/d)`` (d = num - 1) and XLA
    rewrites the divisions into products by r = float32(1/d), folds
    ``stop*r`` into one constant and fuses the last product into the sum:
    ``fma(i, stop*r, start*(1 - i*r))``, then appends ``stop``. numpy's and
    torch's linspace round otherwise: ``jnp.linspace(0, 999, 31)[5]`` is
    166.50002 here and 166.5 there, and the DDIM step rounds it to 167, not
    166. The sum is taken in float64 and rounded once to float32, which is
    the fused sum unless it lands exactly on a float32 midpoint.
    """
    f32 = np.float32
    start, stop = f32(start), f32(stop)
    if num <= 1:
        return np.full((max(num, 0),), start, f32)
    div = num - 1
    r = f32(f32(1) / f32(div))
    i = np.arange(div, dtype=f32)
    head = start * (f32(1) - i * r)
    out = head.astype(np.float64) + i.astype(np.float64) * np.float64(
        f32(stop * r))
    return np.concatenate([out.astype(f32), np.full((1,), stop, f32)])


def half_log_snr(alphas_prod) -> np.ndarray:
    """lambda = 0.5 * (log(abar) - log1p(-abar)) in float32, the JAX
    package's arithmetic (float64 would pick other grid points)."""
    ab = np.asarray(torch.as_tensor(alphas_prod, dtype=torch.float32).cpu())
    return (np.float32(0.5) * (np.log(ab) - np.log1p(-ab))).astype(np.float32)
