"""int8 w8a8 dense ops of the serving head (port of ``smd_tpu/ops/quant.py``).

Scheme (symmetric post-training quantization, as the JAX package has it):

- weights: per output channel, ``w_q[:, j] = clip(round(w[:, j] / s_j),
  -127, 127)`` with ``s_j = max(max|w[:, j]| / 127, 1e-12)`` in float32 and
  round half to even;
- activations: a static scalar scale (calibrated with
  ``models.fuse.calibrate_head_act_scales``) or a dynamic per-row one;
- the int8 x int8 product sums in int32, dequantized as
  ``acc * s_row * s_col (+ b)`` in float32, associated left to right.

``int8_dense`` is plain PyTorch, the counterpart of the JAX package's XLA
int8 path; the hand-written kernel is ``ops/quant_matmul.w8a8_dense``.
The int32 sums are exact on every device: the int8 codes are multiplied in
float64, where every partial sum of K products of at most 127**2 is an
integer below 2**53 (K <= 2**38), so no rounding occurs.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_weight", "int8_codes", "int8_matmul", "int8_dense"]


def _div127(t: torch.Tensor) -> torch.Tensor:
    # A true float32 division: on a CUDA tensor, dividing by a Python number
    # multiplies by its float32 reciprocal instead, which can differ by an ulp.
    return t / torch.full_like(t, 127.0)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a (K, N) kernel.

    Returns ``(w_q int8 (K, N), scale float32 (N,))`` with
    ``w ~= w_q * scale[None, :]``.
    """
    w = w.float()
    scale = _div127(w.abs().amax(dim=0)).clamp_min(1e-12)
    return int8_codes(w, scale[None, :]), scale


def int8_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round_half_even(x / scale), -127, 127)`` as int8; float32 in."""
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of ``x_q @ w_q`` (int8 codes), as float32.

    Each sum is exact in float64 and rounded once to float32, as an int32
    accumulator converted to float32 is.
    """
    return torch.matmul(x_q.double(), w_q.double()).float()


def int8_dense(x, w_q, w_scale, b=None, a_scale=None):
    """``x @ dequant(w_q) (+ b)`` through an int8 product.

    x: (..., K) float; w_q: (K, N) int8; w_scale: (N,); b: (N,) or None;
    a_scale: a scalar static activation scale (number or tensor), or None
    for a dynamic per-row scale. Returns (..., N) float32.
    """
    lead = x.shape[:-1]
    K = x.shape[-1]
    xf = x.reshape(-1, K).float()
    if a_scale is None:
        s_row = _div127(xf.abs().amax(dim=1, keepdim=True)).clamp_min(1e-12)
    else:
        s_row = torch.as_tensor(a_scale, device=x.device).float()
    acc = int8_matmul(int8_codes(xf, s_row), w_q)
    out = acc * s_row * w_scale.float()[None, :]
    if b is not None:
        out = out + b.float()
    return out.reshape(*lead, -1)
