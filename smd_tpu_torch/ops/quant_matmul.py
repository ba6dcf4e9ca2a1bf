"""Fused w8a8 dense: static-scale quantize + int8 product + dequant + bias.

Port of ``smd_tpu/ops/quant_matmul.py`` (``w8a8_dense``, Pallas kernel
``_kernel``)::

    y = (clip(round(x / a_scale), -127, 127) @ w_q) * (a_scale * w_scale[j])
        + b[j]

The codes are an IEEE float32 division rounded half to even; the sum is
int32; the scale product is taken before it multiplies the sum, as in the
Pallas epilogue (``ops/quant.int8_dense`` multiplies by the two scales in
turn instead); y is stored in ``x.dtype``. The scales and the bias are read
as float32, so bf16 leaves count as their float32 values.

On a CUDA tensor the wrapper launches the kernels of
``csrc/quant_matmul.cu`` (quantize, then the int8 product on TMA + wgmma)
or raises, for shapes and dtypes it does not take too: unlike the JAX
wrapper it never falls back to ``int8_dense``. The product reads w_q
K-major, as the (N, K) copy ``transpose_weight`` makes: a caller that
serves one weight many times makes it once and passes it as ``w_t``
(``models.blocks.QuantDenseResBlock`` does); without it each call
transposes w_q first, one more launch of the transpose kernel, counted by
``transpose_weight.launches``. On a CPU tensor it takes ``_reference``, the
plain PyTorch version, whose int32 sums are exact
(``ops/quant.int8_matmul``), and ignores ``w_t``. Serving only: no
backward.
"""
from __future__ import annotations

import torch

from smd_tpu_torch.ops import _build
from smd_tpu_torch.ops.quant import int8_codes, int8_matmul

__all__ = ["w8a8_dense", "transpose_weight"]

# Rows of the codes and of w_t are read by TMA, whose row strides are
# multiples of 16 bytes; y is stored by 8-column vectors.
K_MULTIPLE, N_MULTIPLE = 16, 8


def _require_scale(a_scale):
    if a_scale is None:
        raise ValueError("w8a8_dense requires a static activation scale "
                         "(calibrate with models.fuse."
                         "calibrate_head_act_scales)")


def _reference(x, w_q, w_scale, b=None, a_scale=None):
    """Plain PyTorch version of the kernel, with the same roundings."""
    _require_scale(a_scale)
    lead, K = x.shape[:-1], x.shape[-1]
    s = torch.as_tensor(a_scale, device=x.device).float()
    acc = int8_matmul(int8_codes(x.reshape(-1, K).float(), s), w_q)
    out = acc * (s * w_scale.float())
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype).reshape(*lead, -1)


def transpose_weight(w_q):
    """w_q (K, N) int8 -> its K-major copy (N, K), which the kernel's
    product reads: the transpose kernel on a CUDA tensor, a plain copy on
    the CPU."""
    if w_q.device.type == "cpu":
        return w_q.t().contiguous()
    K, N = w_q.shape
    _build.check_cuda_args(w_q.device, w_q=(w_q, (K, N), _build.INT8))
    w_t = torch.empty((N, K), dtype=torch.int8, device=w_q.device)
    with torch.cuda.device(w_q.device):
        _build.launch("smd_int8_transpose", w_q, w_t, K, N)
    transpose_weight.launches += 1
    return w_t


transpose_weight.launches = 0


def w8a8_dense(x, w_q, w_scale, b=None, a_scale=None, *, w_t=None):
    """``x @ dequant(w_q) + b`` with a static activation scale.

    x: (..., K) float32 or bfloat16; w_q: (K, N) int8; w_scale: (N,);
    b: (N,) or None; a_scale: a number or a one-element tensor (required);
    w_t: w_q's K-major copy ``transpose_weight(w_q)`` or None (then made
    here). Returns (..., N) in x.dtype.
    """
    _require_scale(a_scale)
    if x.device.type == "cpu":
        return _reference(x, w_q, w_scale, b, a_scale)
    lead, K = x.shape[:-1], x.shape[-1]
    N = w_q.shape[-1]
    if not torch.is_tensor(a_scale):
        a_scale = torch.full((), float(a_scale), dtype=torch.float32,
                             device=x.device)
    elif a_scale.numel() == 1:
        a_scale = a_scale.reshape(())
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    _build.check_cuda_args(
        x.device,
        x=(x2, (M, K), _build.FLOATS),
        w_q=(w_q, (K, N), _build.INT8),
        w_scale=(w_scale, (N,), _build.FLOATS),
        b=(b, (N,), _build.FLOATS),
        a_scale=(a_scale, (), _build.FLOATS),
        w_t=(w_t, (N, K), _build.INT8))
    if K == 0 or K % K_MULTIPLE or N % N_MULTIPLE:
        raise ValueError(f"w8a8_dense needs K a positive multiple of "
                         f"{K_MULTIPLE} and N a multiple of {N_MULTIPLE}, "
                         f"got K={K}, N={N}")
    if w_t is None:
        w_t = transpose_weight(w_q)
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "smd_w8a8_dense",
            x2, w_t, w_scale, b, a_scale, x_q, out,
            M, K, N, _build.dtype_code(x), _build.dtype_code(w_scale),
            _build.dtype_code(b) if b is not None else 0,
            _build.dtype_code(a_scale))
    w8a8_dense.launches += 1
    return out.reshape(*lead, N)


w8a8_dense.launches = 0
