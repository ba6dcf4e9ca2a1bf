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

On a CUDA tensor the wrapper launches the kernel of ``csrc/quant_matmul.cu``
(quantize, weight transpose, int8 tensor-core product) or raises, for shapes
and dtypes it does not take too: unlike the JAX wrapper it never falls back
to ``int8_dense``. On a CPU tensor it takes ``_reference``, the plain
PyTorch version, whose int32 sums are exact (``ops/quant.int8_matmul``).
Serving only: no backward.
"""
from __future__ import annotations

import torch

from smd_tpu_torch.ops import _build
from smd_tpu_torch.ops.quant import int8_codes, int8_matmul

__all__ = ["w8a8_dense"]

# The kernel's K step is 16 bytes of int8 codes; it stores two columns of y
# at a time and transposes w_q in tiles of 8.
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


def w8a8_dense(x, w_q, w_scale, b=None, a_scale=None):
    """``x @ dequant(w_q) + b`` with a static activation scale.

    x: (..., K) float32 or bfloat16; w_q: (K, N) int8; w_scale: (N,);
    b: (N,) or None; a_scale: a number or a one-element tensor (required).
    Returns (..., N) in x.dtype.
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
        a_scale=(a_scale, (), _build.FLOATS))
    if K == 0 or K % K_MULTIPLE or N % N_MULTIPLE:
        raise ValueError(f"w8a8_dense needs K a positive multiple of "
                         f"{K_MULTIPLE} and N a multiple of {N_MULTIPLE}, "
                         f"got K={K}, N={N}")
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    w_t = torch.empty((N, K), dtype=torch.int8, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "smd_w8a8_dense",
            x2, w_q, w_scale, b, a_scale, x_q, w_t, out,
            M, K, N, _build.dtype_code(x), _build.dtype_code(w_scale),
            _build.dtype_code(b) if b is not None else 0,
            _build.dtype_code(a_scale))
    w8a8_dense.launches += 1
    return out.reshape(*lead, N)


w8a8_dense.launches = 0
