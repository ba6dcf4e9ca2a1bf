"""Fused FiLM-resblock half: LN + FiLM affine + swish + Dense (+ residual).

Port of ``smd_tpu/ops/fused_film_resblock.py`` (``fused_ln_film_swish_dense``,
Pallas body ``_ln_film_swish_dense_body``)::

    y = swish(LN(x) * scale + shift) @ W + b  [+ residual]

LN has no learned affine (``FusedDenseResBlock`` folds it into scale and
shift) and eps 1e-6; the prologue runs in float32; ``h`` is rounded to W's
dtype before the product, which sums in float32; bias and residual are added
in float32 and the result is stored in ``x.dtype``.

On a CUDA tensor the wrapper launches the CUDA kernel of
``csrc/fused_film_resblock.cu`` (a pass that takes the row statistics and,
for a bf16 W, writes the prologue's bf16 h once; then the product on the
tensor cores with the bias and residual epilogue) or raises; on a CPU
tensor it takes
``_reference``, the plain PyTorch version. Where a gradient is needed the
call is a ``torch.autograd.Function`` whose backward differentiates
``_reference`` at the saved inputs, as the JAX ``custom_vjp`` does; a call
that needs none (serving) takes no autograd node.
"""
from __future__ import annotations

import torch

from smd_tpu_torch.ops import _build

__all__ = ["fused_ln_film_swish_dense"]


def _reference(x, scale, shift, w, b, residual=None):
    """Plain PyTorch transcription of the JAX ``_reference``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + 1e-6)
    h = h * scale.float() + shift.float()
    h = h * torch.sigmoid(h)
    # bf16 operands, float32 sum: the operands are rounded to W's dtype and
    # multiplied in float32, which keeps the sum unrounded.
    out = torch.matmul(h.to(w.dtype).float(), w.float())
    out = out + b.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def _launch(x, scale, shift, w, b, residual):
    """Check what the CUDA kernel takes, launch it and count the launch."""
    B, S, K = x.shape
    N = w.shape[1]
    _build.check_cuda_args(
        x.device,
        x=(x, (B, S, K), _build.FLOATS),
        scale=(scale, (B, 1, K), (torch.float32,)),
        shift=(shift, (B, 1, K), (torch.float32,)),
        w=(w, (K, N), _build.FLOATS),
        b=(b, (N,), _build.FLOATS),
        residual=(residual, (B, S, N), (x.dtype,)))
    if K % 8 or N % 8:
        raise ValueError(f"fused_ln_film_swish_dense needs K and N to be "
                         f"multiples of 8, got K={K}, N={N}")
    out = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    # Each row's LN (mean, 1/std), computed once per call by the kernel,
    # and for a bf16 W the prologue's output h in bf16, the product's A.
    stats = torch.empty((B * S, 2), dtype=torch.float32, device=x.device)
    h = (torch.empty((B * S, K), dtype=torch.bfloat16, device=x.device)
         if w.dtype == torch.bfloat16 else None)
    with torch.cuda.device(x.device):
        _build.launch(
            "smd_fused_ln_film_swish_dense",
            x, scale, shift, w, b, residual, out, stats, h,
            B, S, K, N,
            _build.dtype_code(x), _build.dtype_code(w), _build.dtype_code(b))
    fused_ln_film_swish_dense.launches += 1
    return out


def _forward(x, scale, shift, w, b, residual):
    if x.device.type == "cpu":
        return _reference(x, scale, shift, w, b, residual)
    return _launch(x, scale, shift, w, b, residual)


class _FusedLnFilmSwishDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, w, b, residual):
        ctx.save_for_backward(x, scale, shift, w, b, residual)
        return _forward(x, scale, shift, w, b, residual)

    @staticmethod
    def backward(ctx, g):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = _reference(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in inputs)


def fused_ln_film_swish_dense(x, scale, shift, w, b, residual=None):
    """y = swish(LN(x) * scale + shift) @ w + b [+ residual].

    Shapes: x (B, S, K); scale/shift (B, 1, K) float32; w (K, N); b (N,);
    residual (B, S, N) in x.dtype, or None. Returns (B, S, N) in x.dtype.
    Where no gradient is needed (serving), the call skips the autograd
    node.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, scale, shift, w, b, residual)):
        return _FusedLnFilmSwishDense.apply(x, scale, shift, w, b, residual)
    return _forward(x, scale, shift, w, b, residual)


fused_ln_film_swish_dense.launches = 0
