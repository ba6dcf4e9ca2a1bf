"""Fused short-sequence attention block: LN + QKV + softmax(QK^T/sqrt(Dh))V + out.

Port of ``smd_tpu/ops/fused_attention.py`` (``fused_ln_attention``, Pallas
kernel ``_kernel``): learned-affine LayerNorm (eps 1e-6) -> (S,E)@(E,3E)+b ->
per head softmax(QK^T/sqrt(Dh))V, optionally causal -> (S,E)@(E,E)+b, all in
float32 with the weights cast up, stored in ``x.dtype``. The Pallas kernel's
block-diagonal packing of NB items into one tile is a TPU tiling device and
not part of the function.

On a CUDA tensor the wrapper launches one of the two CUDA kernels of
``csrc/fused_attention.cu`` or raises; on a CPU tensor it takes
``_reference``, the plain PyTorch version. Where a gradient is needed the
call is a ``torch.autograd.Function`` whose backward differentiates
``_reference`` at the saved inputs, as the JAX ``custom_vjp`` does; a call
that needs none (serving) takes no autograd node.

Routing between the two kernels (``tensor_core_route``): bf16 x with bf16
weights, E a multiple of 16 up to 128 and S up to 64 (the sampler's
shapes, B=1000, S=32, E=128, H=8) take ``ln_attention_tc_kernel``: several
items a block on the bf16 tensor cores, LN rows, q, k, v, p and o rounded
to bf16 on the way. Every other case (float32 x, float32 weights, E past
128 or not a multiple of 16, S past 64) takes ``ln_attention_kernel``, the
first version, all float32. ``fused_ln_attention.launches`` counts both;
``fused_ln_attention.tc_launches`` the tensor-core kernel's alone.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from smd_tpu_torch.ops import _build

__all__ = ["fused_ln_attention", "tc_ulp_stats"]

# Head widths the kernels are instantiated for (their per-thread registers).
HEAD_DIMS = (8, 16, 32, 64)
# Dynamic shared memory one block may use on Hopper.
MAX_SHARED_BYTES = 232448
# The tensor-core kernel: both weights in shared memory, an item's keys in
# a warp's registers.
TC_MAX_E, TC_MAX_S = 128, 64


def tensor_core_route(x_dtype, w_dtype, S: int, E: int) -> bool:
    """Whether a call takes the bf16 tensor-core kernel (else the float32
    first version)."""
    return (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and E % 16 == 0 and E <= TC_MAX_E and S <= TC_MAX_S)


def _shared_bytes(S: int, E: int) -> int:
    """The first version's shared memory: LN/attention rows and qkv rows,
    float32."""
    return 4 * S * ((E + 1) + (3 * E + 1))


def _reference(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias, num_heads,
               causal=False):
    """Plain PyTorch transcription of the JAX ``_reference``."""
    B, S, E = x.shape
    Dh = E // num_heads
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    ln = (xf - mean) * torch.rsqrt(var + 1e-6) * ln_scale.float() + \
        ln_bias.float()
    qkv = ln @ wqkv.float() + bqkv.float()
    q, k, v = qkv.split(E, dim=-1)
    q = q.reshape(B, S, num_heads, Dh) / (Dh ** 0.5)
    k = k.reshape(B, S, num_heads, Dh)
    v = v.reshape(B, S, num_heads, Dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, E)
    return (o @ wout.float() + bout.float()).to(x.dtype)


_LOG2E = 1.4426950408889634


def _tc_emulation(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias, num_heads,
                  causal=False):
    """Plain-PyTorch emulation of the tensor-core kernel's bf16 arithmetic
    (``ln_attention_tc_kernel``; bf16 x and weights).

    LN in float32, rounded to bf16; q, k, v = bf16(ln @ wqkv + bqkv) with
    the products exact and the sums in float32 (in this device's order, not
    the tensor cores'); scores q.k in float32; p = exp2(fma(s, c, -m2))
    with c = log2(e)/sqrt(Dh) and m2 = c * the row's max, one rounding; l
    sums the float32 p; p rounded once to bf16 for p.v; o = bf16(p.v / l);
    y = o @ wout + bout in float32, stored in x's type. The kernel differs
    from it only where the float32 summation order or ``exp2f`` flips a
    rounding (``tc_ulp_stats``).
    """
    B, S, E = x.shape
    Dh = E // num_heads
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    ln = ((xf - mean) * torch.rsqrt(var + 1e-6) * ln_scale.float() +
          ln_bias.float()).bfloat16().float()
    qkv = (ln @ wqkv.float() + bqkv.float()).bfloat16().float()
    q, k, v = (t.reshape(B, S, num_heads, Dh).permute(0, 2, 1, 3)
               for t in qkv.split(E, dim=-1))
    s = q @ k.transpose(-1, -2)
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    c = float(np.float32(_LOG2E / math.sqrt(Dh)))
    m2 = s.amax(-1, keepdim=True) * c
    # fma(s, c, -m2) rounded once: the float64 product and difference of two
    # float32 values is exact before the one rounding to float32.
    p = torch.exp2((s.double() * c - m2.double()).float())
    l = p.sum(-1, keepdim=True)
    o = ((p.bfloat16().float() @ v) / l).bfloat16().float()
    o = o.permute(0, 2, 1, 3).reshape(B, S, E)
    return (o @ wout.float() + bout.float()).to(x.dtype)


def _bf16_order(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of the reals, one step per ulp
    (+0 and -0 both 0), as int32."""
    bits = t.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def tc_ulp_stats(out: torch.Tensor, emulated: torch.Tensor):
    """(share of elements not bit-equal, mean signed difference in bf16
    ulps) of the tensor-core kernel's bf16 ``out`` against
    ``_tc_emulation``'s on the same inputs. Both are near 0 for a clean
    kernel; a fault that moves every output one ulp reads (1, +-1)."""
    diff = (_bf16_order(out) - _bf16_order(emulated)).double()
    return float((diff != 0).double().mean()), float(diff.mean())


def _launch(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias, num_heads,
            causal):
    """Check what the CUDA kernels take, launch one and count the launch."""
    B, S, E = x.shape
    wt = (wqkv.dtype,)
    _build.check_cuda_args(
        x.device,
        x=(x, (B, S, E), _build.FLOATS),
        wqkv=(wqkv, (E, 3 * E), _build.FLOATS),
        bqkv=(bqkv, (3 * E,), wt),
        wout=(wout, (E, E), wt),
        bout=(bout, (E,), wt),
        ln_scale=(ln_scale, (E,), wt),
        ln_bias=(ln_bias, (E,), wt))
    if E % num_heads or E // num_heads not in HEAD_DIMS:
        raise ValueError(f"fused_ln_attention takes head widths {HEAD_DIMS}, "
                         f"got E={E}, num_heads={num_heads}")
    tc = tensor_core_route(x.dtype, wqkv.dtype, S, E)
    smem = _shared_bytes(S, E)
    if not tc and smem > MAX_SHARED_BYTES:
        raise ValueError(f"fused_ln_attention: S={S}, E={E} needs {smem} "
                         f"bytes of shared memory, more than "
                         f"{MAX_SHARED_BYTES}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch(
            "smd_fused_ln_attention",
            x, wqkv, bqkv, wout, bout, ln_scale, ln_bias, out,
            B, S, E, num_heads, int(causal),
            _build.dtype_code(x), _build.dtype_code(wqkv), int(tc))
    fused_ln_attention.launches += 1
    fused_ln_attention.tc_launches += int(tc)
    return out


def _forward(*args):
    if args[0].device.type == "cpu":
        return _reference(*args)
    return _launch(*args)


class _FusedLnAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                num_heads, causal):
        ctx.save_for_backward(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias)
        ctx.num_heads, ctx.causal = num_heads, causal
        return _forward(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                        num_heads, causal)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _reference(*inputs, ctx.num_heads, ctx.causal)
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None, None)


def fused_ln_attention(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                       num_heads: int, causal: bool = False):
    """LN + attention block for (B, S, E) with flat (E, 3E)/(E, E) weights.

    The six weight tensors share one dtype (float32 or bfloat16). Where no
    gradient is needed (serving), the call skips the autograd node.
    """
    args = (x, wqkv, bqkv, wout, bout, ln_scale, ln_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedLnAttention.apply(*args, num_heads, causal)
    return _forward(*args, num_heads, causal)


fused_ln_attention.launches = 0
fused_ln_attention.tc_launches = 0
