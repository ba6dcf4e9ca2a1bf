"""Fused short-sequence attention block: LN + QKV + softmax(QK^T/sqrt(Dh))V + out.

Port of ``smd_tpu/ops/fused_attention.py`` (``fused_ln_attention``, Pallas
kernel ``_kernel``): learned-affine LayerNorm (eps 1e-6) -> (S,E)@(E,3E)+b ->
per head softmax(QK^T/sqrt(Dh))V, optionally causal -> (S,E)@(E,E)+b, all in
float32 with the weights cast up, stored in ``x.dtype``. The Pallas kernel's
block-diagonal packing of NB items into one tile is a TPU tiling device and
not part of the function.

On a CUDA tensor the wrapper launches the CUDA kernel of
``csrc/fused_attention.cu`` or raises; on a CPU tensor it takes
``_reference``, the plain PyTorch version. Serving only: no backward yet.
"""
from __future__ import annotations

import torch

from smd_tpu_torch.ops import _build

__all__ = ["fused_ln_attention"]

# Head widths the kernel is instantiated for (its per-thread registers).
HEAD_DIMS = (8, 16, 32, 64)
# Dynamic shared memory one block may use on Hopper.
MAX_SHARED_BYTES = 232448


def _shared_bytes(S: int, E: int) -> int:
    """The kernel's shared memory: LN/attention rows and qkv rows, float32."""
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


def fused_ln_attention(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                       num_heads: int, causal: bool = False):
    """LN + attention block for (B, S, E) with flat (E, 3E)/(E, E) weights.

    The six weight tensors share one dtype (float32 or bfloat16).
    """
    if x.device.type == "cpu":
        return _reference(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                          num_heads, causal)
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
    smem = _shared_bytes(S, E)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"fused_ln_attention: S={S}, E={E} needs {smem} "
                         f"bytes of shared memory, more than "
                         f"{MAX_SHARED_BYTES}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch(
            "smd_fused_ln_attention",
            x, wqkv, bqkv, wout, bout, ln_scale, ln_bias, out,
            B, S, E, num_heads, int(causal),
            _build.dtype_code(x), _build.dtype_code(wqkv))
    fused_ln_attention.launches += 1
    return out


fused_ln_attention.launches = 0
