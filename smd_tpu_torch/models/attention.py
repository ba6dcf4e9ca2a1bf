"""Multi-head self-attention (port of ``smd_tpu/models/attention.py``).

The non-decode einsum path of the standard layout. On an accelerator the
JAX module routes S >= 512 to its flash-attention Pallas kernel; that kernel
is not ported yet (``ROADMAP.md`` queue B), so on a GPU longer sequences
raise here; on the CPU both packages take the einsum path.
"""
from __future__ import annotations

import torch
from torch import nn

from smd_tpu_torch.models.layers import DenseGeneral

__all__ = ["MultiHeadSelfAttention"]

# Sequences at least this long route to flash attention in the JAX layer
# (its use_flash_min_len default) when on an accelerator.
_FLASH_MIN_LEN = 512


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with qkv kernel (E, 3, H, Dh) and out kernel (H, Dh, E).

    features: model width (qkv width == out width == features).
    causal: apply a causal mask (TransformerMDN) or none (TransformerDDPM).
    """

    def __init__(self, features: int, num_heads: int, causal: bool = False):
        super().__init__()
        if features % num_heads:
            raise ValueError("features must divide num_heads")
        self.features = features
        self.num_heads = num_heads
        self.causal = causal
        dh = features // num_heads
        self.qkv = DenseGeneral((features,), (3, num_heads, dh))
        self.out = DenseGeneral((num_heads, dh), (features,))

    def forward(self, x):
        S = x.shape[1]
        if S >= _FLASH_MIN_LEN and x.device.type != "cpu":
            raise NotImplementedError(
                f"S={S} routes to flash_attention, which is not ported yet "
                "(ROADMAP.md, queue B)")
        dh = self.features // self.num_heads
        q, k, v = self.qkv(x).unbind(dim=-3)  # each (B, S, H, Dh)
        q = q / torch.tensor(dh ** 0.5, dtype=q.dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if self.causal:
            mask = torch.ones((S, S), dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out)
