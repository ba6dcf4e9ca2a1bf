"""Multi-head self-attention (port of ``smd_tpu/models/attention.py``).

The full-sequence path, routed as the JAX layer routes it: on an
accelerator (here a CUDA tensor) sequences of at least ``use_flash_min_len``
positions that ``flash_attention.supported`` takes go to the flash-attention
kernel; otherwise, with ``use_packed``, float32/bf16 short sequences go to
``packed_short_seq_attention``; everything else, and every CPU tensor, takes
the einsum path.

Incremental decoding (``MultiHeadSelfAttention.decode``) takes one position
at a time and attends over a key/value cache, as the JAX layer's decode
branch does; the cache is a ``KVCache`` the caller holds and passes in, not
state kept in the module.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
from torch import nn

from smd_tpu_torch.models.layers import DenseGeneral
from smd_tpu_torch.ops import flash_attention as fa

__all__ = ["KVCache", "MultiHeadSelfAttention", "route"]


class KVCache(NamedTuple):
    """The keys and values of the positions decoded so far.

    ``keys[l]`` and ``values[l]`` are layer l's (B, L, H, Dh) buffers, L the
    model's ``max_decode_length``, in the dtype of the layer's key and value
    projections; ``index`` is the next position to decode: a 0-d or
    one-element long tensor on the buffers' device (``init_cache`` makes
    one), which a step captured in a CUDA graph reads at each replay, or an
    int. A decode step writes position ``index`` of the buffers in place and
    returns a cache with ``index + 1`` that shares them: positions past a
    cache's index are masked out, so an earlier cache stays valid for
    decoding its position again.
    """
    keys: Tuple[torch.Tensor, ...]
    values: Tuple[torch.Tensor, ...]
    index: Union[torch.Tensor, int]


def position(index, device) -> torch.Tensor:
    """A cache index as the (1,) long device tensor that ``index_copy_``
    and ``index_select`` take."""
    if torch.is_tensor(index):
        return index.reshape(1)
    return torch.full((1,), index, dtype=torch.long, device=device)


def _on_accelerator(x: torch.Tensor) -> bool:
    """The JAX layer's ``jax.default_backend() != "cpu"``."""
    return x.device.type == "cuda"


def route(seq_len: int, head_dim: int, dtype: torch.dtype,
          on_accelerator: bool, use_flash_min_len: int = 512,
          use_packed: bool = False) -> str:
    """The JAX layer's choice of "flash", "packed" or "einsum"; "packed"
    still falls to the einsum when ``pack_group`` finds no group."""
    if seq_len >= use_flash_min_len and on_accelerator and \
            fa.supported(seq_len, head_dim, dtype):
        return "flash"
    if use_packed and on_accelerator and \
            dtype in (torch.float32, torch.bfloat16):
        return "packed"
    return "einsum"


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with qkv kernel (E, 3, H, Dh) and out kernel (H, Dh, E).

    features: model width (qkv width == out width == features).
    causal: apply a causal mask (TransformerMDN) or none (TransformerDDPM).
    use_flash_min_len, use_packed: the JAX layer's routing (see ``route``).
    ``plain=True`` sends the flash and packed routes to the kernel's plain
    version wherever the tensors lie: the yardstick the kernel is checked
    against, never the serving path.
    """

    def __init__(self, features: int, num_heads: int, causal: bool = False,
                 use_flash_min_len: int = 512, use_packed: bool = False):
        super().__init__()
        if features % num_heads:
            raise ValueError("features must divide num_heads")
        self.features = features
        self.num_heads = num_heads
        self.causal = causal
        self.use_flash_min_len = use_flash_min_len
        self.use_packed = use_packed
        self.plain = False
        dh = features // num_heads
        self.qkv = DenseGeneral((features,), (3, num_heads, dh))
        self.out = DenseGeneral((num_heads, dh), (features,))

    def forward(self, x):
        S = x.shape[1]
        dh = self.features // self.num_heads
        q, k, v = self.qkv(x).unbind(dim=-3)  # each (B, S, H, Dh)
        q = q / torch.tensor(dh ** 0.5, dtype=q.dtype)
        how = route(S, dh, q.dtype, _on_accelerator(x),
                    self.use_flash_min_len, self.use_packed)
        out = None
        if how == "flash":
            op = fa._reference_attention if self.plain else fa.flash_attention
            out = op(q, k, v, self.causal)
        elif how == "packed":
            out = fa.packed_short_seq_attention(q, k, v, self.causal,
                                                plain=self.plain)
        if out is None:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
            if self.causal:
                mask = torch.ones((S, S), dtype=torch.bool,
                                  device=x.device).tril()
                scores = scores.masked_fill(~mask,
                                            torch.finfo(scores.dtype).min)
            weights = torch.softmax(scores, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out)

    def decode(self, x, keys, values, index):
        """One position ``x`` (B, 1, E) at ``index`` (a cache index, see
        ``KVCache``): its key and value written into the (B, L, H, Dh)
        buffers ``keys`` and ``values`` in place, then attention over
        positions ``0..index`` of them (the einsum; the flash kernel takes
        no single query). Nothing is read back to the host."""
        if x.shape[1] != 1:
            raise ValueError("decode consumes one position at a time, got "
                             f"{x.shape[1]}")
        dh = self.features // self.num_heads
        q, k, v = self.qkv(x).unbind(dim=-3)  # each (B, 1, H, Dh)
        at = position(index, x.device)
        keys.index_copy_(1, at, k.to(keys.dtype))
        values.index_copy_(1, at, v.to(values.dtype))
        q = q / torch.tensor(dh ** 0.5, dtype=q.dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, keys)
        mask = torch.arange(keys.shape[1], device=x.device) <= at
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, values))
