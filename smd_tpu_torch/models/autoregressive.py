"""Autoregressive Transformer-MDN baseline (port of
``smd_tpu/models/autoregressive.py``).

The pre-LN trunk of TransformerDDPM with causal attention, then LN →
Dense(mlp_dims) → ``num_mlp_layers`` DenseResBlocks (no FiLM: scale 1,
shift 0) → LN → the MDN head, computed in float32 whatever ``dtype`` is: the
mixture NLL is fragile in bf16. No noise conditioning. Each attention layer
takes the einsum, or on a CUDA tensor of at least 512 positions one causal
``flash_attention`` launch, as the JAX layer routes it.

``decode`` runs one position over a ``KVCache`` (``init_cache``), the
counterpart of the JAX module's ``decode=True`` with its ``cache``
collection.
"""
from __future__ import annotations

import torch
from torch import nn

from smd_tpu_torch.models.attention import KVCache, MultiHeadSelfAttention
from smd_tpu_torch.models.blocks import MDN, DenseResBlock
from smd_tpu_torch.models.ddpm import TransformerEncoder
from smd_tpu_torch.models.layers import Dense, LayerNorm

__all__ = ["shift_right", "TransformerMDN"]


def shift_right(x: torch.Tensor) -> torch.Tensor:
    """Shift along axis 1 by left-padding one zero step (teacher forcing)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


class TransformerMDN(nn.Module):
    """Causal transformer over latent sequences with an MDN output head.

    Flax infers the data width from the input; here it is
    ``data_channels``. ``dtype`` is the compute dtype of the trunk and the
    resblocks; parameters keep theirs, as in Flax. ``remat`` checkpoints the
    trunk's layers in training (``TransformerEncoder``), as JAX wraps them in
    ``nn.remat``; the head keeps its activations.
    """

    def __init__(self, data_channels: int, num_layers: int = 6,
                 num_heads: int = 8, num_mlp_layers: int = 2,
                 mlp_dims: int = 2048, mdn_mixtures: int = 100,
                 embed_channels: int = 128,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 max_decode_length: int = 128):
        super().__init__()
        self.max_decode_length = max_decode_length
        self.TransformerEncoder_0 = TransformerEncoder(
            data_channels, num_layers=num_layers, num_heads=num_heads,
            mlp_dims=mlp_dims, embed_channels=embed_channels, causal=True,
            dtype=dtype, remat=remat, max_decode_length=max_decode_length)
        self.LayerNorm_0 = LayerNorm(embed_channels, dtype=dtype)
        self.Dense_0 = Dense(embed_channels, mlp_dims, dtype=dtype)
        self.block_names = []
        for i in range(num_mlp_layers):
            self.add_module(f"DenseResBlock_{i}",
                            DenseResBlock(mlp_dims, mlp_dims, dtype=dtype))
            self.block_names.append(f"DenseResBlock_{i}")
        self.LayerNorm_1 = LayerNorm(mlp_dims, dtype=dtype)
        self.mdn = MDN(mlp_dims, data_channels, mdn_mixtures)

    def _head(self, x):
        x = self.Dense_0(self.LayerNorm_0(x))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.mdn(self.LayerNorm_1(x).float())

    def forward(self, inputs, shift: bool = True):
        """(B, S, C) -> (pi (B, S, K), mu, log_sigma (B, S, K*C)), float32
        (with float32 head params). ``shift`` feeds the inputs shifted right
        by one zero step (teacher forcing); decoding passes its tokens
        as they are."""
        x = shift_right(inputs) if shift else inputs
        return self._head(self.TransformerEncoder_0(x))

    def init_cache(self, batch: int) -> KVCache:
        """An empty cache of ``max_decode_length`` positions on the params'
        device."""
        return self.TransformerEncoder_0.init_cache(batch)

    def decode(self, token, cache: KVCache):
        """One position ``token`` (B, 1, C) at ``cache.index`` (a device
        tensor, never read back, or an int): returns ((pi, mu, log_sigma) of
        that position, each (B, 1, ...)), the cache advanced by one). The
        cached decode captures this call in a CUDA graph on the card."""
        x, cache = self.TransformerEncoder_0.decode(token, cache)
        return self._head(x), cache

    def use_plain_ops(self, plain: bool = True) -> "TransformerMDN":
        """Route the attention layers' flash route through the kernel's
        plain version (``plain=True``) or through the kernel (``False``,
        the default): the yardstick a kernel run is checked against on the
        card; serving never takes it."""
        for m in self.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.plain = plain
        return self
