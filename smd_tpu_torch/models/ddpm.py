"""Transformer epsilon-predictor (port of ``smd_tpu/models/ddpm.py``).

``TransformerDDPM`` in the standard layout (DenseResBlock head; each
layer's attention is the einsum, or one ``flash_attention`` launch on a
CUDA tensor of at least 512 positions, as the JAX layer routes it), in the
fused serving layout (``fused_attention=True``: each
layer's LN + attention is one ``fused_ln_attention`` launch;
``fused_head=True``: each head resblock is two ``fused_ln_film_swish_dense``
launches), and with the int8 serving head (``quantized_head=True``: each
head resblock is a ``QuantDenseResBlock``; with ``quantized_head_kernel``
its two matmuls are two ``w8a8_dense`` launches). ``dtype`` is the compute
dtype; parameters keep theirs, as in Flax. ``remat=True`` recomputes each
transformer layer in the backward pass instead of keeping its activations.
The models take ``(x, cond)`` with ``cond`` the noise level in any of the
shapes (B,), (B,1), (B,1,1).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from smd_tpu_torch.models.attention import MultiHeadSelfAttention
from smd_tpu_torch.models.blocks import (DenseFiLM, DenseResBlock,
                                         FusedDenseResBlock,
                                         QuantDenseResBlock,
                                         positional_encoding)
from smd_tpu_torch.models.layers import Dense, LayerNorm, lecun_normal_
from smd_tpu_torch.ops import fused_attention as fat

__all__ = ["TransformerEncoder", "TransformerLayer", "FusedTransformerLayer",
           "TransformerDDPM", "TransformerDDPM4"]


def _flat_cond(cond):
    """Normalize conditioning input to shape (B,)."""
    return cond.reshape(cond.shape[0])


class TransformerLayer(nn.Module):
    """One pre-LN attention + MLP block."""

    def __init__(self, num_heads: int, mlp_dims: int, embed_channels: int,
                 causal: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = embed_channels
        self.LayerNorm_0 = LayerNorm(e, dtype=dtype)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            e, num_heads, causal=causal)
        self.LayerNorm_1 = LayerNorm(e, dtype=dtype)
        self.Dense_0 = Dense(e, mlp_dims, dtype=dtype)
        self.Dense_1 = Dense(mlp_dims, e, dtype=dtype)

    def forward(self, x):
        x = self.MultiHeadSelfAttention_0(self.LayerNorm_0(x)) + x
        h = self.Dense_0(self.LayerNorm_1(x))
        h = self.Dense_1(nn.functional.gelu(h, approximate="tanh"))
        return h + x


class FusedTransformerLayer(nn.Module):
    """TransformerLayer with the LN + attention block as one kernel launch.

    Flat (E, 3E)/(E, E) attention weights; convert a standard-layout tree
    with ``models.fuse.fuse_attention_params``. ``plain=True`` runs the
    kernel's plain version wherever the tensors lie: the yardstick the
    kernel is checked against, never the serving path.
    """

    def __init__(self, num_heads: int, mlp_dims: int, embed_channels: int,
                 causal: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = embed_channels
        self.num_heads = num_heads
        self.causal = causal
        self.plain = False
        self.wqkv = nn.Parameter(torch.empty(e, 3 * e))
        self.bqkv = nn.Parameter(torch.zeros(3 * e))
        self.wout = nn.Parameter(torch.empty(e, e))
        self.bout = nn.Parameter(torch.zeros(e))
        self.ln_scale = nn.Parameter(torch.ones(e))
        self.ln_bias = nn.Parameter(torch.zeros(e))
        self.reset_parameters()
        self.LayerNorm_0 = LayerNorm(e, dtype=dtype)
        self.Dense_0 = Dense(e, mlp_dims, dtype=dtype)
        self.Dense_1 = Dense(mlp_dims, e, dtype=dtype)

    def reset_parameters(self, generator=None):
        """The flat attention weights; the submodules draw their own."""
        e = self.wqkv.shape[0]
        lecun_normal_(self.wqkv, e, generator)
        lecun_normal_(self.wout, e, generator)
        for p in (self.bqkv, self.bout, self.ln_bias):
            nn.init.zeros_(p)
        nn.init.ones_(self.ln_scale)

    def forward(self, x):
        op = fat._reference if self.plain else fat.fused_ln_attention
        h = op(x, self.wqkv, self.bqkv, self.wout, self.bout, self.ln_scale,
               self.ln_bias, self.num_heads, self.causal)
        x = x + h.to(x.dtype)
        h = self.Dense_0(self.LayerNorm_0(x))
        h = self.Dense_1(nn.functional.gelu(h, approximate="tanh"))
        return h + x


class TransformerEncoder(nn.Module):
    """Pre-LN transformer trunk: Dense embed + sinusoidal positions, then
    ``num_layers`` attention + MLP blocks."""

    def __init__(self, in_channels: int, num_layers: int = 6,
                 num_heads: int = 8, mlp_dims: int = 2048,
                 embed_channels: int = 128, causal: bool = False,
                 dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, remat: bool = False):
        super().__init__()
        self.embed_channels = embed_channels
        self.dtype = dtype
        self.remat = remat
        self.Dense_0 = Dense(in_channels, embed_channels, dtype=dtype)
        cls = FusedTransformerLayer if fused_attention else TransformerLayer
        self.layer_names = []
        for i in range(num_layers):
            name = f"{cls.__name__}_{i}"
            self.add_module(name, cls(num_heads, mlp_dims, embed_channels,
                                      causal, dtype=dtype))
            self.layer_names.append(name)

    def forward(self, x):
        x = x.to(self.dtype)
        temb = positional_encoding(x.shape[1], self.embed_channels,
                                   device=x.device).to(self.dtype)
        x = self.Dense_0(x) + temb[None]
        for name in self.layer_names:
            layer = getattr(self, name)
            if self.remat and torch.is_grad_enabled():
                # The backward pass runs the layer again instead of keeping
                # its activations, as nn.remat(block_cls) does.
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        return x


class TransformerDDPM(nn.Module):
    """Transformer epsilon-predictor over latent sequences (the main model).

    Noise enters only through the FiLM-conditioned MLP head. Flax infers
    the output width from the input; here it is ``data_channels``.
    """

    def __init__(self, data_channels: int, num_layers: int = 6,
                 num_heads: int = 8, num_mlp_layers: int = 2,
                 mlp_dims: int = 2048, embed_channels: int = 128,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 fused_attention: bool = False, fused_head: bool = False,
                 quantized_head: bool = False,
                 quantized_head_kernel: bool = False):
        super().__init__()
        if fused_head and quantized_head:
            raise ValueError("fused_head and quantized_head exclude each "
                             "other")
        self.TransformerEncoder_0 = TransformerEncoder(
            data_channels, num_layers=num_layers, num_heads=num_heads,
            mlp_dims=mlp_dims, embed_channels=embed_channels, causal=False,
            dtype=dtype, fused_attention=fused_attention, remat=remat)
        self.LayerNorm_0 = LayerNorm(embed_channels, dtype=dtype)
        self.Dense_0 = Dense(embed_channels, mlp_dims, dtype=dtype)
        self.head_names = []
        for i in range(num_mlp_layers):
            self.add_module(f"DenseFiLM_{i}", DenseFiLM(
                128, mlp_dims, sequence=True, dtype=dtype))
            if fused_head:
                block, name = FusedDenseResBlock(mlp_dims, dtype=dtype), \
                    f"FusedDenseResBlock_{i}"
            elif quantized_head:
                block, name = QuantDenseResBlock(
                    mlp_dims, dtype=dtype,
                    use_kernel=quantized_head_kernel), \
                    f"QuantDenseResBlock_{i}"
            else:
                block, name = DenseResBlock(mlp_dims, mlp_dims, dtype=dtype), \
                    f"DenseResBlock_{i}"
            self.add_module(name, block)
            self.head_names.append((f"DenseFiLM_{i}", name))
        self.LayerNorm_1 = LayerNorm(mlp_dims, dtype=dtype)
        # float32 output head for a stable objective
        self.Dense_1 = Dense(mlp_dims, data_channels, dtype=torch.float32)

    def forward(self, inputs, t):
        t = _flat_cond(t)
        x = self.TransformerEncoder_0(inputs)
        x = self.Dense_0(self.LayerNorm_0(x))
        for film_name, block_name in self.head_names:
            scale, shift = getattr(self, film_name)(t)
            x = getattr(self, block_name)(x, scale, shift)
        return self.Dense_1(self.LayerNorm_1(x))

    def use_plain_ops(self, plain: bool = True) -> "TransformerDDPM":
        """Route the fused and int8 layers, and the attention layers' flash
        route, through the kernels' plain versions (``plain=True``) or
        through the kernels (``False``, the default).

        The plain route is the yardstick a kernel run is checked against on
        the card; serving never takes it.
        """
        for m in self.modules():
            if isinstance(m, (FusedTransformerLayer, FusedDenseResBlock,
                              QuantDenseResBlock, MultiHeadSelfAttention)):
                m.plain = plain
        return self


class TransformerDDPM4(TransformerDDPM):
    """Alias architecture named by ``configs/ddpm-multi-32seq-512.cfg:2``:
    TransformerDDPM under the config-supplied hyperparameters."""
