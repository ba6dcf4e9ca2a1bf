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
transformer layer in the backward pass instead of keeping its activations
(``torch.utils.checkpoint`` without the RNG stash, since a layer draws
nothing), in eager steps and inside a captured training chunk alike.
The models take ``(x, cond)`` with ``cond`` the noise level in any of the
shapes (B,), (B,1), (B,1,1).

Beside it the networks of single latents and the score networks:
``DenseDDPM``/``ToyDDPM`` (an input Dense, ``num_layers`` FiLM-conditioned
``DenseResBlock``s, LN, an output Dense), ``DenseNCSN``/``ToyNCSN`` (the
same, conditioned on sigma, output divided by sigma) and ``ConvNCSN`` (a
1-D convolutional network over sequences, output divided by sigma). None
of them has a compute dtype: as in Flax, the input and output Dense, LN
and convolutions compute in the promoted type of their input and params,
while ``DenseFiLM`` and ``DenseResBlock`` keep their float32 default. So a
bf16 call (bf16 params and input) runs the input Dense in bf16 and every
resblock in float32 on params cast up.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from smd_tpu_torch.models.attention import (KVCache, MultiHeadSelfAttention,
                                            position)
from smd_tpu_torch.models.blocks import (DenseFiLM, DenseResBlock,
                                         FusedDenseResBlock,
                                         QuantDenseResBlock, _swish,
                                         positional_encoding)
from smd_tpu_torch.models.layers import (Conv, Dense, GroupNorm, LayerNorm,
                                         lecun_normal_)
from smd_tpu_torch.ops import fused_attention as fat

__all__ = ["TransformerEncoder", "TransformerLayer", "FusedTransformerLayer",
           "TransformerDDPM", "TransformerDDPM4", "DenseDDPM", "DenseNCSN",
           "ConvResBlock1D", "ConvNCSN", "ToyDDPM", "ToyNCSN"]


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

    def forward(self, x, kv=None):
        """``kv``: (keys, values, index) of this layer's cache to decode one
        position (``MultiHeadSelfAttention.decode``); None for the whole
        sequence."""
        h = self.LayerNorm_0(x)
        attention = self.MultiHeadSelfAttention_0
        h = attention(h) if kv is None else attention.decode(h, *kv)
        x = h + x
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
    ``num_layers`` attention + MLP blocks.

    ``decode`` runs one position over a ``KVCache`` (``init_cache``) of
    ``max_decode_length`` positions, in the standard layout only.

    ``remat`` checkpoints each layer while autograd records (training;
    serving, a teacher's calls under ``no_grad`` and ``decode`` keep their
    activations, as JAX's ``not decode`` does). The recompute is exact: a
    layer draws nothing, so its second run is the same kernels on the same
    inputs, and the checkpoint stashes no generator state
    (``preserve_rng_state=False``), which a CUDA graph could not capture.
    The recompute stops at the last tensor the backward needs
    (non-reentrant checkpointing), so on a model axis it runs the MLP's
    input Dense's all-gather again (``parallel/column.py``), on autograd's
    thread in the backward, and not the output Dense's.
    """

    def __init__(self, in_channels: int, num_layers: int = 6,
                 num_heads: int = 8, mlp_dims: int = 2048,
                 embed_channels: int = 128, causal: bool = False,
                 dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, remat: bool = False,
                 max_decode_length: int = 128):
        super().__init__()
        self.embed_channels = embed_channels
        self.num_heads = num_heads
        self.dtype = dtype
        self.remat = remat
        self.fused_attention = fused_attention
        self.max_decode_length = max_decode_length
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
                # its activations, as nn.remat(block_cls) does; no
                # generator stash (see the class's docstring).
                x = checkpoint(layer, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x)
        return x

    def _standard_layout_only(self):
        if self.fused_attention:
            raise NotImplementedError(
                "incremental decoding uses the standard layer layout")

    def cache_spec(self, batch: int):
        """Each layer's key (and value) buffer as (shape, dtype, device):
        (batch, L, H, Dh) in the dtype the key and value projections compute
        in (the promoted type of the layer's LN output and the projection's
        params, as Flax gives ``k.dtype``), on the params' device."""
        self._standard_layout_only()
        dh = self.embed_channels // self.num_heads
        shape = (batch, self.max_decode_length, self.num_heads, dh)
        spec = []
        for name in self.layer_names:
            qkv = getattr(self, name).MultiHeadSelfAttention_0.qkv
            dtype = torch.promote_types(
                torch.promote_types(self.dtype, qkv.kernel.dtype),
                qkv.bias.dtype)
            spec.append((shape, dtype, qkv.kernel.device))
        return spec

    def init_cache(self, batch: int) -> KVCache:
        """An empty cache (``cache_spec``): zero keys and values per layer,
        and index 0 as a 0-d long tensor on the params' device."""
        spec = self.cache_spec(batch)
        keys, values = [], []
        for shape, dtype, device in spec:
            for buffers in (keys, values):
                buffers.append(torch.zeros(shape, dtype=dtype,
                                           device=device))
        return KVCache(tuple(keys), tuple(values),
                       torch.zeros((), dtype=torch.long,
                                   device=spec[0][2] if spec else None))

    def decode(self, x, cache: KVCache):
        """One position ``x`` (B, 1, C) at ``cache.index``, its positional
        row taken from the ``max_decode_length`` table as the JAX layer
        slices it; returns (output (B, 1, E), the cache advanced by one).
        An int index is checked against the capacity here; a tensor index is
        never read back (a decode captured in a CUDA graph reads it at each
        replay), so its caller checks the step count before decoding
        (``mdn_decode.ar_decode_cached`` does)."""
        self._standard_layout_only()
        index = cache.index
        if not torch.is_tensor(index) and \
                not 0 <= index < self.max_decode_length:
            raise ValueError(f"position {index} is past the cache's "
                             f"max_decode_length={self.max_decode_length}")
        x = x.to(self.dtype)
        table = positional_encoding(self.max_decode_length,
                                    self.embed_channels, device=x.device)
        row = table.index_select(0, position(index, x.device))
        x = self.Dense_0(x) + row.to(self.dtype)[None]
        for name, keys, values in zip(self.layer_names, cache.keys,
                                      cache.values):
            x = getattr(self, name)(x, kv=(keys, values, index))
        return x, cache._replace(index=index + 1)


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


class _DenseNet(nn.Module):
    """Input Dense, ``num_layers`` x (DenseFiLM -> DenseResBlock), LN,
    output Dense: the trunk of DenseDDPM and DenseNCSN. ``num_heads`` and
    ``num_mlp_layers`` are taken and unused, as the JAX fields are."""

    def __init__(self, data_channels: int, num_layers: int = 3,
                 mlp_dims: int = 2048, num_heads: int = 0,
                 num_mlp_layers: int = 0):
        super().__init__()
        del num_heads, num_mlp_layers
        self.Dense_0 = Dense(data_channels, mlp_dims)
        self.block_names = []
        for i in range(num_layers):
            self.add_module(f"DenseFiLM_{i}", DenseFiLM(128, mlp_dims))
            self.add_module(f"DenseResBlock_{i}",
                            DenseResBlock(mlp_dims, mlp_dims))
            self.block_names.append((f"DenseFiLM_{i}", f"DenseResBlock_{i}"))
        self.LayerNorm_0 = LayerNorm(mlp_dims)
        self.Dense_1 = Dense(mlp_dims, data_channels)

    def trunk(self, inputs, cond):
        x = self.Dense_0(inputs)
        for film_name, block_name in self.block_names:
            scale, shift = getattr(self, film_name)(cond)
            x = getattr(self, block_name)(x, scale, shift)
        return self.Dense_1(self.LayerNorm_0(x))


class DenseDDPM(_DenseNet):
    """Fully-connected epsilon-predictor for single latents."""

    def forward(self, inputs, t):
        return self.trunk(inputs, _flat_cond(t))


class DenseNCSN(_DenseNet):
    """Fully-connected score network, FiLM-conditioned on the noise level
    sigma (a float, 0-d, (B,) or (B, 1, ...); rounded to the input's dtype
    first, as JAX casts it); output divided by sigma."""

    def forward(self, inputs, sigmas):
        B = inputs.shape[0]
        sig = torch.as_tensor(sigmas, dtype=inputs.dtype,
                              device=inputs.device)
        if sig.dim() <= 1:
            sig = sig.reshape(-1, 1).expand(B, 1)
        x = self.trunk(inputs, _flat_cond(sig.reshape(B, -1)[:, :1]))
        return x / sig.reshape(B, *([1] * (inputs.dim() - 1)))


class ConvResBlock1D(nn.Module):
    """1-D convolutional residual block: conv(3) -> swish (the shortcut) ->
    conv(3) -> GroupNorm(min(32, C)) -> affine -> swish, plus the
    shortcut."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels, 3)
        self.Conv_1 = Conv(out_channels, out_channels, 3)
        self.GroupNorm_0 = GroupNorm(out_channels, min(32, out_channels))

    def forward(self, inputs, scale=1.0, shift=0.0):
        x = _swish(self.Conv_0(inputs))
        shortcut = x
        x = self.GroupNorm_0(self.Conv_1(x))
        return _swish(scale * x + shift) + shortcut


class ConvNCSN(nn.Module):
    """Convolutional score network for sequences (B, L, C): conv(2) to 128
    channels, resblocks of 128, 128, 256, 256, 256, 256, 128, 128 channels,
    LN, relu, conv(2) back to C; output divided by sigma, which does not
    condition it. The unused CLI kwargs are taken as the JAX fields are."""

    CHANNELS = (128, 256, 256, 128)

    def __init__(self, data_channels: int, num_layers: int = 0,
                 num_heads: int = 0, num_mlp_layers: int = 0,
                 mlp_dims: int = 0):
        super().__init__()
        del num_layers, num_heads, num_mlp_layers, mlp_dims
        self.Conv_0 = Conv(data_channels, 128, 2)
        widths = [128]
        for channels in self.CHANNELS:
            widths += [channels, channels]
        self.block_names = []
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"ConvResBlock1D_{i}", ConvResBlock1D(cin, cout))
            self.block_names.append(f"ConvResBlock1D_{i}")
        self.LayerNorm_0 = LayerNorm(128)
        self.Conv_1 = Conv(128, data_channels, 2)

    def forward(self, inputs, sigmas):
        x = self.Conv_0(inputs)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.Conv_1(torch.relu(self.LayerNorm_0(x)))
        sig = torch.as_tensor(sigmas, dtype=inputs.dtype,
                              device=inputs.device)
        ones = [1] * (inputs.dim() - 1)
        sig = sig.reshape(sig.shape[0] if sig.dim() else 1, *ones)
        return x / sig.expand(inputs.shape[0], *ones)


class ToyDDPM(DenseDDPM):
    """Small MLP DDPM for the 2-D toy mixture problem (configs/mixture)."""

    def __init__(self, data_channels: int, num_layers: int = 3,
                 mlp_dims: int = 256, num_heads: int = 0,
                 num_mlp_layers: int = 0):
        super().__init__(data_channels, num_layers, mlp_dims)


class ToyNCSN(DenseNCSN):
    """Small MLP NCSN for the 2-D toy mixture problem (configs/mixture)."""

    def __init__(self, data_channels: int, num_layers: int = 3,
                 mlp_dims: int = 256, num_heads: int = 0,
                 num_mlp_layers: int = 0):
        super().__init__(data_channels, num_layers, mlp_dims)
