"""Shared building blocks (port of ``smd_tpu/models/blocks.py``).

Submodules and parameters carry the Flax names (``Dense_0``, ``LayerNorm_1``,
``w1``, ...) so a Flax params tree maps onto ``named_parameters()`` by path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from smd_tpu_torch.models.layers import Dense, LayerNorm, lecun_normal_
from smd_tpu_torch.ops import fused_film_resblock as ffr
from smd_tpu_torch.ops import quant_matmul as qmm
from smd_tpu_torch.ops.quant import int8_dense

__all__ = [
    "sinusoidal_embedding",
    "positional_encoding",
    "noise_encoding",
    "DenseFiLM",
    "DenseResBlock",
    "FusedDenseResBlock",
    "QuantDenseResBlock",
    "MDN",
]


def sinusoidal_embedding(positions: torch.Tensor,
                         channels: int) -> torch.Tensor:
    """Sin/cos embedding of a 1-D position/noise vector -> (len, channels)."""
    if positions.dim() != 1:
        raise ValueError("sinusoidal_embedding takes a 1-D tensor")
    half_dim = channels // 2
    # float32 throughout, as the JAX package computes it.
    step = float(np.float32(np.log(np.float32(10000.0))) /
                 np.float32(half_dim - 1))
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=positions.device) * -step)
    emb = positions.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if channels % 2 == 1:
        emb = nn.functional.pad(emb, (0, 1))
    return emb


def positional_encoding(seq_len: int, channels: int,
                        device=None) -> torch.Tensor:
    """Transformer positional encoding table, shape (seq_len, channels)."""
    return sinusoidal_embedding(torch.arange(seq_len, device=device), channels)


def noise_encoding(noise: torch.Tensor, channels: int) -> torch.Tensor:
    """Sinusoidal embedding of a continuous noise level, scaled x5000."""
    if noise.dim() == 2:
        noise = noise.squeeze(-1)
    if noise.dim() != 1:
        raise ValueError("noise_encoding takes (B,) or (B, 1)")
    # JAX casts the weakly typed 5000.0 to the noise's dtype before the
    # product (bf16: 4992), where torch would keep the scalar in float32.
    # Rounded on the host: a tensor made on the device would be a copy and
    # a wait at every call.
    scale = torch.tensor(5000.0, dtype=noise.dtype).item()
    return sinusoidal_embedding(noise * scale, channels)


def _swish(x):
    return x * torch.sigmoid(x)


def _ln_film_swish(ln, x, scale, shift):
    """One half's prologue: LN, FiLM affine, swish, in the layers' dtype."""
    return _swish(ln(x) * scale + shift)


class DenseFiLM(nn.Module):
    """Feature-wise linear modulation from a noise level.

    noise (B,) or (B,1) -> (scale, shift) each (B, out_channels), or
    (B, 1, out_channels) when ``sequence=True``.
    """

    def __init__(self, embedding_channels: int, out_channels: int,
                 sequence: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding_channels = embedding_channels
        self.sequence = sequence
        self.dtype = dtype
        width = embedding_channels * 4
        self.Dense_0 = Dense(embedding_channels, width, dtype=dtype)
        self.Dense_1 = Dense(width, width, dtype=dtype)
        self.Dense_2 = Dense(width, out_channels, dtype=dtype)
        self.Dense_3 = Dense(width, out_channels, dtype=dtype)

    def forward(self, position):
        pos = noise_encoding(position, self.embedding_channels).to(self.dtype)
        pos = _swish(self.Dense_0(pos))
        pos = self.Dense_1(pos)
        if self.sequence:
            pos = pos[:, None, :]
        return self.Dense_2(pos), self.Dense_3(pos)


class DenseResBlock(nn.Module):
    """Fully-connected residual block with FiLM conditioning.

    LN -> affine -> swish -> Dense -> LN -> affine -> swish -> Dense, plus a
    projected shortcut when the width changes.
    """

    def __init__(self, in_features: int, output_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(in_features, dtype=dtype)
        self.Dense_0 = Dense(in_features, output_size, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(output_size, dtype=dtype)
        self.Dense_1 = Dense(output_size, output_size, dtype=dtype)
        self.Dense_2: Optional[Dense] = None
        if in_features != output_size:
            self.Dense_2 = Dense(in_features, output_size, dtype=dtype)

    def forward(self, inputs, scale=1.0, shift=0.0):
        x = self.Dense_0(_ln_film_swish(self.LayerNorm_0, inputs, scale,
                                        shift))
        x = self.Dense_1(_ln_film_swish(self.LayerNorm_1, x, scale, shift))
        shortcut = inputs if self.Dense_2 is None else self.Dense_2(inputs)
        return x + shortcut


class FusedDenseResBlock(nn.Module):
    """DenseResBlock with each half one ``fused_ln_film_swish_dense`` call.

    Serving layout: flat params (ln1_scale/ln1_bias/w1/b1, ln2_*/w2/b2); the
    LN affine folds into the FiLM affine so each half is one kernel launch.
    Convert DenseResBlock params with ``models.fuse.fuse_head_params``.
    Requires input width == output_size (the head case). ``plain=True`` runs
    the kernels' plain versions wherever the tensors lie: the yardstick a
    kernel is checked against, never the serving path.
    """

    def __init__(self, output_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        n = output_size
        self.dtype = dtype
        self.plain = False
        for i in (1, 2):
            setattr(self, f"w{i}", nn.Parameter(torch.empty(n, n)))
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(n)))
            setattr(self, f"ln{i}_scale", nn.Parameter(torch.ones(n)))
            setattr(self, f"ln{i}_bias", nn.Parameter(torch.zeros(n)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for i in (1, 2):
            lecun_normal_(getattr(self, f"w{i}"), self.w1.shape[0],
                          generator)
            nn.init.zeros_(getattr(self, f"b{i}"))
            nn.init.ones_(getattr(self, f"ln{i}_scale"))
            nn.init.zeros_(getattr(self, f"ln{i}_bias"))

    def forward(self, inputs, scale, shift):
        scale = torch.as_tensor(scale, dtype=torch.float32,
                                device=inputs.device)
        shift = torch.as_tensor(shift, dtype=torch.float32,
                                device=inputs.device)
        # Fold LN's learned affine into the FiLM affine:
        # (z*ls + lb)*s + sh == z*(ls*s) + (lb*s + sh).
        s1 = self.ln1_scale.float() * scale
        h1 = self.ln1_bias.float() * scale + shift
        s2 = self.ln2_scale.float() * scale
        h2 = self.ln2_bias.float() * scale + shift
        w1, w2 = self.w1.to(self.dtype), self.w2.to(self.dtype)
        op = ffr._reference if self.plain else ffr.fused_ln_film_swish_dense
        u = op(inputs, s1, h1, w1, self.b1)
        return op(u, s2, h2, w2, self.b2, residual=inputs)


class QuantDenseResBlock(nn.Module):
    """DenseResBlock with both matmuls on the int8 path (serving only).

    Each half is LN -> FiLM affine -> swish -> int8 dense, cast to
    ``dtype``, and the block adds its input. Weights are symmetric
    per-channel int8 (``w1_q``/``w2_q``, buffers that ``.to(dtype)`` leaves
    int8) with float scales ``w*_scale``, biases ``b*`` and scalar static
    activation scales ``a*_scale``; convert DenseResBlock params with
    ``models.fuse.quantize_head_params`` and calibrate the activation scales
    with ``models.fuse.calibrate_head_act_scales``. ``use_kernel`` routes
    the matmuls through ``w8a8_dense`` (static scales only), else through
    ``int8_dense``, with a dynamic per-row scale when ``static_act`` is
    False. ``plain=True`` runs the kernel's plain version wherever the
    tensors lie: the yardstick the kernel is checked against. With
    ``observe`` on, each call records ``max|x|`` in float32 of the
    activations before each matmul in ``amax`` (keys ``a1_amax``,
    ``a2_amax``; the largest seen since ``amax`` was last emptied), the
    counterpart of the JAX module's ``sow``. Requires input width ==
    output_size (the head case, no shortcut projection).

    The kernel's product reads each weight K-major: ``kmajor_weight(i)``
    keeps the (N, K) copy of ``w{i}_q``, made once and made again whenever
    ``w{i}_q`` is loaded in place or replaced. It is neither a parameter
    nor a buffer, so ``state_dict`` and ``load_flax_params`` do not see it.
    """

    def __init__(self, output_size: int, dtype: torch.dtype = torch.float32,
                 static_act: bool = True, use_kernel: bool = False):
        super().__init__()
        if use_kernel and not static_act:
            raise ValueError("the w8a8 kernel requires static activation "
                             "scales")
        n = output_size
        self.dtype = dtype
        self.static_act = static_act
        self.use_kernel = use_kernel
        self.plain = False
        self.observe = False
        self.amax: dict = {}
        # i -> (w{i}_q as last seen, its version counter, its (N, K) copy)
        self._kmajor: dict = {}
        self.LayerNorm_0 = LayerNorm(n, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(n, dtype=dtype)
        for i in (1, 2):
            self.register_buffer(f"w{i}_q", torch.zeros(n, n,
                                                       dtype=torch.int8))
            setattr(self, f"w{i}_scale", nn.Parameter(torch.ones(n)))
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(n)))
            setattr(self, f"a{i}_scale", nn.Parameter(torch.ones(())))

    def kmajor_weight(self, i: int):
        """``w{i}_q``'s K-major copy for the w8a8 kernel, made again if
        ``w{i}_q`` changed since (a new tensor or an in-place write)."""
        w_q = getattr(self, f"w{i}_q")
        # An inference-mode tensor has no version counter (and takes no
        # in-place write outside inference mode).
        version = None if w_q.is_inference() else w_q._version
        seen = self._kmajor.get(i)
        if seen is None or seen[0] is not w_q or seen[1] != version:
            seen = (w_q, version, qmm.transpose_weight(w_q))
            self._kmajor[i] = seen
        return seen[2]

    def _dense(self, x, i: int):
        w_q, w_s = getattr(self, f"w{i}_q"), getattr(self, f"w{i}_scale")
        b, a_s = getattr(self, f"b{i}"), getattr(self, f"a{i}_scale")
        if self.observe:
            seen = x.float().abs().amax()
            key = f"a{i}_amax"
            self.amax[key] = seen if key not in self.amax else \
                torch.maximum(self.amax[key], seen)
        if self.use_kernel:
            if self.plain:
                return qmm._reference(x, w_q, w_s, b, a_s).to(self.dtype)
            return qmm.w8a8_dense(x, w_q, w_s, b, a_s,
                                  w_t=self.kmajor_weight(i)).to(self.dtype)
        return int8_dense(x, w_q, w_s, b,
                          a_s if self.static_act else None).to(self.dtype)

    def forward(self, inputs, scale=1.0, shift=0.0):
        if inputs.shape[-1] != self.w1_q.shape[0]:
            raise ValueError("the quantized resblock requires matching "
                             "widths")
        x = self._dense(_ln_film_swish(self.LayerNorm_0, inputs, scale,
                                       shift), 1)
        x = self._dense(_ln_film_swish(self.LayerNorm_1, x, scale, shift), 2)
        return x + inputs


class MDN(nn.Module):
    """Mixture-density output head: unnormalized (pi, mu, log_sigma).

    ``pi`` is (..., num_components); ``mu`` and ``log_sigma`` are (...,
    num_components * out_channels). The Denses have no dtype, as in Flax:
    they compute in the promoted type of their input and params.
    """

    def __init__(self, in_features: int, out_channels: int = 512,
                 num_components: int = 10):
        super().__init__()
        width = out_channels * num_components
        self.Dense_0 = Dense(in_features, width)           # mu
        self.Dense_1 = Dense(in_features, width)           # log_sigma
        self.Dense_2 = Dense(in_features, num_components)  # pi

    def forward(self, inputs):
        # Called in the Flax module's order (the converter pairs by it).
        mu, log_sigma = self.Dense_0(inputs), self.Dense_1(inputs)
        return self.Dense_2(inputs), mu, log_sigma
