"""The Flax Linen layers the JAX models build on, with Flax's parameter layout.

A Dense kernel is ``(in, out)`` and is applied as ``x @ W + b``, so carrying
a Flax params tree over is a rename (``utils/flax_params.py``). The dtype
rules are Flax's: with ``dtype=None`` a layer computes in the promoted type
of its input and parameters; with a dtype it casts all of them to it.
LayerNorm and GroupNorm take their statistics in float32 with Flax's
epsilon (1e-6) and its one-pass variance, and cast the result to the
layer's dtype. A Conv kernel is ``(k, in, out)`` over channel-last input,
as Flax keeps it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["Dense", "DenseGeneral", "LayerNorm", "GroupNorm", "Conv",
           "lecun_normal_", "init_parameters"]


def lecun_normal_(param: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Flax's default kernel init: truncated normal, variance 1/fan_in.

    Drawn on the CPU from ``generator`` (a CPU generator, or the global one
    when None) and copied in, so a seed gives the same weights on any
    device.
    """
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        value = nn.init.trunc_normal_(torch.empty(param.shape), std=std,
                                      a=-2 * std, b=2 * std,
                                      generator=generator)
        return param.copy_(value)


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``module`` anew with Flax's initializers
    (kernels lecun-normal, biases 0, LayerNorm scales 1) from ``seed``.

    Each submodule with a ``reset_parameters(generator)`` draws its own, in
    module order; the counterpart of the JAX package's ``model.init(rng)``
    (the values differ: the draws are torch's, not JAX's).
    """
    generator = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module


def _compute_dtype(dtype, *tensors) -> torch.dtype:
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class DenseGeneral(nn.Module):
    """``flax.linen.DenseGeneral`` over the trailing ``len(in_shape)`` axes;
    with ``use_bias=False`` it has no ``bias`` parameter, as in Flax."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape,
                                               *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape)) \
            if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_normal_(self.kernel, math.prod(self.in_shape), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = (self.kernel,) if self.bias is None else \
            (self.kernel, self.bias)
        dt = _compute_dtype(self.dtype, x, *params)
        n_in = len(self.in_shape)
        lead = x.shape[:x.dim() - n_in]
        k = self.kernel.to(dt).reshape(math.prod(self.in_shape), -1)
        y = torch.matmul(x.to(dt).reshape(*lead, -1), k)
        y = y.reshape(*lead, *self.out_shape)
        return y if self.bias is None else y + self.bias.to(dt)


class Dense(DenseGeneral):
    """``flax.linen.Dense``: kernel ``(in, out)``, bias ``(out,)`` unless
    ``use_bias=False``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True):
        super().__init__((in_features,), (out_features,), dtype, use_bias)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis, with scale and bias."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return _normalize(x, mean, var, self.scale, self.bias, self.dtype)


def _normalize(x, mean, var, scale, bias, dtype):
    """Flax's ``_normalize``: (x - mean) * rsqrt(var + 1e-6) * scale + bias
    in float32, cast to ``dtype`` (None: promoted from x and the params)."""
    mul = torch.rsqrt(var + 1e-6) * scale.float()
    y = (x.float() - mean) * mul + bias.float()
    return y.to(_compute_dtype(dtype, x, scale, bias))


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` over channel-last ``(B, ..., C)``: the
    statistics of each group of ``C // num_groups`` channels over every
    axis but the batch, with scale and bias per channel."""

    def __init__(self, features: int, num_groups: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {features} "
                             "channels")
        self.num_groups = num_groups
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        g = x.float().reshape(B, -1, self.num_groups, C // self.num_groups)
        axes = (1, 3)
        mean = g.mean(axes)
        var = ((g * g).mean(axes) - mean * mean).clamp_min(0.0)
        shape = (B, *([1] * (x.dim() - 2)), C)
        mean = mean.repeat_interleave(C // self.num_groups, -1).reshape(shape)
        var = var.repeat_interleave(C // self.num_groups, -1).reshape(shape)
        return _normalize(x, mean, var, self.scale, self.bias, self.dtype)


class Conv(nn.Module):
    """``flax.linen.Conv`` over one spatial axis, channel-last ``(B, L,
    in)``, stride 1, ``'SAME'`` padding as XLA computes it: k - 1 in all,
    (k - 1) // 2 below and the rest above (k=2 pads 0 and 1)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features,
                                               out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        k, fan_in = self.kernel.shape[0], self.kernel.shape[1]
        lecun_normal_(self.kernel, k * fan_in, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.kernel, self.bias)
        low = (self.kernel_size - 1) // 2
        high = self.kernel_size - 1 - low
        h = nn.functional.pad(x.to(dt).transpose(1, 2), (low, high))
        y = nn.functional.conv1d(h, self.kernel.to(dt).permute(2, 1, 0),
                                 self.bias.to(dt))
        return y.transpose(1, 2)
