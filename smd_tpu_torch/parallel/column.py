"""Column-parallel Dense over the model group (Megatron's f/g pair).

Each rank of a model group holds the column block of a Dense's kernel and
bias and computes ``x @ W[:, blk] + b[blk]``; the blocks are all-gathered
on the feature axis, so every rank goes on with the whole output, as the
JAX package's sharded step does. The backward:

- the gathered output's gradient is the same on every rank of the group
  (what follows is replicated), so each rank takes its own block of it
  (``_GatherFromModel``), not a sum;
- the replicated input's gradient through the Dense is the sum of the
  ranks' block products, so it is all-reduced over the group
  (``_CopyToModel``); the input's other consumers add theirs on each rank.

``torch.distributed.nn.functional.all_gather``'s backward reduce-scatters,
which would multiply the gradient by the group's size; hence these two
functions. The Dense keeps its Flax name and parameter names; the pair is
attached as forward hooks. Each collective goes through
``graphs.collective`` with its buffers made before it, so a captured step
(``utils/graphs.py``) runs it eagerly between two of its graphs: the
gather's blocks are allocated before the cut and joined after it, the
reduce's gradient cloned before it and summed in place in it.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn

from smd_tpu_torch.utils import graphs

__all__ = ["make_column_parallel"]


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        graphs.collective(functools.partial(dist.all_reduce, grad,
                                            group=ctx.group), grad)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The blocks all-gathered on the last axis; the gradient's own block
    backward."""

    @staticmethod
    def forward(ctx, y, group, index, size):
        ctx.index, ctx.size = index, size
        block = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        graphs.collective(functools.partial(dist.all_gather, parts, block,
                                            group=group), block, *parts)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        block = grad.shape[-1] // ctx.size
        return grad.narrow(-1, ctx.index * block, block).contiguous(), \
            None, None, None


def make_column_parallel(dense: nn.Module, mesh) -> nn.Module:
    """Keep this rank's column block of ``dense``'s kernel (in, out) and
    bias, in place, and gather its output over ``mesh.model_group``."""
    from smd_tpu_torch.models.layers import Dense
    if not isinstance(dense, Dense):
        raise TypeError(f"only a Dense splits by columns, not "
                        f"{type(dense).__name__}")
    out = dense.kernel.shape[-1]
    block = out // mesh.model
    lo = mesh.model_index * block
    with torch.no_grad():
        dense.kernel = nn.Parameter(dense.kernel[:, lo:lo + block].clone())
        if dense.bias is not None:
            dense.bias = nn.Parameter(dense.bias[lo:lo + block].clone())
    dense.out_shape = (block,)
    group, index, size = mesh.model_group, mesh.model_index, mesh.model
    dense.register_forward_pre_hook(
        lambda m, args: (_CopyToModel.apply(args[0], group), *args[1:]))
    dense.register_forward_hook(
        lambda m, args, y: _GatherFromModel.apply(y, group, index, size))
    return dense
