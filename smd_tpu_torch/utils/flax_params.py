"""Carry a Flax params tree into the port's modules.

A Flax params tree (nested dicts of arrays, from ``model.init``, a restored
checkpoint or a pickled bundle; standard or fused layout) maps onto
``module.named_parameters()`` by path: the port's modules carry the Flax
names and layouts, so ``TransformerEncoder_0/Dense_0/kernel`` is the
parameter ``TransformerEncoder_0.Dense_0.kernel``. The int8 codes of the
quantized head (``QuantDenseResBlock_k/w1_q``) are buffers, since they
cannot be parameters. Loading checks that every leaf of the tree is used and
every parameter and buffer of the module is set, with matching shapes.
``to_flax_tree`` goes the other way, from a module or its ``{name: tensor}``
params to a Flax-layout numpy tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["flatten", "load_flax_params", "random_flax_params",
           "to_flax_tree"]


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a.b.c": leaf}; a top-level "params" key is dropped."""
    if not prefix and isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def _to_tensor(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)   # ml_dtypes bf16 -> exact float32
    # ascontiguousarray makes a 0-d array 1-d; keep the shape.
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))


def load_flax_params(module: nn.Module, tree) -> nn.Module:
    """Copy every leaf of ``tree`` into the matching parameter or buffer of
    ``module``.

    Each tensor keeps its dtype and device. Raises if a leaf has no tensor,
    a tensor has no leaf, or shapes differ.
    """
    leaves = flatten(tree)
    params = {**dict(module.named_parameters()),
              **dict(module.named_buffers())}
    unused = sorted(set(leaves) - set(params))
    missing = sorted(set(params) - set(leaves))
    if unused or missing:
        raise ValueError(f"params tree does not match the module: unused "
                         f"leaves {unused}, parameters not set {missing}")
    with torch.no_grad():
        for name, p in params.items():
            value = _to_tensor(leaves[name])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree has shape "
                                 f"{tuple(value.shape)}, module has "
                                 f"{tuple(p.shape)}")
            p.copy_(value)
    return module


def to_flax_tree(source) -> dict:
    """``{"params": nested numpy dict}`` of a module's parameters and
    buffers, or of a ``{dotted name: tensor}`` mapping (a state dict, a
    ``TrainState``'s params): the inverse of ``load_flax_params``. bf16
    tensors become float32 arrays (numpy has no bf16); every other dtype is
    kept.
    """
    if isinstance(source, nn.Module):
        source = {**dict(source.named_parameters()),
                  **dict(source.named_buffers())}
    return _unflatten({
        name: (t.detach().float() if t.dtype == torch.bfloat16
               else t.detach()).cpu().numpy()
        for name, t in source.items()})


def _unflatten(leaves: dict) -> dict:
    """{"a.b.c": leaf} -> {"params": nested dict}: ``flatten``'s inverse."""
    tree: dict = {}
    for name, leaf in leaves.items():
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return {"params": tree}


def random_flax_params(module: nn.Module, seed: int) -> dict:
    """A Flax-layout numpy tree with the module's shapes, made from ``seed``.

    Standard or fused layout; for the int8 head, quantize a standard-layout
    tree with ``models.fuse.quantize_head_params``.

    Kernels are normal with variance 1/fan_in; biases, LN biases and LN
    scale offsets are small and non-zero, so every term of the model is
    exercised. Random weights time the same as trained ones.
    """
    rng = np.random.default_rng(seed)
    leaves = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        shape = tuple(p.shape)
        if len(shape) >= 2:
            # The attention "out" kernel (H, Dh, E) contracts its first two
            # axes; every other kernel its first.
            out_kernel = bool(path) and path[-1] == "out"
            fan_in = int(np.prod(shape[:-1])) if out_kernel else shape[0]
            value = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif "scale" in leaf:
            value = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            value = 0.1 * rng.normal(size=shape)
        leaves[name] = value.astype(np.float32)
    return _unflatten(leaves)
