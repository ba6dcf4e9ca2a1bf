"""Convert reference flax-0.3 checkpoints into the port's params (port of
``smd_tpu/utils/convert.py``).

The reference saves ``flax.training.checkpoints.save_checkpoint`` msgpack of
a ``(optimizer, ema_helper, early_stop)`` tuple (``train_ncsn.py:397-399``)
where the param tree uses old ``flax.nn`` auto-naming: every submodule call
gets ``<ClassName>_<k>`` with a call-order cursor shared across classes.
The port's modules carry Linen's names (per type, nested per module).

Both layouts enumerate parameters in *call order*, the old one by its
numeric suffixes, the port's by the order its modules run in one forward
(``module_call_order``, forward pre-hooks, where the JAX package records
Linen's method calls), so the leaves pair positionally with shape checks,
the old separate query/key/value attention kernels fused into the combined
qkv kernel. A shape mismatch aborts loudly. The result is a Flax-layout
numpy tree (``{"params": ...}``) that ``utils/flax_params.load_flax_params``
loads into the port's module, and the JAX package into its own. The
checkpoint is read without flax (``utils/msgpack.py``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from smd_tpu_torch.utils import msgpack
from smd_tpu_torch.utils.flax_params import to_flax_tree

__all__ = ["flatten_old_tree", "convert_params", "module_call_order",
           "load_reference_checkpoint"]

_SUFFIX_RE = re.compile(r"^(.*)_(\d+)$")


def _order_key(name: str) -> Tuple[int, str]:
    m = _SUFFIX_RE.match(name)
    if m:
        return (int(m.group(2)), m.group(1))
    return (1 << 30, name)


def flatten_old_tree(tree: Dict[str, Any], prefix=()
                     ) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """Flatten an old-flax param dict in call order (numeric-suffix sort).

    Within an attention module the q/k/v/out entries keep their given order
    (query, key, value, out).
    """
    out = []
    leaf_names = [k for k, v in tree.items() if not isinstance(v, dict)]
    sub_names = [k for k, v in tree.items() if isinstance(v, dict)]

    # Old attention modules have children named query/key/value/out.
    attn_order = {"query": 0, "key": 1, "value": 2, "out": 3}
    if set(sub_names) <= set(attn_order) and sub_names:
        sub_sorted = sorted(sub_names, key=lambda n: attn_order[n])
    else:
        sub_sorted = sorted(sub_names, key=_order_key)

    # kernel before bias mirrors Linen's creation order.
    leaf_rank = {"kernel": 0, "bias": 1, "scale": 0}
    leaf_sorted = sorted(leaf_names, key=lambda n: (leaf_rank.get(n, 2), n))

    for name in leaf_sorted:
        out.append((prefix + (name,), np.asarray(tree[name])))
    for name in sub_sorted:
        out.extend(flatten_old_tree(tree[name], prefix + (name,)))
    return out


def module_call_order(model: torch.nn.Module, *args, **kwargs):
    """Run one forward of ``model`` on ``args`` while recording the order in
    which its modules are first called.

    Returns (the model's params as a Flax-layout numpy tree, the ordered
    list of module path tuples, the root left out): the counterpart of
    the JAX package's ``linen_call_order``, needed because both trees
    iterate in another order than the modules' calls, which the old
    names' suffixes encode.
    """
    names = {m: tuple(n.split(".")) if n else () for n, m in
             model.named_modules()}
    rows: List[Tuple[str, ...]] = []
    hooks = [m.register_forward_pre_hook(
        lambda module, _: rows.append(names[module]))
        for m in model.modules()]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for hook in hooks:
            hook.remove()
    seen, order = set(), []
    for p in rows:
        if p and p not in seen:
            seen.add(p)
            order.append(p)
    return to_flax_tree(model), order


_LEAF_RANK = {"kernel": 0, "scale": 0, "embedding": 0, "bias": 1}


def _flatten_new_template(params, call_order
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """Flatten the template tree in module-call order."""
    out = []
    for path in call_order:
        node = params
        ok = True
        for p in path:
            if p not in node:
                ok = False
                break
            node = node[p]
        if not ok:
            continue  # param-less module
        leaves = [(k, v) for k, v in node.items()
                  if not (isinstance(v, dict) or hasattr(v, "items"))]
        for k, v in sorted(leaves, key=lambda kv: (_LEAF_RANK.get(
                kv[0], 2), kv[0])):
            out.append((path + (k,), v))
    return out


def _fuse_qkv(old_leaves):
    """Fuse consecutive (query, key, value) kernels+biases into qkv slots.

    Old: .../SelfAttention_k/{query,key,value,out}/{kernel,bias}
    New: .../MultiHeadSelfAttention_k/{qkv/kernel (in,3,H,D), out/...}
    """
    fused = []
    i = 0
    while i < len(old_leaves):
        path, arr = old_leaves[i]
        if len(path) >= 2 and path[-2] == "query" and path[-1] == "kernel":
            # flatten's order: query/kernel, query/bias, key/kernel,
            # key/bias, value/kernel, value/bias
            block = dict()
            base = path[:-2]
            j = i
            while j < len(old_leaves):
                p2, a2 = old_leaves[j]
                if p2[:-2] != base or p2[-2] not in ("query", "key", "value"):
                    break
                block[(p2[-2], p2[-1])] = a2
                j += 1
            qkv_kernel = np.stack([block[("query", "kernel")],
                                   block[("key", "kernel")],
                                   block[("value", "kernel")]], axis=1)
            fused.append((base + ("qkv", "kernel"), qkv_kernel))
            if ("query", "bias") in block:
                qkv_bias = np.stack([block[("query", "bias")],
                                     block[("key", "bias")],
                                     block[("value", "bias")]], axis=0)
                fused.append((base + ("qkv", "bias"), qkv_bias))
            i = j
        else:
            fused.append((path, arr))
            i += 1
    return fused


def convert_params(old_params: Dict[str, Any], new_template, call_order):
    """Positionally map an old-flax param tree onto a template.

    Args:
        old_params: nested dict from the reference checkpoint
            (``optimizer.target.params`` equivalent).
        new_template: the Flax-layout tree of the matching architecture
            (same hyperparameters), e.g. ``module_call_order``'s.
        call_order: module path order from ``module_call_order``.

    Returns:
        A tree with the template's structure holding the old values.
    """
    old_leaves = _fuse_qkv(flatten_old_tree(old_params))
    tpl = new_template["params"] if "params" in new_template else new_template
    new_slots = _flatten_new_template(tpl, call_order)

    if len(old_leaves) != len(new_slots):
        raise ValueError(
            f"Parameter count mismatch: reference has {len(old_leaves)} "
            f"leaves (after qkv fusion), target expects {len(new_slots)}. "
            "Check that the architecture hyperparameters match the "
            "checkpoint's flags.")

    assigned = {}
    for (old_path, arr), (new_path, slot) in zip(old_leaves, new_slots):
        if tuple(arr.shape) != tuple(slot.shape):
            raise ValueError(
                f"Shape mismatch pairing {'/'.join(old_path)} "
                f"{arr.shape} -> {'/'.join(new_path)} {slot.shape}")
        assigned[new_path] = arr.astype(np.asarray(slot).dtype)

    def rebuild(node, prefix):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = rebuild(v, prefix + (k,))
            else:
                out[k] = assigned[prefix + (k,)]
        return out

    rebuilt = rebuild(tpl, ())
    if "params" in new_template:
        return {"params": rebuilt}
    return rebuilt


def load_reference_checkpoint(path: str):
    """Read a reference msgpack checkpoint into nested python dicts."""
    with open(path, "rb") as f:
        return msgpack.restore(f.read())
