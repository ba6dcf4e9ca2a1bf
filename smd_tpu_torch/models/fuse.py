"""Convert standard-layout params to the fused serving layout.

A copy of ``fuse_attention_params`` and ``fuse_head_params`` from
``smd_tpu/models/fuse.py``: numpy on Flax params trees (nested dicts), so
that standard-layout weights serve through the kernels. A pure
reshape/rename:

- ``TransformerLayer_k/{LayerNorm_0, MultiHeadSelfAttention_0/{qkv,out},
  LayerNorm_1, Dense_0, Dense_1}`` (qkv kernel (E,3,H,Dh), out kernel
  (H,Dh,E)) -> ``FusedTransformerLayer_k/{wqkv (E,3E), bqkv, wout (E,E),
  bout, ln_scale, ln_bias, LayerNorm_0, Dense_0, Dense_1}``;
- ``DenseResBlock_k`` -> ``FusedDenseResBlock_k/{ln1_scale, ln1_bias, w1,
  b1, ln2_scale, ln2_bias, w2, b2}``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fuse_attention_params", "fuse_head_params"]


def _fuse_layer(layer):
    out = {}
    attn = layer["MultiHeadSelfAttention_0"]
    qkv_kernel = np.asarray(attn["qkv"]["kernel"])     # (E, 3, H, Dh)
    E = qkv_kernel.shape[0]
    out["wqkv"] = qkv_kernel.reshape(E, -1)
    out["bqkv"] = np.asarray(attn["qkv"]["bias"]).reshape(-1)
    out_kernel = np.asarray(attn["out"]["kernel"])     # (H, Dh, E)
    out["wout"] = out_kernel.reshape(-1, E)
    out["bout"] = np.asarray(attn["out"]["bias"]).reshape(-1)
    out["ln_scale"] = np.asarray(layer["LayerNorm_0"]["scale"])
    out["ln_bias"] = np.asarray(layer["LayerNorm_0"]["bias"])
    # The fused layer has one LayerNorm module: LayerNorm_1 -> LayerNorm_0.
    out["LayerNorm_0"] = dict(layer["LayerNorm_1"])
    out["Dense_0"] = dict(layer["Dense_0"])
    out["Dense_1"] = dict(layer["Dense_1"])
    return out


def _rewrite(params, prefix, new_prefix, convert):
    def rec(node):
        out = {}
        for k, v in node.items():
            if k.startswith(prefix):
                out[new_prefix + k[len(prefix):]] = convert(v)
            elif isinstance(v, dict):
                out[k] = rec(v)
            else:
                out[k] = v
        return out

    if "params" in params:
        return {"params": rec(params["params"]),
                **{k: v for k, v in params.items() if k != "params"}}
    return rec(params)


def fuse_attention_params(params):
    """Rewrite every TransformerLayer_k subtree into FusedTransformerLayer_k.

    Loadable by the same architecture with ``fused_attention=True``.
    """
    return _rewrite(params, "TransformerLayer_", "FusedTransformerLayer_",
                    _fuse_layer)


def _fuse_resblock(block):
    """DenseResBlock params -> FusedDenseResBlock flat layout (pure rename)."""
    if "Dense_2" in block:
        raise ValueError("the fused head has no shortcut projection")
    return {
        "ln1_scale": np.asarray(block["LayerNorm_0"]["scale"]),
        "ln1_bias": np.asarray(block["LayerNorm_0"]["bias"]),
        "w1": np.asarray(block["Dense_0"]["kernel"]),
        "b1": np.asarray(block["Dense_0"]["bias"]),
        "ln2_scale": np.asarray(block["LayerNorm_1"]["scale"]),
        "ln2_bias": np.asarray(block["LayerNorm_1"]["bias"]),
        "w2": np.asarray(block["Dense_1"]["kernel"]),
        "b2": np.asarray(block["Dense_1"]["bias"]),
    }


def fuse_head_params(params):
    """Rewrite DenseResBlock_k subtrees into FusedDenseResBlock_k.

    Loadable by the same architecture with ``fused_head=True``.
    """
    return _rewrite(params, "DenseResBlock_", "FusedDenseResBlock_",
                    _fuse_resblock)
