"""Convert standard-layout params to the fused and int8 serving layouts.

A copy of ``fuse_attention_params``, ``fuse_head_params``,
``quantize_head_params`` and ``calibrate_head_act_scales`` from
``smd_tpu/models/fuse.py``, on Flax params trees (nested dicts of numpy
arrays), so that standard-layout weights serve through the kernels. The fused layouts
are a pure reshape/rename:

- ``TransformerLayer_k/{LayerNorm_0, MultiHeadSelfAttention_0/{qkv,out},
  LayerNorm_1, Dense_0, Dense_1}`` (qkv kernel (E,3,H,Dh), out kernel
  (H,Dh,E)) -> ``FusedTransformerLayer_k/{wqkv (E,3E), bqkv, wout (E,E),
  bout, ln_scale, ln_bias, LayerNorm_0, Dense_0, Dense_1}``;
- ``DenseResBlock_k`` -> ``FusedDenseResBlock_k/{ln1_scale, ln1_bias, w1,
  b1, ln2_scale, ln2_bias, w2, b2}``.

The int8 layout quantizes the head's kernels with ``ops.quant``'s
``quantize_weight`` (on the CPU, float32, round half to even: bit for bit
the JAX package's codes and scales):

- ``DenseResBlock_k`` -> ``QuantDenseResBlock_k/{LayerNorm_0, LayerNorm_1,
  w1_q, w1_scale, b1, a1_scale, w2_q, w2_scale, b2, a2_scale}``, with the
  activation scales at 1.0 until calibrated.
"""
from __future__ import annotations

import numpy as np
import torch

from smd_tpu_torch.models.blocks import QuantDenseResBlock
from smd_tpu_torch.ops.quant import quantize_weight
from smd_tpu_torch.utils.flax_params import load_flax_params

__all__ = ["fuse_attention_params", "fuse_head_params",
           "quantize_head_params", "calibrate_head_act_scales"]


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


def _quantize_resblock(block):
    """DenseResBlock params -> QuantDenseResBlock int8 layout."""
    if "Dense_2" in block:
        raise ValueError("the quantized head has no shortcut projection")
    out = {"LayerNorm_0": dict(block["LayerNorm_0"]),
           "LayerNorm_1": dict(block["LayerNorm_1"])}
    for i in (1, 2):
        dense = block[f"Dense_{i - 1}"]
        w_q, scale = quantize_weight(torch.from_numpy(
            np.asarray(dense["kernel"], np.float32)))
        out[f"w{i}_q"], out[f"w{i}_scale"] = w_q.numpy(), scale.numpy()
        out[f"b{i}"] = np.asarray(dense["bias"])
        out[f"a{i}_scale"] = np.asarray(1.0, np.float32)
    return out


def quantize_head_params(params):
    """Rewrite DenseResBlock_k subtrees into int8 QuantDenseResBlock_k.

    Loadable by the same architecture with ``quantized_head=True``. Keep the
    int8 leaves int8; calibrate the activation scales (1.0 here) with
    ``calibrate_head_act_scales`` before static-scale serving.
    """
    return _rewrite(params, "DenseResBlock_", "QuantDenseResBlock_",
                    _quantize_resblock)


def calibrate_head_act_scales(model, params, batches, margin=1.0, rounds=2):
    """Calibrate the quantized head's static int8 activation scales.

    model: the port's architecture with ``quantized_head=True``, on the
    device to calibrate on; params: the tree from ``quantize_head_params``;
    batches: (x, t) calibration inputs (tensors or arrays), for a diffusion
    sampler states and noise levels spanning its trajectory. Each round
    loads ``params`` into ``model``, runs every batch with each
    QuantDenseResBlock observing the amax of its pre-matmul activations,
    and returns the tree with ``a{1,2}_scale = max(margin * amax / 127,
    1e-12)`` (reckoned in float64, stored in float32, as the JAX package
    does). The second round re-observes under the first round's scales,
    since the first matmul's scale of 1.0 distorts what follows it. The
    model is left holding the last round's input tree.
    """
    batches = list(batches)
    for _ in range(max(rounds, 1)):
        params = _calibrate_once(model, params, batches, margin)
    return params


def _calibrate_once(model, params, batches, margin):
    load_flax_params(model, params)
    blocks = {name: m for name, m in model.named_modules()
              if isinstance(m, QuantDenseResBlock)}
    device = next(model.parameters()).device
    for m in blocks.values():
        m.observe, m.amax = True, {}
    try:
        with torch.no_grad():
            for x, t in batches:
                model(torch.as_tensor(x, device=device),
                      torch.as_tensor(t, device=device))
    finally:
        for m in blocks.values():
            m.observe = False
    has_root = "params" in params
    out = {k: dict(v) if isinstance(v, dict) else v
           for k, v in params.items()}
    for name, m in blocks.items():
        node = out["params"] if has_root else out
        for part in name.split("."):
            node[part] = dict(node[part])
            node = node[part]
        for key, seen in m.amax.items():
            scale = max(margin * float(seen) / 127.0, 1e-12)
            node[key.replace("_amax", "_scale")] = np.asarray(scale,
                                                              np.float32)
    return out
