"""The port's reference-checkpoint converter against ``smd_tpu``'s, on the
CPU.

The msgpack reader against ``flax.serialization.msgpack_restore`` on seeded
trees (every type flax writes, bf16, a chunked array); then, over
``tests/test_convert.py``'s cases, the port's module call order against
``linen_call_order``, the converted leaves against the JAX converter's
(exactly), the converted model's forward against JAX's ``apply`` (1e-5),
both mismatch errors, and ``python -m
smd_tpu_torch.scripts.convert_reference_checkpoint`` in process against
``scripts/convert_reference_checkpoint.py`` on one msgpack checkpoint.
"""
import functools
import importlib.util
import pickle
import sys
from pathlib import Path

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.models import get_model as jax_get_model
from smd_tpu.utils import convert as jconvert
from smd_tpu.utils import io as jio
from smd_tpu_torch.models import get_model
from smd_tpu_torch.scripts import convert_reference_checkpoint as script
from smd_tpu_torch.utils import convert, msgpack
from smd_tpu_torch.utils import io as io_lib
from smd_tpu_torch.utils.flax_params import flatten, load_flax_params
from test_convert import _to_old_format

ROOT = Path(__file__).resolve().parent.parent

# tests/test_convert.py's cases (test_convert_roundtrip).
CASES = {
    "DenseDDPM": (dict(num_layers=2, mlp_dims=32), (10,), True),
    "TransformerDDPM": (dict(num_layers=2, num_heads=4, num_mlp_layers=2,
                             mlp_dims=64), (8, 6), True),
    "TransformerMDN": (dict(num_layers=1, num_heads=2, num_mlp_layers=1,
                            mlp_dims=32, mdn_mixtures=3), (8, 6), False),
}


# -- msgpack -------------------------------------------------------------------

def _seeded_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "Dense_0": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                        "bias": np.zeros(4, np.float32)},
            "ints": rng.integers(-9, 9, (2, 3, 2)).astype(np.int64),
            "bytes8": rng.integers(0, 255, 7).astype(np.uint8),
            "half": rng.normal(size=5).astype(np.float16),
            "wide": rng.normal(size=(2, 2)),
            "flags": rng.random(6) > 0.5,
            "complex": (rng.normal(size=3) + 1j).astype(np.complex64),
            "empty": np.zeros((0, 3), np.float32),
            "scalar0d": np.float32(1.5) * np.ones((), np.float32),
        },
        "step": 1234567, "neg": -33, "small": -5, "big": 2 ** 40,
        "lr": 0.25, "name": "checkpoint_" + "x" * 40, "raw": b"\x00\x01",
        "none": None, "yes": True, "no": False, "cplx": complex(1.5, -2.0),
        "npscalar": np.int32(7), "npfloat": np.float64(2.5),
        "list": [1, "two", 3.0, [4, None]],
        "long_list": list(range(20)), "long_str": "y" * 300,
        "wide_map": {str(i): i for i in range(20)},
        "opt": {"0": {"target": {"params": {"x": np.arange(3.0)}}}},
    }


def _assert_same(ours, ref, path="root"):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            _assert_same(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, ref)
    else:
        assert type(ours) is type(ref) and ours == ref, (path, ours, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_msgpack_reader_equals_flax(seed):
    data = fser.msgpack_serialize(_seeded_tree(seed))
    _assert_same(msgpack.restore(data), fser.msgpack_restore(data))


def test_msgpack_reader_joins_chunked_arrays(monkeypatch):
    """flax chunks arrays beyond its limit (2 GiB; 64 bytes here) into
    dicts of flat chunks, at every level of dicts."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": {"c": np.arange(40, dtype=np.int32).reshape(2, 4, 5),
                  "small": np.ones(3, np.float32)}}
    data = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    ours = msgpack.restore(data)
    _assert_same(ours, fser.msgpack_restore(data))
    np.testing.assert_array_equal(ours["a"], tree["a"])


def test_msgpack_reader_reads_bf16_as_its_float32_values():
    x = jnp.asarray(np.linspace(-3, 3, 11, dtype=np.float32), jnp.bfloat16)
    data = fser.msgpack_serialize({"w": np.asarray(x)})
    ours = msgpack.restore(data)["w"]
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(
        ours, np.asarray(fser.msgpack_restore(data)["w"], np.float32))


def test_msgpack_reader_refuses_truncated_data():
    data = fser.msgpack_serialize(_seeded_tree(0))
    with pytest.raises(ValueError, match="ends inside"):
        msgpack.restore(data[:-5])
    with pytest.raises(ValueError, match="goes on after"):
        msgpack.restore(data + b"\x00")


# -- the converter -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_side(name):
    kw, shape, cond = CASES[name]
    model = jax_get_model(name, **kw)
    x = jnp.zeros((1, *shape))
    args = (x, jnp.zeros((1, *([1] * len(shape))))) if cond else (x,)
    template, order = jconvert.linen_call_order(
        model, jax.random.PRNGKey(0), *args)
    return model, template, order


def _port_side(name):
    kw, shape, cond = CASES[name]
    model = get_model(name, device="cpu", data_channels=shape[-1], **kw)
    x = torch.zeros((1, *shape))
    args = (x, torch.zeros((1, *([1] * len(shape))))) if cond else (x,)
    template, order = convert.module_call_order(model, *args)
    return model, template, order


def _old_tree(template, order, seed):
    """An old-flax tree of the template's shapes, values from a seed."""
    rng = np.random.default_rng(seed)
    values = jax.tree_util.tree_map(
        lambda p: (0.2 * rng.normal(size=np.shape(p))).astype(np.float32),
        template)
    return _to_old_format(values, order)


@pytest.mark.parametrize("name", sorted(CASES))
def test_call_order_equals_linen(name):
    _, _, ref = _jax_side(name)
    _, _, ours = _port_side(name)
    assert ours == ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_converted_leaves_and_forward_equal_jax(name):
    jmodel, jtemplate, jorder = _jax_side(name)
    model, template, order = _port_side(name)
    old = _old_tree(jtemplate, jorder, seed=len(name))
    ref = jconvert.convert_params(old, jtemplate, jorder)
    ours = convert.convert_params(old, template, order)
    ref_leaves, our_leaves = flatten(ref), flatten(ours)
    assert set(our_leaves) == set(ref_leaves)
    for key, want in ref_leaves.items():
        assert our_leaves[key].dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(our_leaves[key], np.asarray(want))
    load_flax_params(model, ours)
    kw, shape, cond = CASES[name]
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, *shape)).astype(np.float32)
    c = rng.uniform(0.1, 0.9, (3, *([1] * len(shape)))).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(c)) if cond else (jnp.asarray(x),)
    targs = (torch.from_numpy(x), torch.from_numpy(c)) if cond else \
        (torch.from_numpy(x),)
    want = jax.tree_util.tree_leaves(jmodel.apply(ref, *jargs))
    with torch.no_grad():
        got = model(*targs)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 1e-5 * np.linalg.norm(b)


def _corrupt_kernel(node):
    for k, v in node.items():
        if isinstance(v, dict):
            if _corrupt_kernel(v):
                return True
        elif k == "kernel":
            node[k] = v[:, :-1]
            return True
    return False


def _drop_bias(node):
    for k, v in list(node.items()):
        if isinstance(v, dict):
            if _drop_bias(v):
                return True
        elif k == "bias":
            del node[k]
            return True
    return False


@pytest.mark.parametrize("fault,message", [
    (_corrupt_kernel, "Shape mismatch pairing"),
    (_drop_bias, "Parameter count mismatch")])
def test_mismatches_raise_jax_errors(fault, message):
    _, jtemplate, jorder = _jax_side("DenseDDPM")
    _, template, order = _port_side("DenseDDPM")
    old = _old_tree(jtemplate, jorder, seed=1)
    fault(old)
    with pytest.raises(ValueError, match=message) as ref:
        jconvert.convert_params(old, jtemplate, jorder)
    with pytest.raises(ValueError, match=message) as ours:
        convert.convert_params(old, template, order)
    assert str(ours.value) == str(ref.value)


def _jax_script():
    """``scripts/convert_reference_checkpoint.py`` as one module (its absl
    flags are global: tests/test_convert.py loads it under this name)."""
    if "convert_cli" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "convert_cli", ROOT / "scripts" / "convert_reference_checkpoint.py")
        sys.modules["convert_cli"] = spec.loader.load_module("convert_cli")
    return sys.modules["convert_cli"]


@pytest.mark.parametrize("use_ema", [True, False])
def test_script_writes_the_jax_scripts_params(tmp_path, use_ema):
    """A msgpack checkpoint of the reference's (optimizer, ema,
    early_stop) tuple: the port's script in process and the JAX script
    write pickles equal leaf for leaf, which both packages load; the EMA
    params unless ``--nouse_ema``."""
    from absl import flags
    _, jtemplate, jorder = _jax_side("TransformerDDPM")
    live = _old_tree(jtemplate, jorder, seed=2)
    ema = _old_tree(jtemplate, jorder, seed=3)
    ckpt = tmp_path / "checkpoint_12"
    ckpt.write_bytes(fser.msgpack_serialize({
        "0": {"target": {"params": live}, "state": {"step": 12}},
        "1": {"mu": 0.999, "params": ema},
        "2": {"best_metric": 0.5, "patience_count": 0}}))
    kw, shape, _ = CASES["TransformerDDPM"]
    common = [f"--checkpoint={ckpt}", "--architecture=TransformerDDPM",
              f"--num_layers={kw['num_layers']}",
              f"--num_heads={kw['num_heads']}",
              f"--num_mlp_layers={kw['num_mlp_layers']}",
              f"--mlp_dims={kw['mlp_dims']}",
              f"--data_shape={','.join(map(str, shape))}",
              "--use_ema" if use_ema else "--nouse_ema"]
    mod = _jax_script()
    flags.FLAGS(["convert", *common, f"--output={tmp_path}/jax.pkl"])
    try:
        mod.main([])
    finally:
        flags.FLAGS.unparse_flags()
    script.main(["convert", *common, f"--output={tmp_path}/ours.pkl",
                 "--device=cpu"])
    ref = flatten(jio.load(str(tmp_path / "jax.pkl")))
    for loader in (io_lib.load, jio.load):
        ours = flatten(loader(str(tmp_path / "ours.pkl")))
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key])
    source = flatten(ema if use_ema else live)
    with open(tmp_path / "ours.pkl", "rb") as f:
        kernel = flatten(pickle.load(f))["Dense_1.kernel"]
    assert any(np.array_equal(kernel, v) for v in source.values())
    model = get_model("TransformerDDPM", device="cpu", data_channels=6, **kw)
    load_flax_params(model, io_lib.load(str(tmp_path / "ours.pkl")))
