"""The port's TransformerDDPM against ``smd_tpu``'s, with weights carried over.

Standard layout, and the fused serving layout built from the same weights
with ``fuse_attention_params``/``fuse_head_params``; float32 on the CPU, where
the port's fused layers take the kernels' plain versions and the JAX
package's take their ``_reference`` formulations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.models import get_model as jax_get_model
from smd_tpu.models.fuse import fuse_attention_params as jax_fuse_attention
from smd_tpu.models.fuse import fuse_head_params as jax_fuse_head
from smd_tpu_torch.models import get_model
from smd_tpu_torch.models.fuse import fuse_attention_params, fuse_head_params
from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                             random_flax_params)

KW = dict(num_layers=2, num_heads=4, num_mlp_layers=2, mlp_dims=64,
          embed_channels=32)
B, S, C = 3, 16, 8


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    # Noise levels as the sampler gives them: sqrt(abar) in (0, 1].
    t = rng.uniform(0.05, 1.0, size=(B, 1, 1)).astype(np.float32)
    return x, t


def _jax_params(x, t):
    model = jax_get_model("TransformerDDPM", **KW)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t))
    params = jax.tree_util.tree_map(np.asarray, params)
    # Non-zero biases and LN affines so every term is compared.
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.normal(size=p.shape)).astype(np.float32),
        params)


def _torch_model(tree, **extra):
    model = get_model("TransformerDDPM", device="cpu", data_channels=C,
                      **KW, **extra)
    return load_flax_params(model, tree).eval()


@pytest.mark.parametrize("layout", ["standard", "fused"])
def test_model_matches_jax(layout):
    x, t = _inputs()
    params = _jax_params(x, t)
    ref = jax_get_model("TransformerDDPM", **KW).apply(
        params, jnp.asarray(x), jnp.asarray(t))
    if layout == "fused":
        tree = fuse_head_params(fuse_attention_params(params))
        model = _torch_model(tree, fused_attention=True, fused_head=True)
    else:
        model = _torch_model(params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t))
    assert out.dtype == torch.float32 and out.shape == (B, S, C)
    # float32; the sinusoidal noise embedding reaches arguments of ~5000 rad,
    # where torch's and XLA's exp differ by an ulp in a few frequencies.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_fused_jax_layout_matches_jax_fused_model():
    """A tree already in the fused layout (from the JAX converter) loads and
    matches the JAX fused model."""
    x, t = _inputs(1)
    params = _jax_params(x, t)
    fused = jax_fuse_head(jax_fuse_attention(params))
    ref = jax_get_model("TransformerDDPM", fused_attention=True,
                        fused_head=True, **KW).apply(
        fused, jnp.asarray(x), jnp.asarray(t))
    model = _torch_model(fused, fused_attention=True, fused_head=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)  # float32, as above


def test_port_converter_matches_jax_converter():
    x, t = _inputs()
    params = _jax_params(x, t)
    ours = fuse_head_params(fuse_attention_params(params))
    theirs = jax_fuse_head(jax_fuse_attention(params))
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, u), (_, v) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_plain_route_equals_kernel_route_on_cpu():
    """On the CPU the wrappers take the plain versions, so both routes of
    the fused model agree exactly and launch nothing."""
    from smd_tpu_torch.ops import fused_attention as fat
    from smd_tpu_torch.ops import fused_film_resblock as ffr
    model = get_model("TransformerDDPM", device="cpu", data_channels=C,
                      fused_attention=True, fused_head=True, **KW)
    load_flax_params(model, random_flax_params(model, seed=3))
    x, t = _inputs(2)
    before = (fat.fused_ln_attention.launches,
              ffr.fused_ln_film_swish_dense.launches)
    with torch.no_grad():
        a = model(torch.from_numpy(x), torch.from_numpy(t))
        b = model.use_plain_ops(True)(torch.from_numpy(x),
                                      torch.from_numpy(t))
    model.use_plain_ops(False)
    assert torch.equal(a, b)
    assert (fat.fused_ln_attention.launches,
            ffr.fused_ln_film_swish_dense.launches) == before


def test_converter_rejects_unused_and_missing_leaves():
    model = get_model("TransformerDDPM", device="cpu", data_channels=C, **KW)
    tree = random_flax_params(model, seed=0)
    extra = {"params": dict(tree["params"], Stray_0={"kernel": np.ones(2)})}
    with pytest.raises(ValueError, match="Stray_0.kernel"):
        load_flax_params(model, extra)
    short = {"params": {k: v for k, v in tree["params"].items()
                        if k != "Dense_1"}}
    with pytest.raises(ValueError, match="Dense_1"):
        load_flax_params(model, short)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["params"]["Dense_1"]["kernel"] = np.ones((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(model, bad)


def test_bf16_model_runs_and_keeps_fp32_head():
    """bf16 compute with the params cast to bf16 (the serving setup):
    finite, float32 out, close to the float32 model."""
    model = get_model("TransformerDDPM", device="cpu", data_channels=C,
                      fused_attention=True, fused_head=True, **KW)
    load_flax_params(model, random_flax_params(model, seed=5))
    bf = get_model("TransformerDDPM", device="cpu", data_channels=C,
                   fused_attention=True, fused_head=True,
                   dtype=torch.bfloat16, **KW)
    bf.load_state_dict(model.state_dict())
    bf = bf.to(torch.bfloat16)
    x, t = _inputs(4)
    with torch.no_grad():
        ref = model(torch.from_numpy(x), torch.from_numpy(t))
        # t stays float32 here: rounded to bf16, 5000*t moves the noise
        # embedding's fastest sinusoids by whole radians.
        out = bf(torch.from_numpy(x).bfloat16(), torch.from_numpy(t))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # bf16 keeps 8 bits of mantissa through 2 layers and the head.
    assert (out - ref).abs().max() < 0.1 * ref.abs().max()


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("TransformerDDPM", device="cpu", data_channels=C,
                  quantized_head=True, **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("DenseDDPM", device="cpu")
    with pytest.raises(ValueError):
        get_model("NoSuchModel", device="cpu")
