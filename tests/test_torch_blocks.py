"""The port's building blocks against ``smd_tpu/models/blocks.py``, float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.models import blocks as jb
from smd_tpu.models.fuse import _fuse_resblock
from smd_tpu_torch.models import blocks
from smd_tpu_torch.models.layers import LayerNorm
from smd_tpu_torch.utils.flax_params import load_flax_params


def _np_tree(params):
    rng = np.random.default_rng(11)
    # Non-zero biases and LN affines so every term is compared.
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.normal(size=p.shape))
        .astype(np.float32), params)


def test_positional_encoding_matches():
    ours = blocks.positional_encoding(32, 128)
    ref = np.asarray(jb.positional_encoding(32, 128))
    # float32; positions < 32 keep the sinusoid arguments small.
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("channels", [32, 128, 33])
def test_noise_encoding_matches(channels):
    noise = np.random.default_rng(0).uniform(0, 1, (16, 1)).astype(np.float32)
    ours = blocks.noise_encoding(torch.from_numpy(noise), channels)
    ref = np.asarray(jb.noise_encoding(jnp.asarray(noise), channels))
    assert ours.shape == ref.shape
    # The x5000 scale puts sinusoid arguments near 5000 rad, where one ulp
    # of a frequency (torch's and XLA's float32 exp differ in a few) moves
    # the value by up to 5000 * 2**-23 * 63/64.
    np.testing.assert_allclose(ours.numpy(), ref, atol=6e-4)


def test_dense_film_matches():
    t = np.random.default_rng(1).uniform(0.05, 1, (4,)).astype(np.float32)
    mod = jb.DenseFiLM(embedding_channels=128, out_channels=48, sequence=True)
    params = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(t)))
    ref_scale, ref_shift = mod.apply(params, jnp.asarray(t))
    ours = load_flax_params(blocks.DenseFiLM(128, 48, sequence=True), params)
    with torch.no_grad():
        scale, shift = ours(torch.from_numpy(t))
    assert scale.shape == (4, 1, 48)
    # float32; carries the noise embedding's difference (up to 6e-4 in a
    # few channels, see test_noise_encoding_matches) through three Dense
    # layers.
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale),
                               atol=1e-3)
    np.testing.assert_allclose(shift.numpy(), np.asarray(ref_shift),
                               atol=1e-3)


def _resblock_inputs(width_in):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 8, width_in)).astype(np.float32)
    scale = (1 + 0.2 * rng.normal(size=(3, 1, 32))).astype(np.float32)
    shift = (0.2 * rng.normal(size=(3, 1, 32))).astype(np.float32)
    return x, scale, shift


@pytest.mark.parametrize("width_in", [32, 24])
def test_dense_resblock_matches(width_in):
    x, scale, shift = _resblock_inputs(width_in)
    if width_in != 32:
        # The same (scale, shift) conditions both halves, so a block that
        # changes width takes scalars (with a shortcut projection).
        scale, shift = np.float32(1.5), np.float32(0.25)
    mod = jb.DenseResBlock(32)
    params = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(scale), jnp.asarray(shift)))
    ref = mod.apply(params, jnp.asarray(x), jnp.asarray(scale),
                    jnp.asarray(shift))
    ours = load_flax_params(blocks.DenseResBlock(width_in, 32), params)
    with torch.no_grad():
        out = ours(torch.from_numpy(x), torch.as_tensor(scale),
                   torch.as_tensor(shift))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)  # float32, two 32-wide products


def test_fused_dense_resblock_matches():
    """FusedDenseResBlock from DenseResBlock weights, against both the JAX
    fused block and the JAX standard block."""
    x, scale, shift = _resblock_inputs(32)
    std = jb.DenseResBlock(32)
    params = _np_tree(std.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(scale), jnp.asarray(shift)))
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    ref_std = std.apply(params, *args)
    fused_params = {"params": _fuse_resblock(params["params"])}
    ref_fused = jb.FusedDenseResBlock(32).apply(fused_params, *args)
    ours = load_flax_params(blocks.FusedDenseResBlock(32), fused_params)
    with torch.no_grad():
        out = ours(torch.from_numpy(x), torch.from_numpy(scale),
                   torch.from_numpy(shift))
    # float32; LN's two-pass variance (kernel) against Flax's one-pass.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_fused), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_std), atol=1e-5,
                               rtol=1e-5)


def test_layernorm_matches_flax():
    import flax.linen as fnn
    x = np.random.default_rng(3).normal(2.0, 3.0, (5, 40)).astype(np.float32)
    mod = fnn.LayerNorm()
    params = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = mod.apply(params, jnp.asarray(x))
    ours = load_flax_params(LayerNorm(40), params)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)  # float32
