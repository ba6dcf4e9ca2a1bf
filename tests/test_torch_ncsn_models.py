"""The port's dense and convolutional networks against ``smd_tpu``'s.

DenseDDPM, DenseNCSN, ConvNCSN, ToyDDPM, ToyNCSN and ConvResBlock1D at
small widths, with the JAX weights carried over by
``utils/flax_params.load_flax_params``; float32 at the TransformerDDPM
test's tolerance, and the bf16 serving call (bf16 params and input, as
``serving_model_fn`` makes it) against JAX's ``model.apply`` on the same
bf16 tree. Also the layers they add, ``Conv`` and ``GroupNorm``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.models import ddpm as jddpm
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.models import blocks as jblocks
from smd_tpu.models import registry as jregistry
from smd_tpu_torch.models import (MODEL_REGISTRY, blocks, ddpm, get_model,
                                  registry)
from smd_tpu_torch.models.layers import Conv, GroupNorm
from smd_tpu_torch.utils.flax_params import load_flax_params

B, D = 3, 16          # dense networks: data width 16
CB, CL, CC = 4, 8, 6  # ConvNCSN: 4 x 8 x 6
DENSE_KW = dict(num_layers=2, mlp_dims=64)
# (architecture, kwargs, input shape, conditioning): DDPM networks take
# sqrt(abar) in (0, 1], score networks sigma.
CASES = {
    "DenseDDPM": (DENSE_KW, (B, D), "abar"),
    "ToyDDPM": (dict(num_layers=2), (B, 2), "abar"),
    "DenseNCSN": (DENSE_KW, (B, D), "sigma"),
    "ToyNCSN": (dict(num_layers=2, mlp_dims=32), (B, 2), "sigma"),
    "ConvNCSN": ({}, (CB, CL, CC), "sigma"),
}


# Each package on its own exp table: at the NCSN flagfiles' sigmas, up to
# 15, the x5000 encoding reaches 75,000 rad, and the table's one-ulp
# difference (see ``xla_frequencies``) grows with the argument; a score
# network's output, divided by sigma, read 1.37e-4 + 1.37e-4 |ref| at worst
# over 10 seeds; held to 3e-4.
LARGE_SIGMA_TOL = 3e-4


@pytest.fixture
def xla_frequencies(monkeypatch):
    """The port's sinusoidal embedding on XLA's float32 frequency table.

    torch's exp rounds the 64 frequencies of a 128-channel embedding
    correctly and XLA's differs by an ulp in 6 of them; at the x5000
    noise encoding's arguments that moves a few channels by up to 6e-4
    (``test_torch_blocks.py::test_noise_encoding_matches``, which holds the
    encoding itself). With the table shared, a network is held to the
    TransformerDDPM test's 1e-4."""
    def embedding(positions, channels):
        half = channels // 2
        freqs = torch.from_numpy(np.asarray(jnp.exp(
            jnp.arange(half) * -(jnp.log(10000.0) / float(half - 1)))))
        emb = positions.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
        if channels % 2:
            emb = torch.nn.functional.pad(emb, (0, 1))
        return emb
    monkeypatch.setattr(blocks, "sinusoidal_embedding", embedding)
    # The same encoding to sin's and cos's last ulp at 5000 rad.
    pos = np.float32([0.5, 3.0, 4999.0])
    np.testing.assert_allclose(
        embedding(torch.from_numpy(pos), 128).numpy(),
        np.asarray(jblocks.sinusoidal_embedding(jnp.asarray(pos), 128)),
        atol=1e-6)


def _inputs(shape, kind, seed=0, sigma_range=(0.01, 1.0)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    lo, hi = (0.05, 1.0) if kind == "abar" else sigma_range
    c = rng.uniform(lo, hi, size=(shape[0], 1)).astype(np.float32)
    return x, c


def _perturbed(tree, seed=7):
    """Non-zero biases, LN and GroupNorm affines, so every term counts."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.normal(size=p.shape))
        .astype(np.float32), tree)


def _close(out, ref, c, kind, tol):
    """The DDPM networks' output, or a score network's times sigma: its
    division by a sigma as small as 0.01 scales the trunk's float32
    rounding by up to 100."""
    ref = np.asarray(ref)
    if kind == "sigma":
        ones = (1,) * (ref.ndim - 1)
        sig = np.broadcast_to(np.asarray(c, np.float32).reshape(-1, *ones),
                              (ref.shape[0], *ones))
        out, ref = out * sig, ref * sig
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def _pair(name, x, c):
    kw, _, _ = CASES[name]
    jmodel = jax_get_model(name, **kw)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                    jnp.asarray(c)))
    model = get_model(name, device="cpu", data_channels=x.shape[-1], **kw)
    return jmodel, params, load_flax_params(model, params).eval()


@pytest.mark.parametrize("name", sorted(CASES))
def test_network_matches_jax(name, xla_frequencies):
    _, shape, kind = CASES[name]
    x, c = _inputs(shape, kind)
    jmodel, params, model = _pair(name, x, c)
    ref = jmodel.apply(params, jnp.asarray(x), jnp.asarray(c))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(c))
    assert out.dtype == torch.float32 and out.shape == shape
    # float32; the x5000 noise embedding's one-ulp exp channels
    # (tests/test_torch_blocks.py), as the TransformerDDPM test states.
    _close(out.numpy(), ref, c, kind, 1e-4)


@pytest.mark.parametrize("name", ["DenseNCSN", "ToyNCSN", "ConvNCSN"])
def test_score_network_at_the_flagfiles_sigmas(name):
    _, shape, _ = CASES[name]
    x, c = _inputs(shape, "sigma", seed=4, sigma_range=(1.0, 15.0))
    jmodel, params, model = _pair(name, x, c)
    ref = jmodel.apply(params, jnp.asarray(x), jnp.asarray(c))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LARGE_SIGMA_TOL, rtol=LARGE_SIGMA_TOL)


@pytest.mark.parametrize("name", ["DenseNCSN", "ConvNCSN"])
@pytest.mark.parametrize("form", ["float", "0-d", "(B,)", "(B,1,...)"])
def test_score_networks_take_every_sigma_form(name, form, xla_frequencies):
    """sigma as a Python float, a 0-d tensor, (B,) or (B, 1, ...): the same
    result as JAX's for the form it takes ((B,) against (B, 1), which JAX's
    DenseNCSN cannot broadcast)."""
    _, shape, _ = CASES[name]
    x, c = _inputs(shape, "sigma", seed=2)
    jmodel, params, model = _pair(name, x, c)
    full = c.reshape(shape[0], *([1] * (len(shape) - 1)))
    ours_arg, ref_arg = {
        "float": (0.625, 0.625),
        "0-d": (torch.tensor(0.625), jnp.asarray(0.625, jnp.float32)),
        "(B,)": (torch.from_numpy(c[:, 0]), jnp.asarray(c)),
        "(B,1,...)": (torch.from_numpy(full), jnp.asarray(full)),
    }[form]
    ref = jmodel.apply(params, jnp.asarray(x), ref_arg)
    with torch.no_grad():
        out = model(torch.from_numpy(x), ours_arg)
    sig = 0.625 if form in ("float", "0-d") else c
    _close(out.numpy(), ref, sig, "sigma", 1e-4)


def _dtypes_of(model, x, c):
    """The output dtype of each top-level submodule in a call."""
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen.setdefault(name, (out[0] if isinstance(out, tuple)
                                   else out).dtype)
        return record
    hooks = [m.register_forward_hook(hook(n))
             for n, m in model.named_children()]
    with torch.no_grad():
        out = model(x, c)
    for h in hooks:
        h.remove()
    return out, seen


@pytest.mark.parametrize("name", ["DenseDDPM", "DenseNCSN"])
def test_bf16_serving_call_follows_flax_promotion(name):
    """bf16 params and input, as ``serving_model_fn`` serves them: the input
    Dense computes in bf16, every DenseFiLM and DenseResBlock in float32 on
    params cast up, the final LN and Dense in float32 (from the blocks);
    sigma is rounded to bf16 before the x5000 noise encoding. Held against
    JAX's ``model.apply`` with the bf16 tree and input."""
    _, shape, kind = CASES[name]
    x, c = _inputs(shape, kind, seed=3)
    jmodel, params, model = _pair(name, x, c)
    jbf = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                 params)
    ref = np.asarray(jmodel.apply(
        jbf, jnp.asarray(x, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16)),
        np.float32)
    model = model.to(torch.bfloat16)
    out, seen = _dtypes_of(model, torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(c).bfloat16())
    assert seen["Dense_0"] == torch.bfloat16
    assert seen["DenseFiLM_0"] == seen["DenseResBlock_1"] == torch.float32
    assert seen["LayerNorm_0"] == seen["Dense_1"] == torch.float32
    assert out.dtype == torch.float32
    # The input Dense's bf16 output may round either side of a bf16 boundary
    # between the two packages' float32 sums, which the float32 blocks carry
    # on: 3.6e-5 of the output's scale at worst over 10 seeds.
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=5e-4 * scale,
                               rtol=0)


def test_bf16_noise_encoding_scales_as_jax():
    """JAX rounds the weakly typed 5000.0 to the noise's bf16 (4992) before
    the product; so does the port. A float32 5000 would move the arguments
    by up to 8 rad, past bf16's spacing of 16-32 rad there."""
    t = np.random.default_rng(6).uniform(0.05, 1.0, 64).astype(np.float32)
    tb = torch.from_numpy(t).bfloat16()
    ref = np.asarray(jblocks.noise_encoding(jnp.asarray(t, jnp.bfloat16),
                                            128))
    ours = blocks.noise_encoding(tb, 128)
    np.testing.assert_array_equal(
        (torch.tensor(5000.0, dtype=torch.bfloat16) * tb).float().numpy(),
        np.asarray(5000.0 * jnp.asarray(t, jnp.bfloat16), np.float32))
    # Equal arguments, each package's exp table: the tolerance of
    # test_torch_blocks.py::test_noise_encoding_matches (a float32 5000
    # moves whole channels, by up to 2).
    np.testing.assert_allclose(ours.numpy(), ref, atol=6e-4)


def test_registry_builds_every_network_but_the_mdn():
    assert set(registry.MODEL_REGISTRY) == set(jregistry.MODEL_REGISTRY)
    for name in ("DenseDDPM", "DenseNCSN", "ConvNCSN", "ToyDDPM", "ToyNCSN"):
        model = get_model(name, device="cpu", data_channels=4, num_layers=1,
                          mlp_dims=16, num_heads=8, num_mlp_layers=2,
                          remat=True, dtype=torch.bfloat16)
        assert type(model) is MODEL_REGISTRY[name]
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    # The MDN, ported since, builds with the JAX defaults (6 causal layers
    # of 8 heads, 2 x 2048 resblocks, 100 mixtures, a 128-position cache).
    mdn = get_model("TransformerMDN", device="cpu", data_channels=4)
    assert type(mdn) is MODEL_REGISTRY["TransformerMDN"]
    assert len(mdn.TransformerEncoder_0.layer_names) == 6
    assert mdn.TransformerEncoder_0.TransformerLayer_0 \
        .MultiHeadSelfAttention_0.causal
    assert len(mdn.block_names) == 2 and mdn.max_decode_length == 128
    assert mdn.mdn.Dense_0.kernel.shape == (2048, 400)
    # The toy defaults, as the JAX fields give them.
    toy = get_model("ToyNCSN", device="cpu", data_channels=2)
    assert len(toy.block_names) == 3 and toy.Dense_0.kernel.shape == (2, 256)


@pytest.mark.parametrize("k", [2, 3])
def test_conv_same_padding_matches_flax(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32)
    conv = fnn.Conv(4, kernel_size=(k,))
    params = _perturbed(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = conv.apply(params, jnp.asarray(x))
    ours = load_flax_params(Conv(5, 4, k), params)
    assert tuple(ours.kernel.shape) == (k, 5, 4)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("channels,dtype", [(64, np.float32), (8, np.float32),
                                            (64, jnp.bfloat16)])
def test_group_norm_matches_flax(channels, dtype):
    rng = np.random.default_rng(channels)
    x = (rng.normal(size=(3, 10, channels)) * 2 + 0.5).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=min(32, channels))
    params = _perturbed(gn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jparams = jax.tree_util.tree_map(lambda p: jnp.asarray(p, dtype), params)
    ref = np.asarray(gn.apply(jparams, jnp.asarray(x, dtype)), np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ours = load_flax_params(GroupNorm(channels, min(32, channels)),
                            params).to(tdt)
    with torch.no_grad():
        out = ours(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    # float32 statistics in both; bf16 out rounds once (2**-8 relative).
    tol = 1e-5 if tdt == torch.float32 else 1e-2
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)


def test_conv_resblock_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 9, 64)).astype(np.float32)
    jblock = jddpm.ConvResBlock1D(64)
    params = _perturbed(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = jblock.apply(params, jnp.asarray(x))
    ours = load_flax_params(ddpm.ConvResBlock1D(64, 64), params)
    assert ours.GroupNorm_0.num_groups == 32
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
