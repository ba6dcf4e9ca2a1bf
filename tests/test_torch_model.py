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
    # remat is ported (the layers' checkpointing in training); it builds.
    assert get_model("TransformerDDPM", device="cpu", data_channels=C,
                     remat=True, **KW).TransformerEncoder_0.remat
    with pytest.raises(ValueError, match="exclude"):
        get_model("TransformerDDPM", device="cpu", data_channels=C,
                  fused_head=True, quantized_head=True, **KW)
    # The MDN baseline is ported; it builds with the JAX defaults.
    mdn = get_model("TransformerMDN", device="cpu", data_channels=C)
    assert len(mdn.TransformerEncoder_0.layer_names) == 6
    assert mdn.mdn.Dense_2.kernel.shape == (2048, 100)
    with pytest.raises(ValueError):
        get_model("NoSuchModel", device="cpu")


# -- the int8 serving head -------------------------------------------------------
# The model of tests/test_quant.py: one layer, two heads, MLP width 128.
QKW = dict(num_layers=1, num_heads=2, num_mlp_layers=2, mlp_dims=128)
QB, QS, QC = 4, 32, 6
# The calibration mix of benchmarks/flagship_e2e.py: noise levels spanning
# the sampler's trajectory.
CAL_T = (0.99, 0.5, 0.1, 0.02)


def _quant_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(QB, QS, QC)).astype(np.float32)
    t = rng.uniform(0.05, 1.0, size=(QB, 1, 1)).astype(np.float32)
    std = jax_get_model("TransformerDDPM", **QKW)
    params = jax.tree_util.tree_map(np.asarray, std.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t)))
    cal = [(rng.normal(size=(QB, QS, QC)).astype(np.float32),
            np.full((QB, 1, 1), tt, np.float32)) for tt in CAL_T]
    return x, t, params, cal


def _quant_torch(tree=None, use_kernel=False):
    model = get_model("TransformerDDPM", device="cpu", data_channels=QC,
                      quantized_head=True, quantized_head_kernel=use_kernel,
                      **QKW)
    return model if tree is None else load_flax_params(model, tree).eval()


def _scales(tree):
    return {str(p): float(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)
            if "a1_scale" in str(p) or "a2_scale" in str(p)}


def _head_flip_step(tree):
    """The most one int8 code flipped by one moves a head matmul output:
    a_s * max(w_s) * 127, over the head's four matmuls."""
    p = tree["params"]
    return max(float(p[f"QuantDenseResBlock_{k}"][f"a{i}_scale"]) *
               float(np.max(p[f"QuantDenseResBlock_{k}"][f"w{i}_scale"]))
               * 127 for k in (0, 1) for i in (1, 2))


def test_calibrate_head_act_scales_matches_jax():
    from smd_tpu.models.fuse import calibrate_head_act_scales as jax_cal
    from smd_tpu.models.fuse import quantize_head_params as jax_quantize
    from smd_tpu_torch.models.fuse import (calibrate_head_act_scales,
                                           quantize_head_params)
    _, _, params, cal = _quant_case()
    ref = jax_cal(jax_get_model("TransformerDDPM", quantized_head=True,
                                **QKW), jax_quantize(params),
                  [(jnp.asarray(a), jnp.asarray(b)) for a, b in cal])
    ours = calibrate_head_act_scales(_quant_torch(),
                                     quantize_head_params(params), cal)
    got, want = _scales(ours), _scales(ref)
    assert set(got) == set(want) and len(got) == 4
    assert all(v != 1.0 for v in got.values())
    # The amax each scale comes from sees the FiLM scale and shift, which
    # carry the noise embedding's float32 exp differences (up to 1e-3 in a
    # few channels, test_torch_blocks.py).
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert ours["params"]["QuantDenseResBlock_0"]["a1_scale"].dtype == \
        np.float32


@pytest.mark.parametrize("use_kernel", [False, True])
def test_quantized_model_matches_jax(use_kernel):
    from smd_tpu.models.fuse import calibrate_head_act_scales as jax_cal
    from smd_tpu.models.fuse import quantize_head_params as jax_quantize
    x, t, params, cal = _quant_case()
    jmodel = jax_get_model("TransformerDDPM", quantized_head=True,
                           quantized_head_kernel=use_kernel, **QKW)
    tree = jax_cal(jax_get_model("TransformerDDPM", quantized_head=True,
                                 **QKW), jax_quantize(params),
                   [(jnp.asarray(a), jnp.asarray(b)) for a, b in cal])
    tree = jax.tree_util.tree_map(np.asarray, tree)
    ref = np.asarray(jmodel.apply(tree, jnp.asarray(x), jnp.asarray(t)))
    model = _quant_torch(tree, use_kernel)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == (QB, QS, QC)
    # The head quantizes activations that carry the FiLM's float32
    # differences (see above); a code next to a rounding boundary flips by
    # one and moves a head output by up to _head_flip_step. Allow four such
    # steps at the output, after the head's LN and output Dense have spread
    # the flipped channels over every output.
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=4 * _head_flip_step(tree))
    # And the bulk of it agrees much more tightly than that.
    assert np.abs(out - ref).mean() < 1e-3 * np.abs(ref).mean()


def test_quantized_model_ddpm_chain_matches_jax():
    """5 DDPM steps through the int8 kernel route on both sides, with the
    JAX draws replayed."""
    from smd_tpu.diffusion import samplers as jax_samplers
    from smd_tpu.diffusion import schedules as jax_schedules
    from smd_tpu.models.fuse import quantize_head_params as jax_quantize
    from smd_tpu_torch.diffusion import samplers, schedules
    x, _, params, _ = _quant_case()
    tree = jax.tree_util.tree_map(np.asarray, jax_quantize(params))
    for k in (0, 1):
        block = tree["params"][f"QuantDenseResBlock_{k}"]
        block["a1_scale"] = np.asarray(0.03, np.float32)
        block["a2_scale"] = np.asarray(0.03, np.float32)
    jmodel = jax_get_model("TransformerDDPM", quantized_head=True,
                           quantized_head_kernel=True, **QKW)
    T = 5
    key = jax.random.PRNGKey(3)
    ref = jax_samplers.diffusion_dynamics(
        key, lambda a, c: jmodel.apply(tree, a, c),
        jax_schedules.noise_schedule(1e-4, 0.05, T, "linear"),
        jnp.asarray(x), collect_steps=0, collect_metrics=False)
    infill, step = [], []
    rng = key
    for _ in range(T):
        rng, infill_rng, noise_rng = jax.random.split(rng, num=3)
        infill.append(np.asarray(jax.random.normal(infill_rng, x.shape)))
        step.append(np.asarray(jax.random.normal(noise_rng, x.shape)))
    model = _quant_torch(tree, use_kernel=True)
    with torch.no_grad():
        out = samplers.diffusion_dynamics(
            None, model, schedules.noise_schedule(1e-4, 0.05, T, "linear"),
            torch.from_numpy(x), collect_steps=0, collect_metrics=False,
            noise=(torch.from_numpy(np.stack(infill)),
                   torch.from_numpy(np.stack(step))))
    # Each step's eps may differ by the flips of test_quantized_model_
    # matches_jax; the update scales eps by sqrt(1/abar - 1) < 0.4 here and
    # the posterior mean contracts the state.
    np.testing.assert_allclose(out.state.numpy(), np.asarray(ref.state),
                               rtol=0, atol=4 * _head_flip_step(tree))


def test_quantized_plain_route_equals_kernel_route_on_cpu():
    from smd_tpu_torch.models.fuse import quantize_head_params
    from smd_tpu_torch.ops import quant_matmul
    x, t, params, _ = _quant_case()
    model = _quant_torch(quantize_head_params(params), use_kernel=True)
    before = quant_matmul.w8a8_dense.launches
    with torch.no_grad():
        a = model(torch.from_numpy(x), torch.from_numpy(t))
        b = model.use_plain_ops(True)(torch.from_numpy(x),
                                      torch.from_numpy(t))
    model.use_plain_ops(False)
    assert torch.equal(a, b)
    assert quant_matmul.w8a8_dense.launches == before
