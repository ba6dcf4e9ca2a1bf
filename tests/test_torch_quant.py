"""The port's int8 serving ops against ``smd_tpu``'s, float32 on the CPU.

``quantize_weight``, ``int8_dense`` and the params converter must give the
JAX package's int8 codes and scales bit for bit. ``w8a8_dense``'s plain
version is held against the Pallas kernel in interpret mode, as
``tests/test_quant.py`` runs it, including a row count the JAX wrapper
serves through its ``int8_dense`` fallback. The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.models import blocks as jb
from smd_tpu.models.fuse import quantize_head_params as jax_quantize_head
from smd_tpu.ops import quant as jq
from smd_tpu.ops import quant_matmul as jqmm
from smd_tpu_torch.models import blocks
from smd_tpu_torch.models.fuse import quantize_head_params
from smd_tpu_torch.ops import quant, quant_matmul
from smd_tpu_torch.utils.flax_params import load_flax_params


def _weight(K, N, seed, zero_column=False):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) * rng.uniform(0.01, 2.0, size=(1, N)))
    if zero_column:
        w[:, 3] = 0.0       # the 1e-12 floor of the scale
    return w.astype(np.float32)


@pytest.mark.parametrize("zero_column", [False, True])
def test_quantize_weight_bit_equal(zero_column):
    w = _weight(96, 160, seed=0, zero_column=zero_column)
    ref_q, ref_s = jq.quantize_weight(jnp.asarray(w))
    w_q, s = quant.quantize_weight(torch.from_numpy(w))
    assert w_q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def _head_tree(N=64, seed=0):
    """A standard-layout two-resblock head with non-zero biases and LN."""
    rng = np.random.default_rng(seed)

    def block():
        return {"LayerNorm_0": {"scale": 1 + 0.1 * rng.normal(size=N),
                                "bias": 0.1 * rng.normal(size=N)},
                "Dense_0": {"kernel": _weight(N, N, rng.integers(1 << 30)),
                            "bias": 0.1 * rng.normal(size=N)},
                "LayerNorm_1": {"scale": 1 + 0.1 * rng.normal(size=N),
                                "bias": 0.1 * rng.normal(size=N)},
                "Dense_1": {"kernel": _weight(N, N, rng.integers(1 << 30)),
                            "bias": 0.1 * rng.normal(size=N)}}
    tree = {"params": {"DenseResBlock_0": block(), "DenseResBlock_1": block(),
                       "Dense_0": {"kernel": _weight(8, N, 9),
                                   "bias": np.zeros(N)}}}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def test_quantize_head_params_bit_equal():
    tree = _head_tree()
    ours = quantize_head_params(tree)
    theirs = jax.tree_util.tree_map(np.asarray, jax_quantize_head(tree))
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, u), (_, v) in zip(a, b):
        assert np.asarray(u).dtype == v.dtype, path
        np.testing.assert_array_equal(np.asarray(u), v)
    assert ours["params"]["QuantDenseResBlock_1"]["w2_q"].dtype == np.int8


def _dense_inputs(M, K, N, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, K)) * 0.5).astype(np.float32)
    w_q, w_s = (np.asarray(a) for a in jq.quantize_weight(
        jnp.asarray(_weight(K, N, seed + 1) * 0.05)))
    b = rng.normal(size=(N,)).astype(np.float32)
    a_s = np.float32(np.abs(x).max() / 127.0)
    return x, w_q, w_s, b, a_s


@pytest.mark.parametrize("static", [True, False])
def test_int8_dense_matches_jax(static):
    x, w_q, w_s, b, a_s = _dense_inputs(48, 128, 96)
    a = a_s if static else None
    ref = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w_q),
                                   jnp.asarray(w_s), jnp.asarray(b), a))
    out = quant.int8_dense(torch.from_numpy(x), torch.from_numpy(w_q),
                           torch.from_numpy(w_s), torch.from_numpy(b),
                           None if a is None else torch.tensor(a))
    assert out.dtype == torch.float32 and out.shape == (48, 96)
    # Same codes, exact int32 sums, the same float32 epilogue: at most an
    # ulp apart (test_quant.py holds int8_dense to 2% of the float product;
    # the port is held to the JAX package itself).
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    dense = x @ (w_q.astype(np.float32) * w_s[None, :]) + b
    rel = np.abs(out.numpy() - dense).mean() / np.abs(dense).mean()
    assert rel < 0.02, rel


def test_int8_codes_and_sums_exact():
    x, w_q, w_s, b, a_s = _dense_inputs(64, 256, 128, seed=3)
    ref_codes = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / a_s), -127,
                                    127).astype(jnp.int8))
    codes = quant.int8_codes(torch.from_numpy(x), torch.tensor(a_s))
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    ref_acc = np.asarray(jax.lax.dot_general(
        jnp.asarray(ref_codes), jnp.asarray(w_q), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    acc = quant.int8_matmul(codes, torch.from_numpy(w_q))
    np.testing.assert_array_equal(acc.numpy(), ref_acc.astype(np.float32))


@pytest.mark.parametrize("M,lead", [(128, (128,)), (160, (4, 40)),
                                    (7, (7,))])
def test_w8a8_reference_matches_pallas_interpret(M, lead):
    """M=7 is a row count the Pallas wrapper cannot tile: JAX serves it
    through int8_dense, the port through the same plain version."""
    K, N = 256, 128
    x, w_q, w_s, b, a_s = _dense_inputs(M, K, N, seed=5)
    assert jqmm.supported(M, K, N) == (M != 7)
    x = x.reshape(*lead, K)
    ref = np.asarray(jqmm.w8a8_dense(jnp.asarray(x), jnp.asarray(w_q),
                                     jnp.asarray(w_s), jnp.asarray(b), a_s,
                                     interpret=True))
    out = quant_matmul.w8a8_dense(torch.from_numpy(x), torch.from_numpy(w_q),
                                  torch.from_numpy(w_s), torch.from_numpy(b),
                                  torch.tensor(a_s))
    assert out.dtype == torch.float32 and out.shape == (*lead, N)
    # Exact int32 sums; the epilogue's two float32 roundings (and, for the
    # fallback, int8_dense's other association of the scales) differ by at
    # most an ulp or two.
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_w8a8_bf16_input_rounds_output_once():
    x, w_q, w_s, b, a_s = _dense_inputs(64, 128, 128, seed=7)
    xb = torch.from_numpy(x).bfloat16()
    out = quant_matmul.w8a8_dense(xb, torch.from_numpy(w_q),
                                  torch.from_numpy(w_s), torch.from_numpy(b),
                                  float(a_s))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jqmm.w8a8_dense(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(w_q),
        jnp.asarray(w_s), jnp.asarray(b), a_s, interpret=True), np.float32)
    # The float32 results agree to an ulp, so the bf16 ones to one bf16 ulp
    # of |y| < 8.
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3.2e-2,
                               rtol=0)


def test_w8a8_requires_activation_scale():
    x, w_q, w_s, b, _ = _dense_inputs(8, 64, 64)
    args = [torch.from_numpy(a) for a in (x, w_q, w_s, b)]
    with pytest.raises(ValueError, match="static activation scale"):
        quant_matmul.w8a8_dense(*args)
    with pytest.raises(ValueError, match="static activation scale"):
        jqmm.w8a8_dense(*(jnp.asarray(a) for a in (x, w_q, w_s, b)))


def test_w8a8_cpu_wrapper_counts_no_launch():
    x, w_q, w_s, b, a_s = _dense_inputs(8, 64, 64)
    before = quant_matmul.w8a8_dense.launches
    quant_matmul.w8a8_dense(*(torch.from_numpy(a) for a in (x, w_q, w_s, b)),
                            float(a_s))
    assert quant_matmul.w8a8_dense.launches == before


# -- QuantDenseResBlock --------------------------------------------------------
B, S, N = 3, 16, 64
MODES = [(False, True), (True, True), (False, False)]  # (use_kernel, static)


def _block_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, N)).astype(np.float32)
    scale = (1 + 0.2 * rng.normal(size=(B, 1, N))).astype(np.float32)
    shift = (0.2 * rng.normal(size=(B, 1, N))).astype(np.float32)
    tree = quantize_head_params(_head_tree(N, seed))
    block = dict(tree["params"]["QuantDenseResBlock_0"])
    # Static scales as calibration would set them: the swish outputs reach
    # ~3, so a code step of ~3/127.
    block["a1_scale"] = np.asarray(0.025, np.float32)
    block["a2_scale"] = np.asarray(0.03, np.float32)
    return x, scale, shift, {"params": block}


def _flip_step(block):
    """The most one int8 code flipped by one moves a matmul output:
    a_s * w_s[j] * |w_q[k, j]| <= a_s * max(w_s) * 127."""
    p = block["params"]
    return max(float(p[f"a{i}_scale"]) * float(p[f"w{i}_scale"].max()) * 127
               for i in (1, 2))


@pytest.mark.parametrize("use_kernel,static", MODES)
def test_quant_resblock_matches_jax(use_kernel, static):
    x, scale, shift, tree = _block_case()
    jmod = jb.QuantDenseResBlock(N, use_kernel=use_kernel, static_act=static)
    ref = np.asarray(jmod.apply(tree, jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(shift)))
    mod = load_flax_params(blocks.QuantDenseResBlock(
        N, use_kernel=use_kernel, static_act=static), tree)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), torch.from_numpy(scale),
                  torch.from_numpy(shift)).numpy()

    # The first matmul's codes: the LN -> FiLM -> swish prologue may differ
    # by an ulp between torch and XLA, which can flip a code next to a
    # rounding boundary by one. Allow FLIPS such flips, and size the output
    # tolerance to what they can move.
    FLIPS = 2
    ln = fnn.LayerNorm().apply({"params": tree["params"]["LayerNorm_0"]},
                               jnp.asarray(x))
    h_ref = np.asarray(fnn.swish(jb.featurewise_affine(
        ln, jnp.asarray(scale), jnp.asarray(shift))))
    with torch.no_grad():
        h = blocks._ln_film_swish(mod.LayerNorm_0, torch.from_numpy(x),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(shift))
    if static:
        a1 = torch.from_numpy(tree["params"]["a1_scale"])
        codes = quant.int8_codes(h, a1).numpy().astype(int)
        ref_codes = np.clip(np.round(h_ref / tree["params"]["a1_scale"]),
                            -127, 127).astype(int)
        diff = np.abs(codes - ref_codes)
        assert diff.max() <= 1 and diff.sum() <= FLIPS, diff.sum()
    # float32 epilogue rounding (1e-5 on |y| <= 6), plus the flips.
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 + FLIPS * _flip_step(tree))


def test_quant_resblock_kernel_and_xla_routes_agree():
    """On the CPU both routes share the codes and the sums; only the
    epilogue's association of the two scales differs."""
    x, scale, shift, tree = _block_case(1)
    args = (torch.from_numpy(x), torch.from_numpy(scale),
            torch.from_numpy(shift))
    outs = []
    for use_kernel in (False, True):
        mod = load_flax_params(blocks.QuantDenseResBlock(
            N, use_kernel=use_kernel), tree)
        with torch.no_grad():
            outs.append(mod(*args))
    # An ulp of the first half's output can flip a code of the second.
    torch.testing.assert_close(outs[1], outs[0], rtol=0,
                               atol=1e-5 + 2 * _flip_step(tree))


def test_quant_resblock_keeps_int8_under_dtype_casts():
    _, _, _, tree = _block_case()
    mod = load_flax_params(blocks.QuantDenseResBlock(N), tree)
    mod = mod.to(torch.bfloat16)
    assert mod.w1_q.dtype == torch.int8 and mod.w2_q.dtype == torch.int8
    assert mod.w1_scale.dtype == torch.bfloat16
    assert mod.a2_scale.dtype == torch.bfloat16
    assert "w1_q" not in dict(mod.named_parameters())
    assert torch.equal(mod.w1_q, torch.from_numpy(tree["params"]["w1_q"]))


def test_quant_resblock_observe_records_amax():
    x, scale, shift, tree = _block_case()
    mod = load_flax_params(blocks.QuantDenseResBlock(N), tree)
    jmod = jb.QuantDenseResBlock(N)
    _, mut = jmod.apply(tree, jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(shift), mutable=["intermediates"])
    mod.observe = True
    with torch.no_grad():
        mod(torch.from_numpy(x), torch.from_numpy(scale),
            torch.from_numpy(shift))
        mod(torch.from_numpy(x[:1]), torch.from_numpy(scale[:1]),
            torch.from_numpy(shift[:1]))
    assert set(mod.amax) == {"a1_amax", "a2_amax"}
    for key, seen in mut["intermediates"].items():
        # float32 max of the same activations, up to the prologue's ulps.
        np.testing.assert_allclose(float(mod.amax[key]), float(seen[0]),
                                   rtol=1e-5)


def test_kernel_block_requires_static_scales():
    with pytest.raises(ValueError, match="static"):
        blocks.QuantDenseResBlock(N, use_kernel=True, static_act=False)


def test_quant_resblock_kmajor_copy_follows_reloads():
    """The K-major copy the kernel reads is made once, made again when
    load_flax_params reloads w1_q in place or w1_q is replaced, and stays
    out of state_dict."""
    _, _, _, tree = _block_case()
    mod = load_flax_params(blocks.QuantDenseResBlock(N, use_kernel=True),
                           tree)
    first = mod.kmajor_weight(1)
    assert torch.equal(first, mod.w1_q.t()) and first.is_contiguous()
    assert mod.kmajor_weight(1) is first
    _, _, _, other = _block_case(seed=3)
    load_flax_params(mod, other)
    assert torch.equal(mod.kmajor_weight(1),
                       torch.from_numpy(other["params"]["w1_q"]).t())
    mod.w2_q = torch.from_numpy(tree["params"]["w2_q"]).clone()
    assert torch.equal(mod.kmajor_weight(2), mod.w2_q.t())
    assert not any("kmajor" in k or k.endswith("_t")
                   for k in mod.state_dict())


def test_w8a8_cpu_wrapper_ignores_the_kmajor_copy():
    x, w_q, w_s, b, a_s = (torch.as_tensor(a) for a in
                           _dense_inputs(16, 64, 32))
    w_t = quant_matmul.transpose_weight(w_q)
    assert torch.equal(w_t, w_q.t())
    out = quant_matmul.w8a8_dense(x, w_q, w_s, b, a_s, w_t=w_t)
    assert torch.equal(out, quant_matmul.w8a8_dense(x, w_q, w_s, b, a_s))
