"""The port's flash attention and its standard-layout serving path against JAX.

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in Pallas interpret mode, as ``tests/test_flash_attention.py`` runs it. Both
attention layers take their einsum on a CPU, so the tests that hold the
flash route force it in each package: the JAX layer sees an accelerator
backend and its kernel runs interpreted, and the port's layer sees a CUDA
tensor, so its wrapper takes the plain version. The CUDA kernel itself is
held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smd_tpu.models.attention as jattn
from smd_tpu.diffusion import samplers as jax_samplers
from smd_tpu.diffusion import schedules as jax_schedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.ops import flash_attention as jfa
from smd_tpu.sampling import generate as jax_generate
import smd_tpu_torch.models.attention as pattn
from smd_tpu_torch.diffusion import samplers, schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.ops import flash_attention as fa
from smd_tpu_torch.sampling import generate
from smd_tpu_torch.utils.flax_params import load_flax_params

# The JAX tests' float32 tolerance for unit-normal q, k, v.
F32_ATOL = 2e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _qkv(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _cast(arrays, dtype):
    """numpy float32 -> (torch tensors, jax arrays) of ``dtype``, equal."""
    t_dtype, j_dtype = DTYPES[dtype]
    ts = [torch.from_numpy(a).to(t_dtype) for a in arrays]
    js = [jnp.asarray(a).astype(j_dtype) for a in arrays]
    return ts, js


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_close(ours, ref, dtype):
    """float32 within F32_ATOL; bf16 is the float32 result rounded once, so
    within one bf16 ulp of |ref| plus F32_ATOL, the most the float32
    results may differ before the rounding."""
    ours, ref = _to_np(ours), _to_np(ref)
    err = np.abs(ours - ref)
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
        return
    _, e = np.frexp(np.abs(ref))
    ulp = np.ldexp(np.ones_like(ref), e - 8)
    assert (err - ulp).max() <= F32_ATOL, (err - ulp).max()


# -- the function -------------------------------------------------------------

_jax_flash = jax.jit(jfa.flash_attention, static_argnums=(3, 4, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 384, 512])
@pytest.mark.parametrize("block_diag", [0, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax(dtype, S, block_diag, causal):
    (q, k, v), (jq, jk, jv) = _cast(_qkv(1, S, 2, 16, seed=S), dtype)
    ours = fa.flash_attention(q, k, v, causal, block_diag)
    assert ours.dtype == q.dtype and ours.shape == (1, S, 2, 16)
    assert torch.equal(ours, fa._reference_attention(q, k, v, causal,
                                                     block_diag))
    interp = _jax_flash(jq, jk, jv, causal, True, block_diag)
    ref = jfa._reference_attention(jq, jk, jv, causal, block_diag)
    _assert_close(ours, interp, dtype)
    _assert_close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_supported_matches_jax(dtype):
    t_dtype, j_dtype = DTYPES[dtype]
    for S in (32, 100, 127, 128, 256, 384, 512, 600, 640, 1024, 1536, 2048):
        for Dh in (8, 16, 64, 128):
            assert fa.supported(S, Dh, t_dtype) == \
                jfa.supported(S, Dh, j_dtype), (S, Dh, dtype)


def test_pick_block_and_pack_group_match_jax():
    for S in (32, 100, 128, 256, 384, 512, 600, 640, 768, 1024, 1536):
        assert fa._pick_block(S) == jfa._pick_block(S)
    for batch in (1, 2, 4, 7, 8, 12, 16, 64, 100, 125, 1000):
        for S in (16, 32, 64, 100, 128, 256):
            assert fa.pack_group(batch, S) == jfa.pack_group(batch, S)


@pytest.mark.parametrize("causal", [False, True])
def test_packed_matches_jax(causal):
    (q, k, v), (jq, jk, jv) = _cast(_qkv(16, 32, 2, 16, seed=3), "float32")
    ours = fa.packed_short_seq_attention(q, k, v, causal)
    ref = jfa.packed_short_seq_attention(jq, jk, jv, causal=causal,
                                         interpret=True)
    assert ours.shape == (16, 32, 2, 16)
    _assert_close(ours, ref, "float32")
    plain = fa.packed_short_seq_attention(q, k, v, causal, plain=True)
    assert torch.equal(ours, plain)


def test_packed_prime_batch_returns_none():
    (q, k, v), (jq, jk, jv) = _cast(_qkv(7, 32, 2, 16), "float32")
    assert fa.packed_short_seq_attention(q, k, v) is None
    assert jfa.packed_short_seq_attention(jq, jk, jv, interpret=True) is None


def test_gradients_match_jax():
    arrays = _qkv(1, 128, 1, 32, seed=4)
    (q, k, v), (jq, jk, jv) = _cast(arrays, "float32")
    for t in (q, k, v):
        t.requires_grad_()
    fa.flash_attention(q, k, v, True).square().sum().backward()
    ref = jax.grad(lambda a, b, c: jnp.sum(
        jfa.flash_attention(a, b, c, True, True) ** 2),
        argnums=(0, 1, 2))(jq, jk, jv)
    for ours, theirs in zip((q.grad, k.grad, v.grad), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=1e-4)  # float32, as in JAX's test


# -- the routing --------------------------------------------------------------

class _Recorder:
    """Stands in for a package's flash module: records which route the
    attention layer took and returns zeros."""

    def __init__(self, real, zeros):
        self.supported = real.supported
        self.pack_group = real.pack_group
        self._zeros = zeros
        self.taken = []

    def flash_attention(self, q, k, v, causal=False):
        self.taken.append("flash")
        return self._zeros(q)

    def packed_short_seq_attention(self, q, k, v, causal=False, **_):
        B, S = q.shape[:2]
        if self.pack_group(B, S) == 1:
            return None
        self.taken.append("packed")
        return self._zeros(q)

    _reference_attention = flash_attention


def _backend(name):
    """The JAX layer's ``jax`` with ``default_backend`` answering ``name``."""
    return types.SimpleNamespace(
        **{a: getattr(jax, a) for a in ("lax", "nn", "numpy")},
        default_backend=lambda: name)


_JAX_LAYER = jattn.MultiHeadSelfAttention(features=32, num_heads=2)
_JAX_PARAMS = {}


def _jax_route(monkeypatch, S, dtype, on_accelerator, use_packed, B=8):
    j_dtype = DTYPES[dtype][1]
    if dtype not in _JAX_PARAMS:   # the params do not depend on S
        _JAX_PARAMS[dtype] = jax.tree_util.tree_map(
            lambda p: p.astype(j_dtype),
            _JAX_LAYER.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32))))
    rec = _Recorder(jfa, jnp.zeros_like)
    monkeypatch.setattr(jattn, "fa", rec)
    monkeypatch.setattr(jattn, "jax", _backend(
        "gpu" if on_accelerator else "cpu"))
    _JAX_LAYER.clone(use_packed=use_packed).apply(
        _JAX_PARAMS[dtype], jnp.zeros((B, S, 32), j_dtype))
    return rec.taken[0] if rec.taken else "einsum"


def _port_route(monkeypatch, S, dtype, on_accelerator, use_packed, B=8):
    rec = _Recorder(fa, torch.zeros_like)
    monkeypatch.setattr(pattn, "fa", rec)
    monkeypatch.setattr(pattn, "_on_accelerator", lambda x: on_accelerator)
    mha = pattn.MultiHeadSelfAttention(32, 2, use_packed=use_packed)
    mha = mha.to(DTYPES[dtype][0])
    with torch.no_grad():
        mha(torch.zeros(B, S, 32, dtype=DTYPES[dtype][0]))
    return rec.taken[0] if rec.taken else "einsum"


# (S, dtype, on accelerator, use_packed) -> the route both layers take at
# Dh = 16.
ROUTES = [
    (32, "float32", True, False, "einsum"),
    (32, "float32", True, True, "packed"),
    (32, "float16", True, True, "einsum"),
    (32, "float32", False, True, "einsum"),
    (128, "bfloat16", True, True, "packed"),
    (511, "bfloat16", True, False, "einsum"),
    (512, "float32", True, False, "flash"),
    (512, "bfloat16", True, True, "flash"),
    (512, "float16", True, False, "einsum"),
    (512, "bfloat16", False, False, "einsum"),
    # No block divides 600, so _pick_block gives 600 itself and the kernel
    # takes it; any S >= 128 is "supported".
    (600, "bfloat16", True, False, "flash"),
    (600, "float16", True, False, "einsum"),
    (1024, "float16", True, True, "einsum"),
]


@pytest.mark.parametrize("S,dtype,on_acc,use_packed,expect", ROUTES)
def test_routing_matches_jax(monkeypatch, S, dtype, on_acc, use_packed,
                             expect):
    """The layer's choice of flash, packed or einsum equals the JAX layer's,
    with "on accelerator" mapped to a CUDA tensor."""
    B = 8 if S <= 128 else 1   # no batch packs sequences longer than 128
    case = (S, dtype, on_acc, use_packed, B)
    assert _jax_route(monkeypatch, *case) == expect
    assert _port_route(monkeypatch, *case) == expect
    how = pattn.route(S, 16, DTYPES[dtype][0], on_acc, use_packed=use_packed)
    if how == "packed" and fa.pack_group(B, S) == 1:
        how = "einsum"   # packed_short_seq_attention returns None
    assert how == expect


def _force_flash_route(monkeypatch):
    """Both layers on their flash route on the CPU: the JAX kernel
    interpreted, the port's wrapper on its plain version. Returns the
    counts of flash calls, (JAX, port)."""
    calls = [0, 0]

    def jax_flash(q, k, v, causal=False):
        calls[0] += 1
        return jfa.flash_attention(q, k, v, causal, True)

    def port_flash(q, k, v, causal=False):
        calls[1] += 1
        return fa.flash_attention(q, k, v, causal)

    monkeypatch.setattr(jattn, "jax", _backend("gpu"))
    monkeypatch.setattr(jattn, "fa", types.SimpleNamespace(
        supported=jfa.supported, flash_attention=jax_flash))
    monkeypatch.setattr(pattn, "_on_accelerator", lambda x: True)
    monkeypatch.setattr(pattn, "fa", types.SimpleNamespace(
        supported=fa.supported, flash_attention=port_flash,
        _reference_attention=fa._reference_attention))
    return calls


@pytest.mark.parametrize("causal", [False, True])
def test_layer_flash_route_matches_jax(monkeypatch, causal):
    calls = _force_flash_route(monkeypatch)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 512, 32)).astype(np.float32)
    jmha = jattn.MultiHeadSelfAttention(features=32, num_heads=2,
                                        causal=causal)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
            np.float32),
        jmha.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    calls[:] = [0, 0]   # init ran the layer
    ref = jmha.apply(params, jnp.asarray(x))
    mha = load_flax_params(pattn.MultiHeadSelfAttention(32, 2,
                                                        causal=causal),
                           params)
    with torch.no_grad():
        ours = mha(torch.from_numpy(x))
    assert calls == [1, 1]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


# -- the slice: the standard-layout TransformerDDPM at S=512 ------------------

KW = dict(num_layers=2, num_heads=2, num_mlp_layers=1, mlp_dims=64,
          embed_channels=32)
B, S, C = 2, 512, 6


def _slice_setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    t = rng.uniform(0.05, 1.0, size=(B, 1, 1)).astype(np.float32)
    jmodel = jax_get_model("TransformerDDPM", **KW)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x[:, :32]),
                         jnp.asarray(t))
    prng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * prng.normal(size=p.shape))
        .astype(np.float32), params)
    model = get_model("TransformerDDPM", device="cpu", data_channels=C, **KW)
    load_flax_params(model, params).eval()
    return x, t, jmodel, params, model


def test_standard_model_flash_route_matches_jax(monkeypatch):
    calls = _force_flash_route(monkeypatch)
    x, t, jmodel, params, model = _slice_setup()
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t))
    assert calls == [KW["num_layers"]] * 2
    assert ours.shape == (B, S, C)
    # float32, as tests/test_torch_model.py (the noise embedding's ulps).
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_standard_model_ddpm_steps_match_jax(monkeypatch):
    """3 DDPM steps at S=512 on both flash routes, with the JAX draws
    replayed into the port's sampler."""
    _force_flash_route(monkeypatch)
    x, _, jmodel, params, model = _slice_setup()
    T = 3
    key = jax.random.PRNGKey(3)
    ref = jax_samplers.diffusion_dynamics(
        key, lambda a, c: jmodel.apply(params, a, c),
        jax_schedules.noise_schedule(1e-4, 0.05, T, "linear"),
        jnp.asarray(x), collect_steps=0, collect_metrics=False)
    infill, step = [], []
    rng = key
    for _ in range(T):
        rng, infill_rng, noise_rng = jax.random.split(rng, num=3)
        infill.append(np.asarray(jax.random.normal(infill_rng, x.shape)))
        step.append(np.asarray(jax.random.normal(noise_rng, x.shape)))
    with torch.no_grad():
        out = samplers.diffusion_dynamics(
            None, model, schedules.noise_schedule(1e-4, 0.05, T, "linear"),
            torch.from_numpy(x), collect_steps=0, collect_metrics=False,
            noise=(torch.from_numpy(np.stack(infill)),
                   torch.from_numpy(np.stack(step))))
    assert torch.isfinite(out.state).all()
    np.testing.assert_allclose(out.state.numpy(), np.asarray(ref.state),
                               atol=1e-4, rtol=1e-4)  # float32, as above


def test_plain_route_equals_kernel_route_on_cpu(monkeypatch):
    """With the flash route forced, the wrapper on a CPU tensor is the
    plain version: both routes agree exactly and count no launch."""
    monkeypatch.setattr(pattn, "_on_accelerator", lambda x: True)
    x, t, _, _, model = _slice_setup()
    before = fa.flash_attention.launches
    with torch.no_grad():
        a = model(torch.from_numpy(x), torch.from_numpy(t))
        b = model.use_plain_ops(True)(torch.from_numpy(x),
                                      torch.from_numpy(t))
    model.use_plain_ops(False)
    assert torch.equal(a, b)
    assert fa.flash_attention.launches == before


# -- the entry point ----------------------------------------------------------

def test_sample_signature_matches_jax():
    """The JAX parameters, order and defaults (the port's randomness is a
    torch.Generator where JAX takes a key), then keyword-only ``device``."""
    ours = list(inspect.signature(generate.sample).parameters.values())
    theirs = list(inspect.signature(jax_generate.sample).parameters.values())
    assert [(p.name, p.default, p.kind) for p in ours[:-1]] == [
        ("generator" if p.name == "rng" else p.name, p.default, p.kind)
        for p in theirs]
    assert (ours[-1].name, ours[-1].default, ours[-1].kind) == \
        ("device", None, inspect.Parameter.KEYWORD_ONLY)
    # The default, "ald", runs.
    sigmas = schedules.noise_schedule(1.0, 0.01, 3, "geometric")
    state, _, _ = generate.sample(lambda x, s: -x / s ** 2, sigmas,
                                  torch.Generator().manual_seed(0), (S, C),
                                  num_samples=2, steps=2, device="cpu")
    assert state.shape == (2, S, C) and torch.isfinite(state).all()


# -- the CUDA kernel's bf16 arithmetic, emulated ------------------------------

_LOG2E = np.float32(1.4426950408889634)


def _bf16_trunc(x):
    """x's top 16 bits: bf16 by truncation, as a float32 tensor."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _emulate_bf16_kernel(q, k, v, causal, block_diag):
    """Plain-PyTorch emulation of ``csrc/flash_attention.cu``'s bf16 path.

    bf16 q and k are widened to float32, so the scores are exact products
    summed in float32 (in the CPU's order, not the tensor cores'). Over
    tiles of 64 keys: the running max in base 2 with one rounding shared by
    every p and alpha, p = exp2(fma(s, log2 e, -m2)), masked keys p = 0;
    p is split into two bf16 parts, hi = p truncated to bf16 and lo =
    bf16(p - hi), whose products with v are summed in float32; l sums the
    float32 p.
    """
    B, S, H, D = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    rows = torch.arange(S)[:, None]
    m2 = torch.full((B, H, S, 1), -np.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for t0 in range(0, S, 64):
        keys = torch.arange(t0, min(t0 + 64, S))[None, :]
        s = qf @ kf[:, :, t0:t0 + 64].transpose(-1, -2)
        keep = torch.ones((S, keys.shape[1]), dtype=torch.bool)
        if causal:
            keep &= keys <= rows
        if block_diag:
            keep &= keys // block_diag == rows // block_diag
        s = s.masked_fill(~keep, -np.inf)
        m2_new = torch.maximum(m2, s.amax(-1, keepdim=True) * _LOG2E)
        mneg = torch.where(torch.isinf(m2_new), torch.zeros(()), -m2_new)
        alpha = torch.exp2(m2 + mneg)
        # fma: one rounding of the exact s * log2e + mneg.
        p = torch.exp2((s.double() * float(_LOG2E) + mneg.double()).float())
        hi = _bf16_trunc(p)
        pv = sum(part @ vf[:, :, t0:t0 + 64]
                 for part in (hi, (p - hi).bfloat16().float()))
        acc = acc * alpha + pv
        l = l * alpha + p.sum(-1, keepdim=True)
        m2 = m2_new
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


def _beyond_one_ulp(ours, ref):
    """max(|ours - ref| - one bf16 ulp of |ref|): ``chip_smoke.check_flash``'s
    measure, which it holds to 1e-5."""
    ours, ref = _to_np(ours), _to_np(ref)
    _, e = np.frexp(np.abs(ref))
    return float((np.abs(ours - ref) - np.ldexp(np.ones_like(ref), e - 8))
                 .max())


@pytest.mark.parametrize("B,S,H,Dh,causal,block_diag", [
    (2, 512, 8, 16, False, 0), (2, 512, 8, 16, True, 0),
    (2, 512, 8, 16, False, 96), (2, 512, 8, 64, False, 0)])
def test_split_p_arithmetic_within_one_bf16_ulp(B, S, H, Dh, causal,
                                                block_diag):
    """p split into two bf16 terms (relative error <= 2**-16) keeps the
    kernel's output within chip_smoke's bound of the JAX reference:
    one bf16 ulp of |ref| plus 1e-5, on unit-normal q, k, v."""
    (q, k, v), (jq, jk, jv) = _cast(_qkv(B, S, H, Dh, seed=Dh + S),
                                    "bfloat16")
    ours = _emulate_bf16_kernel(q, k, v, causal, block_diag)
    ref = jfa._reference_attention(jq, jk, jv, causal, block_diag)
    assert _beyond_one_ulp(ours, ref) <= 1e-5

