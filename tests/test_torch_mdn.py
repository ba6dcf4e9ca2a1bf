"""The port's autoregressive MDN baseline against ``smd_tpu``'s, on the CPU.

The model (teacher-forced and over the KV cache), the mixture losses and
their gradients, one train and one eval step, the serving gates and both
decoders are held against the JAX package on the same numpy-seeded inputs
and the same params (carried over by ``load_flax_params``); the S=512
causal flash route with its gradient, forced in each package (the JAX
kernel interpreted); the CLIs at tiny widths on the CPU. Small sizes: 2
layers, embed 16, MLP 32, 3 mixtures.
"""
import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.diffusion import losses as jlosses
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.sampling import gates as jgates
from smd_tpu.sampling import mdn_decode as jdecode
from smd_tpu.training import diffusion as jdiffusion
from smd_tpu.training import mdn as jtrainer
from smd_tpu.training import optimizer as joptimizer
from smd_tpu_torch import cli, sample_mdn, train_mdn
from smd_tpu_torch.data import records
from smd_tpu_torch.diffusion import losses
from smd_tpu_torch.models import get_model
from smd_tpu_torch.models.autoregressive import shift_right
from smd_tpu_torch.sampling import gates, mdn_decode
from smd_tpu_torch.training import mdn as trainer
from smd_tpu_torch.utils.flax_params import flatten, load_flax_params
from test_torch_flash_attention import _force_flash_route
from test_torch_training import _close, _jax_opt_state_tree

ROOT = Path(__file__).resolve().parent.parent
KW = dict(num_layers=2, num_heads=2, num_mlp_layers=1, mlp_dims=32,
          mdn_mixtures=3, embed_channels=16)
B, S, C = 3, 8, 6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# float32: the same arithmetic in another order (XLA's fused program
# against eager PyTorch), ~1e-7 of the norm a layer.
F32_RTOL = 1e-5
# bf16 compute: the limit of the flagship's bf16 test
# (tests/test_torch_model.py::test_bf16_model_runs_and_keeps_fp32_head),
# 0.1 of the largest output; bf16 keeps 8 bits, and the two packages round
# at other points (XLA keeps fused elementwise chains in float32).
BF16_RTOL = 0.1


def _rel(ours, ref):
    """|ours - ref| / |ref|, in norm."""
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def _jax_setup(seed=1, seq_len=S, channels=C, dtype="float32", **kw):
    """The JAX model and its params: init, then every leaf moved by a
    seeded 0.05-scale normal, so biases and LN affines are non-zero."""
    kw = {**KW, **kw}
    jmodel = jax_get_model("TransformerMDN", dtype=DTYPES[dtype][1], **kw)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, seq_len, channels)))
    rng = np.random.default_rng(seed + 6)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), params)
    return jmodel, params


def _port(params, channels=C, dtype="float32", **kw):
    model = get_model("TransformerMDN", device="cpu", data_channels=channels,
                      dtype=DTYPES[dtype][0], **{**KW, **kw})
    return load_flax_params(model, params)


def _x(seed=0, shape=(B, S, C)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- the model ------------------------------------------------------------------

def test_shift_right_matches_jax():
    from smd_tpu.models.autoregressive import shift_right as jshift
    x = _x()
    np.testing.assert_array_equal(shift_right(torch.from_numpy(x)).numpy(),
                                  np.asarray(jshift(jnp.asarray(x))))


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_matches_jax(dtype, shift):
    """float32 within F32_RTOL of each output's norm; bf16 compute (float32
    params, as --mixed_precision) within BF16_RTOL of its largest
    element. The head is float32 in both."""
    jmodel, params = _jax_setup(dtype=dtype)
    x = _x()
    ref = jmodel.apply(params, jnp.asarray(x), shift=shift)
    with torch.no_grad():
        ours = _port(params, dtype=dtype)(torch.from_numpy(x), shift=shift)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32 and r.dtype == jnp.float32
        assert tuple(o.shape) == r.shape
        if dtype == "float32":
            assert _rel(o, r) <= F32_RTOL, _rel(o, r)
        else:
            err = np.abs(o.numpy() - np.asarray(r)).max()
            assert err <= BF16_RTOL * np.abs(np.asarray(r)).max(), err


def _jax_cached_steps(jmodel, params, x):
    """Every position of JAX's cached decode of ``x``, as its own test of
    the cache feeds it (tests/test_mdn.py)."""
    _, variables = jmodel.apply(params, x[:, :1], decode=True,
                                decode_position=jnp.zeros((), jnp.int32),
                                mutable=["cache"])
    cache = jax.tree_util.tree_map(jnp.zeros_like, variables["cache"])
    outs = []
    for i in range(x.shape[1]):
        out, variables = jmodel.apply(
            {**params, "cache": cache}, x[:, i:i + 1], decode=True,
            decode_position=jnp.asarray(i, jnp.int32), mutable=["cache"])
        cache = variables["cache"]
        outs.append(out)
    return [np.concatenate([np.asarray(o[j]) for o in outs], axis=1)
            for j in range(3)]


def test_cached_decode_matches_jax_and_the_full_forward():
    """Every position of the port's cached decode against JAX's, and
    against the port's own full causal forward (no shift), each within
    F32_RTOL of the norm; the cache is (B, L, H, Dh) a layer in the
    projections' dtype, and the index advances by one a step."""
    jmodel, params = _jax_setup()
    model = _port(params)
    x = _x(1)
    ref = _jax_cached_steps(jmodel, params, jnp.asarray(x))
    cache = model.init_cache(B)
    assert len(cache.keys) == KW["num_layers"] and cache.index == 0
    assert cache.keys[0].shape == (B, 128, 2, 8)
    assert cache.keys[0].dtype == torch.float32
    steps = []
    with torch.no_grad():
        for i in range(S):
            out, cache = model.decode(torch.from_numpy(x[:, i:i + 1]), cache)
            assert cache.index == i + 1
            steps.append(out)
        full = model(torch.from_numpy(x), shift=False)
    for j in range(3):
        ours = torch.cat([s[j] for s in steps], dim=1)
        assert _rel(ours, ref[j]) <= F32_RTOL, _rel(ours, ref[j])
        assert _rel(ours, full[j].numpy()) <= F32_RTOL


def test_decode_guards():
    """Past max_decode_length both packages' cached decoders raise the
    same ValueError; the fused layout has no decode, as in JAX."""
    jmodel, params = _jax_setup()
    model = _port(params, max_decode_length=16)
    with pytest.raises(ValueError, match="max_decode_length"):
        mdn_decode.ar_decode_cached(None, model, 1, steps=17, channels=C)
    with pytest.raises(ValueError, match="max_decode_length"):
        jdecode.ar_decode_cached(jax.random.PRNGKey(0), jmodel, params, 1,
                                 steps=200, channels=C)
    with pytest.raises(ValueError, match="max_decode_length"):
        model.decode(torch.zeros(1, 1, C), model.init_cache(1)._replace(
            index=16))
    fused = get_model("TransformerDDPM", device="cpu", data_channels=C,
                      fused_attention=True, num_layers=1, num_heads=2,
                      embed_channels=16, mlp_dims=32)
    with pytest.raises(NotImplementedError, match="standard layer"):
        fused.TransformerEncoder_0.init_cache(1)


# -- the losses -------------------------------------------------------------------

def _mixture(seed=0, lead=(B, S), K=3, D=C):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * scale
            for shape, scale in (((*lead, K), 1.0), ((*lead, K * D), 1.0),
                                 ((*lead, K * D), 0.3), ((*lead, D), 1.0))]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_mdn_nll_and_its_gradient_match_jax(reduction):
    """The loss within F32_RTOL of its norm, and its gradient (of a
    seeded weighting of the per-position losses for "none") with respect
    to pi, mu, log_sigma and x likewise."""
    arrays = _mixture()
    w = np.random.default_rng(9).uniform(size=B * S).astype(np.float32)

    def jloss(*a):
        out = jlosses.mdn_nll(*a, reduction)
        return (out * w).sum() if reduction == "none" else out

    ref = jlosses.mdn_nll(*map(jnp.asarray, arrays), reduction)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ours = losses.mdn_nll(*ts, reduction)
    assert tuple(ours.shape) == ref.shape
    assert _rel(ours, ref) <= F32_RTOL
    total = (ours * torch.from_numpy(w)).sum() if reduction == "none" \
        else ours
    for g, r in zip(torch.autograd.grad(total, ts), jgrads):
        assert _rel(g, r) <= F32_RTOL, _rel(g, r)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_gaussian_mixture_loss_matches_jax(reduction):
    log_pi, mu, log_sigma, data = _mixture(1, lead=(16,))
    mu, log_sigma = mu.reshape(16, 3, C), log_sigma.reshape(16, 3, C)
    ref = jlosses.gaussian_mixture_loss(
        *map(jnp.asarray, (log_pi, mu, log_sigma, data)), reduction)
    ours = losses.gaussian_mixture_loss(
        *map(torch.from_numpy, (log_pi, mu, log_sigma, data)), reduction)
    assert tuple(ours.shape) == ref.shape
    assert _rel(ours, ref) <= F32_RTOL


# -- training -----------------------------------------------------------------------

def test_train_step_matches_jax():
    """One port step against JAX ``make_train_step`` from the same params
    and batch: the loss, the unclipped gradient norm and the LR within
    1e-5; Adam's moments within 1e-4 of each tensor's largest element; the
    params within 1e-2·lr, except where sqrt(v̂) < 1e-5 (there Adam's
    first step is lr·sign(g), and a gradient near 0 may flip its sign), held
    to 2·lr. No EMA in either."""
    jmodel, params = _jax_setup()
    lr = 1e-3
    jconfig = jdiffusion.TrainConfig(learning_rate=lr, lr_schedule_interval=1,
                                     lr_gamma=0.9)
    jstate = jtrainer.create_train_state(jax.random.PRNGKey(0), jmodel,
                                         (1, S, C), jconfig)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jstep = jtrainer.make_train_step(
        jmodel, joptimizer.stepped_exponential_schedule(lr, 1, 0.9))
    config = trainer.TrainConfig(learning_rate=lr, lr_schedule_interval=1,
                                 lr_gamma=0.9, ema=True)
    state = trainer.create_train_state(_port(params), config, init=False)
    assert state.ema_params is None and jstate.ema_params is None
    batch = _x(2)
    jstate, jm = jstep(jstate, jnp.asarray(batch))
    state, tm = trainer.make_train_step()(state, torch.from_numpy(batch))
    for key in ("loss", "grad", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    ref_opt = _jax_opt_state_tree(jstate)
    for key in ("mu", "nu"):
        for name, ref in ref_opt[key].items():
            _close(state.opt_state[key][name], ref.numpy(), 1e-4)
    for name, ref in flatten(jstate.params).items():
        ref = np.asarray(ref)
        diff = np.abs(state.params[name].detach().numpy() - ref)
        small = np.sqrt(ref_opt["nu"][name].numpy() / (1 - 0.999)) < 1e-5
        assert ((diff <= 1e-2 * lr) | small).all(), (name, diff.max())
        assert diff.max() <= 2 * lr, (name, diff.max())


def test_eval_step_matches_jax():
    jmodel, params = _jax_setup()
    batch = _x(3)
    ref = jtrainer.make_eval_step(jmodel)(params, jnp.asarray(batch))
    ours = trainer.make_eval_step()(_port(params), torch.from_numpy(batch))
    np.testing.assert_allclose(float(ours), float(ref), rtol=F32_RTOL)


# -- serving ------------------------------------------------------------------------

def test_gates_match_jax():
    rng = np.random.default_rng(4)
    real = rng.normal(size=(500, 5, 3)).astype(np.float32) * 2 + 1
    pool = rng.normal(size=(700, 5, 3)).astype(np.float32)
    gen = real * 1.5 + 0.3
    assert gates.gaussian_baseline_nll(real) == \
        jgates.gaussian_baseline_nll(real)
    assert gates.gaussian_baseline_nll(real, pool) == \
        jgates.gaussian_baseline_nll(real, pool)
    assert gates.marginal_deviation(real, gen) == \
        jgates.marginal_deviation(real, gen)


def _deterministic(params):
    """Component 0's pi bias raised by 100: the categorical draw picks it
    whatever the Gumbel noise (at most ~17 apart). With log_sigma capped at
    -inf its sigma is 0, so each sample is component 0's mean, and both
    packages' decodes are functions of the params alone."""
    params = jax.tree_util.tree_map(np.copy, params)
    params["params"]["mdn"]["Dense_2"]["bias"][0] += 100.0
    return params


@pytest.mark.parametrize("cached", [False, True])
def test_deterministic_decode_matches_jax(cached):
    """``ar_decode`` (its final-step resample included) and
    ``ar_decode_cached`` made deterministic in both packages agree within
    1e-4 of the norm, elementwise within 1e-4 of the largest value: each
    step's sample feeds the next."""
    jmodel, params = _jax_setup()
    params = _deterministic(params)
    model = _port(params)
    n = 4
    if cached:
        ref = jdecode.ar_decode_cached(jax.random.PRNGKey(0), jmodel, params,
                                       n, steps=S, channels=C,
                                       log_sigma_cap=-np.inf)
        ours = mdn_decode.ar_decode_cached(torch.Generator().manual_seed(0),
                                           model, n, steps=S, channels=C,
                                           log_sigma_cap=-np.inf)
    else:
        ref = jdecode.ar_decode(
            jax.random.PRNGKey(0),
            lambda t: jmodel.apply(params, t, shift=False), n, steps=S,
            channels=C, log_sigma_cap=-np.inf)
        ours = mdn_decode.ar_decode(
            torch.Generator().manual_seed(0),
            lambda t: model(t, shift=False), n, steps=S, channels=C,
            log_sigma_cap=-np.inf, device="cpu")
    ref = np.asarray(ref)
    assert ours.shape == ref.shape == (n, S, C)
    assert _rel(ours, ref) <= 1e-4
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max())
    if not cached:
        # The final step's resample: position 0 is a sample, not the zero
        # start token, and equals what the cached decode gives there.
        assert np.abs(ref[:, 0]).max() > 0


def _binomial_ok(count, n, p):
    """Within 5 standard deviations of the binomial mean."""
    return abs(count - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def test_sample_mixture_frequencies_and_moments():
    """Components drawn at their softmax(pi) frequencies and each draw from
    its component's normal: frequencies within 5 binomial standard
    deviations; each component's sample mean within 5 sigma/sqrt(n) of mu,
    its standard deviation within 5 sigma/sqrt(2n) of sigma."""
    N, D = 20000, 2
    probs = np.array([0.6, 0.3, 0.1])
    # Centers 12 sigmas and more apart: each draw names its component.
    centers, sigmas = (0.0, 50.0, -50.0), (0.5, 1.0, 2.0)
    pi = torch.log(torch.tensor(probs, dtype=torch.float32)).expand(N, 3)
    mu = torch.tensor([[c] * D for c in centers]).reshape(1, -1).expand(N, -1)
    log_sigma = torch.log(torch.tensor(
        [[s] * D for s in sigmas])).reshape(1, -1).expand(N, -1)
    out = mdn_decode.sample_mixture(torch.Generator().manual_seed(3), pi, mu,
                                    log_sigma, D).numpy()
    assert out.shape == (N, D)
    comp = np.argmin(np.abs(out[:, :1] - np.asarray(centers)[None]), axis=1)
    for k, (p, c, s) in enumerate(zip(probs, centers, sigmas)):
        draws = out[comp == k]
        n = len(draws)
        assert _binomial_ok(n, N, p), (k, n)
        assert np.abs(draws.mean(0) - c).max() <= 5 * s / np.sqrt(n)
        assert np.abs(draws.std(0) - s).max() <= 5 * s / np.sqrt(2 * n)


def test_sample_mixture_cap():
    """The cap bounds a huge-variance component and leaves components
    below it untouched (the same draws, bit for bit)."""
    N, D = 4096, 2
    pi = torch.zeros(N, 2)
    mu = torch.zeros(N, 2 * D)
    wild = torch.tensor([-1.0, -1.0, 6.0, 6.0]).expand(N, -1)
    tight = torch.tensor([-1.0, -1.0, -2.0, -2.0]).expand(N, -1)

    def draw(log_sigma, cap):
        return mdn_decode.sample_mixture(torch.Generator().manual_seed(0),
                                         pi, mu, log_sigma, D, cap)

    assert float(draw(wild, None).abs().max()) > 50.0
    assert float(draw(wild, 0.0).abs().max()) < 10.0
    assert torch.equal(draw(tight, None), draw(tight, 0.0))


# -- the S=512 causal flash route -----------------------------------------------------

def test_flash_route_forward_and_gradient_match_jax(monkeypatch):
    """The MDN over 512 positions with the flash route forced in both
    packages (the JAX kernel interpreted, the port's wrapper on its plain
    version): one causal flash call a layer each; the outputs and every
    parameter's NLL gradient within 1e-4 of the norm (float32, as the
    flagship's S=512 test)."""
    calls = _force_flash_route(monkeypatch)
    kw = dict(num_layers=1, embed_channels=32, mdn_mixtures=2)
    jmodel, params = _jax_setup(seq_len=512, channels=4, **kw)
    model = _port(params, channels=4, **kw)
    x = _x(5, (1, 512, 4))
    calls[:] = [0, 0]

    def jloss(p):
        return jlosses.mdn_nll(*jmodel.apply(p, jnp.asarray(x)),
                               jnp.asarray(x))

    jval, jgrad = jax.value_and_grad(jloss)(params)
    out = model(torch.from_numpy(x))
    val = losses.mdn_nll(*out, torch.from_numpy(x))
    grads = torch.autograd.grad(val, list(model.parameters()))
    assert calls == [1, 1]
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-4)
    ref_out = jmodel.apply(params, jnp.asarray(x))
    for o, r in zip(out, ref_out):
        assert _rel(o, r) <= 1e-4
    jflat = flatten(jgrad)
    for (name, _), g in zip(model.named_parameters(), grads):
        assert _rel(g, jflat[name]) <= 1e-4, (name, _rel(g, jflat[name]))


# -- the entry points -------------------------------------------------------------------

TINY = ["--num_layers=1", "--num_heads=2", "--mlp_dims=32",
        "--batch_size=4", "--mdn_components=3", "--device=cpu"]


@pytest.fixture
def repo_root(monkeypatch):
    """The flagfiles name each other relative to the repository root."""
    monkeypatch.chdir(ROOT)


def test_flags_match_the_jax_clis():
    """sample_mdn's own flags, and their defaults, are those of the JAX
    package's ``sample_mdn.py`` (read from its source, which defines them
    at import into absl's global flags)."""
    tree = ast.parse((ROOT / "sample_mdn.py").read_text())
    ref = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "").startswith("DEFINE_"):
            ref[node.args[0].value] = ast.literal_eval(node.args[1])
    assert ref == {name: cli.FLAGS._flags[name].default for name in ref}
    assert len(ref) == 5


def test_clis_train_resume_sample_and_flush(tmp_path, repo_root):
    data, model_dir = tmp_path / "data", tmp_path / "model"
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("eval", 8)):
        records.write_tfrecord(f"{data}/{split}-0.tfrecord",
                               rng.normal(size=(n, 32, 512)).astype(
                                   np.float32))
    argv = ["--flagfile=configs/mdn-mel-32seq-512.cfg", f"--dataset={data}",
            "--slice_ckpt=checkpoints/slice-mel-512.pkl",
            f"--model_dir={model_dir}", "--snapshot_freq=2", *TINY]
    steps = []
    state = train_mdn.main(["train_mdn", *argv, "--max_steps=3"],
                           step_callback=lambda s, m: steps.append(
                               float(m["loss"])))
    assert state.step == 3 and len(steps) == 3
    assert np.isfinite(steps).all() and state.ema_params is None
    assert cli.FLAGS.architecture == "TransformerMDN"
    assert sorted(os.listdir(model_dir / "ckpt")) == ["2.pt", "3.pt"]
    resumed = []
    state = train_mdn.main(["train_mdn", *argv, "--max_steps=5"],
                           step_callback=lambda s, m: resumed.append(s))
    assert resumed == [4, 5] and state.step == 5

    out = tmp_path / "samples"
    serve = ["sample_mdn", *argv, "--sample_size=4",
             f"--sampling_dir={out}"]
    gen, readings = sample_mdn.main(serve)
    assert gen.shape == (4, 32, 42) and np.isfinite(gen).all()
    assert set(readings) == {"gaussian_nll", "heldout_nll",
                             "marginal_deviation"}
    for name in ("real", "generated"):
        assert (out / "mdn" / f"{name}.pkl").exists()
    gen, _ = sample_mdn.main([*serve, "--nocached_decode", "--noflush",
                              "--mdn_sigma_cap=inf", "--nll_gate=off"])
    assert gen.shape == (4, 32, 42) and np.isfinite(gen).all()
    # Five steps on random latents beat no Gaussian baseline by 8 nats.
    with pytest.raises(SystemExit, match="REFUSING TO DECODE"):
        sample_mdn.main([*serve, "--nll_gate=fail"])


def test_clis_need_a_gpu_or_device_cpu(tmp_path, monkeypatch, repo_root):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--flagfile=configs/mdn-mel-32seq-512.cfg",
            f"--dataset={tmp_path}", f"--model_dir={tmp_path}/m"]
    for main in (train_mdn.main, sample_mdn.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["prog", *argv])
    with pytest.raises(ValueError, match="mesh 0x2 does not cover 1"):
        train_mdn.main(["train_mdn", *argv, "--model_parallelism=2",
                        "--device=cpu"])
