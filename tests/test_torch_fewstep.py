"""The port's few-step samplers and generation drivers against ``smd_tpu``'s.

DDIM, DPM-Solver++, the distilled and consistency samplers, the stochastic
encoder, interpolation and the infill masks, on a small TransformerDDPM
(2 layers, embed 32, MLP 64, float32) with the JAX weights carried over and
the JAX draws replayed (each JAX step splits its key as the sampler's
docstring says). The integer timesteps of DDIM and DPM++ are held equal to
JAX's over a sweep of (T, steps).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.diffusion import samplers as jsamplers
from smd_tpu.diffusion import schedules as jschedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.sampling import generate as jgenerate
from smd_tpu.training import distill as jdistill
from smd_tpu_torch.diffusion import samplers, schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.sampling import generate
from smd_tpu_torch.training import distill
from smd_tpu_torch.utils import logging as log_lib
from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                             random_flax_params)

KW = dict(num_layers=2, num_heads=4, num_mlp_layers=2, mlp_dims=64,
          embed_channels=32)
B, S, C, T = 2, 16, 8, 50
SHAPE = (B, S, C)
# Each sampler runs two models in both packages. ``tanh``, tanh(x·w + c),
# which both compute to the last ulp, holds the samplers' arithmetic to
# 1e-5. The TransformerDDPM's outputs differ by up to ~4e-5 between the
# packages (the noise embedding's one-ulp exp channels, tests/
# test_torch_model.py), which x0 = (x - s·eps)/a scales by up to 1/a and
# the chain carries on: 1.3e-4 measured after 10 DDIM steps; held to 5e-4.
TOLS = {"tanh": 1e-5, "transformer": 5e-4}


def _make_models():
    model = get_model("TransformerDDPM", device="cpu", data_channels=C, **KW)
    params = random_flax_params(model, seed=7)
    load_flax_params(model, params).eval().requires_grad_(False)
    jmodel = jax_get_model("TransformerDDPM", **KW)
    return jax.jit(lambda x, c: jmodel.apply(params, x, c)), model


@pytest.fixture(scope="module")
def transformer():
    return _make_models()


@pytest.fixture
def fns(request, transformer):
    """(JAX model_fn, port model_fn, tolerance) for ``request.param``."""
    if request.param == "transformer":
        return (*transformer, TOLS["transformer"])
    w = np.random.default_rng(3).normal(size=(S, C)).astype(np.float32)
    return (lambda x, c: jnp.tanh(x * w + c),
            lambda x, c: torch.tanh(x * torch.from_numpy(w) + c),
            TOLS["tanh"])


def _betas(num=T):
    return (jschedules.noise_schedule(1e-4, 0.05, num, "linear"),
            schedules.noise_schedule(1e-4, 0.05, num, "linear"))


def _init(seed=0):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


def _infill():
    samples = np.random.default_rng(3).uniform(-1, 1, SHAPE) \
        .astype(np.float32)
    masks = np.zeros(SHAPE, np.float32)
    masks[:, :4] = 1
    masks[:, -4:] = 1
    return samples, masks


def _replayed(key, steps, parts):
    """Each step's ``split(key, parts)`` draws after the carry, stacked by
    position: a tuple of ``parts - 1`` arrays (steps, *SHAPE)."""
    out = [[] for _ in range(parts - 1)]
    for _ in range(steps):
        key, *subs = jax.random.split(key, num=parts)
        for o, k in zip(out, subs):
            o.append(np.asarray(jax.random.normal(k, SHAPE)))
    return tuple(torch.from_numpy(np.stack(o)) for o in out)


def _pair(infill):
    """JAX and port infill kwargs."""
    if not infill:
        return {}, {}
    s, m = _infill()
    return (dict(infill_samples=jnp.asarray(s), infill_masks=jnp.asarray(m)),
            dict(infill_samples=torch.from_numpy(s),
                 infill_masks=torch.from_numpy(m)))


def _close(ours, ref, tol):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)


# -- timesteps ----------------------------------------------------------------

# (T, step counts): every count at T=20 and T=100, the first 40 and a few
# large ones at T=1000 (each count is a compile on the JAX side).
SWEEP = ((20, range(1, 21)), (100, range(1, 101)),
         (1000, [*range(1, 41), 50, 64, 100, 128, 250, 500, 999, 1000]))


@functools.partial(jax.jit, static_argnums=2)
def _jax_linspace(start, stop, num):
    """``jnp.linspace`` with traced ends, as the eager samplers call it."""
    return jnp.linspace(start, stop, num)


def test_ddim_taus_equal_jax():
    """``linspace_f32`` is ``jnp.linspace`` bit for bit, so the rounded DDIM
    timesteps are JAX's."""
    for T_, counts in SWEEP:
        for n in counts:
            ref = np.asarray(_jax_linspace(0.0, T_ - 1.0, n))
            np.testing.assert_array_equal(
                schedules.linspace_f32(0, T_ - 1, n), ref)
            np.testing.assert_array_equal(samplers.ddim_taus(T_, n),
                                          np.round(ref).astype(np.int64))
    # The trap: torch's float32 linspace rounds index 5 down to 166.5.
    assert schedules.linspace_f32(0, 999, 31)[5] == np.float32(166.50002)
    assert samplers.ddim_taus(1000, 31)[5] == 167
    assert round(float(torch.linspace(0, 999, 31)[5])) == 166


def _jax_dpmpp_taus(lam_all, num_steps, lam_max):
    """``smd_tpu/diffusion/samplers.py:455-470`` on JAX's ``lam_all``:
    ``jnp.linspace`` on the card's side of the trap, the rest (exact
    float32 subtraction and comparisons, integer cummax) in numpy."""
    T_ = lam_all.shape[0]
    lam_hi = lam_all[0] if lam_max is None else \
        np.minimum(lam_all[0], np.float32(lam_max))
    lam_grid = np.asarray(_jax_linspace(lam_hi, lam_all[T_ - 1], num_steps))
    taus = np.argmin(np.abs(lam_all[None, :] - lam_grid[:, None]), axis=1)
    k = np.arange(num_steps)
    return np.minimum(np.maximum.accumulate(taus - k) + k, T_ - 1)


@pytest.mark.parametrize("lam_max", [2.5, None])
def test_dpmpp_taus_equal_jax(lam_max):
    for T_, counts in ((20, range(2, 21)), (100, range(2, 41)),
                       (1000, [*range(2, 26), 50, 100, 200])):
        betas = schedules.noise_schedule(1e-6, 0.01, T_, "linear")
        ap = schedules.ddpm_constants(betas).alphas_prod
        jap = jschedules.ddpm_constants(jnp.asarray(betas.numpy())) \
            .alphas_prod
        # samplers.py:447, as the eager sampler computes it.
        lam_all = np.asarray(0.5 * (jnp.log(jap) - jnp.log1p(-jap)))
        for n in counts:
            np.testing.assert_array_equal(
                samplers.dpmpp_taus(ap, n, lam_max),
                _jax_dpmpp_taus(lam_all, n, lam_max),
                err_msg=f"T={T_}, {n} steps")


# -- the samplers -------------------------------------------------------------

@pytest.mark.parametrize("fns,eta,infill", [
    ("tanh", 0.0, False), ("tanh", 0.0, True), ("tanh", 1.0, False),
    ("tanh", 1.0, True), ("transformer", 1.0, True)], indirect=["fns"])
def test_ddim_matches_jax(fns, eta, infill):
    jfn, tfn, tol = fns
    jb, tb = _betas()
    jin, tin = _pair(infill)
    key, steps = jax.random.PRNGKey(5), 10
    ref = jsamplers.ddim_dynamics(key, jfn, jb, jnp.asarray(_init()),
                                  num_steps=steps, eta=eta, collect_steps=4,
                                  collect_metrics=True, **jin)
    with torch.no_grad():
        out = samplers.ddim_dynamics(None, tfn, tb,
                                     torch.from_numpy(_init()),
                                     num_steps=steps, eta=eta,
                                     collect_steps=4, collect_metrics=True,
                                     **tin, noise=_replayed(key, steps, 3))
    assert out.collection.shape == (5, *SHAPE)
    assert out.metrics.shape == (4, steps, 1)
    _close(out.state, ref.state, tol)
    _close(out.collection, ref.collection, tol)
    _close(out.metrics, ref.metrics, tol)
    if infill:
        s, m = _infill()
        np.testing.assert_array_equal(out.state.numpy()[m == 1], s[m == 1])


@pytest.mark.parametrize("fns,lam_max,steps", [
    ("tanh", 2.5, 8), ("tanh", None, 8), ("tanh", 2.5, 19),
    ("transformer", 2.5, 8)], indirect=["fns"])
def test_dpmpp_matches_jax(fns, lam_max, steps):
    """19 steps on T=20 forces duplicate timesteps (h == 0): the guard
    keeps the chain finite in both packages."""
    jfn, tfn, tol = fns
    num = 20 if steps == 19 else T
    jb, tb = _betas(num)
    taus = samplers.dpmpp_taus(schedules.ddpm_constants(tb).alphas_prod,
                               steps, lam_max)
    assert (np.diff(taus) == 0).any() == (steps == 19)
    jin, tin = _pair(True)
    key = jax.random.PRNGKey(6)
    ref = jsamplers.dpmpp_dynamics(key, jfn, jb, jnp.asarray(_init(1)),
                                   num_steps=steps, lam_max=lam_max,
                                   collect_steps=3, collect_metrics=True,
                                   **jin)
    (noise,) = _replayed(key, steps, 2)
    with torch.no_grad():
        out = samplers.dpmpp_dynamics(None, tfn, tb,
                                      torch.from_numpy(_init(1)),
                                      num_steps=steps, lam_max=lam_max,
                                      collect_steps=3, collect_metrics=True,
                                      **tin, noise=noise)
    assert torch.isfinite(out.state).all()
    _close(out.state, ref.state, tol)
    _close(out.collection, ref.collection, tol)
    _close(out.metrics, ref.metrics, tol)


@pytest.mark.parametrize("fns,num_steps,infill", [
    ("tanh", 1, False), ("tanh", 4, True), ("transformer", 4, True)],
    indirect=["fns"])
def test_distilled_matches_jax(fns, num_steps, infill):
    jfn, tfn, tol = fns
    jb, tb = _betas()
    jin, tin = _pair(infill)
    key = jax.random.PRNGKey(7)
    ref = jsamplers.distilled_ddim_dynamics(
        key, jfn, jdistill.distill_grid(jb, num_steps), jnp.asarray(_init()),
        **jin)
    (noise,) = _replayed(key, num_steps, 2)
    with torch.no_grad():
        out = samplers.distilled_ddim_dynamics(
            None, tfn, distill.distill_grid(tb, num_steps),
            torch.from_numpy(_init()), **tin, noise=noise)
    assert out.collection is None and out.metrics is None
    _close(out.state, ref.state, tol)


@pytest.mark.parametrize("fns,k,infill", [
    ("tanh", 1, False), ("tanh", 3, True), ("transformer", 3, True)],
    indirect=["fns"])
def test_consistency_matches_jax(fns, k, infill):
    jfn, tfn, tol = fns
    jb, tb = _betas()
    jgrid, _ = jdistill.halve_grid(jdistill.distill_grid(jb, 16))
    grid, _ = distill.halve_grid(distill.distill_grid(tb, 16))
    jin, tin = _pair(infill)
    key = jax.random.PRNGKey(8)
    ref = jsamplers.consistency_dynamics(key, jfn, jgrid,
                                         jnp.asarray(_init()), num_steps=k,
                                         **jin)
    with torch.no_grad():
        out = samplers.consistency_dynamics(None, tfn, grid,
                                            torch.from_numpy(_init()),
                                            num_steps=k, **tin,
                                            noise=_replayed(key, k, 3))
    _close(out.state, ref.state, tol)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="outside"):
            samplers.consistency_dynamics(None, tfn, grid,
                                          torch.from_numpy(_init()),
                                          num_steps=bad)


def test_stochastic_encoder_matches_jax():
    jb, tb = _betas(1000)
    real = np.random.default_rng(4).uniform(-1, 1, SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jsamplers.diffusion_stochastic_encoder(key, jnp.asarray(real), jb)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, SHAPE)))
    out = samplers.diffusion_stochastic_encoder(None, torch.from_numpy(real),
                                                tb, noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_collate_and_log_sampling_metrics_match_jax(tmp_path, monkeypatch):
    """The collated dicts, and the scalars ``log_sampling_metrics`` hands
    its SummaryWriter: each level's slope, step, alpha and noise at step
    ``steps·level + j``, the JAX ``log_metrics``' numbering."""
    metrics = np.random.default_rng(0).normal(size=(4, 3, 5)) \
        .astype(np.float32)
    ref = jsamplers.collate_sampling_metrics(jnp.asarray(metrics))
    ours = samplers.collate_sampling_metrics(torch.from_numpy(metrics))
    assert ours == ref and len(ours) == 3 and len(ours[0]) == 5
    assert samplers.collate_sampling_metrics(None) == []

    logged = []

    class Writer:
        def __init__(self, log_dir):
            logged.append(log_dir)

        def scalar(self, tag, value, step):
            logged.append((tag, float(value), int(step)))

        def flush(self):
            pass

    monkeypatch.setattr(log_lib, "SummaryWriter", Writer)
    log_lib.log_sampling_metrics(torch.from_numpy(metrics), 2, str(tmp_path))
    assert logged == [f"{tmp_path}/sampling_epoch2"] + [
        (tag, float(value), 5 * i + j) for i, level in enumerate(ref)
        for j, step in enumerate(level) for tag, value in step.items()]


# -- the generation drivers ---------------------------------------------------

@pytest.mark.parametrize("problem,shape", [("toy", (6, 2)),
                                           ("vae", (3, 32, 5))])
def test_infill_edge_mask_matches_jax(problem, shape):
    real = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    for ours, ref in zip(generate.infill_edge_mask(real, problem),
                         jgenerate.infill_edge_mask(real, problem)):
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(generate.interpolation_endpoints(real),
                         jgenerate.interpolation_endpoints(real)):
        np.testing.assert_array_equal(ours, ref)


def test_interpolate_matches_jax(transformer):
    jfn, model = transformer
    jb, tb = _betas(10)
    real = np.random.default_rng(5).uniform(-1, 1, SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(10)
    ref, _, _ = jgenerate.interpolate(jfn, jb, key, real, num_alphas=3)
    # JAX: split(key, 3) -> (carry, starts, goals), then per interpolant
    # split(carry) -> (carry, chain) with the chain's (infill, noise) draws.
    key, enc1, enc2 = jax.random.split(key, num=3)
    chains = []
    for _ in range(3):
        key, ld = jax.random.split(key)
        chains.append(_replayed(ld, 10, 3))
    noise = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, SHAPE)))
                  for k in (enc1, enc2))
    out, collections, metrics = generate.interpolate(
        model, tb, None, real, num_alphas=3, device="cpu",
        noise=(*noise, chains))
    assert out.shape == (3, *SHAPE) and len(collections) == len(metrics) == 3
    _close(out, ref, TOLS["transformer"])


@pytest.mark.parametrize("sampling", ["ddim", "dpmpp", "distilled",
                                      "consistency"])
def test_generate_sample_fewstep_on_cpu(transformer, sampling):
    """One generator draws the initial state, then the sampler's noise."""
    _, model = transformer
    _, tb = _betas(20)
    grid = distill.distill_grid(tb, 4)
    kw = dict(ddim_steps=3, distill_grid=grid)
    state, coll, metrics = generate.sample(
        model, tb, torch.Generator().manual_seed(0), (S, C), num_samples=3,
        sampling=sampling, ddim_eta=1.0, device="cpu", **kw)
    gen = torch.Generator().manual_seed(0)
    init = generate.make_init(gen, 3, (S, C), sampling, device="cpu")
    direct = {
        "ddim": lambda: samplers.ddim_dynamics(
            gen, model, tb, init, num_steps=3, eta=1.0, collect_steps=40,
            collect_metrics=True),
        "dpmpp": lambda: samplers.dpmpp_dynamics(
            gen, model, tb, init, num_steps=3, collect_metrics=True),
        "distilled": lambda: samplers.distilled_ddim_dynamics(
            gen, model, grid, init),
        "consistency": lambda: samplers.consistency_dynamics(
            gen, model, grid, init, num_steps=3)}[sampling]()
    assert state.shape == (3, S, C) and torch.isfinite(state).all()
    assert torch.equal(state, direct.state)
    # DDIM collects by default; DPM++ only when asked for.
    assert (coll is not None) == (sampling == "ddim")
    if sampling == "ddim":
        assert coll.shape == (4, 3, S, C) and metrics.shape == (4, 3, 1)
    if sampling == "dpmpp":
        _, coll, _ = generate.sample(
            model, tb, torch.Generator().manual_seed(0), (S, C),
            num_samples=3, sampling="dpmpp", device="cpu",
            ensure_snapshots=True, **kw)
        assert coll.shape == (4, 3, S, C)
    if sampling in ("distilled", "consistency"):
        with pytest.raises(ValueError, match="grid"):
            generate.sample(model, tb, None, (S, C), sampling=sampling,
                            device="cpu")


@pytest.mark.parametrize("objective", ["progressive", "consistency"])
def test_port_samples_a_jax_distilled_student(transformer, objective):
    """A student distilled by the JAX package (two steps from the test
    model), carried over with ``load_flax_params``, samples in the port as
    in JAX: the distilled sampler on its stage's grid, the consistency
    sampler in 1 and 2 steps on its bundle's grid (the TransformerDDPM's
    tolerance)."""
    from smd_tpu.training import consistency as jconsistency
    _, model = transformer
    jmodel = jax_get_model("TransformerDDPM", **KW)
    params = random_flax_params(model, seed=7)
    jb, _ = _betas()
    rng = np.random.default_rng(6)
    batches = (rng.uniform(-1, 1, SHAPE).astype(np.float32)
               for _ in iter(int, 1))
    if objective == "progressive":
        out = jdistill.progressive_distill(
            jmodel, params, jb, batches, start_steps=2, end_steps=2,
            steps_per_stage=2, scan_chunk=1)[2]
        runs = [(jsamplers.distilled_ddim_dynamics,
                 samplers.distilled_ddim_dynamics, {}, 2)]
    else:
        out = jconsistency.consistency_distill(
            jmodel, params, jb, batches, num_segments=4, steps=2,
            scan_chunk=1)
        runs = [(jsamplers.consistency_dynamics,
                 samplers.consistency_dynamics, dict(num_steps=k), 3)
                for k in (1, 2)]
    student = get_model("TransformerDDPM", device="cpu", data_channels=C,
                        **KW)
    load_flax_params(student, out["params"]).requires_grad_(False)
    grid = np.asarray(out["grid"])
    key = jax.random.PRNGKey(11)
    for jfn, tfn, kw, parts in runs:
        ref = jfn(key, lambda x, c: jmodel.apply(out["params"], x, c),
                  jnp.asarray(grid), jnp.asarray(_init(2)), **kw)
        steps = kw.get("num_steps", grid.shape[0] - 1)
        replay = _replayed(key, steps, parts)
        with torch.no_grad():
            ours = tfn(None, student, grid, torch.from_numpy(_init(2)),
                       **kw, noise=replay if parts == 3 else replay[0])
        _close(ours.state, ref.state, TOLS["transformer"])
