"""The port's annealed (ALD) and consistent (CAS) Langevin samplers against
``smd_tpu``'s, and the replay buffer's semantics.

Each chain runs in both packages from the same initial state with the JAX
draws replayed (each JAX step splits its key into (carry, noise, infill)),
with snapshot collection, metrics and infill masks: on a tanh score model
both packages compute to within tanh's ulp, and on a 1-layer DenseNCSN with the
JAX weights carried over (both packages on XLA's exp table, as in
``tests/test_torch_ncsn_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ncsn_models import xla_frequencies  # noqa: F401

from smd_tpu.diffusion import samplers as jsamplers
from smd_tpu.diffusion import schedules as jschedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.sampling import generate as jgenerate
from smd_tpu_torch.diffusion import samplers, schedules
from smd_tpu_torch.diffusion.replay import ReplayBuffer
from smd_tpu_torch.models import get_model
from smd_tpu_torch.sampling import generate
from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                             random_flax_params)

B, D = 3, 8
SHAPE = (B, D)
L, T = 5, 3
EPSILON = 2e-5    # alpha = 0.2 at the noisiest level
# tanh: the samplers' arithmetic; XLA's and torch's tanh differ by an ulp
# in a few elements, which 15 steps carry to 3 ulps: held to 4 ulps of the
# chain's scale (2**-21). ncsn: a 1-layer DenseNCSN whose outputs differ
# between the packages by float32 rounding only, which the 1/sigma output
# scale (up to 100) and 15 or 5 steps carry on: held to 1e-4 of the scale.
TOLS = {"tanh": 2.0 ** -21, "ncsn": 1e-4}


def _sigmas():
    return (jschedules.noise_schedule(1.0, 0.01, L, "geometric"),
            schedules.noise_schedule(1.0, 0.01, L, "geometric"))


def _tanh_fns():
    w = np.random.default_rng(3).normal(size=(D,)).astype(np.float32)
    return (lambda x, s: jnp.tanh(x * w + s),
            lambda x, s: torch.tanh(x * torch.from_numpy(w) + s))


def _ncsn_fns():
    model = get_model("DenseNCSN", device="cpu", data_channels=D,
                      num_layers=1, mlp_dims=32)
    params = random_flax_params(model, seed=5)
    load_flax_params(model, params).eval().requires_grad_(False)
    jmodel = jax_get_model("DenseNCSN", num_layers=1, mlp_dims=32)
    return jax.jit(lambda x, s: jmodel.apply(params, x, s)), model


def _replayed(key, steps):
    """Each step's (noise, infill) draws after the carry of
    ``split(key, 3)``, stacked: two arrays (steps, *SHAPE)."""
    out = ([], [])
    for _ in range(steps):
        key, *subs = jax.random.split(key, num=3)
        for o, k in zip(out, subs):
            o.append(np.asarray(jax.random.normal(k, SHAPE)))
    return tuple(torch.from_numpy(np.stack(o)) for o in out)


def _infill():
    samples = np.random.default_rng(4).uniform(-1, 1, SHAPE) \
        .astype(np.float32)
    masks = np.zeros(SHAPE, np.float32)
    masks[:, :2] = 1
    return samples, masks


@pytest.mark.parametrize("infill", [False, True])
@pytest.mark.parametrize("model", ["tanh", "ncsn"])
@pytest.mark.parametrize("sampler", ["ald", "cas"])
def test_chain_matches_jax(sampler, model, infill, xla_frequencies):
    jfn, fn = _tanh_fns() if model == "tanh" else _ncsn_fns()
    jsig, sig = _sigmas()
    init = np.random.default_rng(0).uniform(-1.7, 1.7, SHAPE) \
        .astype(np.float32)
    key = jax.random.PRNGKey(9)
    steps = L * T if sampler == "ald" else L
    jkw, kw = {}, {}
    if infill:
        s, m = _infill()
        jkw = dict(infill_samples=jnp.asarray(s), infill_masks=jnp.asarray(m))
        kw = dict(infill_samples=torch.from_numpy(s),
                  infill_masks=torch.from_numpy(m))
    jsampler, ours_sampler = {
        "ald": (jsamplers.annealed_langevin_dynamics,
                samplers.annealed_langevin_dynamics),
        "cas": (jsamplers.consistent_langevin_dynamics,
                samplers.consistent_langevin_dynamics)}[sampler]
    ref = jsampler(key, jfn, jsig, jnp.asarray(init), EPSILON, T, **jkw,
                   collect_steps=4, collect_metrics=True)
    with torch.no_grad():
        out = ours_sampler(None, fn, sig, torch.from_numpy(init), EPSILON, T,
                           **kw, collect_steps=4, collect_metrics=True,
                           noise=_replayed(key, steps))
    # 4 snapshots, the start and the final denoise step.
    assert out.collection.shape == (6, *SHAPE)
    assert out.metrics.shape == ((4, L, T) if sampler == "ald"
                                 else (4, L, 1))
    tol = TOLS[model]
    scale = float(np.abs(np.asarray(ref.collection)).max())
    for ours, theirs in ((out.state, ref.state),
                         (out.collection, ref.collection)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=tol * scale, rtol=0)
    # Norms of the same arrays, and the float32 step sizes bit for bit.
    np.testing.assert_array_equal(out.metrics[2].numpy(),
                                  np.asarray(ref.metrics[2]))
    np.testing.assert_allclose(out.metrics.numpy(), np.asarray(ref.metrics),
                               rtol=max(tol, 1e-6), atol=1e-6)


@pytest.mark.parametrize("sampling", ["ald", "cas"])
def test_generate_sample_serves_the_langevin_samplers(sampling):
    """``generate.sample``: ``ald`` is the default; the initial state is
    U(-sqrt(12)/2, sqrt(12)/2) as in JAX; the default collection holds 100
    snapshots (fewer steps: all), the start and the denoise step."""
    _, sig = _sigmas()
    _, fn = _tanh_fns()
    gen = torch.Generator().manual_seed(0)
    kw = {} if sampling == "ald" else dict(sampling="cas")
    state, coll, metrics = generate.sample(fn, sig, gen, (D,), num_samples=B,
                                           epsilon=EPSILON, steps=T,
                                           device="cpu", **kw)
    steps = L * T if sampling == "ald" else L
    assert state.shape == SHAPE and torch.isfinite(state).all()
    assert coll.shape == (steps + 2, *SHAPE)
    assert metrics.shape == (4, L, T if sampling == "ald" else 1)
    rho = float(np.sqrt(12) / 2)
    assert float(coll[0].abs().max()) <= rho
    collated = samplers.collate_sampling_metrics(metrics)
    assert len(collated) == L and set(collated[0][0]) == \
        {"slope", "step", "alpha", "noise"}
    # The JAX package's collection and metrics shapes.
    jstate, jcoll, jmetrics = jgenerate.sample(
        _tanh_fns()[0], _sigmas()[0], jax.random.PRNGKey(0), (D,),
        num_samples=B, epsilon=EPSILON, steps=T, **kw)
    assert jcoll.shape == coll.shape and jmetrics.shape == metrics.shape
    # Without collection or metrics, and with the denoise step off.
    state2, coll2, metrics2 = generate.sample(
        fn, sig, torch.Generator().manual_seed(0), (D,), num_samples=B,
        epsilon=EPSILON, steps=T, denoise=False, collect_steps=0,
        collect_metrics=False, device="cpu", **kw)
    assert coll2 is None and metrics2 is None and state2.shape == SHAPE


def test_replay_buffer_semantics():
    gen = torch.Generator().manual_seed(0)
    buf = ReplayBuffer.create(64, 4, gen, device="cpu")
    assert buf.data.shape == (64, 4)
    assert float(buf.data.min()) >= 0 and float(buf.data.max()) < 1
    new = buf.add(torch.full((8, 4), 7.0))
    # Immutable: the old buffer is unchanged; the new one holds the samples
    # first and drops the 8 oldest entries.
    assert torch.equal(new.data[:8], torch.full((8, 4), 7.0))
    assert torch.equal(new.data[8:], buf.data[:-8])
    assert not torch.equal(buf.data[:8], new.data[:8])
    # p=1: every vector from the buffer, distinct entries.
    out = new.sample(gen, 16, p=1.0)
    assert out.shape == (16, 4)
    rows = {tuple(r.tolist()) for r in out}
    assert len(rows) == 16 and rows <= {tuple(r.tolist()) for r in new.data}
    # p=0: every vector fresh, U[0, 1).
    fresh = new.sample(gen, 16, p=0.0)
    assert float(fresh.min()) >= 0 and float(fresh.max()) < 1
    assert not any(tuple(r.tolist()) in rows for r in fresh)
    # The share taken from the buffer follows p.
    full = ReplayBuffer(4096, 1, torch.full((4096, 1), 5.0))
    share = float((full.sample(gen, 4096, p=0.95) == 5.0).double().mean())
    assert abs(share - 0.95) < 0.02
