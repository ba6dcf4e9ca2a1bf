"""The sampler chains and the MDN decodes as one step body over staged
tables (``smd_tpu_torch/utils/graphs.py``), on the CPU.

On the card the step is captured in a CUDA graph and replayed once a step;
here the same body runs eagerly, reading the same staged tables and
per-call buffers, so these tests hold what the graph reads: every table
entry equals the host float the eager loop used bit for bit, the collection
writes land where ``_collection_slots`` says, a kept chain serves a second
call with another schedule as a fresh chain would, and the cached decode
over a device-tensor cache index equals JAX's with JAX's draws replayed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.sampling import mdn_decode as jdecode
from smd_tpu_torch.diffusion import samplers, schedules
from smd_tpu_torch.sampling import mdn_decode
from smd_tpu_torch.training import distill
from smd_tpu_torch.utils import graphs
from test_torch_mdn import C as MDN_C
from test_torch_mdn import S as MDN_S
from test_torch_mdn import _deterministic, _jax_setup, _port, _rel

f32 = np.float32
SHAPE = (3, 8, 4)
T = 12


@pytest.fixture(autouse=True)
def _fresh_chains():
    graphs.release()
    yield
    graphs.release()


def _tanh_fn(seed=3):
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        size=SHAPE[1:]).astype(f32))
    return lambda x, c: torch.tanh(x * w + c)


def _init(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=SHAPE).astype(f32))


def _infill():
    rng = np.random.default_rng(5)
    samples = torch.from_numpy(rng.uniform(-1, 1, SHAPE).astype(f32))
    masks = torch.zeros(SHAPE)
    masks[:, :2] = 1
    return dict(infill_samples=samples, infill_masks=masks)


def _betas(end=0.05, num=T):
    return schedules.noise_schedule(1e-4, end, num, "linear")


# -- the staged tables ---------------------------------------------------

def test_ddpm_table_is_the_host_floats_and_reaches_the_model():
    """DDPM's seven constants a step as the loop took them (t = T-1-i; at
    t = 0 no noise and the infill samples themselves), and the model's
    noise-level input read back from inside the steps."""
    c = schedules.ddpm_constants(_betas())
    tables = samplers.ddpm_tables(c)
    host = {k: getattr(c, k).numpy() for k in (
        "alphas_prod", "sqrt_alphas_prod", "sqrt_recip_alphas_prod",
        "sqrt_alphas_prod_m1", "posterior_mu1", "posterior_mu2",
        "posterior_log_var")}
    one = f32(1.0)
    for i, t in enumerate(range(T - 1, -1, -1)):
        row = {n: tables[n][i] for n in tables}
        assert row["cond"] == host["sqrt_alphas_prod"][t]
        assert row["recip"] == host["sqrt_recip_alphas_prod"][t]
        assert row["m1"] == host["sqrt_alphas_prod_m1"][t]
        assert row["mu1"] == host["posterior_mu1"][t]
        assert row["mu2"] == host["posterior_mu2"][t]
        assert row["level"] == host["alphas_prod"][t]
        if t > 0:
            assert row["noise_scale"] == np.exp(
                f32(0.5) * host["posterior_log_var"][t])
            assert row["y_a"] == host["sqrt_alphas_prod"][t]
            assert row["y_b"] == np.sqrt(one - host["alphas_prod"][t])
        else:
            assert (row["noise_scale"], row["y_a"], row["y_b"]) == (0, 1, 0)
    assert all(v.dtype == f32 and v.shape == (T,) for v in tables.values())
    seen = []
    fn = _tanh_fn()

    def spy(x, cond):
        seen.append(cond.reshape(-1).clone())
        return fn(x, cond)

    samplers.diffusion_dynamics(torch.Generator().manual_seed(0), spy,
                                _betas(), _init(), collect_steps=0,
                                collect_metrics=False)
    assert all(torch.equal(s, torch.full((SHAPE[0],), float(v)))
               for s, v in zip(seen, tables["cond"]))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_table_is_the_host_floats(eta):
    """σ and the direction coefficient at eta 0 and 1 as the loop computed
    them, and the variants: noise drawn before the last step only where σ
    is non-zero, infill noise before the last step."""
    n = 7
    c = schedules.ddpm_constants(_betas())
    tables, variants = samplers.ddim_tables(c, n, eta)
    abar = c.alphas_prod.numpy()[samplers.ddim_taus(T, n)]
    abar_prev = np.concatenate([np.ones(1, f32), abar[:-1]])
    one = f32(1.0)
    for j, i in enumerate(range(n - 1, -1, -1)):
        a, a_prev = abar[i], abar_prev[i]
        sigma = (f32(eta) * np.sqrt((one - a_prev) / (one - a)) *
                 np.sqrt(one - a / a_prev))
        assert tables["sigma"][j] == sigma
        assert tables["dir_coeff"][j] == np.sqrt(
            np.maximum(one - a_prev - sigma ** 2, f32(0)))
        assert tables["sqrt_a"][j] == tables["cond"][j] == np.sqrt(a)
        assert tables["sqrt_1ma"][j] == np.sqrt(one - a)
        assert tables["sqrt_a_prev"][j] == np.sqrt(a_prev)
        assert variants[j] == (bool(i > 0 and sigma != 0), i > 0)
    assert (tables["sigma"] == 0).all() == (eta == 0)


def test_dpmpp_table_is_zero_on_the_euler_steps():
    """The second-order coefficients as the loop took them, 0 on the first
    and last steps and where duplicate taus give h = 0 (T=10 over 12
    steps clamps the last taus to T-1)."""
    c = schedules.ddpm_constants(_betas(num=10))
    n = 12
    tables = samplers.dpmpp_tables(c, n)
    abar = c.alphas_prod.numpy()[samplers.dpmpp_taus(c.alphas_prod, n)]
    one = f32(1.0)
    abar_next = np.minimum(np.concatenate([np.ones(1, f32), abar[:-1]]),
                           f32(1.0 - 1e-6))
    a_cur, s_cur = np.sqrt(abar), np.sqrt(one - abar)
    a_next, s_next = np.sqrt(abar_next), np.sqrt(one - abar_next)
    h = np.log(a_next / s_next) - np.log(a_cur / s_cur)
    h_prev = np.concatenate([h[1:], np.ones(1, f32)])
    r = np.where((h == 0) | (h_prev == 0), one,
                 h_prev / np.where(h == 0, one, h))
    euler_seen = 0
    for j, k in enumerate(range(n - 1, -1, -1)):
        assert tables["alpha"][j] == tables["cond"][j] == a_cur[k]
        assert tables["sigma"][j] == s_cur[k]
        assert tables["alpha_next"][j] == a_next[k]
        assert tables["sigma_next"][j] == s_next[k]
        if k == n - 1 or k == 0 or h[k] == 0:
            euler_seen += 1
            assert tables["corr"][j] == tables["corr_coeff"][j] == 0
        else:
            assert tables["corr"][j] == one / (f32(2.0) * r[k])
            assert tables["corr_coeff"][j] == \
                a_next[k] * (np.exp(-h[k]) - one)
    assert euler_seen > 2   # the h = 0 steps are there


@pytest.mark.parametrize("consistent", [False, True])
def test_langevin_tables_are_the_host_floats(consistent):
    """ALD's α and √(2α) a level, T steps each; CAS's β·σ_{i+1}, with 0
    after the last level."""
    sig = schedules.noise_schedule(1.0, 0.01, 5, "geometric")
    eps, t = f32(1e-5), 3
    tables, s, last2 = samplers.langevin_tables(sig, float(eps), t,
                                                consistent)
    s = sig.numpy()
    alphas = eps * np.square(s / s[-1])
    beta = np.sqrt(f32(1) - np.square(f32(1) - eps / (s[-1] * s[-1])))
    steps = 5 if consistent else 5 * t
    assert all(len(v) == steps for v in tables.values())
    for n in range(steps):
        level = n if consistent else n // t
        assert tables["sigma"][n] == s[level]
        assert tables["alpha"][n] == alphas[level]
        if consistent:
            assert tables["amp"][n] == (beta * s[level + 1] if level < 4
                                        else 0)
        else:
            assert tables["amp"][n] == np.sqrt(f32(2) * alphas[level])
    assert last2 == s[-1] * s[-1]


# -- the collection ------------------------------------------------------

@pytest.mark.parametrize("total, collect", [(12, 5), (10, 10), (3, 5),
                                            (7, 1)])
def test_slot_table_is_the_collection_slots(total, collect):
    """Each step's slot is ``_collection_slots``' (the first of duplicate
    indices), the spare row elsewhere."""
    slots = samplers._collection_slots(total, collect)
    table = samplers._slot_table(total, collect, spare=99)
    assert [int(v) for v in table] == [slots.get(j + 1, 99)
                                       for j in range(total)]


def test_an_uncollected_step_writes_nothing_returned():
    """A 4-snapshot collection holds the start and the states of its 4
    steps (those of a chain that collects every step), nothing else: the
    spare row the other steps write is not returned."""
    fn, init = _tanh_fn(), _init()
    run = lambda c: samplers.diffusion_dynamics(
        torch.Generator().manual_seed(1), fn, _betas(), init,
        collect_steps=c, collect_metrics=False).collection
    every, some = run(T), run(4)
    assert some.shape == (5, *SHAPE)
    assert torch.equal(some[0], init)
    for slot, step in enumerate(samplers._collection_indices(T, 4)):
        assert torch.equal(some[slot + 1], every[step])


# -- kept chains ---------------------------------------------------------

def _chain(name):
    """call(which) for one sampler: "a" and "b" are schedules of one
    length; infill, collection and metrics on where the sampler has them."""
    fn, init, infill = _tanh_fn(), _init(), _infill()

    def gen():
        return torch.Generator().manual_seed(4)

    def call(which):
        end = 0.05 if which == "a" else 0.08
        b = _betas(end)
        if name == "ddpm":
            out = samplers.diffusion_dynamics(gen(), fn, b, init,
                                              collect_steps=4, **infill)
        elif name == "ddim":
            out = samplers.ddim_dynamics(gen(), fn, b, init, num_steps=5,
                                         eta=1.0, collect_steps=3,
                                         collect_metrics=True, **infill)
        elif name == "dpmpp":
            out = samplers.dpmpp_dynamics(gen(), fn, b, init, num_steps=5,
                                          collect_steps=3,
                                          collect_metrics=True, **infill)
        elif name == "distilled":
            out = samplers.distilled_ddim_dynamics(
                gen(), fn, distill.distill_grid(b, 4), init, **infill)
        elif name == "consistency":
            out = samplers.consistency_dynamics(
                gen(), fn, distill.distill_grid(b, 4), init, num_steps=3,
                **infill)
        else:
            sig = schedules.noise_schedule(1.0, 0.01 if which == "a"
                                           else 0.02, 4, "geometric")
            dyn = samplers.annealed_langevin_dynamics if name == "ald" \
                else samplers.consistent_langevin_dynamics
            out = dyn(gen(), fn, sig, init, 1e-5, 2, collect_steps=3,
                      **infill)
        return [t for t in out if t is not None]
    return call


@pytest.mark.parametrize("name", ["ddpm", "ddim", "dpmpp", "distilled",
                                  "consistency", "ald", "cas"])
def test_a_kept_chain_serves_another_schedule_as_a_fresh_one(name):
    """A second call with another schedule of the same length goes through
    the kept chain (its staged buffers) and equals a fresh chain on that
    schedule bit for bit, and differs from the first call's result."""
    call = _chain(name)
    first = call("a")
    kept = list(graphs._CHAINS.values())
    assert len(kept) == 1
    second = call("b")
    assert list(graphs._CHAINS.values()) == kept
    graphs.release()
    fresh = call("b")
    assert len(fresh) == len(second) and all(
        torch.equal(x, y) for x, y in zip(second, fresh))
    assert not torch.equal(first[0], second[0])


@pytest.mark.parametrize("cached", [False, True])
def test_a_kept_decode_serves_another_seed_as_a_fresh_one(cached):
    """Both MDN decodes: a second call through the kept chain with another
    generator equals a fresh decode with it, the generator left where the
    fresh decode leaves it."""
    _, params = _jax_setup()
    model = _port(params).eval()
    full = lambda t: model(t, shift=False)   # noqa: E731 (one key)

    def call(seed):
        gen = torch.Generator().manual_seed(seed)
        if cached:
            out = mdn_decode.ar_decode_cached(gen, model, 2, steps=MDN_S,
                                              channels=MDN_C)
        else:
            out = mdn_decode.ar_decode(gen, full, 2, steps=MDN_S,
                                       channels=MDN_C, device="cpu")
        return out, gen.get_state()

    first = call(0)
    second = call(1)
    assert len(graphs._CHAINS) == 1
    graphs.release()
    fresh = call(1)
    assert torch.equal(second[0], fresh[0])
    assert torch.equal(second[1], fresh[1])
    assert not torch.equal(first[0], second[0])


def test_a_rebound_parameter_makes_a_new_chain():
    """A kept chain is keyed by its model function and what the function
    holds: a parameter rebound (not written in place) makes a new chain,
    whose result reads the new weights; an in-place write keeps it."""
    model = torch.nn.Linear(SHAPE[-1], SHAPE[-1])
    fn = lambda x, c: model(x) * c   # noqa: E731 (one key)
    run = lambda: samplers.diffusion_dynamics(   # noqa: E731
        torch.Generator().manual_seed(0), fn, _betas(), _init(),
        collect_steps=0, collect_metrics=False).state
    with torch.no_grad():
        before = run()
        kept = list(graphs._CHAINS.values())
        model.weight.mul_(0.5)
        inplace = run()
        assert list(graphs._CHAINS.values()) == kept
        model.weight = torch.nn.Parameter(model.weight * 2.0)
        rebound = run()
    assert list(graphs._CHAINS.values()) != kept
    assert not torch.equal(before, inplace)
    assert torch.equal(rebound, before)


def test_kept_chains_are_bounded():
    init = _init()
    fns = [_tanh_fn(s) for s in range(graphs.MAX_CHAINS + 2)]
    for fn in fns:
        samplers.diffusion_dynamics(None, fn, _betas(), init,
                                    collect_steps=0, collect_metrics=False)
    assert len(graphs._CHAINS) == graphs.MAX_CHAINS
    assert [k[1] for k in graphs._CHAINS] == fns[2:]


# -- the cached decode over a device index --------------------------------

def test_cached_decode_with_a_device_index_matches_jax(monkeypatch):
    """``ar_decode_cached`` (its cache index the chain's device tensor)
    against JAX's, with JAX's normal draws replayed into the port's
    ``sample_mixture``; component 0's pi bias +100 makes both pick it
    whatever the Gumbel draws. The index is a long tensor, advanced in
    place by the chain."""
    jmodel, params = _jax_setup()
    params = _deterministic(params)
    model = _port(params).eval()
    n, key = 4, jax.random.PRNGKey(3)
    ref = jdecode.ar_decode_cached(key, jmodel, params, n, steps=MDN_S,
                                   channels=MDN_C)
    normals = iter([np.asarray(jax.random.normal(
        jax.random.split(k)[1], (n, MDN_C), jnp.float32))
        for k in jax.random.split(key, MDN_S)])
    monkeypatch.setattr(torch, "randn", lambda *a, **kw: torch.from_numpy(
        next(normals)))
    cache = model.init_cache(n)
    assert torch.is_tensor(cache.index) and cache.index.dtype == torch.long
    out = mdn_decode.ar_decode_cached(torch.Generator().manual_seed(0),
                                      model, n, steps=MDN_S, channels=MDN_C)
    assert next(normals, None) is None
    assert _rel(out, np.asarray(ref)) <= 1e-4, _rel(out, np.asarray(ref))
