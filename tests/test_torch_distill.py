"""The port's distillation (progressive, consistency distillation and
consistency training) against ``smd_tpu``'s, and its CLIs, on the CPU.

One step of each JAX ``make_*`` step from the same state, batch and draws
(JAX's ``split(rng)`` draws replayed; the CT segment drawn by JAX's
``categorical``), carried into the port by name: loss and gradient norm,
then the Adam moments, params and EMA. A small TransformerDDPM (2 layers,
embed 32, MLP 64, float32). Then the drivers' stages, curricula and logging
boundaries on the port alone. The CLIs are in tests/test_torch_sample_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smd_tpu.diffusion import schedules as jschedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.training import consistency as jconsistency
from smd_tpu.training import distill as jdistill
from smd_tpu.training.state import TrainState as JaxTrainState
from smd_tpu_torch.diffusion import schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.training import consistency, distill, optimizer
from smd_tpu_torch.training.state import TrainState
from smd_tpu_torch.utils.flax_params import (flatten, load_flax_params,
                                             random_flax_params)

KW = dict(num_layers=2, num_heads=2, num_mlp_layers=2, mlp_dims=64,
          embed_channels=32)
B, S, C, T = 4, 8, 6, 1000
LR = 1e-3


def _betas():
    return (jschedules.noise_schedule(1e-6, 0.01, T, "linear"),
            schedules.noise_schedule(1e-6, 0.01, T, "linear"))


def _batch(seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, S, C)).astype(np.float32)


def _setup():
    """(JAX model, port model, the trained params as a Flax tree)."""
    model = get_model("TransformerDDPM", device="cpu", data_channels=C, **KW)
    params = random_flax_params(model, seed=3)
    load_flax_params(model, params)
    return jax_get_model("TransformerDDPM", **KW), model, params


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _perturbed(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (p + scale * rng.normal(size=p.shape)).astype(np.float32),
        params)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in flatten(tree).items()}


# -- schedule and grids -------------------------------------------------------

@pytest.mark.parametrize("args", [(1e-4, 2, 20), (1e-4, 100, 3000),
                                  (3e-4, 0, 10), (1e-3, 1, 7)])
def test_warmup_cosine_decay_schedule_matches_optax(args):
    ref = optax.warmup_cosine_decay_schedule(0.0, *args,
                                             end_value=args[0] * 0.01)
    ours = optimizer.warmup_cosine_decay_schedule(*args)
    for count in [*range(0, min(args[2], 40) + 5), args[2] // 2,
                  args[2] - 1, args[2], args[2] + 10]:
        # float32; numpy's cos and XLA's differ by up to an ulp.
        np.testing.assert_allclose(
            ours(count), float(ref(jnp.asarray(count, jnp.int32))),
            rtol=1e-6)
    with pytest.raises(ValueError, match="positive"):
        optimizer.warmup_cosine_decay_schedule(1e-4, 10, 10)


@pytest.mark.parametrize("num_steps,lam_max", [(1, 2.5), (8, 2.5), (16, None),
                                               (64, 2.5)])
def test_distill_grid_and_halving_match_jax(num_steps, lam_max):
    jb, tb = _betas()
    ref = np.asarray(jdistill.distill_grid(jb, num_steps, lam_max))
    ours = distill.distill_grid(tb, num_steps, lam_max)
    assert ours.dtype == np.float32 and ours.shape == (num_steps + 1,)
    # float32: numpy's log and XLA's may differ by an ulp in lambda.
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    if num_steps % 2 == 0:
        for a, b in zip(distill.halve_grid(ours), jdistill.halve_grid(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)
    else:
        with pytest.raises(ValueError, match="cannot halve"):
            distill.halve_grid(ours)


def test_segment_masses_match_jax():
    jb, tb = _betas()
    jgrid = jdistill.distill_grid(jb, 16)
    sig = jnp.sqrt((1.0 - jgrid) / jgrid)
    cdf = jax.scipy.special.erf((jnp.log(sig) - -1.1) /
                                (jnp.sqrt(2.0) * 2.0))
    ref = jnp.maximum(cdf[:-1] - cdf[1:], 0.0) + 1e-12
    ours_sig, ours = consistency._segment_masses(
        torch.from_numpy(distill.distill_grid(tb, 16)), -1.1, 2.0)
    np.testing.assert_allclose(ours_sig.numpy(), np.asarray(sig), rtol=1e-6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-12)


def _ct_logits(jgrid, p_mean=-1.1, p_std=2.0):
    """``smd_tpu/training/consistency.py:162-169``: the segments' logits."""
    sig = jnp.sqrt((1.0 - jgrid) / jgrid)
    cdf = jax.scipy.special.erf((jnp.log(sig) - p_mean) /
                                (jnp.sqrt(2.0) * p_std))
    return jnp.log(jnp.maximum(cdf[:-1] - cdf[1:], 0.0) + 1e-12)


@pytest.mark.parametrize("objective", ["progressive", "cd", "ct"])
@pytest.mark.parametrize("clip_x0", [False, True])
def test_losses_match_jax_on_one_model(objective, clip_x0):
    """Each objective's arithmetic, on student, teacher and target models
    that both packages compute to the last ulp (tanh(x·w + c)), from the
    same draws: equal to float32 rounding (1e-6)."""
    jb, tb = _betas()
    ws = [np.random.default_rng(k).normal(size=(S, C)).astype(np.float32)
          for k in range(3)]
    jfns = [lambda x, c, w=w: jnp.tanh(x * w + c) for w in ws]
    tfns = [lambda x, c, w=w: torch.tanh(x * torch.from_numpy(w) + c)
            for w in ws]
    batch, rng = _batch(4), jax.random.PRNGKey(4)
    idx_rng, eps_rng = jax.random.split(rng)
    eps = jax.random.normal(eps_rng, (B, S, C))
    if objective == "ct":
        jgrid = jdistill.distill_grid(jb, 16)
        i = jax.random.categorical(idx_rng, _ct_logits(jgrid), shape=(B,))
        ref = jconsistency.consistency_training_loss(
            jnp.asarray(batch), jfns[0], jfns[1], jgrid, rng,
            clip_x0=clip_x0)
        ours = consistency.consistency_training_loss(
            torch.from_numpy(batch), tfns[0], tfns[1],
            distill.distill_grid(tb, 16), clip_x0=clip_x0,
            draws=(torch.from_numpy(np.array(i)),
                   torch.from_numpy(np.array(eps))))
    else:
        jgrid, jmids = jdistill.halve_grid(jdistill.distill_grid(jb, 16))
        grid, mids = distill.halve_grid(distill.distill_grid(tb, 16))
        draws = (torch.from_numpy(np.array(jax.random.randint(
            idx_rng, (B,), 0, 8))), torch.from_numpy(np.array(eps)))
        if objective == "progressive":
            ref = jdistill.progressive_distillation_loss(
                jnp.asarray(batch), jfns[0], jfns[1], jgrid, jmids, rng,
                clip_x0=clip_x0)
            ours = distill.progressive_distillation_loss(
                torch.from_numpy(batch), tfns[0], tfns[1], grid, mids,
                clip_x0=clip_x0, draws=draws)
        else:
            ref = jconsistency.consistency_distillation_loss(
                jnp.asarray(batch), jfns[0], jfns[1], jfns[2], jgrid, jmids,
                rng, clip_x0=clip_x0)
            ours = consistency.consistency_distillation_loss(
                torch.from_numpy(batch), tfns[0], tfns[1], tfns[2], grid,
                mids, clip_x0=clip_x0, draws=draws)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


# -- one step of each objective -----------------------------------------------

def _jax_state(params, schedule, ema, ema_mu=0.999, ema_params=None):
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))
    state = JaxTrainState.create(params, tx, ema=ema, ema_mu=ema_mu)
    if ema_params is not None:
        state = state.replace(ema_params=ema_params)
    return state


def _carry(jstate, model, tx):
    """A port state holding JAX's: params, Adam moments and count, EMA,
    step."""
    student = distill.trainable_copy(model, _torch_tree(jstate.params))
    state = TrainState.create(student, tx, torch.Generator(),
                              ema=jstate.ema_params is not None,
                              ema_mu=jstate.ema_mu)
    adam = jstate.opt_state[1][0]
    state.opt_state = {"count": int(adam.count), "mu": _torch_tree(adam.mu),
                       "nu": _torch_tree(adam.nu)}
    if jstate.ema_params is not None:
        state.ema_params = _torch_tree(jstate.ema_params)
    state.step = int(jstate.step)
    return state


def _assert_state_matches(tstate, jstate, lr, scale=1.0):
    """float32, one step computed in another order (XLA's program against
    eager PyTorch), as tests/test_torch_training.py holds the train step
    (``scale=1``, gradients within 1e-5): the Adam moments within
    1e-4·scale of each tensor's largest element; the params and EMA within
    1e-2·lr·scale, or 2·lr where sqrt(v̂) < 1e-5 (Adam divides each
    gradient's last-bit difference by it). ``scale`` is the gradients'
    tolerance over 1e-5."""
    adam = jstate.opt_state[1][0]
    for key in ("mu", "nu"):
        for name, ref in flatten(getattr(adam, key)).items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                tstate.opt_state[key][name].numpy(), ref, rtol=1e-4 * scale,
                atol=1e-4 * scale * np.abs(ref).max())
    nu = flatten(adam.nu)
    pairs = [(tstate.params, jstate.params)]
    if jstate.ema_params is not None:
        pairs.append((tstate.ema_params, jstate.ema_params))
    for ours, refs in pairs:
        for name, ref in flatten(refs).items():
            diff = np.abs(ours[name].detach().numpy() - np.asarray(ref))
            v_hat = np.asarray(nu[name]) / (1 - 0.999 ** tstate.step)
            small = np.sqrt(v_hat) < 1e-5
            assert ((diff <= 1e-2 * lr * scale) | small).all(), \
                (name, diff[~small].max())
            assert diff.max() <= 2 * lr, (name, diff.max())


# The x0 clip (every objective's default) makes the loss's gradient jump
# where an x0 element crosses +-1. The two packages' models differ by ~1e-5
# relative, ~1e-4 in x0 after the 1/alpha of the noisiest level, so an
# element that close to the boundary clips in one package only and its
# gradient is zero there: with the clip the gradient norm differs by up to
# 3.3e-5 (measured) and a few elements of the Adam moments by 5%. So each
# step is compared in full without the clip (the update's arithmetic, the
# same either way), and with the clip by its loss (1e-5) and gradient norm
# (1e-3).
CLIPPED_GRAD_RTOL = 1e-3


def _compare_steps(make_jstep, jloss, tstep_fn, jstate, model, draws_of,
                   clip_x0, rtol=1e-5):
    """Without the clip: step JAX's state twice (count 0 at zero LR, then at
    the peak); before each, carry it into the port and take the port's
    step on the same batch and draws; compare loss, gradient norm and the
    new state. With the clip: one step's loss and gradient norm."""
    tx = distill._optimizer(LR, 1, 10)
    jstep = None if clip_x0 else make_jstep()
    for seed in (11,) if clip_x0 else (11, 12):
        batch, rng = _batch(seed), jax.random.PRNGKey(seed)
        tstate = _carry(jstate, model, tx)
        loss, grads = jax.value_and_grad(jloss)(jstate.params,
                                                jnp.asarray(batch), rng,
                                                jstate)
        tstate, tm = tstep_fn(tstate, torch.from_numpy(batch),
                              draws=draws_of(rng))
        # float32 in another order; the models differ by ~1e-5 relative.
        np.testing.assert_allclose(float(tm["loss"]), float(loss), rtol=rtol)
        np.testing.assert_allclose(
            float(tm["grad"]), float(optax.global_norm(grads)),
            rtol=CLIPPED_GRAD_RTOL if clip_x0 else rtol)
        if jstep is None:
            continue
        jstate, jm = jstep(jstate, jnp.asarray(batch), rng)
        np.testing.assert_allclose(float(jm["loss"]), float(loss), rtol=1e-6)
        assert tstate.step == int(jstate.step)
        _assert_state_matches(tstate, jstate, LR, scale=rtol / 1e-5)


def _index_draws(num_levels):
    def draws_of(rng):
        idx_rng, eps_rng = jax.random.split(rng)
        i = jax.random.randint(idx_rng, (B,), 0, num_levels)
        eps = jax.random.normal(eps_rng, (B, S, C))
        return torch.from_numpy(np.array(i)), torch.from_numpy(np.array(eps))
    return draws_of


def _schedule():
    return optax.warmup_cosine_decay_schedule(0.0, LR, 1, 10,
                                              end_value=LR * 0.01)


@pytest.mark.parametrize("clip_x0", [False, True])
def test_progressive_distill_step_matches_jax(setup, clip_x0):
    jmodel, model, params = setup
    jb, tb = _betas()
    jgrid, jmids = jdistill.halve_grid(jdistill.distill_grid(jb, 8))
    grid, mids = distill.halve_grid(distill.distill_grid(tb, 8))

    def jloss(p, batch, rng, state):
        return jdistill.progressive_distillation_loss(
            batch, lambda x, c: jmodel.apply(p, x, c),
            lambda x, c: jmodel.apply(params, x, c), jgrid, jmids, rng,
            clip_x0=clip_x0)

    _compare_steps(
        lambda: jdistill.make_distill_step(jmodel, params, jgrid, jmids,
                                           clip_x0=clip_x0),
        jloss, distill.make_distill_step(model, _torch_tree(params), grid,
                                         mids, clip_x0=clip_x0),
        _jax_state(_perturbed(params, 1), _schedule(), False), model,
        _index_draws(4), clip_x0)


@pytest.mark.parametrize("clip_x0", [False, True])
def test_consistency_distill_step_matches_jax(setup, clip_x0):
    jmodel, model, params = setup
    jb, tb = _betas()
    jgrid, jmids = jdistill.halve_grid(jdistill.distill_grid(jb, 16))
    grid, mids = distill.halve_grid(distill.distill_grid(tb, 16))

    def jloss(p, batch, rng, state):
        return jconsistency.consistency_distillation_loss(
            batch, lambda x, c: jmodel.apply(p, x, c),
            lambda x, c: jmodel.apply(state.ema_params, x, c),
            lambda x, c: jmodel.apply(params, x, c), jgrid, jmids, rng,
            clip_x0=clip_x0)

    # The student and its EMA (the target network) both off the teacher.
    _compare_steps(
        lambda: jconsistency.make_cd_step(jmodel, params, jgrid, jmids,
                                          clip_x0=clip_x0),
        jloss, consistency.make_cd_step(model, _torch_tree(params), grid,
                                        mids, clip_x0=clip_x0),
        _jax_state(_perturbed(params, 1), _schedule(), True, 0.95,
                   ema_params=_perturbed(params, 2)), model,
        _index_draws(8), clip_x0)


@pytest.mark.parametrize("clip_x0", [False, True])
def test_consistency_train_step_matches_jax(setup, clip_x0):
    """JAX's CT step is a scan of one step: the chunk's key is
    ``split(rng, 1)[0]``, whose split draws the segment (``categorical``
    over the masses' logs) and the noise. Its loss and gradient norm are
    held to 5e-5: both points' x0 carry the models' difference times
    sigma/alpha (up to 12 here), weighted by 1/(sigma_n - sigma_{n+1})
    (up to 2.0e-5 measured unclipped; on an identical model the losses are
    equal, ``test_losses_match_jax_on_one_model``)."""
    jmodel, model, params = setup
    jb, tb = _betas()
    jgrid = jdistill.distill_grid(jb, 16)

    def make_jstep():
        scan = jconsistency.make_ct_scan(jmodel, jgrid, clip_x0=clip_x0)

        def jstep(state, batch, rng):
            state, losses = scan(state, batch[None], rng)
            return state, {"loss": losses[0]}
        return jstep

    def jloss(p, batch, rng, state):
        return jconsistency.consistency_training_loss(
            batch, lambda x, c: jmodel.apply(p, x, c),
            lambda x, c: jmodel.apply(state.ema_params, x, c), jgrid,
            jax.random.split(rng, 1)[0], clip_x0=clip_x0)

    logits = _ct_logits(jgrid)

    def draws_of(rng):
        idx_rng, eps_rng = jax.random.split(jax.random.split(rng, 1)[0])
        i = jax.random.categorical(idx_rng, logits, shape=(B,))
        eps = jax.random.normal(eps_rng, (B, S, C))
        return torch.from_numpy(np.array(i)), torch.from_numpy(np.array(eps))

    _compare_steps(
        make_jstep, jloss,
        consistency.make_ct_step(model, distill.distill_grid(tb, 16),
                                 clip_x0=clip_x0),
        _jax_state(_perturbed(params, 1), _schedule(), True, 0.0), model,
        draws_of, clip_x0, rtol=5e-5)


# -- the drivers on the port --------------------------------------------------

def _tiny():
    tiny = dict(num_layers=1, num_heads=2, num_mlp_layers=1, mlp_dims=16,
                embed_channels=16)
    model = get_model("TransformerDDPM", device="cpu", data_channels=3,
                      **tiny)
    load_flax_params(model, random_flax_params(model, seed=0))
    return model, {n: p.detach().clone() for n, p in model.named_parameters()}


def _endless(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.uniform(-1, 1, (4, 5, 3)).astype(np.float32)


def test_progressive_distill_stages_and_logging():
    model, params = _tiny()
    _, tb = _betas()
    logged = []
    stages = distill.progressive_distill(
        model, params, tb, _endless(), start_steps=8, end_steps=2,
        steps_per_stage=5, scan_chunk=2,
        log_fn=lambda n, step, loss: logged.append((n, step)))
    assert sorted(stages) == [2, 4, 8]
    dense = distill.distill_grid(tb, 16)
    for n, stage in stages.items():
        np.testing.assert_array_equal(stage["grid"], dense[::16 // n])
        assert set(stage["params"]) == set(params)
        assert all(torch.isfinite(p).all() for p in stage["params"].values())
    # The JAX loop logs at each chunk's last step: 2, 4, then the rest (1).
    assert logged == [(n, s) for n in (8, 4, 2) for s in (1, 3, 4)]
    # The students moved off the teacher; the input params did not change.
    assert not torch.equal(stages[2]["params"]["Dense_1.kernel"],
                           params["Dense_1.kernel"])
    assert torch.equal(dict(model.named_parameters())["Dense_1.kernel"],
                       params["Dense_1.kernel"])
    with pytest.raises(ValueError, match="power-of-2"):
        distill.progressive_distill(model, params, tb, _endless(),
                                    start_steps=6, end_steps=2)


def test_consistency_drivers_stages_and_logging():
    model, params = _tiny()
    _, tb = _betas()
    logged = []
    cd = consistency.consistency_distill(
        model, params, tb, _endless(), num_segments=4, steps=3,
        scan_chunk=1, log_fn=lambda n, step, loss: logged.append((n, step)))
    np.testing.assert_array_equal(cd["grid"],
                                  distill.distill_grid(tb, 8)[::2])
    # scan_chunk <= 1: the JAX loop logs at every 500th step and the last.
    assert logged == [(4, 0), (4, 2)]
    logged.clear()
    ct = consistency.consistency_train(
        model, params, tb, _endless(), steps=7, seg_schedule=(2, 4, 8),
        scan_chunk=2, log_fn=lambda n, step, loss: logged.append((n, step)))
    np.testing.assert_array_equal(ct["grid"], distill.distill_grid(tb, 8))
    # 2 steps a stage, the last stage the remaining 3; steps counted over
    # all stages.
    assert logged == [(2, 1), (4, 3), (8, 5), (8, 6)]
    for out in (cd, ct):
        assert all(torch.isfinite(p).all() for p in out["params"].values())
