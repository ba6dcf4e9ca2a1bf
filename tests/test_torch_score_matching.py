"""The port's score-matching objectives and small losses against
``smd_tpu``'s.

DSM and SSM on a small DenseNCSN (2 layers, MLP 64, data width 16; the JAX
weights carried over, both packages on XLA's exp table as in
``tests/test_torch_ncsn_models.py``) with the JAX package's draws replayed
through ``draws=``: the loss and every parameter's gradient against
``jax.value_and_grad``, in discrete and in continuous noise. SSM's
gradient differentiates through a vector-Jacobian product (a double
backward). Then the train step on both objectives, the continuous-noise
arithmetic on a decreasing schedule, and the five small losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ncsn_models import xla_frequencies  # noqa: F401

from smd_tpu.diffusion import losses as jlosses
from smd_tpu.diffusion import schedules as jschedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu_torch.diffusion import losses, schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.training import diffusion as trainer
from smd_tpu_torch.utils.flax_params import flatten, load_flax_params

B, D, L = 8, 16, 20
KW = dict(num_layers=2, mlp_dims=64)
OBJECTIVES = {
    "dsm": (jlosses.denoising_score_matching_loss,
            losses.denoising_score_matching_loss),
    "ssm": (jlosses.sliced_score_matching_loss,
            losses.sliced_score_matching_loss),
}


def _sigmas():
    """The NCSN flagfiles' geometric schedule from 15 to 0.01, at L=20."""
    return (jschedules.noise_schedule(15.0, 0.01, L, "geometric"),
            schedules.noise_schedule(15.0, 0.01, L, "geometric"))


def _batch(seed=0):
    return np.random.default_rng(seed).normal(size=(B, D)).astype(np.float32)


def _models(seed=3):
    x = _batch()
    jmodel = jax_get_model("DenseNCSN", **KW)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                         jnp.ones((B, 1)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.normal(size=p.shape))
        .astype(np.float32), params)
    model = get_model("DenseNCSN", device="cpu", data_channels=D, **KW)
    return jmodel, params, load_flax_params(model, params)


def _jax_draws(key, objective, continuous, sigmas, shape):
    """The draws of the JAX objective at ``key``: (labels, u, eps) for
    DSM, (labels, u, eps, vectors) for SSM."""
    if objective == "dsm":
        rng, sample_rng = jax.random.split(key)
    else:
        rng, sample_rng, score_rng = jax.random.split(key, num=3)
    label_rng, noise_rng = jax.random.split(rng)
    labels = jax.random.randint(label_rng, (shape[0],),
                                minval=int(continuous),
                                maxval=sigmas.shape[0])
    u = jax.random.uniform(noise_rng, labels.shape) if continuous else None
    eps = jax.random.normal(sample_rng, shape)
    draws = [labels, u, eps]
    if objective == "ssm":
        draws.append(jax.random.rademacher(score_rng, shape,
                                           dtype=jnp.float32))
    return tuple(None if d is None else torch.from_numpy(np.asarray(d))
                 for d in draws)


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("objective", ["dsm", "ssm"])
def test_loss_and_gradients_match_jax(objective, continuous,
                                      xla_frequencies):
    jloss_fn, loss_fn = OBJECTIVES[objective]
    jsig, sig = _sigmas()
    jmodel, params, model = _models()
    x, key = _batch(), jax.random.PRNGKey(11)

    def jloss(p):
        return jloss_fn(jnp.asarray(x), lambda a, c: jmodel.apply(p, a, c),
                        jsig, key, continuous, "mean")
    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    draws = _jax_draws(key, objective, continuous, jsig, x.shape)
    loss = loss_fn(torch.from_numpy(x), model, sig, None, continuous,
                   "mean", draws=draws)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    # float32 sums in the two packages' orders; SSM's Hessian term is a
    # difference of large terms.
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    ref_grads = flatten(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, g in zip(names, grads):
        ref = ref_grads[name]
        err = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref),
                                                     1e-12)
        assert err < 1e-4, (name, err)


def test_continuous_noise_takes_the_level_before_the_label():
    """``jax.random.uniform(minval=sigma[l-1], maxval=sigma[l])`` is
    ``max(lo, lo + u (hi - lo))``; the geometric schedule decreases, so it
    returns sigma[l-1] for every u, in both packages (C.4's arithmetic)."""
    jsig, sig = _sigmas()
    shape = (4096, 2)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jlosses._sample_sigmas(key, jsig, jnp.zeros(shape),
                                            True)).reshape(-1)
    label_rng, noise_rng = jax.random.split(key)
    labels = np.asarray(jax.random.randint(label_rng, (shape[0],), 1, L))
    np.testing.assert_array_equal(ref, np.asarray(jsig)[labels - 1])
    u = torch.from_numpy(np.asarray(jax.random.uniform(noise_rng,
                                                       (shape[0],))))
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    ours = losses._sample_sigmas(sig, torch.zeros(shape), True,
                                 torch.from_numpy(labels), u)
    np.testing.assert_array_equal(ours.reshape(-1).numpy(), ref)
    assert ours.shape == (shape[0], 1)


@pytest.mark.parametrize("objective", ["dsm", "ssm"])
def test_train_step_on_score_matching(objective):
    """One step of each objective from the generator: finite loss and
    gradient norm, every parameter moved; SSM's step takes the double
    backward. The eval step runs without a gradient."""
    _, sig = _sigmas()
    _, _, model = _models(seed=4)
    config = trainer.TrainConfig(loss=objective, continuous_noise=True,
                                 ema=True)
    state = trainer.create_train_state(model, config, seed=0, init=False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = trainer.make_train_step(trainer.objective_by_name(objective),
                                   sig, True)
    x = torch.from_numpy(_batch(1))
    _, metrics = step(state, x)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad"])
    assert all(not torch.equal(before[n], p)
               for n, p in model.named_parameters())
    total = trainer.make_eval_step(trainer.objective_by_name(objective), sig,
                                   True)(model, x,
                                         torch.Generator().manual_seed(1))
    assert torch.isfinite(total) and not total.requires_grad


def test_objectives_by_name():
    assert trainer.objective_by_name("dsm") is \
        losses.denoising_score_matching_loss
    assert trainer.objective_by_name("ssm") is \
        losses.sliced_score_matching_loss
    assert trainer.objective_by_name("ddpm") is losses.diffusion_loss
    with pytest.raises(ValueError):
        trainer.objective_by_name("nope")


def _small_inputs():
    rng = np.random.default_rng(9)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "mean_squared_error": ((f(6, 5), f(6, 5)), {}),
        "series_loss": ((f(4, 3), f(2, 3), f(2, 3)), {}),
        "binary_cross_entropy_with_logits": (
            (3 * f(6, 5), (rng.uniform(size=(6, 5)) < 0.5)
             .astype(np.float32)), {}),
        "sigmoid_cross_entropy": ((3 * f(6, 5), rng.uniform(
            size=(6, 5)).astype(np.float32)), {}),
        "kl_divergence_std_normal": ((f(6, 5), rng.uniform(
            0.1, 2.0, size=(6, 5)).astype(np.float32)), {}),
    }


@pytest.mark.parametrize("name", sorted(_small_inputs()))
def test_small_losses_match_jax(name):
    args, kw = _small_inputs()[name]
    ref = np.asarray(getattr(jlosses, name)(*map(jnp.asarray, args), **kw))
    ours = getattr(losses, name)(*map(torch.from_numpy, args), **kw)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
    # series_loss: zero on a perfect prediction, as the JAX test has it.
    if name == "series_loss":
        ctx, target = torch.ones(4, 3), torch.ones(1, 3)
        assert float(losses.series_loss(ctx, target, target)) == 0.0
        assert float(losses.series_loss(ctx, target, target * 2)) > 0.0
