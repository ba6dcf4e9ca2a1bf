"""The port's training path against ``smd_tpu``'s, on the CPU.

The objective, the optimizer and one whole train step are held against the
JAX package from the same params, batch and draws (the JAX ``split(rng, 4)``
draws of ``diffusion_loss`` replayed into the port); the fused layout's
gradients against the JAX ``custom_vjp`` ones, the Pallas kernels run
interpreted; the loop's checkpoints, resume and boundaries on the port
alone. Small sizes: 2 layers, embed 32, MLP 64, 2 heads.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import smd_tpu.ops as jops
from smd_tpu.diffusion import losses as jlosses
from smd_tpu.diffusion import schedules as jschedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.models.fuse import fuse_attention_params, fuse_head_params
from smd_tpu.ops import fused_attention as jfat
from smd_tpu.ops import fused_film_resblock as jffr
from smd_tpu.training import diffusion as jtrainer
from smd_tpu.training import optimizer as joptimizer
from smd_tpu.training.state import EarlyStopping as JaxEarlyStopping
from smd_tpu_torch.diffusion import losses, schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.training import diffusion as trainer
from smd_tpu_torch.training import optimizer
from smd_tpu_torch.training.state import EarlyStopping
from smd_tpu_torch.utils.checkpoints import CheckpointManager
from smd_tpu_torch.utils.flax_params import flatten, load_flax_params

KW = dict(num_layers=2, num_heads=2, num_mlp_layers=2, mlp_dims=64,
          embed_channels=32)
B, S, C, T = 4, 8, 6, 1000


def _batch(seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, S, C)).astype(np.float32)


def _jax_params(seed=1):
    model = jax_get_model("TransformerDDPM", **KW)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, S, C)),
                        jnp.zeros((1, 1, 1)))
    # Non-zero biases and LN affines, so every term has a gradient.
    rng = np.random.default_rng(seed + 6)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), params)


def _torch_model(tree, **extra):
    model = get_model("TransformerDDPM", device="cpu", data_channels=C,
                      **KW, **extra)
    return load_flax_params(model, tree)


def _replayed_draws(rng, batch_shape, continuous_noise):
    """The draws of JAX ``diffusion_loss`` under ``rng``: labels, u and eps."""
    _, label_rng, sample_rng, noise_rng = jax.random.split(rng, num=4)
    c = int(continuous_noise)
    labels = jax.random.randint(label_rng, (batch_shape[0],), minval=c,
                                maxval=T + c)
    u = jax.random.uniform(noise_rng, (batch_shape[0],))
    eps = jax.random.normal(sample_rng, batch_shape)
    return tuple(torch.from_numpy(np.array(d)) for d in (labels, u, eps))


def _simple_model(w):
    """A model_fn both packages compute the same way to the last ulp."""
    return (lambda x, c: jnp.tanh(x * w + c),
            lambda x, c: torch.tanh(x * torch.from_numpy(w) + c))


# -- the objective ------------------------------------------------------------

@pytest.mark.parametrize("continuous_noise", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_diffusion_loss_matches_jax(continuous_noise, reduction):
    batch = _batch()
    w = np.random.default_rng(3).normal(size=(S, C)).astype(np.float32)
    jfn, tfn = _simple_model(w)
    betas = jschedules.noise_schedule(1e-6, 0.01, T, "linear")
    rng = jax.random.PRNGKey(4)
    ref = jax.jit(lambda b, r: jlosses.diffusion_loss(
        b, jfn, betas, r, continuous_noise, reduction))(jnp.asarray(batch),
                                                        rng)
    ours = losses.diffusion_loss(
        torch.from_numpy(batch), tfn,
        schedules.noise_schedule(1e-6, 0.01, T, "linear"), None,
        continuous_noise, reduction,
        draws=_replayed_draws(rng, batch.shape, continuous_noise))
    assert ours.shape == ref.shape
    # float32, the same operations in the same order.
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_jax_uniform_between_decreasing_levels_is_the_lower_label():
    """``jax.random.uniform``'s ``max(minval, ...)`` with the decreasing pair
    (alphas_prod[l-1], alphas_prod[l]) always returns the first: what
    ``diffusion_loss`` conditions on, in both packages."""
    ap = losses.padded_alphas_prod(
        schedules.noise_schedule(1e-6, 0.01, T, "linear"))
    labels = jnp.arange(1, T + 1)
    used = jax.random.uniform(jax.random.PRNGKey(0), labels.shape,
                              minval=jnp.asarray(ap.numpy())[labels - 1],
                              maxval=jnp.asarray(ap.numpy())[labels])
    np.testing.assert_array_equal(np.asarray(used), ap.numpy()[:-1])


def test_padded_alphas_prod_matches_jax_cumprod():
    betas = jschedules.noise_schedule(1e-6, 0.01, T, "linear")
    ref = jax.jit(lambda b: jnp.concatenate(
        [jnp.ones((1,)), jnp.cumprod(1.0 - b)]))(betas)
    ours = losses.padded_alphas_prod(
        schedules.noise_schedule(1e-6, 0.01, T, "linear"))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_loss_draws_from_the_generator():
    batch = torch.from_numpy(_batch())
    betas = schedules.noise_schedule(1e-6, 0.01, T, "linear")
    model = lambda x, c: torch.zeros_like(x)   # noqa: E731
    a, b = (losses.diffusion_loss(batch, model, betas,
                                  torch.Generator().manual_seed(0), True,
                                  "none") for _ in range(2))
    assert torch.equal(a, b) and a.shape == (B,)
    # A zero model leaves the mean square of the noise: about 1.
    assert abs(float(a.mean()) - 1.0) < 0.2


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("count", [0, 1, 2, 3, 4, 5, 7, 12])
def test_schedule_matches_optax(warmup, count):
    ref = joptimizer.stepped_exponential_schedule(0.01, 2, 0.5, warmup)
    ours = optimizer.stepped_exponential_schedule(0.01, 2, 0.5, warmup)
    np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)


@pytest.mark.parametrize("warmup,adam_m_bf16", [(0, False), (3, False),
                                                (0, True)])
def test_optimizer_matches_optax(warmup, adam_m_bf16):
    """clip + Adam + schedule over 5 steps on the same gradients; step 3's
    gradient is above the clip."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * (5.0 if i == 2 else 0.1))
        .astype(np.float32), params) for i in range(5)]
    tx = joptimizer.make_optimizer(0.01, 1.0, 0.5, 2, warmup, adam_m_bf16)
    opt = optimizer.make_optimizer(0.01, 1.0, 0.5, 2, warmup, adam_m_bf16)
    jp, jstate = params, tx.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in flatten(params).items()}
    tstate = opt.init(tp)
    for i, g in enumerate(grads):
        assert i != 2 or float(optax.global_norm(g)) > 1.0
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply(tp, {k: torch.from_numpy(v)
                       for k, v in flatten(g).items()}, tstate)
        adam = jstate[1][0]
        assert tstate["count"] == int(adam.count)
        # 1e-6 of each tensor's largest element: the global norms round in
        # another order, so the clipped step's gradients, and the moments
        # where 0.1·g and 0.9·m cancel, differ in their last bits.
        for name, ref in flatten(jp).items():
            _close(tp[name], ref, 1e-6)
        for name, ref in flatten(adam.nu).items():
            _close(tstate["nu"][name], ref, 1e-6)
        for name, ref in flatten(adam.mu).items():
            mu = tstate["mu"][name]
            assert (mu.dtype == torch.bfloat16) == adam_m_bf16
            # bf16 moments: the same float32 value rounded once, so within
            # one bf16 ulp of each other.
            _close(mu, ref, 2 ** -8 if adam_m_bf16 else 1e-6)


def _close(ours, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_early_stopping_matches_jax():
    ours, ref = EarlyStopping(patience=1), JaxEarlyStopping(patience=1)
    for metric in (3.0, 2.0, 2.5, 2.4, 1.0, 1.5, 1.6, 1.7):
        a, ours = ours.update(metric)
        b, ref = ref.update(metric)
        assert a == b
        assert (ours.best_metric, ours.patience_count, ours.should_stop) == \
            (ref.best_metric, ref.patience_count, ref.should_stop)


# -- one whole train step -----------------------------------------------------

def _jax_opt_state_tree(state):
    adam = state.opt_state[1][0]
    return {"count": int(adam.count),
            "mu": {k: torch.from_numpy(np.asarray(v).copy())
                   for k, v in flatten(adam.mu).items()},
            "nu": {k: torch.from_numpy(np.asarray(v).copy())
                   for k, v in flatten(adam.nu).items()}}


def _assert_state_matches(tstate, jstate, lr):
    """float32, the same step computed in another order (XLA's fused
    program against eager PyTorch).

    The Adam moments, linear and quadratic in the gradients, within 1e-4
    of each tensor's largest element: the gradients of the FiLM layers
    carry the noise embedding's ~5000 rad arguments, where torch's and
    XLA's exp differ by an ulp (tests/test_torch_model.py holds the model
    to 1e-4 for it). The params and the EMA within 1e-2·lr (1e-5):
    Adam divides each gradient by its RMS sqrt(v̂), so a gradient's
    absolute error δg moves the step by about lr·δg/sqrt(v̂), and the
    gradients here carry a δg of up to ~1e-7 (the FiLM layers, through the
    noise embedding's one-ulp channels). Where sqrt(v̂) is below 1e-5 that
    is over a hundredth of lr, and near Adam's eps (1e-8) even a flipped
    sign, so those elements are held only to the distance two runs' steps
    can put between a param, 2·lr. One step, from the same state."""
    adam = jstate.opt_state[1][0]
    for key in ("mu", "nu"):
        for name, ref in flatten(getattr(adam, key)).items():
            _close(tstate.opt_state[key][name], ref, 1e-4)
    nu = flatten(adam.nu)
    for ours, refs in ((tstate.params, jstate.params),
                       (tstate.ema_params, jstate.ema_params)):
        for name, ref in flatten(refs).items():
            ref = np.asarray(ref)
            diff = np.abs(ours[name].detach().numpy() - ref)
            v_hat = np.asarray(nu[name]) / (1 - 0.999 ** tstate.step)
            small = np.sqrt(v_hat) < 1e-5
            tight = diff <= 1e-2 * lr
            assert (tight | small).all(), (name, diff[~small].max())
            assert diff.max() <= 2 * lr, (name, diff.max())


def _carry_from_jax(jstate, config):
    """A port state holding JAX's: params, Adam moments and count by name,
    EMA and step."""
    state = trainer.create_train_state(
        _torch_model(jax.tree_util.tree_map(np.asarray, jstate.params)),
        config, init=False)
    state.opt_state = _jax_opt_state_tree(jstate)
    state.ema_params = {k: torch.from_numpy(np.asarray(v).copy())
                        for k, v in flatten(jstate.ema_params).items()}
    state.step = int(jstate.step)
    return state


def test_train_step_matches_jax():
    """The port's train step against JAX ``make_train_step`` from the same
    params, batch and draws, EMA on: the first step from the same initial
    params, the second from JAX's state after the first, carried over by
    name (params, Adam moments and count, EMA)."""
    params = _jax_params()
    config = trainer.TrainConfig(learning_rate=1e-3, ema=True, mu=0.9,
                                 lr_schedule_interval=1, lr_gamma=0.9)
    jconfig = jtrainer.TrainConfig(learning_rate=1e-3, ema=True, mu=0.9,
                                   lr_schedule_interval=1, lr_gamma=0.9)
    jmodel = jax_get_model("TransformerDDPM", **KW)
    jbetas = jschedules.noise_schedule(1e-6, 0.01, T, "linear")
    jstate = jtrainer.create_train_state(jax.random.PRNGKey(0), jmodel,
                                         (1, S, C), (1, 1, 1), jconfig)
    jstate = jstate.replace(
        params=params, ema_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=jstate.tx.init(params))
    jstep = jtrainer.make_train_step(
        jmodel, jlosses.diffusion_loss, jbetas, True,
        joptimizer.stepped_exponential_schedule(1e-3, 1, 0.9))
    tstep = trainer.make_train_step(
        losses.diffusion_loss,
        schedules.noise_schedule(1e-6, 0.01, T, "linear"), True)
    for i, seed in enumerate((11, 12)):
        tstate = _carry_from_jax(jstate, config)
        batch, rng = _batch(seed), jax.random.PRNGKey(seed)
        jstate, jm = jstep(jstate, jnp.asarray(batch), rng)
        tstate, tm = tstep(tstate, torch.from_numpy(batch),
                           draws=_replayed_draws(rng, batch.shape, True))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad"]), float(jm["grad"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert tstate.step == int(jstate.step) == i + 1
        _assert_state_matches(tstate, jstate, 1e-3)


def test_ema_starts_as_a_copy():
    state = trainer.create_train_state(_torch_model(_jax_params()),
                                       trainer.TrainConfig(ema=True),
                                       init=False)
    for name, p in state.params.items():
        assert torch.equal(state.ema_params[name], p)
        assert state.ema_params[name].data_ptr() != p.data_ptr()
    assert state.sampling_params is state.ema_params


def test_remat_gradients_equal_plain_gradients():
    params = _jax_params()
    x, t = torch.from_numpy(_batch()), torch.full((B, 1, 1), 0.4)
    grads = []
    for remat in (False, True):
        model = _torch_model(params, remat=remat)
        loss = model(x, t).square().sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_seeded_init_is_flax_style_and_reproducible():
    a = get_model("TransformerDDPM", device="cpu", data_channels=C, **KW)
    b = get_model("TransformerDDPM", device="cpu", data_channels=C, **KW)
    trainer.create_train_state(a, trainer.TrainConfig(), seed=3)
    trainer.create_train_state(b, trainer.TrainConfig(), seed=3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        if name.endswith("LayerNorm_0.scale"):
            assert (p == 1).all(), name
    k = a.TransformerEncoder_0.Dense_0.kernel
    # lecun normal: variance 1/fan_in, truncated at 2 std.
    assert abs(float(k.detach().std()) * C ** 0.5 - 1.0) < 0.3


# -- the fused layout's gradients ---------------------------------------------

@pytest.fixture
def jax_fused_kernels(monkeypatch):
    """The JAX fused layers on their kernel route on the CPU: the
    ``custom_vjp`` kernels run interpreted. Returns the call counts
    (film, attention)."""
    calls = [0, 0]

    def film(*args, **kwargs):
        calls[0] += 1
        return jffr.fused_ln_film_swish_dense(*args, interpret=True,
                                              **kwargs)

    def attention(*args):
        calls[1] += 1
        return jfat.fused_ln_attention(*args, True)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    # The layers import these modules when called.
    monkeypatch.setattr(jops, "fused_film_resblock", types.SimpleNamespace(
        fused_ln_film_swish_dense=film, supported=lambda *a: True,
        _reference=jffr._reference))
    monkeypatch.setattr(jops, "fused_attention", types.SimpleNamespace(
        fused_ln_attention=attention, supported=lambda *a: True,
        _reference=jfat._reference))
    return calls


def test_fused_layout_gradients_match_jax_custom_vjp(jax_fused_kernels):
    """The port's fused layout (its autograd nodes, their plain versions on
    the CPU) against JAX's through its ``custom_vjp`` kernels."""
    params = fuse_head_params(fuse_attention_params(_jax_params()))
    x, t = _batch(), np.full((B, 1, 1), 0.4, np.float32)
    jmodel = jax_get_model("TransformerDDPM", fused_attention=True,
                           fused_head=True, **KW)
    ref = jax.grad(lambda p: jnp.sum(jmodel.apply(p, x, t) ** 2))(params)
    assert jax_fused_kernels == [2 * KW["num_mlp_layers"], KW["num_layers"]]

    model = _torch_model(params, fused_attention=True, fused_head=True)
    names = [n for n, _ in model.named_parameters()]
    loss = model(torch.from_numpy(x), torch.from_numpy(t)).square().sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ref = flatten(ref)
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        # float32, within 1e-4 of each tensor's largest element; the noise
        # embedding's ~5000 rad arguments, as in tests/test_torch_model.py.
        _close(g, ref[name], 1e-4)


# -- the loop: checkpoints, resume, boundaries ---------------------------------

TINY = dict(num_layers=1, num_heads=2, num_mlp_layers=1, mlp_dims=16,
            embed_channels=16)


def _tiny_model():
    return get_model("TransformerDDPM", device="cpu", data_channels=3,
                     **TINY)


def _batches(n, seed):
    data = np.random.default_rng(seed).uniform(
        -1, 1, (n, 4, 5, 3)).astype(np.float32)
    return lambda: iter(list(data))


def _fit(model_dir, max_steps, snapshot_freq=100, scan_chunk=1,
         epoch_batches=4, seen=None):
    config = trainer.TrainConfig(batch_size=4, epochs=8, max_steps=max_steps,
                                 snapshot_freq=snapshot_freq,
                                 logging_freq=100, verbose=False, ema=True,
                                 mu=0.9, scan_chunk=scan_chunk)
    betas = schedules.noise_schedule(1e-4, 0.02, 10, "linear")
    callback = None if seen is None else \
        (lambda s, em, i: seen.append(s.step))
    return trainer.fit(_tiny_model(), betas, _batches(epoch_batches, 0),
                       _batches(1, 1), (5, 3), config, model_dir,
                       snapshot_callback=callback)


def test_checkpoint_manager_saves_keeps_and_restores(tmp_path):
    state = trainer.create_train_state(_tiny_model(), trainer.TrainConfig())
    manager = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert manager.latest_step is None
    assert manager.restore_latest(state) is state
    for step in (1, 2, 3):
        state.step = step
        manager.save(step, state)
    assert manager.all_steps() == [2, 3] and manager.latest_step == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["2.pt", "3.pt"]
    fresh = trainer.create_train_state(_tiny_model(), trainer.TrainConfig(),
                                       seed=5)
    fresh = manager.restore_latest(fresh)
    assert fresh.step == 3
    for name, p in state.params.items():
        assert torch.equal(fresh.params[name], p)
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())


def test_resume_equals_a_straight_run(tmp_path):
    """N steps, then a resume to 2N, equal 2N straight steps: the
    checkpoint carries the generator's state, and an epoch holds N
    batches, so the resumed run's data order is the straight run's."""
    _fit(str(tmp_path / "a"), 4, snapshot_freq=4)
    resumed = _fit(str(tmp_path / "a"), 8, snapshot_freq=4)
    straight = _fit(str(tmp_path / "b"), 8, snapshot_freq=4)
    assert resumed.step == straight.step == 8
    for name, p in straight.params.items():
        assert torch.equal(resumed.params[name], p), name
        assert torch.equal(resumed.ema_params[name],
                           straight.ema_params[name]), name
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())


def test_resume_at_completion_is_a_noop(tmp_path):
    first = _fit(str(tmp_path / "r"), 6)
    again = _fit(str(tmp_path / "r"), 6)
    assert again.step == 6
    for name, p in first.params.items():
        assert torch.equal(again.params[name], p)
    assert CheckpointManager(str(tmp_path / "r" / "ckpt")).all_steps() == [6]


@pytest.mark.parametrize("scan_chunk", [1, 4])
def test_scan_chunk_fit_boundaries(tmp_path, scan_chunk, monkeypatch):
    """Snapshots land at snapshot_freq and training stops at max_steps,
    chunked or not (the JAX package's test_scan_chunk_fit_boundaries). With
    scan_chunk 4 the steps go through the chunk, cut at the snapshot (4,
    then 2 to step 6) and at max_steps (4 to step 10)."""
    from smd_tpu_torch.training import graphs
    chunks = []
    call = graphs.TrainChunk.__call__

    def spy(self, state, batches, draws=None):
        chunks.append(len(batches))
        return call(self, state, batches, draws)

    monkeypatch.setattr(graphs.TrainChunk, "__call__", spy)
    seen = []
    state = _fit(str(tmp_path / "s"), 10, snapshot_freq=6,
                 scan_chunk=scan_chunk, epoch_batches=50, seen=seen)
    assert state.step == 10
    assert seen == [6, 10]
    assert CheckpointManager(str(tmp_path / "s" / "ckpt")).all_steps() == \
        [6, 10]
    assert chunks == ([] if scan_chunk == 1 else [4, 2, 4])


def test_unported_objectives_raise():
    """Every objective the JAX package names is ported (dsm and ssm held
    against it in tests/test_torch_score_matching.py); an unknown one
    raises."""
    assert trainer.objective_by_name("dsm") is \
        losses.denoising_score_matching_loss
    assert trainer.objective_by_name("ssm") is \
        losses.sliced_score_matching_loss
    with pytest.raises(ValueError):
        trainer.objective_by_name("nope")
    assert trainer.objective_by_name("ddpm") is losses.diffusion_loss
