"""The port's MusicVAE training against ``smd_tpu``'s, on the CPU.

Scheduled sampling in the teacher-forced decoder, flat and hierarchical,
with JAX's per-step draws replayed through ``gumbel=`` and ``ss_mix=``;
``elbo_loss`` and its gradient through encoder, conductor and decoder;
three train steps against optax's chain from the same tree and the eval
step's accuracies; the schedule's end value; the port's
``train_musicvae`` script in process on a tiny corpus (the JAX script's
numpy draws, the artifact read by both packages, ``--init_from``).
JAX-side params come from ``random_flax_params`` of the port's module (see
``test_torch_musicvae.py``).
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smd_tpu.codec import musicvae as jmv
from smd_tpu_torch.codec import musicvae as mv
from smd_tpu_torch.training import musicvae as mvtrain
from smd_tpu_torch.training import optimizer
from smd_tpu_torch.utils.flax_params import flatten, random_flax_params
from test_torch_musicvae import _onehots

# float32: the same arithmetic in another order (XLA's scan against eager
# PyTorch); every comparison is of the norm of the difference to the norm
# of JAX's value.
F32_NORM_RTOL = 1e-5
# elbo_loss alone, on the same float32 inputs: one reduction order apart.
ELBO_RTOL = 1e-6

CONFIGS = {
    "flat": dict(latent_dims=16, enc_units=16, dec_units=(16, 24), depth=90,
                 max_seq_len=32, free_bits=0.0, beta=0.2),
    "hier4": dict(latent_dims=8, enc_units=16, dec_units=(16,), depth=90,
                  max_seq_len=32, hier_segments=4, conductor_units=16,
                  conductor_layers=2, free_bits=0.0, beta=0.2),
}


def _setup(name, seed=0, **overrides):
    kw = {**CONFIGS[name], **overrides}
    jcfg = jmv.MusicVAEConfig(**kw)
    with torch.device("meta"):
        shapes = mv.MusicVAE(mv.MusicVAEConfig(**kw))
    params = random_flax_params(shapes, seed)
    model = mv.build_musicvae(mv.MusicVAEConfig(**kw), params, device="cpu")
    return jcfg, jmv.MusicVAE(jcfg), params, model


def _norm_rel(ours, ref):
    ours = ours.detach().double().numpy() if torch.is_tensor(ours) else \
        np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def jax_training_draws(key, batch, latent, length, depth, segments=1):
    """The draws of JAX's ``MusicVAE.__call__`` from ``key``: the encoder's
    noise from the first half of ``split(key)``; then, from the second,
    each teacher-forced step splits three ways and draws the Gumbel noise
    of ``categorical`` (B·S, depth) and the uniforms of ``bernoulli``
    (B·S, 1)."""
    rng, dec = jax.random.split(key)
    noise = np.asarray(jax.random.normal(rng, (batch, latent)))
    gumbel, mix = [], []
    rows = batch * segments
    for _ in range(length // segments):
        dec, step, mix_key = jax.random.split(dec, 3)
        gumbel.append(np.asarray(jax.random.gumbel(step, (rows, depth))))
        mix.append(np.asarray(jax.random.uniform(mix_key, (rows, 1))))
    return noise, np.stack(gumbel, 1), np.stack(mix, 1)


def _replayed(draws):
    noise, gumbel, mix = draws
    return dict(noise=torch.tensor(noise), gumbel=torch.tensor(gumbel),
                ss_mix=torch.tensor(mix))


def _fed_tokens(logits, gumbel, mix, targets, ss_prob, segments):
    """The token each teacher-forced step feeds back: the draw where
    ``u < ss_prob``, else the target (numpy, from a side's own logits)."""
    B, T, depth = logits.shape
    rows = logits.reshape(B * segments, T // segments, depth)
    draw = np.argmax(rows + gumbel, axis=-1)
    target = targets.reshape(B * segments, T // segments, depth).argmax(-1)
    return np.where(mix[..., 0] < np.float32(ss_prob), draw, target)


@pytest.mark.parametrize("ss_prob", [0.5, 1.0])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_scheduled_sampling_matches_jax(name, ss_prob):
    jcfg, jmodel, params, model = _setup(name)
    B, S = 4, max(jcfg.hier_segments, 1)
    x = _onehots(np.random.default_rng(5), B, jcfg)
    key = jax.random.PRNGKey(13)
    ref, _, _ = jax.jit(lambda x: jmodel.apply(params, x, key,
                                               ss_prob=ss_prob))(x)
    ref = np.asarray(ref)
    draws = jax_training_draws(key, B, jcfg.latent_dims, jcfg.max_seq_len,
                               jcfg.depth, S)
    with torch.no_grad():
        ours, _, _ = model(torch.from_numpy(x), ss_prob=ss_prob,
                           **_replayed(draws))
    assert _norm_rel(ours, ref) < F32_NORM_RTOL
    fed = _fed_tokens(ref, draws[1], draws[2], x, ss_prob, S)
    np.testing.assert_array_equal(
        _fed_tokens(ours.numpy(), draws[1], draws[2], x, ss_prob, S), fed)
    # The draws are fed: at 1.0 every step, at 0.5 some, and they differ
    # from the targets (random weights).
    target = x.reshape(B * S, -1, jcfg.depth).argmax(-1)
    assert (fed != target).any()
    # Bools choose as the uniforms they came from do.
    with torch.no_grad():
        as_bools, _, _ = model(
            torch.from_numpy(x), ss_prob=ss_prob,
            noise=torch.tensor(draws[0]), gumbel=torch.tensor(draws[1]),
            ss_mix=torch.tensor(draws[2] < np.float32(ss_prob)))
    torch.testing.assert_close(as_bools, ours, rtol=0, atol=0)


def test_scheduled_sampling_draws_from_the_generator():
    _, _, _, model = _setup("flat")
    x = torch.from_numpy(_onehots(np.random.default_rng(6), 3,
                                  jmv.MusicVAEConfig(**CONFIGS["flat"])))
    with torch.no_grad():
        runs = [model(x, torch.Generator().manual_seed(s), ss_prob=0.5)[0]
                for s in (1, 1, 2)]
        plain, _, _ = model(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], plain)


@pytest.mark.parametrize("free_bits", ["off", "half", "all"])
def test_elbo_loss_matches_jax(free_bits):
    rng = np.random.default_rng(1)
    B, T, depth, latent = 6, 32, 90, 16
    logits = rng.normal(0, 2, (B, T, depth)).astype(np.float32)
    targets = np.eye(depth, dtype=np.float32)[rng.integers(0, depth, (B, T))]
    mu = rng.normal(0, 1, (B, latent)).astype(np.float32)
    sigma = rng.uniform(0.05, 2.0, (B, latent)).astype(np.float32)
    kl_bits = 0.5 * np.sum(mu ** 2 + sigma ** 2 - 1 - np.log(sigma ** 2),
                           -1) / np.log(2)
    # No free bits; the median row's KL (half the rows clipped at 0); more
    # than every row's KL.
    bits = {"off": 0.0, "half": float(np.median(kl_bits)),
            "all": float(kl_bits.max()) + 1}[free_bits]
    ref, ref_aux = jmv.elbo_loss(logits, targets, mu, sigma, free_bits=bits,
                                 beta=0.2)
    ours, aux = mv.elbo_loss(*map(torch.from_numpy,
                                  (logits, targets, mu, sigma)),
                             free_bits=bits, beta=0.2)
    for a, b in ((ours, ref), (aux["rec"], ref_aux["rec"]),
                 (aux["kl"], ref_aux["kl"])):
        assert abs(float(a) - float(b)) <= ELBO_RTOL * abs(float(b))
    if free_bits == "all":
        assert abs(float(ours) - float(aux["rec"])) <= \
            ELBO_RTOL * float(aux["rec"])


def _jax_loss_fn(jmodel, cfg, x, key, ss_prob):
    def loss_fn(p):
        logits, mu, sigma = jmodel.apply(p, x, key, ss_prob=ss_prob)
        return jmv.elbo_loss(logits, x, mu, sigma, free_bits=cfg.free_bits,
                             beta=cfg.beta)
    return loss_fn


@pytest.mark.parametrize("name,ss_prob,free_bits",
                         [("flat", 0.5, 0.0), ("flat", 0.0, 4.0),
                          ("hier4", 0.5, 0.0)])
def test_elbo_gradient_matches_jax(name, ss_prob, free_bits):
    jcfg, jmodel, params, model = _setup(name, free_bits=free_bits)
    B, S = 4, max(jcfg.hier_segments, 1)
    x = _onehots(np.random.default_rng(7), B, jcfg)
    key = jax.random.PRNGKey(17)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jmodel, jcfg, x, key, ss_prob), has_aux=True))(params)
    draws = jax_training_draws(key, B, jcfg.latent_dims, jcfg.max_seq_len,
                               jcfg.depth, S)
    model.requires_grad_(True)
    logits, mu, sigma = model(torch.from_numpy(x), ss_prob=ss_prob,
                              **_replayed(draws))
    ours, ours_aux = mv.elbo_loss(logits, torch.from_numpy(x), mu, sigma,
                                  free_bits=jcfg.free_bits, beta=jcfg.beta)
    ours.backward()
    ours = float(ours.detach())
    assert abs(ours - float(loss)) <= F32_NORM_RTOL * abs(float(loss))
    assert abs(float(ours_aux["kl"].detach()) - float(aux["kl"])) <= \
        F32_NORM_RTOL * abs(float(aux["kl"]))
    ref = flatten(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    for n, p in named.items():
        assert p.grad is not None, n
        assert _norm_rel(p.grad, ref[n]) < F32_NORM_RTOL, n


@pytest.mark.parametrize("args", [(1e-3, 2, 20), (3e-4, 200, 2000),
                                  (1e-3, 1, 10), (5e-4, 10, 300)])
@pytest.mark.parametrize("end_fraction", [0.01, 0.02])
def test_schedule_end_fraction_matches_optax(args, end_fraction):
    lr, warmup, steps = args
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                             end_value=lr * end_fraction)
    ours = optimizer.warmup_cosine_decay_schedule(
        lr, warmup, steps, end_fraction=end_fraction)
    counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2,
                     steps - 1, steps, steps + 1, 3 * steps,
                     *range(0, steps + 5, max(steps // 50, 1))})
    for c in counts:
        # float32 both; numpy's cos and XLA's differ by up to an ulp.
        np.testing.assert_allclose(
            ours(c), float(ref(jnp.asarray(c, jnp.int32))), rtol=1e-6)
    np.testing.assert_allclose(ours(steps), lr * end_fraction, rtol=1e-6)
    np.testing.assert_allclose(ours(10 * steps), lr * end_fraction,
                               rtol=1e-6)
    if end_fraction == 0.01:   # the distillation trainers' default
        default = optimizer.warmup_cosine_decay_schedule(lr, warmup, steps)
        assert all(default(c) == ours(c) for c in counts)


def _optax_chain(lr, warmup_steps, steps):
    warmup = min(warmup_steps, max(steps // 10, 1))
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, steps, end_value=lr * 0.02)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_steps_match_optax(name):
    """Three full train steps (ELBO with scheduled sampling, clip, Adam on
    the codec's schedule) from the same tree, JAX's draws replayed."""
    jcfg, jmodel, params, model = _setup(name, free_bits=1.0)
    B, S = 4, max(jcfg.hier_segments, 1)
    lr, warmup_steps, steps, ss = 3e-3, 200, 10, 0.3
    tx = _optax_chain(lr, warmup_steps, steps)

    @jax.jit
    def jax_step(p, opt_state, batch, key):
        x = jax.nn.one_hot(batch, jcfg.depth)
        (loss, _), grads = jax.value_and_grad(
            _jax_loss_fn(jmodel, jcfg, x, key, ss), has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    ref, opt_state = params, tx.init(params)
    model.requires_grad_(True)
    ours_opt = mvtrain.make_optimizer(lr, warmup_steps, steps)
    ours_state = ours_opt.init(dict(model.named_parameters()))
    data = np.random.default_rng(8)
    for i in range(3):
        batch = data.integers(0, jcfg.depth, (B, jcfg.max_seq_len)).astype(
            np.uint8)
        key = jax.random.PRNGKey(100 + i)
        ref, opt_state, loss = jax_step(ref, opt_state, batch, key)
        draws = jax_training_draws(key, B, jcfg.latent_dims,
                                   jcfg.max_seq_len, jcfg.depth, S)
        ours, _ = mvtrain.train_step(model, ours_opt, ours_state,
                                     torch.from_numpy(batch), ss,
                                     **_replayed(draws))
        assert abs(float(ours) - float(loss)) <= \
            F32_NORM_RTOL * abs(float(loss))
    ref = flatten(jax.tree_util.tree_map(np.asarray, ref))
    for n, p in model.named_parameters():
        assert _norm_rel(p, ref[n]) < F32_NORM_RTOL, n
    assert ours_state["count"] == 3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_step_matches_jax(name):
    """The four accuracies of the JAX trainer's ``eval_step`` (its lines
    copied, as the script defines it inline), JAX's draws replayed."""
    jcfg, jmodel, params, model = _setup(name)
    B, S = 6, max(jcfg.hier_segments, 1)
    data = np.random.default_rng(9)
    # Half the rows PAD (token 0), as the multitrack grid's tails are.
    batch = data.integers(1, jcfg.depth, (B, jcfg.max_seq_len))
    batch[:, jcfg.max_seq_len // 2:] = 0
    key = jax.random.PRNGKey(21)

    @jax.jit
    def jax_eval(batch, rng):
        x = jax.nn.one_hot(batch, jcfg.depth)
        logits, mu, sigma = jmodel.apply(params, x, rng)
        labels = x.argmax(-1)
        mask = labels != 0
        tf_hit = logits.argmax(-1) == labels
        tf_acc = tf_hit.mean()
        tf_acc_np = (tf_hit * mask).sum() / jnp.maximum(mask.sum(), 1)
        _, samples = jmodel.apply(params, mu, rng, temperature=1e-3,
                                  method=jmv.MusicVAE.decode)
        fr_hit = samples == labels
        fr_acc = fr_hit.mean()
        fr_acc_np = (fr_hit * mask).sum() / jnp.maximum(mask.sum(), 1)
        return tf_acc, fr_acc, tf_acc_np, fr_acc_np

    ref = [float(a) for a in jax_eval(batch, key)]
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                         (B, jcfg.latent_dims)))
    from test_torch_musicvae import jax_draws
    gumbel = jax_draws(key, B * S, jcfg.max_seq_len // S, jcfg.depth)
    ours = mvtrain.eval_step(model, torch.from_numpy(batch),
                             noise=torch.tensor(noise),
                             gumbel=torch.from_numpy(gumbel))
    got = [float(ours[k]) for k in ("tf_acc", "fr_acc", "tf_acc_nonpad",
                                    "fr_acc_nonpad")]
    assert got == ref
    assert got[2] != got[0]   # the mask counts


# -- the script -----------------------------------------------------------------

TINY_SCRIPT = ["--latent_dims=8", "--enc_units=16", "--dec_units=16",
               "--dec_layers=1", "--batch_size=8", "--log_every=5",
               "--scan_chunk=3", "--eval_batches=2", "--parse_workers=1",
               "--device=cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from smd_tpu_torch.scripts import make_melody_corpus
    root = tmp_path_factory.mktemp("corpus")
    make_melody_corpus.main(["make_melody_corpus", f"--output_dir={root}",
                             "--n_songs=10", "--seed=4"])
    return root


def jax_script_draws(n, seed, batch, eval_frac, steps, log_every,
                     scan_chunk):
    """The JAX script's numpy draws (``scripts/train_musicvae.py:228-236``
    and ``:372-375``, its lines): the held-out chunks, then each step's
    batch indices, ``scan_chunk`` steps a draw."""
    rng_np = np.random.default_rng(seed)
    perm = rng_np.permutation(n)
    n_eval = max(batch, int(n * eval_frac)) if eval_frac else 0
    n_eval = min(n_eval, max(n - batch, 0))
    chunk = max(1, min(scan_chunk, log_every))
    step, batches = 0, []
    while step < steps:
        k_steps = min(chunk, steps - step)
        batches.extend(rng_np.integers(0, n - n_eval, (k_steps, batch)))
        step += k_steps
    return perm[:n_eval], np.asarray(batches)


def _chunks(corpus, count=8):
    from smd_tpu_torch.scripts.train_musicvae import load_tensors
    ids = load_tensors(sorted(str(p) for p in corpus.glob("*.mid")), 1)
    return [np.eye(90, dtype=np.float32)[row] for row in ids[:count]]


def test_script_trains_and_both_packages_load_its_artifact(corpus,
                                                           tmp_path):
    from smd_tpu.utils import io as jio
    from smd_tpu_torch.scripts import train_musicvae
    from smd_tpu_torch.utils import io as io_lib
    out = train_musicvae.main([
        "train_musicvae", f"--input={corpus}/*.mid", *TINY_SCRIPT,
        "--steps=20", "--scheduled_sampling=0.5", "--keep_best",
        "--eval_frac=0.1", "--seed=3", f"--output={tmp_path / 'codec.pkl'}"])
    metrics = out["metrics"]
    n = metrics["eval_chunks"] + metrics["train_chunks"]
    eval_index, batches = jax_script_draws(n, 3, 8, 0.1, 20, 5, 3)
    np.testing.assert_array_equal(out["eval_index"], eval_index)
    np.testing.assert_array_equal(out["batch_indices"], batches)
    assert out["losses"].shape == (20,) and np.isfinite(out["losses"]).all()
    assert set(metrics) >= {"eval_teacher_forced_acc", "eval_roundtrip_acc",
                            "eval_teacher_forced_acc_nonpad",
                            "eval_roundtrip_acc_nonpad"}

    ours_bundle = io_lib.load(str(tmp_path / "codec.pkl"))
    leaves = flatten(ours_bundle["params"])
    assert all(v.dtype == np.float16 for v in leaves.values())
    jax_codec = jmv.TrainedMusicVAE(params=jio.load(
        str(tmp_path / "codec.pkl")))
    ours_codec = mv.TrainedMusicVAE(params=ours_bundle, device="cpu")
    assert jax_codec.config == jmv.MusicVAEConfig(**dataclasses.asdict(
        ours_codec.config)) and ours_codec.config.enc_units == 16
    chunks = _chunks(corpus)
    _, ref_mu, ref_sigma = jax_codec.encode_tensors(chunks)
    _, mu, sigma = ours_codec.encode_tensors(chunks)
    assert _norm_rel(mu, ref_mu) < F32_NORM_RTOL
    assert _norm_rel(sigma, ref_sigma) < F32_NORM_RTOL


def test_init_from_checks_the_architecture(corpus, tmp_path):
    from smd_tpu_torch.scripts import train_musicvae
    base = [f"--input={corpus}/*.mid", *TINY_SCRIPT, "--steps=2",
            f"--output={tmp_path / 'out.pkl'}"]
    train_musicvae.main(["t", *base, f"--output={tmp_path / 'a.pkl'}"])
    assert not (tmp_path / "out.pkl").exists()
    with pytest.raises(ValueError, match="does not match the architecture "
                       "flags \\(param tree shapes differ\\)"):
        train_musicvae.main(["t", *base, "--dec_units=24",
                             f"--init_from={tmp_path / 'a.pkl'}"])
    # Same shapes, another chunk length (the LSTMs do not depend on it):
    # the pickled config's fields catch it.
    from smd_tpu_torch.utils import io as io_lib
    bundle = io_lib.load(str(tmp_path / "a.pkl"))
    bundle["config"] = dataclasses.replace(bundle["config"], max_seq_len=64)
    io_lib.save(bundle, str(tmp_path / "b.pkl"))
    with pytest.raises(ValueError, match="different architecture/problem "
                       "than the current flags and corpus: max_seq_len: "
                       "checkpoint=64 flags=32"):
        train_musicvae.main(["t", *base, f"--init_from={tmp_path / 'b.pkl'}"])


def test_a_jax_bundle_fine_tunes_in_the_port(corpus, tmp_path, caplog):
    """A bundle in the JAX script's format (JAX config class, float16
    Flax tree, pickled by the JAX package's ``io.save``) seeds the port's
    run: at a learning rate of 1e-12 the shipped params are the bundle's."""
    from smd_tpu.utils import io as jio
    from smd_tpu_torch.scripts import train_musicvae
    from smd_tpu_torch.utils import io as io_lib
    kw = dict(latent_dims=8, enc_units=16, dec_units=(16,), depth=90,
              max_seq_len=32, free_bits=48.0, beta=0.2)
    with torch.device("meta"):
        shapes = mv.MusicVAE(mv.MusicVAEConfig(**kw))
    tree = jax.tree_util.tree_map(lambda v: v.astype(np.float16),
                                  random_flax_params(shapes, 5))
    jio.save({"params": tree, "config": jmv.MusicVAEConfig(**kw),
              "metrics": {}}, str(tmp_path / "jax.pkl"))
    with caplog.at_level(logging.INFO, logger="smd_tpu_torch"):
        train_musicvae.main([
            "t", f"--input={corpus}/*.mid", *TINY_SCRIPT, "--steps=3",
            "--learning_rate=1e-12", "--noscheduled_sampling_ramp",
            "--scheduled_sampling=0.5", f"--init_from={tmp_path / 'jax.pkl'}",
            f"--output={tmp_path / 'tuned.pkl'}"])
    assert "init_from baseline" in caplog.text
    tuned = flatten(io_lib.load(str(tmp_path / "tuned.pkl"))["params"])
    for name, value in flatten(tree).items():
        np.testing.assert_array_equal(tuned[name], value)
