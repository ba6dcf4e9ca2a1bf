"""The port's MusicVAE against ``smd_tpu``'s, on the CPU.

The LSTM cell, the encoder (flat and hierarchical), the teacher-forced
logits, the conductor and the sampled decode, with JAX's Gumbel draws
replayed through ``gumbel=``, on tiny configs from the same params (JAX's
init moved by a seeded normal, carried over by ``load_flax_params``), in
float32 and at bf16 compute; the shipped codec bundles, read by the port's
unpickler; the Flax tree round trip.
"""
import dataclasses
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from smd_tpu import config as jconfig
from smd_tpu.codec import melody as jmelody
from smd_tpu.codec import musicvae as jmv
from smd_tpu.codec import performance as jperf
from smd_tpu_torch import config
from smd_tpu_torch.codec import musicvae as mv
from smd_tpu_torch.models import get_model
from smd_tpu_torch.utils import io as io_lib
from smd_tpu_torch.utils.flax_params import (flatten, load_flax_params,
                                             random_flax_params, to_flax_tree)
from test_torch_codec import melody_piece

# float32: the same arithmetic in another order (XLA's scan against eager
# PyTorch), ~3e-7 of the largest output measured through 32 steps.
F32_RTOL = 1e-5
# bf16 compute: the LSTMs round their products and gates to bf16 (8 bits),
# at other points than XLA, which keeps fused elementwise chains in
# float32; ~1e-2 of the largest output measured through 32 steps.
BF16_RTOL = 5e-2
# A bf16 free-running decode is compared token for token up to the first
# step where JAX's top-two score gap (logits / temperature + Gumbel) is
# below BF16_RTOL of the largest logit, the most a bf16 rounding moves a
# logit: such a step may flip, and everything after it. Over all steps at
# least BF16_TOKENS of the tokens must agree (all did, measured).
BF16_TOKENS = 0.9

CONFIGS = {
    "flat": dict(latent_dims=16, enc_units=12, dec_units=(10, 14), depth=90,
                 max_seq_len=32),
    "hier4-conductor1": dict(latent_dims=16, enc_units=12, dec_units=(10,),
                             depth=90, max_seq_len=32, hier_segments=4,
                             conductor_units=8, conductor_layers=1),
    "hier4-conductor2": dict(latent_dims=16, enc_units=12, dec_units=(10,),
                             depth=90, max_seq_len=32, hier_segments=4,
                             conductor_units=8, conductor_layers=2),
}
DTYPES = {"float32": (torch.float32, jnp.float32, F32_RTOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_RTOL)}
SHIPPED = ("musicvae-melody.pkl", "musicvae-melody-big.pkl",
           "musicvae-melody16.pkl", "musicvae-multi.pkl")


def _rel(ours, ref):
    """max |ours - ref| / max |ref|."""
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _setup(name, dtype="float32", seed=0):
    """The JAX model, a seeded Flax-layout tree (kernels normal with
    variance 1/fan_in, biases 0.1-scale normal: no term is zero) and the
    port's model with the tree carried in."""
    kw = CONFIGS[name]
    jcfg = jmv.MusicVAEConfig(**kw)
    jmodel = jmv.MusicVAE(jcfg, dtype=DTYPES[dtype][1])
    with torch.device("meta"):
        shapes = mv.MusicVAE(mv.MusicVAEConfig(**kw))
    params = random_flax_params(shapes, seed)
    model = mv.build_musicvae(mv.MusicVAEConfig(**kw), params,
                              dtype=DTYPES[dtype][0], device="cpu")
    return jcfg, jmodel, params, model


def _onehots(rng, batch, cfg):
    tokens = rng.integers(0, cfg.depth, size=(batch, cfg.max_seq_len))
    return np.eye(cfg.depth, dtype=np.float32)[tokens]


def jax_draws(key, batch, length, depth):
    """The Gumbel draws of JAX's decoder from ``key``: each step splits
    the key and ``categorical`` draws (batch, depth) from the new one."""
    draws = []
    for _ in range(length):
        key, step = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(step, (batch, depth),
                                                  jnp.float32)))
    return np.stack(draws, axis=1)


def tokens_agree_until_close(ours, ref, scores, margin):
    """Each row's tokens equal up to its first step whose top-two score
    gap is below ``margin``."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) < margin
    for row in range(ref.shape[0]):
        stop = int(np.argmax(close[row])) if close[row].any() \
            else ref.shape[1]
        np.testing.assert_array_equal(ours[row, :stop], ref[row, :stop])


def test_lstm_cell_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    c = rng.normal(size=(5, 6)).astype(np.float32)
    h = rng.normal(size=(5, 6)).astype(np.float32)
    for jdt, tdt, rtol in ((None, None, F32_RTOL),
                           (jnp.bfloat16, torch.bfloat16, BF16_RTOL)):
        ours = mv.LSTMCell(7, 6, tdt)
        params = random_flax_params(ours, seed=2)
        (jc, jh), _ = fnn.OptimizedLSTMCell(6, dtype=jdt).apply(
            params, (c, h), x)
        load_flax_params(ours, params)
        (tc, th), out = ours((torch.from_numpy(c), torch.from_numpy(h)),
                             torch.from_numpy(x))
        assert out is th
        # Flax's promotion: a float32 carry stays float32 under bf16.
        assert tc.dtype == torch.float32 and th.dtype == torch.float32
        assert _rel(tc, jc) < rtol and _rel(th, jh) < rtol


def _jax_outputs(jmodel, params, x, hier):
    """Encoder, teacher-forced logits (with the noise JAX's ``__call__``
    draws from the first half of its split key), conductor and decode at
    temperature 1 from key 11, in one compiled program."""
    def run(x):
        mu, sigma = jmodel.apply(params, x, method=lambda m, x: m.encoder(x))
        key = jax.random.PRNGKey(7)
        logits, _, _ = jmodel.apply(params, x, key)
        noise = jax.random.normal(jax.random.split(key)[0], mu.shape)
        emb = jmodel.apply(params, mu, method=lambda m, z: m.conductor(z)) \
            if hier else None
        dec_logits, tokens = jmodel.apply(params, mu, jax.random.PRNGKey(11),
                                          1.0, method=jmv.MusicVAE.decode)
        return mu, sigma, noise, logits, emb, dec_logits, tokens
    return [None if a is None else np.array(a)
            for a in jax.jit(run)(jnp.asarray(x))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_musicvae_matches_jax(name, dtype):
    jcfg, jmodel, params, model = _setup(name, dtype)
    rtol = DTYPES[dtype][2]
    B = 5
    x = _onehots(np.random.default_rng(3), B, jcfg)
    mu, sigma, noise, logits, emb, dec_logits, tokens = _jax_outputs(
        jmodel, params, x, jcfg.hier_segments > 0)

    with torch.no_grad():
        ours_mu, ours_sigma = model.encoder(torch.from_numpy(x))
        assert ours_mu.dtype == torch.float32
        assert _rel(ours_mu, mu) < rtol and _rel(ours_sigma, sigma) < rtol
        ours, _, _ = model(torch.from_numpy(x), noise=torch.from_numpy(noise))
        assert ours.shape == logits.shape and _rel(ours, logits) < rtol
        if jcfg.hier_segments:
            assert _rel(model.conductor(torch.from_numpy(mu)), emb) < rtol
        # Sampling at temperature 1, JAX's draws replayed.
        S = max(jcfg.hier_segments, 1)
        draws = jax_draws(jax.random.PRNGKey(11), B * S,
                          jcfg.max_seq_len // S, jcfg.depth)
        ours_logits, ours_tokens = model.decode(
            torch.from_numpy(mu), 1.0, gumbel=torch.from_numpy(draws))
    if dtype == "float32":
        np.testing.assert_array_equal(ours_tokens.numpy(), tokens)
        assert _rel(ours_logits, dec_logits) < rtol
    else:
        tokens_agree_until_close(
            ours_tokens.numpy().reshape(B * S, -1),
            tokens.reshape(B * S, -1),
            dec_logits.reshape(B * S, -1, jcfg.depth) + draws,
            BF16_RTOL * np.abs(dec_logits).max())
        assert (ours_tokens.numpy() == tokens).mean() >= BF16_TOKENS


def _shipped(name):
    path = f"{mv._CKPT_DIR}/{name}"
    with open(path, "rb") as f:
        return path, pickle.load(f)


def test_shipped_melody_codec_tokens_equal_jax():
    """The 28 MB melody codec through each package's TrainedMusicVAE: the
    same posterior, the same tokens with JAX's draws replayed, and the
    round-trip accuracy the JAX package's own test asks for."""
    path, bundle = _shipped("musicvae-melody.pkl")
    jvae = jmv.TrainedMusicVAE(params=bundle)
    vae = mv.TrainedMusicVAE(params=io_lib.load(path), device="cpu")
    assert not vae.random_weights and vae.config == mv.MusicVAEConfig(
        **dataclasses.asdict(jvae.config))
    chunks = []
    seed = 100
    while len(chunks) < 48:
        chunks += vae.converter.to_tensors(
            melody_piece(seed)).inputs[::2]
        seed += 1
    chunks = chunks[:48]
    _, jmu, jsigma = jvae.encode_tensors(chunks)
    _, mu, sigma = vae.encode_tensors(chunks)
    assert _rel(mu, jmu) < F32_RTOL and _rel(sigma, jsigma) < F32_RTOL

    # JAX's decode_to_tensors takes the next key of its stream and pads
    # the batch to a power of two.
    key = jax.random.split(jvae._rng)[1]
    jtokens = jvae.decode_to_tensors(jmu)
    draws = jax_draws(key, jvae._bucket(len(chunks)), 32, 90)[:len(chunks)]
    tokens = vae.decode_to_tensors(jmu, gumbel=torch.from_numpy(draws))
    np.testing.assert_array_equal(tokens, jtokens)
    labels = np.stack(chunks).argmax(-1)
    acc = float((tokens == labels).mean())
    assert acc > 0.8, f"round-trip token accuracy {acc:.3f}"


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_bundles_load(name):
    """Every leaf of each shipped bundle lands on the port's module with its
    shape, fp16 restored to float32; the config normalized as JAX does."""
    path, _ = _shipped(name)   # pickle.load here: the JAX package's class
    bundle = io_lib.load(path)
    assert type(bundle["config"]) is mv.MusicVAEConfig
    vae = mv.TrainedMusicVAE(params=bundle, device="cpu")
    assert dataclasses.asdict(vae.config) == dataclasses.asdict(
        jmv.normalize_config(bundle["config"]))
    leaves = flatten(mv.normalize_params(bundle["params"]))
    state = vae.model.state_dict()
    assert set(leaves) == set(state)
    for key, leaf in leaves.items():
        assert leaf.dtype == np.float16
        assert state[key].dtype == torch.float32
        np.testing.assert_array_equal(state[key].numpy(),
                                      leaf.astype(np.float32))
    assert vae.converter.seq_len == vae.config.max_seq_len


def test_unpickler_maps_the_config_and_refuses_other_jax_globals(tmp_path):
    cfg = jmv.MusicVAEConfig(latent_dims=8, hier_segments=2)
    path = tmp_path / "config.pkl"
    path.write_bytes(pickle.dumps({"config": cfg, "x": np.arange(3)}))
    loaded = io_lib.load(str(path))
    assert type(loaded["config"]) is mv.MusicVAEConfig
    assert dataclasses.asdict(loaded["config"]) == dataclasses.asdict(cfg)
    for obj, name in ((jmelody.MelodyConverter(),
                       "smd_tpu.codec.melody.MelodyConverter"),
                      (jnp.arange(3), "jax")):
        path.write_bytes(pickle.dumps(obj))
        with pytest.raises(pickle.UnpicklingError, match=name):
            io_lib.load(str(path))


def _assert_trees_equal(ours, ref):
    assert set(flatten(ours)) == set(flatten(ref))
    for key, leaf in flatten(ref).items():
        assert flatten(ours)[key].dtype == leaf.dtype
        np.testing.assert_array_equal(flatten(ours)[key], leaf)


def test_to_flax_tree_inverts_load_flax_params():
    _, _, params, model = _setup("hier4-conductor2")
    _assert_trees_equal(to_flax_tree(load_flax_params(model, params)),
                        params)
    flagship = get_model("TransformerDDPM", device="cpu", data_channels=6,
                         num_layers=1, num_heads=2, mlp_dims=16)
    tree = random_flax_params(flagship, seed=3)
    _assert_trees_equal(to_flax_tree(load_flax_params(flagship, tree)), tree)
    # A {name: tensor} mapping (a TrainState's params) gives the same tree.
    _assert_trees_equal(to_flax_tree(dict(flagship.named_parameters())),
                        tree)


def test_old_conductor_name_and_config_load():
    """Bundles pickled before ``conductor_layers`` and the ``lstm_0`` name
    load as 1-layer conductors; the caller's tree is left as it is."""
    jcfg, _, params, _ = _setup("hier4-conductor1")
    cell = params["params"]["conductor"]["cell"]
    old = {"params": {**params["params"], "conductor": {
        **params["params"]["conductor"],
        "cell": {"lstm": cell["lstm_0"],
                 "segment_embedding": cell["segment_embedding"]}}}}
    cfg = jmv.MusicVAEConfig(**CONFIGS["hier4-conductor1"])
    del cfg.__dict__["conductor_layers"]     # as pickled before the field
    vae = mv.TrainedMusicVAE(params={"params": old, "config": cfg},
                             device="cpu")
    assert vae.config.conductor_layers == 1
    assert "lstm" in old["params"]["conductor"]["cell"]
    np.testing.assert_array_equal(
        vae.model.conductor.cell.lstm_0.hi.kernel.numpy(),
        cell["lstm_0"]["hi"]["kernel"])


def test_decode_guards():
    _, _, _, model = _setup("hier4-conductor1")
    z = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="must divide by hier_segments=4"):
        model.decode(z, length=30)
    # Scheduled sampling runs (tests/test_torch_codec_training.py holds it
    # against JAX).
    _, _, _, model = _setup("flat")
    with torch.no_grad():
        logits, _, _ = model(torch.zeros(2, 32, 90), ss_prob=0.5)
    assert logits.shape == (2, 32, 90) and torch.isfinite(logits).all()


@pytest.mark.parametrize("entry", ["melody-2-big", "melody-16-big",
                                   "multi-1-big"])
def test_converter_inference_and_random_weights(entry, caplog):
    """A codec built without params and without a shipped fit picks the
    converter JAX picks, and warns that its weights are random."""
    model = config.MUSIC_VAE_CONFIG[entry].model
    tiny = dataclasses.replace(model, latent_dims=8, enc_units=4,
                               dec_units=(4,), conductor_units=4)
    with caplog.at_level(logging.WARNING):
        vae = mv.TrainedMusicVAE(config=tiny, device="cpu")
    assert vae.random_weights and "random weights" in caplog.text
    # The converter jmv.TrainedMusicVAE infers for these shapes.
    ref = {"melody-2-big": jmelody.melody_2bar_converter,
           "melody-16-big": jconfig.melody_16bar_converter,
           "multi-1-big": jperf.multiperf_default_1bar_converter}[entry]
    assert type(vae.converter).__name__ == type(ref).__name__

    def public(converter):
        return {k: v for k, v in vars(converter).items() if k[0] != "_"}
    assert public(vae.converter) == public(ref)
    assert jconfig.MUSIC_VAE_CONFIG[entry].model == jmv.MusicVAEConfig(
        **dataclasses.asdict(model))
