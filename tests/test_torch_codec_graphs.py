"""The codec's recurrences as kept chains (``codec/musicvae.py`` over
``utils/graphs.py``), on the CPU.

On the card each recurrence (the BiLSTM encoder, the decoder in its three
modes, the conductor) is one step captured in a CUDA graph and replayed
once a step; here the same step body runs eagerly, reading the same staged
rows and per-call buffers. These tests hold what the graph reads: each step
body against JAX's ``MusicVAE`` with JAX's draws replayed, at
``test_torch_musicvae.py``'s small configs and tolerances, float32 and
bf16; each chain bit-equal to the inline steps that autograd takes; the
bucketed ``encode_tensors`` and ``decode_to_tensors`` row by row against
the unpadded calls; a kept chain serving a second call at another
temperature, seed or batch as a fresh chain does; a kept chain reading
a parameter written in place since its last call, and a rebound parameter
making a new chain; and the chain bounds keeping every chain of a noise
-> MIDI call.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from smd_tpu.codec import musicvae as jmv
from smd_tpu_torch.codec import musicvae as mv
from smd_tpu_torch.diffusion import schedules
from smd_tpu_torch.sampling import generate
from smd_tpu_torch.utils import graphs
from test_torch_codec_training import _fed_tokens, jax_training_draws
from test_torch_musicvae import (BF16_TOKENS, DTYPES, _jax_outputs,
                                 _onehots, _rel, _setup, jax_draws,
                                 tokens_agree_until_close)

CASES = ("flat", "hier4-conductor1")
SS_PROB = 0.5
# The bucketed encode against the unpadded one: the same rows through
# float32 products whose kernel MKL picks by the batch size, read 6.4e-8
# of the largest |mu| or |sigma| at most (batches 3-7 padded to 8).
BUCKET_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_chains():
    graphs.release()
    yield
    graphs.release()


def _labels():
    return sorted(key[0] for key in graphs._CODEC_CHAINS)


def _chains():
    return list(graphs._CODEC_CHAINS.values())


def _segments(jcfg):
    return max(jcfg.hier_segments, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_step_bodies_match_jax(name, dtype):
    """The encoder, the teacher-forced, free-running and scheduled-sampling
    decoder and the conductor through their chains' step bodies against
    JAX's scans, JAX's noise and Gumbel draws replayed, within
    ``test_torch_musicvae.py``'s tolerance of the dtype; the bf16 tokens
    as that file holds them."""
    jcfg, jmodel, params, model = _setup(name, dtype)
    rtol = DTYPES[dtype][2]
    B, S = 5, _segments(jcfg)
    hier = jcfg.hier_segments > 0
    x = _onehots(np.random.default_rng(3), B, jcfg)
    mu, sigma, noise, logits, emb, dec_logits, tokens = _jax_outputs(
        jmodel, params, x, hier)
    with torch.no_grad():
        ours_mu, ours_sigma = model.encoder(torch.from_numpy(x))
        assert _labels() == ["encoder"]
        assert _rel(ours_mu, mu) < rtol and _rel(ours_sigma, sigma) < rtol
        ours, _, _ = model(torch.from_numpy(x), noise=torch.from_numpy(noise))
        assert "teacher decoder" in _labels()
        assert ("conductor" in _labels()) == hier
        assert _rel(ours, logits) < rtol
        if hier:
            assert _rel(model.conductor(torch.from_numpy(mu)), emb) < rtol
        draws = jax_draws(jax.random.PRNGKey(11), B * S,
                          jcfg.max_seq_len // S, jcfg.depth)
        ours_logits, ours_tokens = model.decode(
            torch.from_numpy(mu), 1.0, gumbel=torch.from_numpy(draws))
        assert "free decoder" in _labels()
    if dtype == "float32":
        np.testing.assert_array_equal(ours_tokens.numpy(), tokens)
        assert _rel(ours_logits, dec_logits) < rtol
    else:
        tokens_agree_until_close(
            ours_tokens.numpy().reshape(B * S, -1),
            tokens.reshape(B * S, -1),
            dec_logits.reshape(B * S, -1, jcfg.depth) + draws,
            rtol * np.abs(dec_logits).max())
        assert (ours_tokens.numpy() == tokens).mean() >= BF16_TOKENS


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_scheduled_sampling_chain_matches_jax(name, dtype):
    """The scheduled-sampling decoder's chain (the draw fed where the
    step's mix says so) against JAX's ``__call__`` with ``ss_prob``, its
    draws replayed: the logits within the dtype's tolerance and, in
    float32, every fed token JAX's."""
    jcfg, jmodel, params, model = _setup(name, dtype)
    rtol = DTYPES[dtype][2]
    B, S = 4, _segments(jcfg)
    x = _onehots(np.random.default_rng(5), B, jcfg)
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jax.jit(lambda x: jmodel.apply(
        params, x, key, ss_prob=SS_PROB))(x)[0], np.float32)
    noise, gumbel, mix = jax_training_draws(
        key, B, jcfg.latent_dims, jcfg.max_seq_len, jcfg.depth, S)
    with torch.no_grad():
        ours, _, _ = model(torch.from_numpy(x), ss_prob=SS_PROB,
                           noise=torch.tensor(noise),
                           gumbel=torch.tensor(gumbel),
                           ss_mix=torch.tensor(mix))
    assert "scheduled decoder" in _labels()
    assert _rel(ours, ref) < rtol
    if dtype == "float32":
        np.testing.assert_array_equal(
            _fed_tokens(ours.numpy(), gumbel, mix, x, SS_PROB, S),
            _fed_tokens(ref, gumbel, mix, x, SS_PROB, S))


def _every_mode(model, x, mu, draws):
    """(mu, sigma, teacher-forced logits, scheduled-sampling logits,
    free-running logits and tokens) of ``model``."""
    cfg = model.config
    S = max(cfg.hier_segments, 1)
    rows, length = x.shape[0] * S, cfg.max_seq_len // S
    gumbel = draws[:rows, :length]
    mix = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(rows, length, 1)).astype(np.float32))
    noise = torch.zeros_like(mu)
    enc = model.encoder(x)
    teacher = model(x, noise=noise)[0]
    scheduled = model(x, noise=noise, ss_prob=SS_PROB, gumbel=gumbel,
                      ss_mix=mix)[0]
    free = model.decode(mu, 0.7, gumbel=gumbel)
    return (*enc, teacher, scheduled, *free)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_chains_equal_the_inline_steps(name, dtype):
    """Every chain (autograd off) bit-equal to the inline steps autograd
    takes (autograd on), which make no chain: the same per-step
    arithmetic."""
    jcfg, _, _, model = _setup(name, dtype)
    x = torch.from_numpy(_onehots(np.random.default_rng(8), 3, jcfg))
    mu = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, jcfg.latent_dims)).astype(np.float32))
    draws = mv.gumbel_noise((3 * 4, 32, jcfg.depth),
                            torch.Generator().manual_seed(2))
    with torch.no_grad():
        chained = _every_mode(model, x, mu, draws)
    labels = _labels()
    assert labels == sorted(["encoder", "teacher decoder",
                             "scheduled decoder", "free decoder"]
                            + ["conductor"] * (jcfg.hier_segments > 0))
    with torch.enable_grad():
        inline = _every_mode(model, x, mu, draws)
    assert _labels() == labels
    for a, b in zip(chained, inline):
        assert torch.equal(a, b.detach())


@pytest.mark.parametrize("name", CASES)
def test_bucketed_encode_and_decode_equal_the_unpadded_rows(name):
    """``encode_tensors`` pads 5 chunks to 8 and slices them back: bit-equal
    to the model's encode of the padded batch, whose noise is drawn for 8
    rows as JAX draws it, and each row within BUCKET_RTOL of the unpadded
    encoder's. ``decode_to_tensors`` draws for the 5 rows and pads: its
    tokens equal the unpadded decode's with those draws, and the codec's
    generator ends where that decode leaves it."""
    jcfg, _, params, _ = _setup(name)
    cfg = mv.MusicVAEConfig(**dataclasses.asdict(jcfg))
    vae = mv.TrainedMusicVAE(params=params, config=cfg, device="cpu")
    x = _onehots(np.random.default_rng(3), 5, jcfg)
    state = vae._generator.get_state()
    z, mu, sigma = vae.encode_tensors(list(x))
    assert z.shape == mu.shape == sigma.shape == (5, cfg.latent_dims)
    padded = torch.from_numpy(np.concatenate([x, np.zeros_like(x[:3])]))
    with torch.no_grad():
        ref = vae.model.encode(padded, torch.Generator().set_state(state))
        unpadded = vae.model.encoder(torch.from_numpy(x))
    for ours, want in zip((z, mu, sigma), ref):
        np.testing.assert_array_equal(ours, want[:5].numpy())
    for ours, want in zip((mu, sigma), unpadded):
        assert _rel(ours, want.numpy()) <= BUCKET_RTOL

    S = _segments(jcfg)
    state = vae._generator.get_state()
    tokens = vae.decode_to_tensors(mu, temperature=1.0)
    gen = torch.Generator().set_state(state)
    with torch.no_grad():
        _, want = vae.model.decode(torch.from_numpy(mu), 1.0, generator=gen)
    np.testing.assert_array_equal(tokens, want.numpy())
    assert torch.equal(vae._generator.get_state(), gen.get_state())
    assert "free decoder" in _labels() and "encoder" in _labels()


def test_a_kept_chain_serves_another_call_as_a_fresh_one():
    """A second decode through the kept chains at another temperature and
    seed, and a third at another batch, equal fresh chains' decodes, the
    generator left where the fresh decode leaves it; the temperature is
    staged each call (the first call's is not kept)."""
    jcfg, _, _, model = _setup("hier4-conductor1")
    mu = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, jcfg.latent_dims)).astype(np.float32))

    def call(temperature, seed, rows=4):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out = model.decode(mu[:rows], temperature, generator=gen)
        return (*out, gen.get_state())

    first = call(1.0, 0)
    kept = _chains()
    assert len(kept) == 2   # the conductor and the free decoder
    second = call(0.3, 1)
    third = call(0.3, 1, rows=2)
    assert _chains() == kept
    graphs.release()
    for ours in (second, third):
        fresh = call(0.3, 1, rows=ours[0].shape[0])
        assert all(torch.equal(a, b) for a, b in zip(ours, fresh))
        graphs.release()
    assert not torch.equal(first[1], second[1])


def test_a_kept_chain_reads_the_weights_of_each_call():
    """The decoder's chain holds its gate kernels joined, rewritten from the
    parameters before each call: a kernel written in place keeps the chain
    and its decode reads the new weights; a kernel rebound makes a new
    chain (the old one freed), which reads the new tensor. Each equals the
    inline steps on the weights of that call."""
    jcfg, _, _, model = _setup("flat")
    mu = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, jcfg.latent_dims)).astype(np.float32))
    gumbel = mv.gumbel_noise((3, 32, jcfg.depth),
                             torch.Generator().manual_seed(5))

    def decode():
        with torch.no_grad():
            return model.decode(mu, 1.0, gumbel=gumbel)

    def inline():
        with torch.enable_grad():
            return [t.detach() for t in model.decode(mu, 1.0, gumbel=gumbel)]

    before = decode()
    (kept,) = _chains()
    cell = model.decoder.cell.lstm_0
    with torch.no_grad():
        cell.hi.kernel.mul_(3.0)
    written = decode()
    assert _chains() == [kept]
    assert all(torch.equal(a, b) for a, b in zip(written, inline()))
    assert not torch.equal(written[0], before[0])
    cell.hf.kernel = torch.nn.Parameter(cell.hf.kernel * 2.0,
                                        requires_grad=False)
    rebound = decode()
    (new,) = _chains()
    assert new is not kept
    assert all(torch.equal(a, b) for a, b in zip(rebound, inline()))
    assert not torch.equal(rebound[0], written[0])


_W = torch.from_numpy(np.random.default_rng(3).normal(
    size=(4, 3)).astype(np.float32))


def _tanh_model(x, c):
    return torch.tanh(x * _W + c)


def _noise_to_midi(vae, seed):
    """A DPM++-2 sample of 2 x 4 x 3 latents, then the hierarchical codec's
    decode of its rows as latents (the sampler chain, then the conductor
    and decoder chains)."""
    betas = schedules.noise_schedule(1e-4, 0.05, 12, "linear")
    with torch.no_grad():
        state, _, _ = generate.sample(
            _tanh_model, betas, torch.Generator().manual_seed(seed), (4, 3),
            num_samples=2, sampling="dpmpp", ddim_steps=2, collect_steps=0,
            collect_metrics=False, device="cpu")
    z = np.resize(state.numpy(), (2, vae.config.latent_dims))
    vae._generator.manual_seed(seed)
    return vae.decode_to_tensors(z, temperature=1.0)


def test_the_bounds_keep_every_chain_of_a_noise_to_midi_call():
    """A noise -> MIDI call keeps its sampler chain and its codec's two
    chains; a second call replays all three (the same kept chains), also
    after MAX_CHAINS other sampler chains ran between: the codec's chains
    have a bound of their own."""
    jcfg, _, params, _ = _setup("hier4-conductor1")
    config = mv.MusicVAEConfig(**dataclasses.asdict(jcfg))
    vae = mv.TrainedMusicVAE(params=params, config=config, device="cpu")
    first = _noise_to_midi(vae, 0)
    samplers, codec = list(graphs._CHAINS.values()), _chains()
    assert len(samplers) == 1 and _labels() == ["conductor", "free decoder"]
    assert graphs.MAX_CODEC_CHAINS >= 2
    second = _noise_to_midi(vae, 0)
    assert list(graphs._CHAINS.values()) == samplers and _chains() == codec
    np.testing.assert_array_equal(first, second)
    betas = schedules.noise_schedule(1e-4, 0.05, 12, "linear")
    for s in range(graphs.MAX_CHAINS):
        w = float(s + 2)
        with torch.no_grad():
            generate.sample(lambda x, c, w=w: torch.tanh(x * w + c), betas,
                            None, (4, 3), num_samples=2, sampling="dpmpp",
                            ddim_steps=2, collect_steps=0,
                            collect_metrics=False, device="cpu")
    assert _chains() == codec
    third = _noise_to_midi(vae, 0)
    assert _chains() == codec
    np.testing.assert_array_equal(first, third)


def test_decoder_shapes_are_checked():
    """Draws of another shape than (B, L, depth) raise, naming the input,
    before any step."""
    jcfg, _, _, model = _setup("flat")
    mu = torch.zeros(2, jcfg.latent_dims)
    with torch.no_grad(), pytest.raises(ValueError, match="gumbel of shape"):
        model.decode(mu, 1.0, gumbel=torch.zeros(2, 31, jcfg.depth))
    assert _chains() == []
