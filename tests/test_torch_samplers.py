"""The port's DDPM sampler against ``smd_tpu``'s, with the JAX draws replayed.

The JAX sampler splits its key each step into (carry, infill, noise) and
draws the infill noise, then the step noise (``samplers.py``,
``diffusion_dynamics``). The test replays those splits outside the scan and
hands the same normals to the port, which runs the same small model with the
weights carried over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.diffusion import samplers as jax_samplers
from smd_tpu.diffusion import schedules as jax_schedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.models.fuse import fuse_attention_params, fuse_head_params
from smd_tpu.sampling import generate as jax_generate
from smd_tpu_torch.diffusion import samplers, schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.sampling import generate
from smd_tpu_torch.utils.flax_params import load_flax_params

KW = dict(num_layers=2, num_heads=4, num_mlp_layers=2, mlp_dims=64,
          embed_channels=32)
B, S, C, T = 2, 16, 8, 50


def _replayed_noise(rng, shape, steps):
    infill, step = [], []
    for _ in range(steps):
        rng, infill_rng, noise_rng = jax.random.split(rng, num=3)
        infill.append(np.asarray(jax.random.normal(infill_rng, shape)))
        step.append(np.asarray(jax.random.normal(noise_rng, shape)))
    return torch.from_numpy(np.stack(infill)), torch.from_numpy(np.stack(step))


def _setup():
    rng = np.random.default_rng(0)
    init = rng.normal(size=(B, S, C)).astype(np.float32)
    jmodel = jax_get_model("TransformerDDPM", **KW)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(init),
                         jnp.ones((B, 1, 1)))
    prng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * prng.normal(size=p.shape))
        .astype(np.float32), params)
    # Serve the fused layout on both sides, as the flagship does.
    fused = fuse_head_params(fuse_attention_params(params))
    jfused = jax_get_model("TransformerDDPM", fused_attention=True,
                           fused_head=True, **KW)
    model = get_model("TransformerDDPM", device="cpu", data_channels=C,
                      fused_attention=True, fused_head=True, **KW)
    load_flax_params(model, fused).eval()
    return init, (lambda x, c: jfused.apply(fused, x, c)), model


@pytest.mark.parametrize("infill", [False, True])
def test_diffusion_dynamics_matches_jax(infill):
    init, jax_fn, model = _setup()
    betas = jax_schedules.noise_schedule(1e-4, 0.05, T, "linear")
    masks = samples = None
    if infill:
        samples = np.random.default_rng(3).uniform(
            -1, 1, (B, S, C)).astype(np.float32)
        masks = np.zeros((B, S, C), np.float32)
        masks[:, :4] = 1
        masks[:, -4:] = 1
    key = jax.random.PRNGKey(5)
    ref = jax_samplers.diffusion_dynamics(
        key, jax_fn, betas, jnp.asarray(init),
        infill_samples=None if samples is None else jnp.asarray(samples),
        infill_masks=None if masks is None else jnp.asarray(masks),
        collect_steps=7, collect_metrics=True)

    with torch.no_grad():
        out = samplers.diffusion_dynamics(
            None, model, schedules.noise_schedule(1e-4, 0.05, T, "linear"),
            torch.from_numpy(init),
            infill_samples=None if samples is None else
            torch.from_numpy(samples),
            infill_masks=None if masks is None else torch.from_numpy(masks),
            collect_steps=7, collect_metrics=True,
            noise=_replayed_noise(key, (B, S, C), T))
    assert out.state.shape == (B, S, C)
    assert out.collection.shape == (8, B, S, C)
    assert out.metrics.shape == (4, T, 1)
    # float32 over 50 model calls; eps enters x0 scaled by up to
    # sqrt(1/abar - 1) ~ 1.2 and the posterior mean contracts it again.
    np.testing.assert_allclose(out.state.numpy(), np.asarray(ref.state),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.collection.numpy(),
                               np.asarray(ref.collection), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(out.metrics.numpy(), np.asarray(ref.metrics),
                               atol=1e-4, rtol=1e-4)
    if infill:
        # The held content comes back exactly at the last step.
        np.testing.assert_array_equal(out.state.numpy()[masks == 1],
                                      samples[masks == 1])


def test_collection_slots_match_jax_indices():
    for total, collect in [(1000, 40), (50, 7), (10, 1), (5, 5), (3, 2)]:
        ours = samplers._collection_indices(total, collect)
        ref = np.asarray(jax_samplers._collection_indices(total, collect))
        np.testing.assert_array_equal(ours, ref)


def test_generate_sample_ddpm_on_cpu():
    _, _, model = _setup()
    betas = schedules.noise_schedule(1e-4, 0.05, 20, "linear")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        state, coll, metrics = generate.sample(
            model, betas, gen, (S, C), num_samples=3, sampling="ddpm",
            collect_steps=4, device="cpu")
        gen2 = torch.Generator().manual_seed(0)
        init = generate.make_init(gen2, 3, (S, C), "ddpm", device="cpu")
        direct = samplers.diffusion_dynamics(gen2, model, betas, init,
                                             collect_steps=4)
    assert state.shape == (3, S, C) and torch.isfinite(state).all()
    assert coll.shape == (5, 3, S, C) and metrics.shape == (4, 20, 1)
    # One generator draws the initial state, then the sampler's noise.
    assert torch.equal(state, direct.state)


def test_unported_samplers_raise():
    """Every sampler the JAX package names is ported (the NCSN family's
    ``ald``, the default, and ``cas`` run in tests/test_torch_langevin.py);
    an unknown one raises."""
    assert set(generate.SAMPLERS) == set(jax_generate.SAMPLERS)
    with pytest.raises(ValueError):
        generate.sample(None, None, None, (S, C), sampling="nope",
                        device="cpu")
