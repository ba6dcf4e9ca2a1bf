"""The scanned chunk of training steps: the port's against ``smd_tpu``'s,
on the CPU.

``make_train_chunk`` of the diffusion trainer (a ToyDDPM and a 1-layer
fused TransformerDDPM, JAX's kernels on their references, with and without
``remat``) and of the MDN (with and without ``remat``) against JAX's
``make_train_chunk`` with K = 3, from the same params and batches, JAX's
per-key draws replayed; each trainer's chunk against as many eager
steps from the same state and generator state, bit for bit (on the CPU the
chunk runs its steps eagerly, reading its slots from the staged buffers
the card's CUDA graph reads), and each ``remat`` chunk against its eager
``remat`` steps and against the chunk without ``remat``; a checkpointed
layer leaving the generators where they were; the state's storage kept
across steps, chunks and a resume (what a captured step needs); the staged
tables equal to the host's floats; the loop's chunk boundaries; the mesh
rule (the chunk is made under any grid; ``--distill`` across ranks
raises) and the debug rule. Small sizes.
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
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
from smd_tpu.training import mdn as jmdn
from smd_tpu.training import optimizer as joptimizer
from smd_tpu_torch.codec import musicvae as mv
from smd_tpu_torch.diffusion import losses, schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.scripts import train_musicvae
from smd_tpu_torch.training import consistency, distill, graphs, loop
from smd_tpu_torch.training import diffusion as trainer
from smd_tpu_torch.training import mdn
from smd_tpu_torch.training import musicvae as mvtrain
from smd_tpu_torch.training import optimizer
from smd_tpu_torch.utils.flax_params import flatten, load_flax_params
from test_torch_mdn import _jax_setup as _mdn_jax_setup
from test_torch_mdn import _port as _mdn_port
from test_torch_ncsn_models import xla_frequencies  # noqa: F401 (fixture)
from test_torch_parallel import KEY_BIAS_RTOL, port_name, remat_layer_names
from test_torch_training import _close, _jax_opt_state_tree, _replayed_draws

ROOT = Path(__file__).resolve().parent.parent
K, T = 3, 1000
LR = 1e-3
FUSED_KW = dict(num_layers=1, num_heads=2, num_mlp_layers=2, mlp_dims=64,
                embed_channels=32)
# (JAX and port kwargs, batch shape, cond shape, port kwargs only)
NETWORKS = {
    "toy": ("ToyDDPM", dict(num_layers=2, mlp_dims=32), (4, 2), (1, 1), {}),
    "fused": ("TransformerDDPM", FUSED_KW, (4, 8, 6), (1, 1, 1),
              dict(fused_attention=True, fused_head=True)),
    # Each layer checkpointed: JAX's nn.remat under its scan, the port's
    # torch.utils.checkpoint under the chunk.
    "fused_remat": ("TransformerDDPM", FUSED_KW, (4, 8, 6), (1, 1, 1),
                    dict(fused_attention=True, fused_head=True, remat=True)),
}


def _perturbed(tree, seed):
    """Every leaf moved by a seeded 0.05-scale normal: non-zero biases and
    LN affines, so every term has a gradient."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), tree)


def _batches(shape, seed=0, k=K):
    return np.random.default_rng(seed).uniform(
        -1, 1, (k, *shape)).astype(np.float32)


def _jax_diffusion(name):
    """(JAX model, its params, JAX state, port model with the params)."""
    arch, kw, shape, cond, extra = NETWORKS[name]
    jmodel = jax_get_model(arch, **kw, **extra)
    jconfig = jtrainer.TrainConfig(learning_rate=LR, ema=True, mu=0.9,
                                   lr_schedule_interval=1, lr_gamma=0.9)
    plain = jax_get_model(arch, **kw)
    params = _perturbed(plain.init(jax.random.PRNGKey(1),
                                   jnp.zeros((1, *shape[1:])),
                                   jnp.zeros(cond)), 7)
    if extra:
        params = fuse_head_params(fuse_attention_params(params))
    model = load_flax_params(get_model(arch, device="cpu",
                                       data_channels=shape[-1], **kw,
                                       **extra), params)
    if extra.get("remat"):
        params = remat_layer_names(params)
    jstate = jtrainer.create_train_state(jax.random.PRNGKey(0), plain,
                                         (1, *shape[1:]), cond, jconfig)
    jstate = jstate.replace(
        params=params, ema_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=jstate.tx.init(params))
    return jmodel, jstate, model


@pytest.fixture
def jax_fused_references(monkeypatch):
    """The JAX fused layers on their kernel route on the CPU, each kernel
    replaced by its ``_reference``, the function the port's plain versions
    transcribe (the ``jax_fused_kernels`` fixture of
    tests/test_torch_training.py, with the references for the interpreted
    kernels: three steps of Adam carry the interpreted kernels' other
    summation order into the params beyond the one-step tolerance). Returns
    the call counts (film, attention)."""
    calls = [0, 0]

    def film(*args, **kwargs):
        calls[0] += 1
        return jffr._reference(*args, **kwargs)

    def attention(*args):
        calls[1] += 1
        return jfat._reference(*args)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jops, "fused_film_resblock", types.SimpleNamespace(
        fused_ln_film_swish_dense=film, supported=lambda *a: True,
        _reference=jffr._reference))
    monkeypatch.setattr(jops, "fused_attention", types.SimpleNamespace(
        fused_ln_attention=attention, supported=lambda *a: True,
        _reference=jfat._reference))
    return calls


def _assert_chunk_state_matches(state, jstate):
    """The state after K steps against JAX's. Adam's moments within 1e-4
    of each tensor's largest element, as the one-step test holds them
    (tests/test_torch_training.py::_assert_state_matches). The params and
    the EMA within 1e-5 of each leaf's norm, as the sharded step is held
    (tests/test_torch_parallel.py), a fused qkv bias's key block within
    KEY_BIAS_RTOL of the bias's norm, and every element within 2·K·lr: the
    one-step test's elementwise 1e-2·lr does not carry over K steps, since
    Adam's first step moves an element whose true gradient is 0 (the
    attention key bias) or below float noise by ±lr on the sign of that
    noise, and the later steps' gradients then see params up to 2·lr
    apart (read: 0.12·lr at elements of the ToyDDPM's FiLM layers after 3
    steps, 4.1e-6 of the worst leaf's norm)."""
    adam = jstate.opt_state[1][0]
    for key in ("mu", "nu"):
        for name, ref in flatten(getattr(adam, key)).items():
            _close(state.opt_state[key][port_name(name)], ref, 1e-4)
    for ours, refs in ((state.params, jstate.params),
                       (state.ema_params, jstate.ema_params)):
        for name, ref in flatten(refs).items():
            name, ref = port_name(name), np.asarray(ref)
            got = ours[name].detach().numpy()
            assert np.abs(got - ref).max() <= 2 * K * LR, name
            blocks = [(got, ref, 1e-5, np.linalg.norm(ref))]
            if name.endswith("bqkv"):
                E = ref.shape[0] // 3
                blocks = [(got[i * E:(i + 1) * E], ref[i * E:(i + 1) * E],
                           KEY_BIAS_RTOL if i == 1 else 1e-5,
                           np.linalg.norm(ref if i == 1 else
                                          ref[i * E:(i + 1) * E]))
                          for i in range(3)]
            for g, w, limit, scale in blocks:
                assert np.linalg.norm(g - w) <= limit * scale, \
                    (name, np.linalg.norm(g - w) / scale)


def _port_state(model):
    config = trainer.TrainConfig(learning_rate=LR, ema=True, mu=0.9,
                                 lr_schedule_interval=1, lr_gamma=0.9)
    return trainer.create_train_state(model, config, init=False)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_diffusion_chunk_matches_jax(name, xla_frequencies,  # noqa: F811
                                     jax_fused_references):
    """K steps of the port's chunk against JAX's ``make_train_chunk`` (one
    ``lax.scan``; the fused layout on the kernels' references), the same
    params and (K, B, ...) batches, JAX's draws
    under each of its K keys replayed: the (K,) loss, grad and lr rows,
    then params, EMA and Adam state (``_assert_chunk_state_matches``)."""
    jmodel, jstate, model = _jax_diffusion(name)
    shape = NETWORKS[name][2]
    jbetas = jschedules.noise_schedule(1e-6, 0.01, T, "linear")
    jchunk = jtrainer.make_train_chunk(
        jmodel, jlosses.diffusion_loss, jbetas, True,
        joptimizer.stepped_exponential_schedule(LR, 1, 0.9))
    batches, rng = _batches(shape), jax.random.PRNGKey(5)
    jstate, jm = jchunk(jstate, jnp.asarray(batches), rng)
    draws = [_replayed_draws(key, shape, True)
             for key in jax.random.split(rng, K)]
    state = _port_state(model)
    chunk = trainer.make_train_chunk(
        losses.diffusion_loss,
        schedules.noise_schedule(1e-6, 0.01, T, "linear"), True)
    state, tm = chunk(state, torch.from_numpy(batches),
                      draws=tuple(torch.stack(d) for d in zip(*draws)))
    if name.startswith("fused"):
        # Each step's model call through JAX's kernels: 2 film halves a
        # FiLM layer's, one attention a layer (K steps, traced once).
        assert jax_fused_references == [2 * FUSED_KW["num_mlp_layers"],
                                        FUSED_KW["num_layers"]]
    for key, rtol in (("loss", 1e-5), ("grad", 1e-5), ("lr", 1e-6)):
        assert tm[key].shape == (K,)
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                   rtol=rtol)
    assert state.step == int(jstate.step) == K
    assert state.opt_state["count"] == int(jstate.opt_state[1][0].count)
    _assert_chunk_state_matches(state, jstate)


def test_mdn_chunk_matches_jax():
    """The MDN's chunk against JAX's ``smd_tpu/training/mdn.py``
    ``make_train_chunk``: the (K,) rows within 1e-5, Adam's moments and
    the params as the MDN's one-step test holds them."""
    _check_mdn_chunk_against_jax(remat=False)


def test_mdn_remat_chunk_matches_jax():
    """As ``test_mdn_chunk_matches_jax``, each trunk layer checkpointed in
    both packages (JAX's ``nn.remat`` under its scan, the port's
    ``torch.utils.checkpoint`` under its chunk)."""
    _check_mdn_chunk_against_jax(remat=True)


def _check_mdn_chunk_against_jax(remat):
    jmodel, params = _mdn_jax_setup(remat=remat)
    jconfig = jtrainer.TrainConfig(learning_rate=LR, lr_schedule_interval=1,
                                   lr_gamma=0.9)
    jstate = jmdn.create_train_state(jax.random.PRNGKey(0), jmodel,
                                     (1, 8, 6), jconfig)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jchunk = jmdn.make_train_chunk(
        jmodel, joptimizer.stepped_exponential_schedule(LR, 1, 0.9))
    batches = np.random.default_rng(2).normal(
        size=(K, 3, 8, 6)).astype(np.float32)
    jstate, jm = jchunk(jstate, jnp.asarray(batches))
    config = mdn.TrainConfig(learning_rate=LR, lr_schedule_interval=1,
                             lr_gamma=0.9)
    state = mdn.create_train_state(
        _mdn_port(remat_layer_names(params, False), remat=remat), config,
        init=False)
    state, tm = mdn.make_train_chunk()(state, torch.from_numpy(batches))
    for key in ("loss", "grad", "lr"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                   rtol=1e-5)
    assert state.step == int(jstate.step) == K
    ref_opt = {key: {port_name(n): v for n, v in tree.items()}
               for key, tree in _jax_opt_state_tree(jstate).items()
               if key in ("mu", "nu")}
    for key in ("mu", "nu"):
        for name, ref in ref_opt[key].items():
            _close(state.opt_state[key][name], ref.numpy(), 1e-4)
    for name, ref in flatten(jstate.params).items():
        name, ref = port_name(name), np.asarray(ref)
        diff = np.abs(state.params[name].detach().numpy() - ref)
        v_hat = ref_opt["nu"][name].numpy() / (1 - 0.999 ** K)
        small = np.sqrt(v_hat) < 1e-5
        assert ((diff <= 1e-2 * LR) | small).all(), (name, diff.max())
        assert diff.max() <= 2 * LR, (name, diff.max())


# -- the chunk against the port's own eager steps -----------------------------

TINY = dict(num_layers=1, num_heads=2, num_mlp_layers=1, mlp_dims=16,
            embed_channels=16)


def _tiny_ddpm(seed=0, **extra):
    model = get_model("TransformerDDPM", device="cpu", data_channels=3,
                      **TINY, **extra)
    trainer.create_train_state(model, trainer.TrainConfig(), seed=seed)
    return model


def _betas():
    return schedules.noise_schedule(1e-4, 0.02, 50, "linear")


class _Diffusion:
    """A TrainState-based trainer: ``step`` its eager step, ``chunk`` the
    same steps as one chunk."""

    def __init__(self, kind):
        betas = _betas()
        kind, remat = kind.removesuffix("_remat"), kind.endswith("_remat")
        if kind == "mdn":
            model = get_model("TransformerMDN", device="cpu",
                              data_channels=3, mdn_mixtures=2, remat=remat,
                              **TINY)
            self.state = mdn.create_train_state(model, mdn.TrainConfig())
            self.step, self.chunk = mdn.make_train_step(), \
                mdn.make_train_chunk()
            return
        model = _tiny_ddpm(fused_attention=kind in ("fused", "bf16"),
                           fused_head=kind in ("fused", "bf16"),
                           dtype=torch.bfloat16 if kind == "mixed" else
                           torch.float32, remat=remat)
        if kind == "bf16":
            model = model.to(torch.bfloat16)
        config = trainer.TrainConfig(ema=True, mu=0.9, adam_m_bf16=True,
                                     lr_warmup=2)
        self.state = trainer.create_train_state(model, config, init=False)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        grid, mids = distill.halve_grid(distill.distill_grid(betas, 4))
        if kind in ("ddpm", "mixed", "fused", "bf16", "ssm"):
            objective = trainer.objective_by_name(
                "ssm" if kind == "ssm" else "ddpm")
            sig = np.linspace(1.0, 0.05, 10).astype(np.float32) \
                if kind == "ssm" else betas
            self.step = trainer.make_train_step(objective, sig, True)
            self.chunk = trainer.make_train_chunk(objective, sig, True)
        elif kind == "distill":
            self.step, self.chunk = (distill.make_distill_step(
                model, params, grid, mids, chunk=c) for c in (False, True))
        elif kind == "cd":
            self.step, self.chunk = (consistency.make_cd_step(
                model, params, grid, mids, chunk=c) for c in (False, True))
        else:
            self.step, self.chunk = (consistency.make_ct_step(
                model, distill.distill_grid(betas, 4), chunk=c)
                for c in (False, True))

    def tensors(self):
        return self.state.tensors()

    def eager(self, batches):
        return [self.step(self.state, torch.from_numpy(b))[1]["loss"]
                for b in batches]

    def chunked(self, batches):
        return list(self.chunk(self.state, batches)[1]["loss"])

    def counts(self):
        return self.state.step, self.state.opt_state["count"]

    def generator(self):
        return self.state.generator


class _Codec:
    """The codec's eager step and chunk, scheduled sampling on."""

    def __init__(self):
        cfg = mv.MusicVAEConfig(latent_dims=4, enc_units=8, dec_units=(8,),
                                max_seq_len=6, depth=5, free_bits=1.0)
        self.model = mv.build_musicvae(cfg, seed=0, device="cpu").train()
        self.model.requires_grad_(True)
        self.opt = mvtrain.make_optimizer(1e-3, 2, 20)
        self.opt_state = self.opt.init(dict(self.model.named_parameters()))
        self.gen = torch.Generator().manual_seed(0)
        self.chunk = mvtrain.make_train_chunk(
            self.model, self.opt, self.opt_state, self.gen,
            scheduled_sampling=True)

    def tensors(self):
        return self.opt.tensors(dict(self.model.named_parameters()),
                                self.opt_state)

    def eager(self, batches):
        return [mvtrain.train_step(self.model, self.opt, self.opt_state,
                                   torch.from_numpy(b), 0.5, self.gen)[0]
                for b in batches]

    def chunked(self, batches):
        return list(self.chunk(batches, [0.5] * len(batches))["loss"])

    def counts(self):
        return self.opt_state["count"]

    def generator(self):
        return self.gen


# Every trainer whose model takes ``remat`` (``mixed``: bf16 compute on
# float32 params, --mixed_precision), its layers checkpointed.
REMAT_TRAINERS = tuple(f"{kind}_remat" for kind in (
    "ddpm", "mixed", "fused", "bf16", "ssm", "mdn", "distill", "cd", "ct"))
TRAINERS = ("ddpm", "mixed", "fused", "bf16", "ssm", "mdn", "distill", "cd",
            "ct", "codec") + REMAT_TRAINERS


def _trainer(kind):
    return _Codec() if kind == "codec" else _Diffusion(kind)


def _trainer_batches(kind, k=4):
    rng = np.random.default_rng(3)
    if kind == "codec":
        return rng.integers(0, 5, (k, 4, 6)).astype(np.int64)
    return rng.uniform(-1, 1, (k, 4, 5, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", TRAINERS)
def test_chunk_equals_eager_steps(kind):
    """K steps as one chunk against K eager steps from the same state and
    generator state: the same params, Adam moments, EMA, losses, counts and
    generator state, bit for bit (the same arithmetic, the LR and bias
    corrections from the staged tables, which hold the host's floats)."""
    batches = _trainer_batches(kind)
    ours, ref = _trainer(kind), _trainer(kind)
    for a, b in zip(ours.tensors(), ref.tensors()):
        assert torch.equal(a, b)
    got = ours.chunked(batches)
    want = ref.eager(batches)
    assert torch.equal(torch.stack(got), torch.stack(want))
    for a, b in zip(ours.tensors(), ref.tensors()):
        assert torch.equal(a, b)
    assert ours.counts() == ref.counts()
    assert torch.equal(ours.generator().get_state(),
                       ref.generator().get_state())


@pytest.mark.parametrize("kind", REMAT_TRAINERS)
def test_remat_chunk_equals_the_plain_chunk(kind):
    """A chunk of a model that checkpoints its layers against the same
    chunk of the same model without ``remat``, from the same state: bit for
    bit (the backward's recompute runs the same operations on the same
    inputs and draws nothing)."""
    batches = _trainer_batches(kind)
    ours, ref = _trainer(kind), _trainer(kind.removesuffix("_remat"))
    assert torch.equal(torch.stack(ours.chunked(batches)),
                       torch.stack(ref.chunked(batches)))
    for a, b in zip(ours.tensors(), ref.tensors()):
        assert torch.equal(a, b)
    assert torch.equal(ours.generator().get_state(),
                       ref.generator().get_state())


@pytest.mark.parametrize("arch", ["TransformerDDPM", "TransformerMDN"])
def test_remat_layers_draw_nothing_and_stash_no_generator(arch,
                                                          monkeypatch):
    """``remat`` checkpoints each layer while autograd records, without
    the generator stash that a CUDA graph cannot capture
    (``preserve_rng_state=False``), and never under ``no_grad`` (serving,
    a teacher's calls). The stash buys nothing: a checkpointed layer's
    forward and backward leave the default generator where they were, and
    the gradients equal the un-checkpointed model's."""
    from smd_tpu_torch.models import ddpm
    calls = []
    real = ddpm.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(kwargs)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(ddpm, "checkpoint", spy)
    kw = dict(TINY, num_layers=2)
    extra = dict(mdn_mixtures=2) if arch == "TransformerMDN" else \
        dict(fused_attention=True, fused_head=True)
    models = [get_model(arch, device="cpu", data_channels=3, remat=remat,
                        **kw, **extra) for remat in (True, False)]
    models[1].load_state_dict(models[0].state_dict())
    x = torch.from_numpy(_batches((2, 5, 3), k=1)[0])
    args = (x,) if arch == "TransformerMDN" else (x, torch.full((2,), 0.3))
    with torch.no_grad():
        models[0](*args)
    assert calls == []
    grads = []
    for model in models:
        before = torch.get_rng_state()
        out = model(*args)
        out = out if torch.is_tensor(out) else torch.cat(out, -1)
        grads.append(torch.autograd.grad(out.square().sum(),
                                         list(model.parameters())))
        assert torch.equal(torch.get_rng_state(), before)
    assert calls == [dict(use_reentrant=False,
                          preserve_rng_state=False)] * kw["num_layers"]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _cd_target(chunk):
    """The target network a CD chunk loads the EMA into."""
    fn = chunk.loss_fn
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))["target"]


@pytest.mark.parametrize("kind", ("ddpm", "cd", "codec"))
def test_state_keeps_its_storage(kind):
    """Every tensor a step writes (params, Adam moments, EMA, the
    consistency target's params) keeps its storage across an eager step, a
    chunk and a resume: a CUDA graph replays into the addresses it
    captured."""
    ours = _trainer(kind)
    batches = _trainer_batches(kind)
    extra = list(_cd_target(ours.chunk).parameters()) if kind == "cd" \
        else []
    pointers = [t.data_ptr() for t in ours.tensors() + extra]
    ours.eager(batches[:1])
    ours.chunked(batches)
    if kind != "codec":
        ours.state.load_state_dict(ours.state.state_dict())
    assert [t.data_ptr() for t in ours.tensors() + extra] == pointers


def test_staged_tables_equal_the_host_floats():
    """The per-step rows a chunk stages (the LR, Adam's bias corrections,
    the codec's scheduled-sampling probability) equal the host schedule's
    floats bit for bit, read back from inside the steps."""
    for opt in (optimizer.make_optimizer(1e-3, 1.0, 0.9, 3, 4),
                mvtrain.make_optimizer(1e-3, 5, 40)):
        count, k = 2, 9
        tables = opt.tables(count, k)
        train_musicvae.FLAGS(["train_musicvae", "--input=x",
                              "--scheduled_sampling=0.3", "--steps=11"])
        tables["ss_prob"] = np.asarray(train_musicvae.ss_probs(count, k),
                                       np.float32)
        seen = graphs.StepChunk(
            lambda slot: {n: slot[n] for n in tables},
            lambda: [torch.zeros(1)], None, "table probe")(
                {"batch": np.zeros((k, 1), np.float32)}, tables)
        for j in range(k):
            host = opt.hyperparams(count + j)
            # Each value as an operation rounds the eager step's float.
            assert [float(seen[n][j]) for n in ("lr", "inv_bc1",
                                                "inv_bc2")] == \
                [float(np.float32(v)) for v in host]
            assert float(seen["ss_prob"][j]) == \
                train_musicvae.ss_probs(count + j, 1)[0]


def test_hyperparams_are_the_host_schedule():
    """``hyperparams``: the LR at the count before the increment, and the
    reciprocals of optax's float32 bias corrections at count + 1."""
    opt = optimizer.make_optimizer(1e-2, 1.0, 0.5, 2, 3)
    f32 = np.float32
    for count in range(6):
        lr, inv_bc1, inv_bc2 = opt.hyperparams(count)
        assert lr == opt.schedule(count)
        assert inv_bc1 == 1 / float(f32(1) - np.power(
            f32(0.9), f32(count + 1), dtype=f32))
        assert inv_bc2 == 1 / float(f32(1) - np.power(
            f32(0.999), f32(count + 1), dtype=f32))


# -- the loop -----------------------------------------------------------------

def _fit(model_dir, scan_chunk, max_steps=10, snapshot_freq=6,
         epoch_batches=50, mesh=None):
    config = trainer.TrainConfig(batch_size=4, epochs=2, max_steps=max_steps,
                                 snapshot_freq=snapshot_freq,
                                 logging_freq=100, verbose=False, ema=True,
                                 mu=0.9, scan_chunk=scan_chunk)
    data = np.random.default_rng(0).uniform(
        -1, 1, (epoch_batches, 4, 5, 3)).astype(np.float32)
    return trainer.fit(_tiny_ddpm(), _betas(), lambda: iter(list(data)),
                       lambda: iter(list(data[:1])), (5, 3), config,
                       model_dir, mesh=mesh)


def test_chunked_fit_equals_per_step_fit(tmp_path):
    """On the CPU a chunk's steps are the eager steps: a chunked run (chunks
    cut at the snapshot and at max_steps) ends bit-equal to a per-step
    run, checkpoints and generator included."""
    straight = _fit(str(tmp_path / "a"), 1)
    chunked = _fit(str(tmp_path / "b"), 4)
    assert chunked.step == straight.step == 10
    for a, b in zip(chunked.tensors(), straight.tensors()):
        assert torch.equal(a, b)
    assert torch.equal(chunked.generator.get_state(),
                       straight.generator.get_state())


def test_chunked_resume_equals_a_straight_chunked_run(tmp_path):
    """A chunked run (chunks of 3 cut at the snapshot every 4 steps; an
    epoch of 4 batches) resumed from its checkpoint at 4 ends where a
    straight chunked run to 8 ends; the resume writes into the state's own
    tensors."""
    kw = dict(snapshot_freq=4, epoch_batches=4)
    _fit(str(tmp_path / "r"), 3, max_steps=4, **kw)
    resumed = _fit(str(tmp_path / "r"), 3, max_steps=8, **kw)
    straight = _fit(str(tmp_path / "s"), 3, max_steps=8, **kw)
    assert resumed.step == straight.step == 8
    for a, b in zip(resumed.tensors(), straight.tensors()):
        assert torch.equal(a, b)


def test_scan_chunk_under_a_mesh_raises(monkeypatch):
    """Under any mesh (a data axis, a model axis, both) the chunk is made:
    each collective of its step cuts the captured step
    (``utils/graphs.collective``), the recompute's of a ``remat`` model
    too, and the loop's refusal is gone (tests/test_torch_parallel.py runs
    the chunks on 2 ranks, with ``remat`` on the model axis). What still
    raises: ``--distill`` across ranks, whose steps take no mesh, as in
    JAX."""
    from smd_tpu_torch import train_ncsn
    from smd_tpu_torch.parallel import mesh as mesh_lib
    for data, model in ((2, 1), (1, 2), (2, 2)):
        mesh = mesh_lib.Mesh(data=data, model=model)
        assert isinstance(trainer.make_train_chunk(
            losses.diffusion_loss, _betas(), True, mesh=mesh),
            graphs.TrainChunk)
        assert isinstance(mdn.make_train_chunk(mesh=mesh), graphs.TrainChunk)
    assert not hasattr(loop, "MESH_CHUNK")
    assert not hasattr(loop, "check_chunk_mesh")
    monkeypatch.setattr(train_ncsn.cli, "initialize_from_flags",
                        lambda: (0, 2))
    monkeypatch.chdir(ROOT)
    with pytest.raises(ValueError, match="--distill runs on one rank, not 2"):
        train_ncsn.main(["train_ncsn",
                         "--flagfile=configs/ddpm-mel-32seq-512.cfg",
                         "--distill", "--device=cpu", "--model_dir=unused"])


def test_debug_nans_checks_each_chunks_losses(tmp_path):
    """With ``debug_nans`` the chunk path checks the chunk's (K,) losses
    (a graph cannot capture autograd's anomaly mode, which stays off)."""
    config = trainer.TrainConfig(batch_size=4, epochs=1, max_steps=8,
                                 snapshot_freq=100, verbose=False,
                                 debug_nans=True, scan_chunk=4)
    data = np.full((8, 4, 5, 3), np.nan, np.float32)
    with pytest.raises(FloatingPointError, match="steps 1 to 4"):
        trainer.fit(_tiny_ddpm(), _betas(), lambda: iter(list(data)),
                    lambda: iter(list(data[:1])), (5, 3), config)
    assert not torch.is_anomaly_enabled()


def test_uncapturable_modes_are_named():
    """What a CUDA graph cannot capture raises at the card's capture with
    its name, before any warm-up step: autograd's anomaly mode. ``remat``
    is not among them: no chunk takes a list of modes to refuse, and a
    ``remat`` model's chunk runs its steps."""
    import inspect
    state = _port_state(_tiny_ddpm(remat=True))
    assert not hasattr(graphs, "uncapturable")
    assert list(inspect.signature(graphs.StepChunk).parameters) == \
        ["step", "mutable", "generator", "label"]
    chunk = graphs.StepChunk(lambda slot: {}, state.tensors, None,
                             "diffusion train step")
    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(ValueError, match="diffusion train step cannot "
                           "be captured in a CUDA graph under autograd's "
                           "anomaly mode"):
            chunk._capture(None, None)
    chunk = trainer.make_train_chunk(losses.diffusion_loss, _betas(), True)
    _, metrics = chunk(state, _trainer_batches("ddpm", 2))
    assert torch.isfinite(metrics["loss"]).all()
    assert chunk._chunk.label == "diffusion train step"
