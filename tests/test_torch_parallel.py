"""The port across processes against ``smd_tpu``'s mesh, on the CPU.

The mesh shapes and errors and the parameter split rules against
``smd_tpu.parallel.mesh``; then one process group of 2 gloo ranks
(``tests/test_torch_parallel_ranks.py``, spawned once for the module) takes a
data-parallel and a model-parallel train step of a narrow flagship (2
layers, embed 32, MLP 64) from params drawn for JAX, with JAX's draws
replayed, held to JAX's ``make_train_step`` on conftest's 8-device CPU
mesh (data 2; data 1 x model 2): the gradients within 1e-5 of each leaf's
norm, the params after the step within 1e-5 (the key biases, on float
noise, within 1e-3: see ``KEY_BIAS_RTOL``); runs the
loop on both grids (checkpoints, resume, the result loaded on one rank and
held to one rank's run); takes the diffusion and MDN trainers' chunks on
the data axis and on the model axis (a chunk of 4 and one of 2) bit-equal
to the same ranks' single steps and within 1e-5 of JAX's chunks over its
mesh of 2 of those devices on the same grid (``shard_chunk``); counts the
collectives of a step, every one through ``graphs.collective`` (the cut
of a captured step), with and without ``remat`` (the models' layers
checkpointed, their all-gathers recomputed in the backward; its chunks on
the model axis held to the single steps and to JAX's ``remat`` chunks);
and trains through ``train_ncsn`` (model axis 2 and data axis 2, each
chunked and by single steps) and ``train_mdn`` (data axis 2). ``dryrun_multichip(4)`` spawns 4 ranks of its own, its 2 x 2
chunk against its single steps. Also the op profile of
``utils/profiling``.
"""
import json
import os
import pickle
import re
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks
from smd_tpu.diffusion import losses as jlosses
from smd_tpu.diffusion import schedules as jschedules
from smd_tpu.models import get_model as jax_get_model
from smd_tpu.models.fuse import fuse_attention_params, fuse_head_params
from smd_tpu.parallel import mesh as jmesh
from smd_tpu.training import diffusion as jtrainer
from smd_tpu.training import mdn as jmdn
from smd_tpu.training import optimizer as joptimizer
from smd_tpu.utils import profiling as jprofiling
from smd_tpu_torch import dryrun
from smd_tpu_torch.data import records
from smd_tpu_torch.diffusion import losses, schedules
from smd_tpu_torch.models import blocks, get_model
from smd_tpu_torch.parallel import mesh as mesh_lib
from smd_tpu_torch.training import diffusion as trainer
from smd_tpu_torch.training import loop as loop_lib
from smd_tpu_torch.utils import profiling
from smd_tpu_torch.utils.checkpoints import CheckpointManager
from smd_tpu_torch.utils.flax_params import flatten, load_flax_params
from test_torch_mdn import KW as MDN_KW
from test_torch_mdn import _jax_setup as _mdn_jax_setup

ROOT = Path(__file__).resolve().parent.parent
KW = dict(num_layers=2, num_heads=2, num_mlp_layers=2, mlp_dims=64,
          embed_channels=32)
B, S, C, T = 4, 8, 6, 50
BETAS = (1e-6, 0.01, T, "linear")
TRAIN = dict(learning_rate=1e-3, ema=True, mu=0.9, lr_schedule_interval=1,
             lr_gamma=0.9)
LOOP = dict(learning_rate=1e-3, mu=0.9, epochs=10, snapshot_freq=2,
            logging_freq=1, checkpoints_to_keep=5, verbose=False)


# -- the mesh and the split rules ----------------------------------------------

@pytest.mark.parametrize("data,model,n", [
    (-1, 1, 8), (4, 2, 8), (3, 2, 8), (2, 2, 4), (-1, 4, 8), (-1, 3, 8),
    (1, 2, 2), (2, 1, 2), (-1, 1, 1), (8, 1, 4)])
def test_mesh_shapes_and_errors_equal_jax(data, model, n):
    config = dict(data=data, model=model)
    try:
        ref = jmesh.make_mesh(jmesh.MeshConfig(**config),
                              devices=jax.devices()[:n]).shape
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            mesh_lib.mesh_shape(mesh_lib.MeshConfig(**config), n)
        return
    assert dict(zip(("data", "model"), mesh_lib.mesh_shape(
        mesh_lib.MeshConfig(**config), n))) == dict(ref)


def test_one_rank_has_no_groups(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert mesh_lib.initialize_distributed("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    mesh = mesh_lib.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.data_group, mesh.model_group) == (None, None)
    with pytest.raises(ValueError, match="mesh 0x2 does not cover 1"):
        mesh_lib.make_mesh(mesh_lib.MeshConfig(model=2))


def test_two_ranks_on_one_card_raise(monkeypatch):
    """NCCL refuses two ranks on one card: raised before any group."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL takes one card a rank"):
        mesh_lib.initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_shard_batch_takes_the_data_rows():
    batch = torch.arange(8.0).reshape(8, 1)
    for rank, rows in ((0, [0, 1, 2, 3]), (1, [0, 1, 2, 3]),
                       (2, [4, 5, 6, 7]), (3, [4, 5, 6, 7])):
        mesh = mesh_lib.Mesh(data=2, model=2, rank=rank)
        assert mesh_lib.shard_batch(batch, mesh)[:, 0].tolist() == rows
    assert mesh_lib.shard_batch(batch, None) is batch


def _jax_init(name, kw, shape, shapes_only=False):
    model = jax_get_model(name, **kw)
    args = (jax.random.PRNGKey(0), jnp.zeros((1, *shape)),
            jnp.zeros((1, *([1] * len(shape)))))
    # The split rules read shapes alone: the init traced, not run.
    return jax.eval_shape(model.init, *args) if shapes_only else \
        model.init(*args)


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("name,layout", [
    ("TransformerDDPM", "standard"), ("TransformerDDPM", "fused"),
    ("DenseDDPM", "standard")])
def test_param_spec_splits_what_jax_splits(name, layout, model_axis):
    """The leaves split and their specs equal JAX's ``param_spec`` on the
    same tree; in the fused layout film and attention stay whole."""
    fused = layout == "fused"
    kw = KW if name == "TransformerDDPM" else dict(num_layers=2,
                                                   mlp_dims=64)
    shape = (S, C) if name == "TransformerDDPM" else (10,)
    tree = _jax_init(name, kw, shape, shapes_only=True)
    if fused:
        tree = fuse_head_params(fuse_attention_params(jax.tree_util.tree_map(
            lambda p: np.zeros(p.shape, p.dtype), tree)))
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=8 // model_axis,
                                            model=model_axis))
    ref = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        spec = tuple(jmesh.param_spec(path, leaf, mesh))
        ref[jmesh._path_str(path).replace("params/", "", 1)
            .replace("/", ".")] = spec
    extra = dict(fused_attention=True, fused_head=True) if fused else {}
    model = get_model(name, device="cpu", data_channels=shape[-1], **kw,
                      **extra)
    ours = {n: mesh_lib.param_spec(n, p.shape, model_axis)
            for n, p in model.named_parameters()}
    assert ours == ref
    split = {n for n, s in ours.items() if s}
    assert split and all(".Dense_" in f".{n}" for n in split)
    if fused:
        assert not any(n.endswith((".w1", ".w2", ".wqkv", ".wout"))
                       for n in split)


# -- two ranks -----------------------------------------------------------------

def _jax_params(seed=1):
    params = _jax_init("TransformerDDPM", KW, (S, C))
    rng = np.random.default_rng(seed + 6)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), params)


def _replayed_draws(rng, batch_shape):
    """The draws of JAX ``diffusion_loss`` under ``rng``: labels, u, eps."""
    _, label_rng, sample_rng, noise_rng = jax.random.split(rng, num=4)
    labels = jax.random.randint(label_rng, (batch_shape[0],), minval=1,
                                maxval=T + 1)
    u = jax.random.uniform(noise_rng, (batch_shape[0],))
    eps = jax.random.normal(sample_rng, batch_shape)
    return tuple(np.array(d) for d in (labels, u, eps))


RNG_SEED = 11
# The chunks on the data axis: 6 steps of a global batch of CHUNK_BATCH
# rows, as a chunk of 4 and a chunk of 2, JAX's chunk j drawing from
# PRNGKey(CHUNK_KEYS[j]).
CHUNK_BATCH = 8
CHUNK_CUTS = ((0, 4), (4, 6))
CHUNK_KEYS = (21, 22)


def _chunk_draws(batch_shape):
    """The draws of JAX's chunks (each splits its key once a step), stacked
    over the 6 steps."""
    draws = [_replayed_draws(key, batch_shape)
             for seed, (lo, hi) in zip(CHUNK_KEYS, CHUNK_CUTS)
             for key in jax.random.split(jax.random.PRNGKey(seed), hi - lo)]
    return tuple(np.stack(d) for d in zip(*draws))


def _case(work):
    rng = np.random.default_rng(2)
    batch = rng.uniform(-1, 1, (B, S, C)).astype(np.float32)
    data = work / "data"
    for split, n in (("train", 12), ("eval", 8)):
        records.write_tfrecord(f"{data}/{split}-0.tfrecord",
                               rng.normal(size=(n, 32, 512)).astype(
                                   np.float32))
    xla_freqs = {half: np.asarray(jnp.exp(jnp.arange(half) * -(
        jnp.log(10000.0) / float(half - 1)))) for half in (8, 16, 64)}
    chunk_shape = (CHUNK_CUTS[-1][1], CHUNK_BATCH, S, C)
    return {"params": _jax_params(), "channels": C, "kw": KW,
            "xla_freqs": xla_freqs,
            "betas": BETAS, "train_config": TRAIN, "loop_config": LOOP,
            "batch": batch,
            "draws": _replayed_draws(jax.random.PRNGKey(RNG_SEED),
                                     batch.shape),
            "loop_train": [rng.uniform(-1, 1, (B, S, C)).astype(np.float32)
                           for _ in range(3)],
            "loop_eval": [rng.uniform(-1, 1, (B, S, C)).astype(np.float32)
                          for _ in range(2)],
            "chunk_batches": rng.uniform(-1, 1, chunk_shape).astype(
                np.float32),
            "chunk_draws": _chunk_draws(chunk_shape[1:]),
            "mdn_kw": MDN_KW, "mdn_params": _mdn_jax_setup()[1],
            "mdn_batches": rng.normal(size=chunk_shape).astype(np.float32),
            "dataset": str(data)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The case, what rank 0 of 2 gloo ranks saw, and their directory."""
    work = tmp_path_factory.mktemp("ranks")
    case = _case(work)
    with open(work / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    cwd = os.getcwd()
    os.chdir(ROOT)   # the flagfiles name each other from the root
    try:
        torch.multiprocessing.spawn(
            test_torch_parallel_ranks.run, args=(2, dryrun.free_port(),
                                             str(work)),
            nprocs=2, join=True)
    finally:
        os.chdir(cwd)
    with open(work / "out.pkl", "rb") as f:
        return case, pickle.load(f), work


def _jax_step(case, data, model):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model),
                           devices=jax.devices()[:data * model])
    jmodel = jax_get_model("TransformerDDPM", **KW)
    state = jtrainer.create_train_state(
        jax.random.PRNGKey(0), jmodel, (1, S, C), (1, 1, 1),
        jtrainer.TrainConfig(**TRAIN))
    shardings = jmesh.shard_params(case["params"], mesh)
    params = jax.device_put(case["params"], shardings)
    state = state.replace(params=params,
                          ema_params=jax.device_put(case["params"],
                                                    shardings),
                          opt_state=state.tx.init(params))
    step = jtrainer.make_train_step(
        jmodel, jlosses.diffusion_loss, jschedules.noise_schedule(*BETAS),
        True, joptimizer.stepped_exponential_schedule(1e-3, 1, 0.9))
    batch = jmesh.shard_batch(jnp.asarray(case["batch"]), mesh)
    rng = jax.random.PRNGKey(RNG_SEED)

    def loss_fn(p):
        return jlosses.diffusion_loss(
            batch, lambda x, c: jmodel.apply(p, x, c),
            jschedules.noise_schedule(*BETAS), rng, True, "mean")

    grads = jax.jit(jax.grad(loss_fn))(params)
    new, metrics = step(state, batch, rng)
    # The params' shardings going in (XLA picks those coming out).
    split = {n for n, s in flatten(jax.tree_util.tree_map(
        lambda x: tuple(x.spec), shardings,
        is_leaf=lambda x: hasattr(x, "spec"))).items() if "model" in s}
    return new, metrics, grads, split


# Adam's first step divides each gradient element by its own size, so
# where the true gradient is 0 (the key bias, to which softmax is blind) it
# turns float noise into a step of the learning rate. After the steps every
# leaf is held to 1e-5 of its norm, a qkv bias's query and value blocks to
# 1e-5 of theirs, and its key block to KEY_BIAS_RTOL of the whole qkv
# bias's norm (the limit that leaf had whole). Read on the CPU: the key
# block 1.9e-4 to 6.1e-4 of the leaf's norm (data 2 and model 2, the step
# against JAX and the loop against one rank); every other block at most
# 6.9e-6 of its own.
KEY_BIAS_RTOL = 1e-3
# Flax's nn.remat names each wrapped transformer layer "Checkpoint" + its
# class's name (TransformerEncoder_0/CheckpointTransformerLayer_0/...); the
# port's modules keep the plain names with remat or without.
_LAYER = re.compile(r"(Fused)?TransformerLayer_\d+")


def remat_layer_names(tree, remat=True):
    """A Flax tree with its transformer layers named as JAX's ``remat``
    model names them (``remat=True``) or as the plain model and the port
    name them (``False``)."""
    out = {}
    for key, value in tree.items():
        if remat and _LAYER.fullmatch(key):
            key = "Checkpoint" + key
        elif not remat and key.startswith("Checkpoint"):
            key = key[len("Checkpoint"):]
        out[key] = remat_layer_names(value, remat) \
            if isinstance(value, Mapping) else value
    return out


def port_name(name):
    """The port's parameter name for a flattened Flax leaf name, with or
    without ``remat``'s layer names."""
    return name.replace(".Checkpoint", ".")


def _assert_leaves_close(ours, ref, rtol=1e-5, stepped=False,
                         key_steps=None):
    """Each leaf of ``ours`` within ``rtol`` of the norm of ``ref``'s;
    ``stepped`` (params after Adam) holds each qkv bias (3, H, Dh) block
    by block, the key block to KEY_BIAS_RTOL of the leaf's norm, or, with
    ``key_steps`` (K steps taken), each of its elements within 2·K·lr
    (``KEY_STEPS_RULE``)."""
    ref = {port_name(k): np.asarray(v) for k, v in flatten(ref).items()}
    assert set(ours) == set(ref)
    for name, want in ref.items():
        got = ours[name]
        assert got.shape == want.shape, name
        blocks = [(name, got, want, rtol, np.linalg.norm(want))]
        if stepped and name.endswith("qkv.bias"):
            blocks = [(f"{name}[{part}]", got[i], want[i],
                       KEY_BIAS_RTOL if part == "key" else rtol,
                       np.linalg.norm(want if part == "key" else want[i]))
                      for i, part in enumerate(("query", "key", "value"))]
            if key_steps is not None:
                key = blocks.pop(1)
                worst = np.abs(key[1] - key[2]).max()
                assert worst <= 2 * key_steps * TRAIN["learning_rate"], \
                    (key[0], worst)
        for block, g, w, limit, scale in blocks:
            error = np.linalg.norm(g - w)
            assert error <= limit * scale, (block, error, scale)


@pytest.mark.parametrize("grid", ["dp", "tp"])
def test_sharded_step_equals_jax(ranks, grid):
    """Data 2 and data 1 x model 2, the port's 2 ranks against JAX's
    sharded step with the same draws: every gathered gradient within 1e-5
    of its leaf's norm, the loss and the unclipped gradient norm within
    1e-5; the params and EMA after the step within 1e-5 of each leaf's
    norm, the key biases within KEY_BIAS_RTOL."""
    case, out, _ = ranks
    data, model = (2, 1) if grid == "dp" else (1, 2)
    new, metrics, grads, split = _jax_step(case, data, model)
    ours = out[grid]
    _assert_leaves_close(ours["grads"], grads)
    _assert_leaves_close(ours["params"], new.params, stepped=True)
    _assert_leaves_close(ours["ema"], new.ema_params, stepped=True)
    np.testing.assert_allclose(ours["loss"], float(metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(ours["grad"], float(metrics["grad"]),
                               rtol=1e-5)
    assert set(ours["split"]) == split
    assert bool(split) == (grid == "tp")
    for name in split:   # each rank holds the column block
        assert ours["shapes"][name][-1] * 2 == ours["params"][name].shape[-1]


# After K Adam steps an attention key bias (true gradient 0) is a random
# walk of +-lr steps on the sign of float noise, whatever the grid: JAX's
# own chunks of the MDN on 8, 2 and 1 devices differ in its key block by
# 1.2e-3 to 4.3e-3 of the bias's norm (up to 1.08e-3 an element), beyond
# KEY_BIAS_RTOL, which holds one step. The MDN's chunks hold that block as
# tests/test_torch_chunk.py holds K steps: every element within 2·K·lr
# (the ranks read 2.8e-3 of the norm, 5.4e-4 an element, against JAX's
# 2-device chunks). The flagship's key blocks meet KEY_BIAS_RTOL.
KEY_STEPS_RULE = ("mdn",)
# JAX's chunks are taken on the grid the ranks run, a data axis of 2 or a
# model axis of 2 over conftest's devices, as ``_jax_step`` takes the one
# step: six Adam steps
# carry each grid's summation order into the elements whose gradient is
# at float noise. Read on the CPU, DenseFiLM_0.Dense_3.kernel after the 6
# steps: JAX's 8-device chunks against its 2-device ones 1.42e-5 of the
# leaf's norm (against one device 1.47e-5; 2 against 1 device 5.4e-7);
# the ranks against JAX's 2-device chunks 3.3e-6 (5.7e-6 the worst leaf).
CHUNK_MESHES = {"dp": dict(data=2, model=1), "tp": dict(data=1, model=2)}


def _jax_chunks(case, trainer_name, grid="dp"):
    """JAX's chunks over ``grid``'s CHUNK_MESHES grid of conftest's
    devices, as its chunked ``fit`` runs them (tests/test_parallel.py): the
    case's params laid out by ``shard_params``, each (K, 8, ...) stack by
    ``shard_chunk``; a grid ending in ``_remat`` checkpoints the models'
    layers (``nn.remat``, its layer names). Returns the state and the 6
    losses."""
    remat = grid.endswith("_remat")
    shape = CHUNK_MESHES[grid.removesuffix("_remat")]
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**shape),
                           devices=jax.devices()[:shape["data"] *
                                                 shape["model"]])
    schedule = joptimizer.stepped_exponential_schedule(1e-3, 1, 0.9)
    config = jtrainer.TrainConfig(**TRAIN)
    if trainer_name == "mdn":
        jmodel = jax_get_model("TransformerMDN", remat=remat, **MDN_KW)
        state = jmdn.create_train_state(jax.random.PRNGKey(0), jmodel,
                                        (1, S, C), config)
        params, stack = case["mdn_params"], case["mdn_batches"]
        chunk = jmdn.make_train_chunk(jmodel, schedule)
    else:
        jmodel = jax_get_model("TransformerDDPM", remat=remat, **KW)
        state = jtrainer.create_train_state(
            jax.random.PRNGKey(0), jmodel, (1, S, C), (1, 1, 1), config)
        params, stack = case["params"], case["chunk_batches"]
        chunk = jtrainer.make_train_chunk(
            jmodel, jlosses.diffusion_loss, jschedules.noise_schedule(*BETAS),
            True, schedule)
    params = remat_layer_names(params, remat)
    shardings = jmesh.shard_params(params, mesh)
    params = jax.device_put(params, shardings)
    state = state.replace(params=params, opt_state=state.tx.init(params))
    if state.ema_params is not None:
        state = state.replace(ema_params=jax.device_put(
            remat_layer_names(case["params"], remat), shardings))
    losses = []
    for seed, (lo, hi) in zip(CHUNK_KEYS, CHUNK_CUTS):
        batches = jmesh.shard_chunk(jnp.asarray(stack[lo:hi]), mesh)
        key = () if trainer_name == "mdn" else (jax.random.PRNGKey(seed),)
        state, metrics = chunk(state, batches, *key)
        losses.append(np.asarray(metrics["loss"]))
    return state, np.concatenate(losses)


def _check_chunk_equals_steps(out, grid, trainer_name):
    steps = out["chunks"][grid][f"{trainer_name}_steps"]
    chunk = out["chunks"][grid][f"{trainer_name}_chunk"]
    assert steps["step"] == chunk["step"] == CHUNK_CUTS[-1][1]
    assert torch.equal(steps["losses"], chunk["losses"])
    assert len(steps["tensors"]) == len(chunk["tensors"])
    for a, b in zip(steps["tensors"], chunk["tensors"]):
        assert torch.equal(a, b)
    assert torch.equal(steps["generator"], chunk["generator"])


@pytest.mark.parametrize("trainer_name", ["replayed", "drawn", "mdn"])
def test_data_axis_chunk_equals_the_per_step_ranks(ranks, trainer_name):
    """On 2 ranks on a data axis, a chunk of 4 and a chunk of 2 (each rank
    on its rows of the global stack, the all-reduce between the step's
    captured graphs) leave the state, the losses and the generator
    bit-equal to the same ranks' 6 single steps: the diffusion trainer
    with JAX's draws replayed and with the draws from its generator, and
    the MDN trainer."""
    _check_chunk_equals_steps(ranks[1], "dp", trainer_name)


@pytest.mark.parametrize("trainer_name", ["replayed", "drawn", "mdn"])
def test_model_axis_chunk_equals_the_per_step_ranks(ranks, trainer_name):
    """As on the data axis, on a model axis of 2 (both ranks on the whole
    stack, each split Dense's gather and reduce and the norm's all-reduce
    between the step's captured graphs): every rank's blocks and
    replicated leaves, the losses and the generator bit-equal to its 6
    single steps."""
    _check_chunk_equals_steps(ranks[1], "tp", trainer_name)


def _check_chunk_equals_jax(ranks, grid, trainer_name):
    case, out, _ = ranks
    ours = out["chunks"][grid][f"{trainer_name}_chunk"]
    state, jax_losses = _jax_chunks(case, trainer_name, grid)
    assert int(state.step) == ours["step"]
    key_steps = ours["step"] if trainer_name in KEY_STEPS_RULE else None
    _assert_leaves_close(ours["params"], state.params, stepped=True,
                         key_steps=key_steps)
    if trainer_name == "mdn":
        assert ours["ema"] is None
    else:
        _assert_leaves_close(ours["ema"], state.ema_params, stepped=True)
    np.testing.assert_allclose(ours["losses"].numpy(), jax_losses,
                               rtol=1e-5)


@pytest.mark.parametrize("trainer_name", ["replayed", "mdn"])
def test_data_axis_chunk_equals_jax(ranks, trainer_name):
    """The 2 ranks' chunks on a data axis against JAX's chunks over its
    mesh (CHUNK_MESHES) from the same params and global stacks, JAX's
    draws replayed: the params (and the diffusion trainer's EMA) within
    1e-5 of each leaf's norm, the key biases within KEY_BIAS_RTOL, as
    ``test_sharded_step_equals_jax`` holds one step (the MDN's key biases
    by ``KEY_STEPS_RULE``); the 6 losses within 1e-5."""
    _check_chunk_equals_jax(ranks, "dp", trainer_name)


@pytest.mark.parametrize("trainer_name", ["replayed", "mdn"])
def test_model_axis_chunk_equals_jax(ranks, trainer_name):
    """The 2 ranks' chunks on a model axis (their split leaves gathered
    whole) against JAX's chunks on a (data 1, model 2) mesh, by the same
    rules as on the data axis."""
    _check_chunk_equals_jax(ranks, "tp", trainer_name)


@pytest.mark.parametrize("trainer_name", ["replayed", "mdn"])
def test_model_axis_remat_chunk_equals_the_per_step_ranks(ranks,
                                                          trainer_name):
    """With each transformer layer checkpointed (``remat``), on a model
    axis of 2: the backward's recompute runs the layers' all-gathers
    again, between the step's captured graphs as well; every rank's state,
    the losses and the generator bit-equal to its 6 single ``remat``
    steps."""
    _check_chunk_equals_steps(ranks[1], "tp_remat", trainer_name)


@pytest.mark.parametrize("trainer_name", ["replayed", "mdn"])
def test_model_axis_remat_chunk_equals_jax(ranks, trainer_name):
    """The 2 ranks' ``remat`` chunks on a model axis against JAX's chunks
    of its ``remat`` models (``nn.remat`` under the scan) on a (data 1,
    model 2) mesh, by the rules of the chunks without it."""
    _check_chunk_equals_jax(ranks, "tp_remat", trainer_name)


@pytest.mark.parametrize("grid", ["dp", "tp", "tp_remat"])
def test_every_collective_of_a_step_goes_through_the_cut(ranks, grid):
    """Every ``torch.distributed`` collective of a chunk's steps is called
    inside ``graphs.collective`` (where a captured step cuts its graphs;
    one called past it would fail under gloo or be captured under NCCL),
    and a step cuts once for each split Dense's gather, once for each
    split Dense whose input needs a gradient (its all-reduce in the
    backward), once for the norm under a model axis and once for the
    gradients' all-reduce under a data axis. Under ``remat`` the backward
    recomputes each transformer layer up to the last tensor it saved, so
    it gathers again for every split Dense of a layer but the last (the
    MLP's output Dense, whose gathered output only the residual sum
    reads): one cut more for each."""
    _, out, _ = ranks
    cuts = out["cuts"][grid]
    assert cuts["outside"] == 0
    assert cuts["inside"] == cuts["cuts"] > 0
    per_step = cuts["cuts"] // cuts["steps"]
    assert per_step * cuts["steps"] == cuts["cuts"]
    data, model = (2, 1) if grid == "dp" else (1, 2)
    dense, grad_inputs = cuts["split_dense"], cuts["grad_inputs"]
    recomputed = 0
    if grid == "tp_remat":
        layers = KW["num_layers"]
        assert cuts["layer_dense"] == 2 * layers   # each MLP's two Dense
        recomputed = cuts["layer_dense"] - layers
    assert cuts["gathers"] == (dense + recomputed) * cuts["steps"]
    assert bool(dense) == (model > 1)
    assert per_step == dense + grad_inputs + (model > 1) + (data > 1) + \
        recomputed
    if grid != "dp":
        # The trunk's input projection and each FiLM's first Dense take
        # the data and the noise embedding, which need no gradient.
        assert (dense, grad_inputs) == (19, 16)
        assert per_step == 2 * dense - 3 + 1 + recomputed


def _one_rank_loop(case, max_steps, model_dir=None):
    model = load_flax_params(
        get_model("TransformerDDPM", device="cpu", data_channels=C, **KW),
        case["params"])
    cfg = trainer.TrainConfig(**LOOP, max_steps=max_steps)
    state = trainer.create_train_state(model, cfg, seed=3, init=False)
    sigmas = schedules.noise_schedule(*BETAS)
    return loop_lib.run_loop(
        state, trainer.make_train_step(losses.diffusion_loss, sigmas, True),
        trainer.make_eval_step(losses.diffusion_loss, sigmas, True),
        lambda: iter(case["loop_train"]), lambda: iter(case["loop_eval"]),
        cfg, model_dir=model_dir)


@pytest.fixture(scope="module")
def one_rank(ranks):
    """One rank's run of the loop's global batches: 4 steps, resumed to
    6, with the ranks' frequency table."""
    case, _, work = ranks
    embedding = blocks.sinusoidal_embedding
    blocks.sinusoidal_embedding = test_torch_parallel_ranks.xla_embedding(
        case["xla_freqs"])
    try:
        _one_rank_loop(case, 4, str(work / "one"))
        state = _one_rank_loop(case, 6, str(work / "one"))
    finally:
        blocks.sinusoidal_embedding = embedding
    return {n: p.detach().numpy() for n, p in state.params.items()}


@pytest.mark.parametrize("grid", ["dp", "tp"])
def test_loop_on_two_ranks_checkpoints_resumes_and_loads_on_one(
        ranks, one_rank, grid):
    """The 2-rank loop writes one checkpoint set (rank 0), resumes from it
    on both ranks, and ends where one rank's run of the global batches
    (4 steps, resumed to 6) ends; its last checkpoint loads whole on one
    rank."""
    case, out, work = ranks
    first, resumed = out[f"loop_{grid}"]
    assert (first["step"], resumed["step"]) == (4, 6)
    assert first["files"] == ["2.pt", "4.pt"]
    assert resumed["files"] == ["2.pt", "4.pt", "6.pt"]
    _assert_leaves_close(resumed["params"], {"params": _nest(one_rank)},
                         stepped=True)
    one = _one_rank_loop(case, 0)
    manager = CheckpointManager(work / f"loop-{grid}" / "ckpt")
    loaded = manager.restore_latest(one)
    assert loaded.step == 6
    for name, p in loaded.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      resumed["params"][name])


def _nest(flat):
    tree = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def test_clis_train_on_two_ranks_and_serve_on_one(ranks, monkeypatch):
    """``train_ncsn --model_parallelism=2`` and ``train_mdn`` on 2 ranks in
    one group; the model-parallel checkpoint served by ``sample_ncsn`` on
    one rank."""
    from smd_tpu_torch import sample_ncsn
    case, out, work = ranks
    steps, split, shape = out["clis"]["ncsn"]
    assert steps == 3 and split and shape == {"data": 1, "model": 2}
    steps, split, shape = out["clis"]["mdn"]
    assert steps == 3 and not split and shape == {"data": 2, "model": 1}
    assert sorted(os.listdir(work / "ncsn" / "ckpt")) == ["2.pt", "3.pt"]
    monkeypatch.chdir(ROOT)
    sample_ncsn.main([
        "sample_ncsn", "--flagfile=configs/ddpm-mel-32seq-512.cfg",
        f"--dataset={case['dataset']}",
        "--slice_ckpt=checkpoints/slice-mel-512.pkl",
        f"--model_dir={work}/ncsn", "--num_layers=1", "--num_heads=2",
        "--mlp_dims=32", "--num_sigmas=20", "--batch_size=4",
        "--device=cpu", "--sampling=ddim", "--ddim_steps=2", "--sample_size=4",
        f"--sampling_dir={work}/samples"])
    with open(work / "samples" / "ncsn" / "generated.pkl", "rb") as f:
        generated = np.asarray(pickle.load(f))
    # Inverse transformed through the slice to the 512-d latents.
    assert generated.shape == (4, 32, 512) and np.isfinite(generated).all()


def _check_cli_chunk(runs, shape):
    (step2, shape2, chunked), (step1, shape1, single) = runs[2], runs[1]
    assert step2 == step1 == 3
    assert shape2 == shape1 == shape
    assert len(chunked) == len(single)
    for a, b in zip(chunked, single):
        assert torch.equal(a, b)


def test_train_ncsn_chunk_on_the_data_axis_equals_its_steps(ranks):
    """``train_ncsn --scan_chunk=2`` on a data axis of 2 (a chunk of 2,
    then one step cut at max_steps) ends bit-equal to the same run by
    single steps: params, Adam moments and EMA."""
    _check_cli_chunk(ranks[1]["clis"]["ncsn_chunk"], {"data": 2, "model": 1})


def test_train_ncsn_chunk_on_the_model_axis_equals_its_steps(ranks):
    """``train_ncsn --scan_chunk=2 --model_parallelism=2`` (a chunk of 2,
    then one step cut at max_steps) ends bit-equal to the same run by
    single steps: rank 0's blocks and whole leaves, its moments and EMA."""
    _check_cli_chunk(ranks[1]["clis"]["ncsn_model_chunk"],
                     {"data": 1, "model": 2})


def test_dryrun_multichip_on_four_cpu_ranks():
    """The 2 x 2 grid's step, and its chunk of 2 bit-equal to its 2 single
    steps on every rank (``dryrun_multichip`` raises otherwise)."""
    result = dryrun.dryrun_multichip(4, device="cpu")
    assert (result["data"], result["model"], result["backend"]) == \
        (2, 2, "gloo")
    assert result["split_params"] > 0 and np.isfinite(result["loss"])


# -- profiling -----------------------------------------------------------------

def _trace_events():
    """A Chrome trace as ``torch.profiler`` writes one on the card: two
    operations, the kernels they launch, one kernel of the port."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
           "dur": 50, "args": {"External id": 1}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 60,
           "dur": 10, "args": {"External id": 2}}]
    for i in range(2):
        ev.append({"ph": "X", "cat": "kernel", "name": "sm90_gemm_bf16",
                   "ts": 100 + i * 40, "dur": 30,
                   "args": {"External id": 1}})
    ev.append({"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 200,
               "dur": 5, "args": {"External id": 2}})
    ev.append({"ph": "X", "cat": "kernel", "name": "film_gemm_kernel",
               "ts": 210, "dur": 100, "args": {"External id": 0}})
    return {"traceEvents": ev}


def test_op_profile_tables_device_time_in_jax_layout(tmp_path):
    with open(tmp_path / "trace-1-1.json", "w") as f:
        json.dump(_trace_events(), f)
    total, rows = profiling.op_profile(str(tmp_path))
    assert total == pytest.approx(0.165)
    assert [(r["category"], r["occurrences"]) for r in rows] == \
        [("film_gemm_kernel", 1), ("aten::mm", 2), ("aten::add", 1)]
    assert rows[1]["ms"] == pytest.approx(0.06)
    assert rows[1]["share"] == pytest.approx(0.06 / 0.165)
    assert rows[1]["top"][0][0] == "sm90_gemm_bf16"
    assert profiling.format_op_profile(total, rows, steps=2) == \
        jprofiling.format_op_profile(total, rows, steps=2)


def test_trace_on_the_cpu_has_no_device_time(tmp_path):
    with profiling.trace(str(tmp_path), "cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert isinstance(prof, torch.profiler.profile)
    (path,) = tmp_path.glob("trace-*.json")
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(ValueError, match="no device activity"):
        profiling.op_profile(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.op_profile(str(tmp_path / "none"))


def test_loop_profiles_through_the_trace(tmp_path):
    model = get_model("TransformerDDPM", device="cpu", data_channels=C,
                      **KW)
    cfg = trainer.TrainConfig(**{**LOOP, "snapshot_freq": 100},
                              max_steps=3, profile_steps=2,
                              profile_start_step=1)
    state = trainer.create_train_state(model, cfg)
    sigmas = schedules.noise_schedule(*BETAS)
    batches = [np.random.default_rng(i).uniform(-1, 1, (B, S, C))
               .astype(np.float32) for i in range(2)]
    loop_lib.run_loop(
        state, trainer.make_train_step(losses.diffusion_loss, sigmas, True),
        trainer.make_eval_step(losses.diffusion_loss, sigmas, True),
        lambda: iter(batches), lambda: iter(batches[:1]), cfg,
        model_dir=str(tmp_path / "m"))
    assert len(list((tmp_path / "m" / "profile").glob("trace-*.json"))) == 1
