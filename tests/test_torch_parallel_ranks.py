"""The ranks of ``tests/test_torch_parallel.py``: gloo processes on the CPU.

A spawned rank imports this module to find its function, so it imports
torch, numpy and the port only (the test file imports JAX). ``run`` reads
the case the test wrote (``case.pkl``: the narrow flagship's params in the
Flax layout, a global batch, the JAX package's draws, the loop's batches,
a dataset for the CLIs, the chunks' global stacks and draws), takes every
step the test asks for in one process group and writes what rank 0 saw to
``out.pkl``.
"""
import functools
import os
import pickle
import sys

import torch
import torch.distributed as dist

from smd_tpu_torch.diffusion import losses, schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.parallel import mesh as mesh_lib
from smd_tpu_torch.training import diffusion as trainer
from smd_tpu_torch.training import loop as loop_lib
from smd_tpu_torch.training import mdn
from smd_tpu_torch.utils import graphs
from smd_tpu_torch.utils.flax_params import load_flax_params

GRIDS = (("dp", mesh_lib.MeshConfig(data=2, model=1)),
         ("tp", mesh_lib.MeshConfig(data=1, model=2)))
# The model axis with each transformer layer checkpointed (``remat``): the
# backward's recompute runs the layers' all-gathers again.
REMAT_GRID = ("tp_remat", mesh_lib.MeshConfig(data=1, model=2))
# Every collective of torch.distributed a step could call.
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce",
               "all_to_all", "all_to_all_single", "barrier", "broadcast",
               "gather", "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "scatter", "send", "recv", "isend", "irecv")


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else
            (v.numpy() if torch.is_tensor(v) else v)
            for k, v in tree.items()}


def _model(case, remat=False):
    model = get_model("TransformerDDPM", device="cpu",
                      data_channels=case["channels"], remat=remat,
                      **case["kw"])
    return load_flax_params(model, case["params"])


def _step(case, config):
    """One train step of the narrow flagship from the case's params on the
    global batch with the JAX draws, over ``config``'s mesh."""
    mesh = mesh_lib.make_mesh(config)
    state = trainer.create_train_state(_model(case), trainer.TrainConfig(
        **case["train_config"]), init=False, mesh=mesh)
    sigmas = schedules.noise_schedule(*case["betas"])
    batch = mesh_lib.shard_batch(torch.from_numpy(case["batch"]), mesh)
    loss_fn = trainer.make_loss_fn(losses.diffusion_loss, sigmas, True, mesh)
    grads, _ = state.gradients(loss_fn(state.model, batch, None,
                                       case["draws"]))
    grads = {n: (mesh_lib.gather_leaf(g, state.specs[n], mesh)
                 if n in state.specs else g).numpy()
             for n, g in grads.items()}
    step = trainer.make_train_step(losses.diffusion_loss, sigmas, True, mesh)
    state, metrics = step(state, batch, draws=case["draws"])
    saved = state.state_dict()
    return {"grads": grads, "params": _numpy(saved["params"]),
            "ema": _numpy(saved["ema_params"]),
            "loss": float(metrics["loss"]), "grad": float(metrics["grad"]),
            "split": sorted(state.specs),
            "shapes": {n: tuple(p.shape) for n, p in state.params.items()}}


def _loop(case, model_dir, config, max_steps):
    """``run_loop`` over ``config``'s mesh, each rank on its rows of the
    loop's global batches; returns the whole final state."""
    mesh = mesh_lib.make_mesh(config)
    cfg = trainer.TrainConfig(**case["loop_config"], max_steps=max_steps)
    state = trainer.create_train_state(_model(case), cfg, seed=3,
                                       init=False, mesh=mesh)
    sigmas = schedules.noise_schedule(*case["betas"])
    rows = lambda batches: [mesh_lib.shard_batch(b, mesh)  # noqa: E731
                            for b in batches]
    state = loop_lib.run_loop(
        state, trainer.make_train_step(losses.diffusion_loss, sigmas, True,
                                       mesh),
        trainer.make_eval_step(losses.diffusion_loss, sigmas, True, mesh),
        lambda: iter(rows(case["loop_train"])),
        lambda: iter(rows(case["loop_eval"])), cfg, model_dir=model_dir,
        mesh=mesh)
    saved = state.state_dict()
    return {"step": state.step, "params": _numpy(saved["params"]),
            "files": sorted(os.listdir(f"{model_dir}/ckpt"))}


def _mdn_model(case, remat=False):
    model = get_model("TransformerMDN", device="cpu",
                      data_channels=case["channels"], remat=remat,
                      **case["mdn_kw"])
    return load_flax_params(model, case["mdn_params"])


def _replicated(state):
    """The state's tensors that every rank holds whole (params, moments,
    EMA): under a model axis the split leaves' blocks differ by rank."""
    whole = [n for n in state.params if n not in state.specs]
    trees = (state.params, state.opt_state["mu"], state.opt_state["nu"],
             state.ema_params or {})
    return [tree[n].detach() for tree in trees for n in whole if n in tree]


def _cuts(case, config, remat=False):
    """A chunk of 2 diffusion steps of the narrow flagship (``remat``: its
    layers checkpointed) over ``config``'s mesh with every collective of
    ``torch.distributed`` wrapped: the calls made outside
    ``graphs.collective`` and inside it, the cuts (``graphs.collective``
    calls) a step, the all-gathers among them, the split Dense layers, how
    many of them take an input that needs a gradient (those all-reduce it
    in the backward) and how many lie inside the transformer layers."""
    mesh = mesh_lib.make_mesh(config)
    state = trainer.create_train_state(_model(case, remat),
                                       trainer.TrainConfig(
                                           **case["train_config"]),
                                       init=False, mesh=mesh)
    modules = dict(state.model.named_modules())
    owners = sorted({n.rsplit(".", 1)[0] for n in state.specs})
    needs_grad = {}
    hooks = [modules[o].register_forward_pre_hook(
        lambda m, args, o=o: needs_grad.__setitem__(o, args[0].requires_grad))
        for o in owners]
    calls = {"outside": 0, "inside": 0, "cuts": 0, "gathers": 0}
    depth = [0]
    real_collective = graphs.collective

    def collective(fn, *buffers):
        calls["cuts"] += 1
        depth[0] += 1
        try:
            real_collective(fn, *buffers)
        finally:
            depth[0] -= 1

    def wrapped(real, *args, **kwargs):
        calls["inside" if depth[0] else "outside"] += 1
        calls["gathers"] += real is reals["all_gather"]
        return real(*args, **kwargs)

    reals = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}
    stack = torch.from_numpy(case["chunk_batches"][:2])
    chunk = trainer.make_train_chunk(
        losses.diffusion_loss, schedules.noise_schedule(*case["betas"]),
        True, mesh)
    graphs.collective = collective
    for name, real in reals.items():
        setattr(dist, name, functools.partial(wrapped, real))
    try:
        chunk(state, mesh_lib.shard_chunk(stack, mesh))
    finally:
        graphs.collective = real_collective
        for name, real in reals.items():
            setattr(dist, name, real)
        for hook in hooks:
            hook.remove()
    return {**calls, "steps": len(stack), "split_dense": len(owners),
            "grad_inputs": sum(needs_grad.values()),
            "layer_dense": sum("TransformerLayer_" in o for o in owners)}


def _state_out(state, losses):
    """What a run left: every tensor a step writes, the losses, the step
    count, and the whole params and EMA (the JAX comparison's)."""
    saved = state.state_dict()
    return {"tensors": [t.detach().clone() for t in state.tensors()],
            "losses": torch.cat(losses), "step": state.step,
            "params": _numpy(saved["params"]),
            "ema": None if saved["ema_params"] is None else
            _numpy(saved["ema_params"])}


def _chunks(case, config, remat=False,
            trainers=("replayed", "drawn", "mdn")):
    """The diffusion trainer (the case's draws replayed, and drawn from
    the state's generator) and the MDN trainer over ``config``'s mesh (a
    data axis of 2, or a model axis of 2; ``remat``: the models' layers
    checkpointed): the global (6, batch, ...) stack
    as a chunk of 4 and a chunk of 2 (cut as at a snapshot), each rank on
    its rows (``shard_chunk``; both ranks of a model group on the whole
    stack), against the same ranks' 6 per-step steps on their rows of each
    global batch (``shard_batch``). The replicas (the replicated leaves on
    a model axis) are checked equal after each run."""
    mesh = mesh_lib.make_mesh(config)
    sigmas = schedules.noise_schedule(*case["betas"])
    config = trainer.TrainConfig(**case["train_config"])
    out = {}
    for trainer_name in trainers:
        stack = torch.from_numpy(case["mdn_batches" if trainer_name == "mdn"
                                      else "chunk_batches"])
        draws = None
        if trainer_name == "replayed":
            draws = tuple(torch.from_numpy(d) for d in case["chunk_draws"])
        for how in ("steps", "chunk"):
            if trainer_name == "mdn":
                state = mdn.create_train_state(_mdn_model(case, remat),
                                               config, init=False, mesh=mesh)
                step, chunk = mdn.make_train_step(mesh), \
                    mdn.make_train_chunk(mesh)
            else:
                state = trainer.create_train_state(
                    _model(case, remat), config, seed=5, init=False,
                    mesh=mesh)
                step = trainer.make_train_step(losses.diffusion_loss, sigmas,
                                               True, mesh)
                chunk = trainer.make_train_chunk(losses.diffusion_loss,
                                                 sigmas, True, mesh)
            run = []
            if how == "steps":
                for i in range(len(stack)):
                    kw = {} if draws is None else \
                        {"draws": tuple(d[i] for d in draws)}
                    batch = mesh_lib.shard_batch(stack[i], mesh)
                    run.append(step(state, batch, **kw)[1]["loss"][None])
            else:
                rows = mesh_lib.shard_chunk(stack, mesh)
                for lo, hi in ((0, 4), (4, len(stack))):
                    kw = {} if draws is None else \
                        {"draws": tuple(d[lo:hi] for d in draws)}
                    run.append(chunk(state, rows[lo:hi], **kw)[1]["loss"])
            mesh_lib.check_replicas_equal(_replicated(state), "state")
            out[f"{trainer_name}_{how}"] = _state_out(state, run)
            out[f"{trainer_name}_{how}"]["generator"] = \
                state.generator.get_state()
    return out


def _clis(case, work):
    """``train_ncsn`` on a model axis of 2 and ``train_mdn`` on a data axis
    of 2, both in the running group (each rank reads its shard);
    ``train_ncsn --scan_chunk=2`` on each axis against its single
    steps."""
    from smd_tpu_torch import train_mdn, train_ncsn
    common = [f"--dataset={case['dataset']}",
              "--slice_ckpt=checkpoints/slice-mel-512.pkl",
              "--num_layers=1", "--num_heads=2", "--mlp_dims=32",
              "--batch_size=4", "--device=cpu", "--snapshot_freq=2",
              "--max_steps=3"]
    ncsn = train_ncsn.main(["train_ncsn",
                            "--flagfile=configs/ddpm-mel-32seq-512.cfg",
                            f"--model_dir={work}/ncsn", "--num_sigmas=20",
                            "--model_parallelism=2", *common])
    # Each axis through the chunk (2 steps, then 1 cut at max_steps) and
    # through single steps, from the same seed; the model axis's single
    # steps are the run above.
    chunked = {"dp": {}, "tp": {1: (ncsn.step, ncsn.mesh.shape,
                                    [t.clone() for t in ncsn.tensors()])}}
    for grid, scan_chunk, extra in (("dp", 2, []), ("dp", 1, []),
                                    ("tp", 2, ["--model_parallelism=2"])):
        state = train_ncsn.main([
            "train_ncsn", "--flagfile=configs/ddpm-mel-32seq-512.cfg",
            f"--model_dir={work}/ncsn-{grid}-{scan_chunk}",
            "--num_sigmas=20", f"--scan_chunk={scan_chunk}", *extra,
            *common])
        chunked[grid][scan_chunk] = (state.step, state.mesh.shape,
                                     [t.clone() for t in state.tensors()])
    mdn = train_mdn.main(["train_mdn",
                          "--flagfile=configs/mdn-mel-32seq-512.cfg",
                          f"--model_dir={work}/mdn", "--mdn_components=3",
                          *common])
    return {"ncsn": (ncsn.step, sorted(ncsn.specs), ncsn.mesh.shape),
            "mdn": (mdn.step, sorted(mdn.specs), mdn.mesh.shape),
            "ncsn_chunk": chunked["dp"], "ncsn_model_chunk": chunked["tp"]}


def xla_embedding(freqs):
    """The port's sinusoidal embedding on XLA's float32 frequency tables
    (``freqs``: {channels // 2: table}), as ``test_torch_ncsn_models``'s
    ``xla_frequencies`` fixture makes it: torch's exp and XLA's differ by
    an ulp in a few frequencies, which the x5000 noise encoding makes
    1e-4."""
    def embedding(positions, channels):
        table = torch.from_numpy(freqs[channels // 2]).to(positions.device)
        emb = positions.float()[:, None] * table[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
        if channels % 2:
            emb = torch.nn.functional.pad(emb, (0, 1))
        return emb
    return embedding


def run(rank, world, port, work):
    # As on the card, which has tensorboard and no TensorFlow: the summary
    # writer takes tensorboard's own stub (importing TensorFlow takes 10 s).
    sys.modules["tensorflow"] = None
    from smd_tpu_torch.models import blocks
    torch.set_num_threads(1)   # tiny shapes; the test workers share the cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with open(f"{work}/case.pkl", "rb") as f:
            case = pickle.load(f)
        blocks.sinusoidal_embedding = xla_embedding(case["xla_freqs"])
        out = {}
        for name, config in GRIDS:
            out[name] = _step(case, config)
            # Trained 4 steps with checkpoints at 2 and 4, then resumed to 6.
            out[f"loop_{name}"] = [_loop(case, f"{work}/loop-{name}", config,
                                         steps) for steps in (4, 6)]
        out["chunks"] = {name: _chunks(case, config)
                         for name, config in GRIDS}
        out["chunks"][REMAT_GRID[0]] = _chunks(case, REMAT_GRID[1], True,
                                               ("replayed", "mdn"))
        out["cuts"] = {name: _cuts(case, config) for name, config in GRIDS}
        out["cuts"][REMAT_GRID[0]] = _cuts(case, REMAT_GRID[1], True)
        out["clis"] = _clis(case, work)
        if rank == 0:
            with open(f"{work}/out.pkl", "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
