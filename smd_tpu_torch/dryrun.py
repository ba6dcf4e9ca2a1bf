"""The flagship's forward and a multi-rank dry run (port of
``__graft_entry__.py``).

``entry()`` is the full-width flagship's forward on one card with its
example arguments; ``dryrun_multichip(n)`` runs two whole train steps
over n ranks on a (data, model) mesh, then the same two steps as one chunk
(``make_train_chunk``: on the card captured in CUDA graphs, each
collective eager between two of them) from the same start, which must
leave every rank's state bit-equal to its steps. Each rank is a process
(``torch.multiprocessing.spawn``) in a process group of its own address:
with a card for each rank, NCCL; with fewer cards than ranks the ranks
share the cards and the group is gloo over CUDA tensors, and the line
printed says so; with ``device="cpu"``, gloo on the CPU. It never moves to
the CPU by itself.
"""
from __future__ import annotations

import json
import math
import os
import socket
import tempfile

import torch
import torch.distributed as dist

from smd_tpu_torch.device import resolve_device

__all__ = ["entry", "dryrun_multichip", "free_port"]


def entry(device="cuda"):
    """The flagship TransformerDDPM (6 layers, 8 heads, MLP 2048) with
    params drawn from seed 0 on ``device``, and its example arguments
    (x of 8x32x42 ones, the noise level 0.5): ``fn(*args)`` runs the
    forward."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.layers import init_parameters
    device = resolve_device(device)
    model = get_model("TransformerDDPM", device=device, data_channels=42,
                      num_layers=6, num_heads=8, num_mlp_layers=2,
                      mlp_dims=2048)
    init_parameters(model, 0)
    x = torch.ones((8, 32, 42), device=device)
    t = torch.full((8, 1, 1), 0.5, device=device)
    return model, (x, t)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(device: torch.device, n: int):
    """(backend, cards) for n ranks: NCCL with a card each, else gloo."""
    if device.type != "cuda":
        return "gloo", 0
    cards = torch.cuda.device_count()
    return ("nccl" if cards >= n else "gloo"), cards


def _dryrun_rank(rank, n, device_type, backend, port, out_dir):
    """One rank of ``dryrun_multichip``: the tiny flagship's 2 train steps
    on this rank's rows, then a chunk of 2 from the same start; writes its
    first loss and whether the chunk equals the steps to
    ``out_dir/{rank}.json``."""
    from smd_tpu_torch.diffusion import losses, schedules
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.parallel import mesh as mesh_lib
    from smd_tpu_torch.training import diffusion as trainer

    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        model_axis = 2 if n % 2 == 0 and n >= 4 else 1
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=n // model_axis,
                                                      model=model_axis))
        batch_size = 2 * mesh.data
        seq_len, channels, mlp_dims = 8, 16, 64
        config = trainer.TrainConfig(loss="ddpm", batch_size=batch_size)

        def fresh():
            model = get_model("TransformerDDPM", device=device,
                              data_channels=channels, num_layers=2,
                              num_heads=4, num_mlp_layers=1,
                              mlp_dims=mlp_dims)
            return trainer.create_train_state(model, config, seed=0,
                                              mesh=mesh)

        betas = schedules.noise_schedule(1e-6, 0.01, 10, "linear")
        step = trainer.make_train_step(losses.diffusion_loss, betas, True,
                                       mesh)
        gen = torch.Generator().manual_seed(1)
        batches = torch.stack([torch.randn((batch_size, seq_len, channels),
                                           generator=gen) * 0.5
                               for _ in range(2)])
        rows = mesh_lib.shard_chunk(batches, mesh).to(device)
        state = fresh()
        step_losses = [step(state, batch)[1]["loss"] for batch in rows]
        chunked = fresh()
        chunk = trainer.make_train_chunk(losses.diffusion_loss, betas, True,
                                         mesh)
        _, metrics = chunk(chunked, rows)
        chunk_equal = torch.equal(metrics["loss"],
                                  torch.stack(step_losses)) and all(
            torch.equal(a, b) for a, b in zip(chunked.tensors(),
                                              state.tensors()))
        chunk.close()
        loss = float(step_losses[0])
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump({"loss": loss, "data": mesh.data,
                       "model": mesh.model, "split": len(state.specs),
                       "device": str(device), "chunk_equal": chunk_equal},
                      f)
        if not math.isfinite(loss):
            raise FloatingPointError(f"rank {rank}: loss {loss}")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Two full train steps over ``n_devices`` ranks on a (data x model)
    mesh, model 2 when n is even and at least 4, and the same steps as a
    chunk of 2; tiny shapes, real groups. Asserts a finite loss, equal on
    every rank, and on every rank a chunk bit-equal to its steps (params,
    Adam moments, EMA, losses); prints one line and returns what it
    printed as a dict."""
    device = resolve_device(device)
    backend, cards = _backend(device, n_devices)
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.spawn(
            _dryrun_rank, args=(n_devices, device.type, backend, port,
                                out_dir),
            nprocs=n_devices, join=True)
        ranks = []
        for rank in range(n_devices):
            with open(os.path.join(out_dir, f"{rank}.json")) as f:
                ranks.append(json.load(f))
    losses = {r["loss"] for r in ranks}
    if len(losses) != 1:
        raise AssertionError(f"the ranks' losses differ: {sorted(losses)}")
    unequal = [r for r, got in enumerate(ranks) if not got["chunk_equal"]]
    if unequal:
        raise AssertionError(f"on ranks {unequal} the chunk of 2 differs "
                             "from the 2 single steps")
    shared = device.type == "cuda" and cards < n_devices
    result = {"ranks": n_devices, "data": ranks[0]["data"],
              "model": ranks[0]["model"], "backend": backend,
              "device": device.type, "cards": cards,
              "loss": ranks[0]["loss"], "split_params": ranks[0]["split"]}
    where = (f"{n_devices} ranks sharing {cards} card(s), gloo over CUDA "
             "tensors" if shared else
             f"{n_devices} ranks, one card each" if device.type == "cuda"
             else f"{n_devices} ranks on the CPU")
    print(f"dryrun_multichip({n_devices}) OK: mesh {result['data']}x"
          f"{result['model']}, {backend} ({where}), "
          f"{result['split_params']} parameters split a rank, loss "
          f"{result['loss']:.6f}; a chunk of 2 bit-equal to its 2 single "
          "steps on every rank", flush=True)
    return result
