"""Process groups and sharding rules (port of ``smd_tpu/parallel/mesh.py``).

The JAX package jits every step over a ``('data', 'model')`` device mesh
and lets XLA emit the collectives. The port runs one process a card (one
rank of ``torch.distributed``) and writes the collectives itself:

- ``data``: the batch axis. Each rank of a data group holds its rows of the
  global batch; ``training/state.py`` all-reduces the gradients over the
  group and divides by its size.
- ``model``: the tensor-parallel axis. A rank of a model group holds the
  column block of every rule-matched Dense kernel and bias
  (``param_spec``), computes its block of the output and all-gathers the
  rest (``parallel/column.py``). With ``model == 1`` everything is
  replicated.

Rank r sits at (data r // model, model r % model), as JAX's ``make_mesh``
reshapes its device list to (data, model). The ranks of one model group
share their data rows, so they read the same shard of the dataset.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from smd_tpu_torch.device import resolve_device

__all__ = ["MeshConfig", "Mesh", "mesh_shape", "make_mesh",
           "initialize_distributed", "param_spec", "shard_params",
           "shard_batch", "shard_chunk", "check_replicas_equal", "pack",
           "unpack", "gather_leaf", "slice_leaf", "barrier"]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(device=None) -> Tuple[int, int]:
    """Join the process group that torchrun's variables declare.

    With ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set,
    starts the default group (NCCL on ``cuda``, with
    ``torch.cuda.set_device(LOCAL_RANK)``; gloo on the CPU) and returns
    (rank, world size); without them creates no group and returns (0, 1),
    as the JAX package does on one host. A group started already is kept.
    Two ranks of one host on one card raise: NCCL refuses it.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not all(k in os.environ for k in _ENV):
        return 0, 1
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(
                f"rank {rank} has local rank {local} and this host has "
                f"{cards} CUDA device(s): NCCL takes one card a rank, so "
                f"start at most {cards} processes a host")
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                             f"{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    return rank, world


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: all remaining ranks
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid over the ranks of the default group.

    ``data_group`` holds the ranks with this rank's model index (the
    gradient all-reduce), ``model_group`` those with its data index (the
    column-parallel products); a group of one rank is None.
    """
    data: int
    model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def mesh_shape(config: MeshConfig, n: int) -> Tuple[int, int]:
    """(data, model) of ``config`` over ``n`` ranks; JAX's error when the
    grid does not cover them."""
    model = max(1, config.model)
    data = config.data if config.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    return data, model


def make_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """The (data, model) grid over the default group's ranks (one rank, no
    groups, without a group). Every rank calls it, in the same order as
    every other collective."""
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    rank = dist.get_rank() if started else 0
    data, model = mesh_shape(config, world)
    data_group = model_group = None
    if started:
        # Every rank creates every group, its own or not.
        for i in range(data):
            ranks = list(range(i * model, (i + 1) * model))
            group = dist.new_group(ranks) if model > 1 else None
            if rank in ranks:
                model_group = group
        for j in range(model):
            ranks = list(range(j, world, model))
            group = dist.new_group(ranks) if data > 1 else None
            if rank in ranks:
                data_group = group
    return Mesh(data, model, rank, data_group, model_group)


# Parameter partition rules: name regex -> spec. The kernels of the Dense
# layers split their output dim over 'model', their biases likewise;
# everything else is replicated. Names are the port's dotted Flax paths.
_PARAM_RULES = (
    (re.compile(r".*Dense_\d+\.kernel$"), (None, "model")),
    (re.compile(r".*Dense_\d+\.bias$"), ("model",)),
)


def param_spec(name: str, shape: Sequence[int], model: int) -> tuple:
    """The partition spec of one parameter, JAX's rule for rule: () for
    replicated, else one entry a dim, "model" on the split dim. A dim is
    split only when the model axis divides it; with model == 1 everything
    is replicated."""
    if model == 1:
        return ()
    for pat, spec in _PARAM_RULES:
        if pat.match(name):
            ok = all(ax != "model" or (d < len(shape) and
                                       shape[d] % model == 0)
                     for d, ax in enumerate(spec))
            if ok and len(shape) == len(spec):
                return spec
    return ()


def shard_params(model: torch.nn.Module, mesh: Mesh) -> Dict[str, tuple]:
    """Keep this rank's column block of every rule-matched parameter, in
    place, and make its Dense column-parallel over the model group;
    returns {name: spec} of the split parameters (empty when model == 1).
    Call it on every rank of the group, with equal parameters."""
    from smd_tpu_torch.parallel import column
    specs = {name: param_spec(name, p.shape, mesh.model)
             for name, p in model.named_parameters()}
    specs = {n: s for n, s in specs.items() if "model" in s}
    modules = dict(model.named_modules())
    for owner in sorted({n.rsplit(".", 1)[0] for n in specs}):
        column.make_column_parallel(modules[owner], mesh)
    return specs


def _rows(total: int, mesh: Mesh, what: str) -> int:
    if total % mesh.data:
        raise ValueError(f"a {what} of {total} rows does not split over a "
                         f"data axis of {mesh.data}")
    return total // mesh.data


def shard_batch(batch: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a global batch: block ``data_index`` of ``data``
    along the leading axis."""
    if mesh is None or mesh.data == 1:
        return batch
    rows = _rows(batch.shape[0], mesh, "global batch")
    return batch[mesh.data_index * rows:(mesh.data_index + 1) * rows]


def shard_chunk(batches, mesh: Optional[Mesh]):
    """This rank's rows of a (K, batch, ...) stack of K step batches: the
    step axis whole, each step's batch axis (dim 1) split as
    ``shard_batch`` splits one step's (JAX's ``shard_chunk``, which lays
    the stack out so over the mesh's devices)."""
    if mesh is None or mesh.data == 1:
        return batches
    rows = _rows(batches.shape[1], mesh, "step batch of the chunk")
    return batches[:, mesh.data_index * rows:(mesh.data_index + 1) * rows]


def check_replicas_equal(tensors: Iterable[torch.Tensor],
                         what: str = "parameters"):
    """Raise unless ``tensors`` hold the same values on every rank: a
    float64 checksum (the sum and the sum of squares) broadcast from rank
    0 and compared. Nothing to check without a group."""
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return
    tensors = list(tensors)
    local = torch.stack([
        sum(t.detach().double().sum() for t in tensors),
        sum(t.detach().double().square().sum() for t in tensors)])
    reference = local.clone()
    dist.broadcast(reference, src=0)
    if not torch.equal(local, reference):
        raise RuntimeError(
            f"rank {dist.get_rank()}: the {what} differ from rank 0's "
            f"(checksum {local.tolist()} against {reference.tolist()}); "
            "every rank must draw them from the same seed")


def pack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors concatenated into one flat float32 buffer (the data
    group's all-reduce of a step's gradients and loss takes one)."""
    return torch.cat([t.reshape(-1).float() for t in tensors])


def unpack(flat: torch.Tensor, like: List[torch.Tensor], size: int
           ) -> List[torch.Tensor]:
    """``flat`` (a ``pack`` of ``like``, summed over ``size`` ranks)
    divided by ``size`` in place and split back into each tensor of
    ``like``'s shape and dtype."""
    flat /= size
    out, start = [], 0
    for t in like:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def gather_leaf(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of a split leaf: its blocks all-gathered over the
    model group and joined on the split dim."""
    dim = spec.index("model")
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=dim)


def slice_leaf(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole leaf on its split dim."""
    dim = spec.index("model")
    block = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * block, block).contiguous()


def barrier(mesh: Optional[Mesh]):
    """Wait for every rank, when there is more than one."""
    if mesh is not None and mesh.data * mesh.model > 1:
        dist.barrier()
