"""Training state (port of ``smd_tpu/training/state.py``).

``TrainState`` holds everything a step changes: the step count, the model
(whose parameters are the params), the optimizer and its state, the float32
EMA of the params, and the generator of the step's draws. The step changes
it in place, the PyTorch idiom, where the JAX step returns a new pytree.
``state_dict``/``load_state_dict`` carry all of it through a checkpoint, the
generator's state included, so a resumed run draws what a straight run
would have drawn. A checkpoint loaded on another kind of device (trained on
the card, sampled on the CPU) keeps the new state's generator, whose state
has another form there. Params, Adam moments and EMA are written in place,
by a step and by ``load_state_dict`` alike, so a step captured in a CUDA
graph (``training/graphs.py``) keeps writing the state's own tensors.

Under a ``parallel.mesh.Mesh`` (``mesh``, with ``specs`` naming the
parameters split over the model axis): ``descend`` averages the gradients
(and the loss) over the data group through one flattened buffer, and the
global norm sums the split leaves' squares over the model group, counting
each replicated leaf once; clipping, Adam and the EMA then run alike on
every rank. Both all-reduces go through ``graphs.collective``, as the
column-parallel layers' do (``parallel/column.py``), so a captured step
(``utils/graphs.py``) runs each eagerly between two of its graphs.
``state_dict`` gathers the split leaves whole (a collective: every rank
calls it) and ``load_state_dict`` keeps this rank's blocks, so a
checkpoint restores under any grid and serves on one card.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import torch
from torch import nn

from smd_tpu_torch.parallel import mesh as mesh_lib
from smd_tpu_torch.training.optimizer import Optimizer
from smd_tpu_torch.utils import graphs

__all__ = ["TrainState", "EarlyStopping"]


@dataclasses.dataclass(frozen=True)
class EarlyStopping:
    """Early-stopping state (the JAX package's, rule for rule)."""
    min_delta: float = 0.0
    patience: int = 0
    best_metric: float = float("inf")
    patience_count: int = 0
    should_stop: bool = False

    def update(self, metric):
        if math.isinf(self.best_metric) or \
                self.best_metric - metric > self.min_delta:
            return True, dataclasses.replace(self, best_metric=metric,
                                             patience_count=0)
        should_stop = self.patience_count >= self.patience or self.should_stop
        return False, dataclasses.replace(
            self, patience_count=self.patience_count + 1,
            should_stop=should_stop)


@dataclasses.dataclass
class TrainState:
    """Model + optimizer state + EMA + generator, changed in place."""
    model: nn.Module
    tx: Optimizer
    opt_state: dict
    ema_params: Optional[Dict[str, torch.Tensor]]
    generator: torch.Generator
    step: int = 0
    ema_mu: float = 0.999
    mesh: Optional[mesh_lib.Mesh] = None
    specs: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer, generator,
               ema: bool = True, ema_mu: float = 0.999, mesh=None,
               specs: Optional[Dict[str, tuple]] = None) -> "TrainState":
        params = dict(model.named_parameters())
        # The EMA starts as a copy of the params and stays float32.
        ema_params = ({n: p.detach().float().clone()
                       for n, p in params.items()} if ema else None)
        return cls(model=model, tx=tx, opt_state=tx.init(params),
                   ema_params=ema_params, generator=generator,
                   ema_mu=ema_mu, mesh=mesh, specs=dict(specs or {}))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        grad_norm: Optional[torch.Tensor] = None,
                        hyper: Optional[Dict[str, torch.Tensor]] = None):
        """Clip, Adam and the EMA update; returns the LR of the step.
        ``hyper``: the step's LR and bias corrections as device tensors
        (``Optimizer.apply``), in a captured step, which counts nothing:
        ``advance`` counts the steps of a chunk after it."""
        params = self.params
        lr = self.tx.apply(params, grads, self.opt_state, grad_norm, hyper)
        if self.ema_params is not None:
            mu = self.ema_mu
            names = list(params)
            ema = [self.ema_params[n] for n in names]
            with torch.no_grad():
                torch._foreach_mul_(ema, mu)
                torch._foreach_add_(ema, torch._foreach_mul(
                    [params[n].float() for n in names], 1 - mu))
        if hyper is None:
            self.step += 1
        return lr

    def advance(self, steps: int) -> None:
        """Count ``steps`` steps taken with ``hyper`` (a chunk's)."""
        self.step += steps
        self.opt_state["count"] += steps

    def descend(self, loss: torch.Tensor,
                hyper: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """One step on ``loss``: its gradient with respect to every param,
        their unclipped global norm, then ``apply_gradients``. Returns the
        metrics ``loss``, ``grad`` (device tensors) and ``lr`` (a float, or
        ``hyper``'s tensor). Under a data axis the gradients and the loss
        are the data group's means."""
        grads, loss = self.gradients(loss)
        grad_norm = self.global_norm(grads)
        lr = self.apply_gradients(grads, grad_norm, hyper)
        return {"loss": loss, "grad": grad_norm, "lr": lr}

    def tensors(self):
        """Every tensor a step writes: params, Adam moments, EMA."""
        return [*self.tx.tensors(self.params, self.opt_state),
                *(self.ema_params or {}).values()]

    def gradients(self, loss: torch.Tensor):
        """({name: gradient of ``loss``}, the loss detached); under a data
        axis both are the data group's means: ``mesh.pack``, summed over
        the group, ``mesh.unpack``. A split parameter's gradient is its
        block's."""
        params = self.params
        grads = torch.autograd.grad(loss, list(params.values()))
        loss = loss.detach()
        mesh = self.mesh
        if mesh is not None and mesh.data > 1:
            tensors = [*grads, loss]
            flat = mesh_lib.pack(tensors)
            graphs.collective(functools.partial(
                torch.distributed.all_reduce, flat, group=mesh.data_group),
                flat)
            *grads, loss = mesh_lib.unpack(flat, tensors, mesh.data)
        return dict(zip(params, grads)), loss

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients, in float32: the split
        leaves' squares summed over the model group, each replicated leaf
        counted once."""
        norms = torch._foreach_norm(list(grads.values()), 2,
                                    dtype=torch.float32)
        whole, split = [norms[0].new_zeros(())], [norms[0].new_zeros(())]
        for name, norm in zip(grads, norms):
            (split if name in self.specs else whole).append(norm)
        sharded = torch.stack(split).square().sum()
        if self.specs:
            graphs.collective(functools.partial(
                torch.distributed.all_reduce, sharded,
                group=self.mesh.model_group), sharded)
        return torch.sqrt(torch.stack(whole).square().sum() + sharded)

    @property
    def sampling_params(self) -> Dict[str, torch.Tensor]:
        """EMA params when enabled, else the live params."""
        if self.ema_params is not None:
            return self.ema_params
        return {n: p.detach() for n, p in self.params.items()}

    def _by_leaf(self, tree, fn):
        """``tree`` ({name: tensor}, or the optimizer state's nested dicts of
        them) with ``fn(tensor, spec)`` applied to each split leaf."""
        if not self.specs or tree is None:
            return tree
        return {k: (self._by_leaf(v, fn) if isinstance(v, dict) else
                    fn(v, self.specs[k]) if k in self.specs else v)
                for k, v in tree.items()}

    def state_dict(self) -> dict:
        """The whole state; the split leaves gathered whole (a collective
        under a model axis: every rank of the group calls it)."""
        def gather(tree):
            return self._by_leaf(tree, lambda t, spec: mesh_lib.gather_leaf(
                t, spec, self.mesh))

        return {"step": self.step,
                "params": gather({n: p.detach()
                                  for n, p in self.params.items()}),
                "opt_state": gather(self.opt_state),
                "ema_params": gather(self.ema_params),
                "generator": self.generator.get_state(),
                "generator_device": self.generator.device.type}

    def load_state_dict(self, saved: dict) -> "TrainState":
        """Load a whole state (any grid's), keeping this rank's blocks of
        the split leaves."""
        def blocks(tree):
            return self._by_leaf(tree, lambda t, spec: mesh_lib.slice_leaf(
                t, spec, self.mesh))

        def copy(into, tree):
            """``tree``'s tensors copied into ``into``'s, by name."""
            for k, v in tree.items():
                if isinstance(v, dict):
                    copy(into[k], v)
                elif torch.is_tensor(v):
                    into[k].copy_(v)
                else:
                    into[k] = v

        with torch.no_grad():
            copy(self.params, blocks(saved["params"]))
            copy(self.opt_state, blocks(saved["opt_state"]))
            if self.ema_params is not None:
                copy(self.ema_params, blocks(saved["ema_params"]))
        if saved["generator_device"] == self.generator.device.type:
            self.generator.set_state(saved["generator"])
        self.step = int(saved["step"])
        return self
