"""Autoregressive Transformer-MDN training harness (port of
``smd_tpu/training/mdn.py``).

The objective is the teacher-forced mixture NLL (``losses.mdn_nll``); the
step is the diffusion harness's: gradient, the gradients' unclipped global
norm, clip and Adam, with the metrics ``loss``, ``grad`` and ``lr``. The
reference MDN has no EMA. ``make_train_chunk`` takes the steps
``scan_chunk`` at a time, as the JAX package's scans them in one dispatch:
one step captured in a CUDA graph and replayed on the card, eager steps on
the CPU (``training/graphs.py``, through ``loop.run_loop``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from smd_tpu_torch.diffusion.losses import mdn_nll
from smd_tpu_torch.training import diffusion as dtrainer
from smd_tpu_torch.training import graphs
from smd_tpu_torch.training import loop as loop_lib
from smd_tpu_torch.training.diffusion import TrainConfig
from smd_tpu_torch.training.state import TrainState
from smd_tpu_torch.utils import logging as log_lib

__all__ = ["create_train_state", "make_train_step", "make_train_chunk",
           "make_eval_step", "fit"]


def create_train_state(model, config: TrainConfig, seed: int = 0,
                       init: bool = True, mesh=None) -> TrainState:
    """The diffusion harness's state without the EMA, whatever
    ``config.ema`` says: the reference MDN checkpoints no EMA. ``mesh``:
    see ``diffusion.create_train_state``."""
    return dtrainer.create_train_state(
        model, dataclasses.replace(config, ema=False), seed, init, mesh)


def make_train_step(mesh=None):
    """``train_step(state, batch) -> (state, metrics)``: one step on the
    teacher-forced NLL, averaged over every position of the batch. The
    objective draws nothing and the state averages the gradients over the
    data group, so ``mesh`` changes nothing here: it is taken to match the
    JAX signature."""
    del mesh

    def train_step(state: TrainState, batch):
        return state, state.descend(_loss(state, batch))

    return train_step


def _loss(state: TrainState, batch, draws=None):
    """The teacher-forced NLL's mean over the batch's positions."""
    del draws
    pi, mu, log_sigma = state.model(batch)
    return mdn_nll(pi, mu, log_sigma, batch, "mean")


def make_train_chunk(mesh=None) -> graphs.TrainChunk:
    """``train_chunk(state, batches) -> (state, metrics)``: ``scan_chunk``
    train steps on a (K, batch, ...) stack, each metric a (K,) row (JAX's
    ``make_train_chunk``; see ``diffusion.make_train_chunk``). Under any
    ``mesh`` ``batches`` is this rank's rows of each step's batch
    (``mesh.shard_chunk``), each of the step's collectives eager between
    two of its captured graphs. The objective draws nothing, so ``mesh``
    changes nothing else here."""
    del mesh
    return graphs.TrainChunk(_loss, "MDN train step")


def make_eval_step(mesh=None):
    """``eval_step(model, batch, generator=None) -> NLL summed over the
    batch's positions, over the sequence length``: each example's mean NLL
    a position, summed (this rank's rows' under a mesh; the loop sums the
    ranks'). ``mesh`` is taken to match the JAX signature."""
    del mesh

    @torch.no_grad()
    def eval_step(model, batch, generator=None):
        del generator
        pi, mu, log_sigma = model(batch)
        return mdn_nll(pi, mu, log_sigma, batch, "sum") / batch.shape[1]

    return eval_step


def fit(model,
        train_data: Callable[[], Iterable],
        eval_data: Callable[[], Iterable],
        input_shape,
        config: TrainConfig,
        model_dir: Optional[str] = None,
        mesh=None,
        seed: int = 0,
        snapshot_callback: Optional[Callable] = None,
        step_callback: Optional[Callable] = None):
    """Train a TransformerMDN; see ``loop.run_loop`` for the loop.

    ``model`` is on the device to train on; its params are drawn anew from
    ``seed``. ``input_shape`` is the JAX signature's per-example shape,
    where the model's shapes come from its init. ``mesh``: see
    ``diffusion.fit``. Returns the final TrainState.
    """
    del input_shape
    state = create_train_state(model, config, seed, mesh=mesh)
    log_lib.report_params(state.params)
    train_chunk = make_train_chunk(mesh) if config.scan_chunk > 1 else None
    return loop_lib.run_loop(state, make_train_step(mesh),
                             make_eval_step(mesh), train_data, eval_data,
                             config, model_dir=model_dir, mesh=mesh,
                             snapshot_callback=snapshot_callback,
                             step_callback=step_callback,
                             train_chunk=train_chunk)
