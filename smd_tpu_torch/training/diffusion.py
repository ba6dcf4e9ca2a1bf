"""Diffusion training harness (port of ``smd_tpu/training/diffusion.py``).

The step: loss → gradient → the gradients' unclipped global norm → clip →
Adam → float32 EMA, with the metrics ``loss``, ``grad`` and ``lr`` (as
device tensors, except the LR, a float). The JAX package jits this into one
program; here it is one eager step on the model's device. Its chunk of K
steps (``make_train_chunk``, JAX's ``lax.scan`` of the step) is the same
step captured in a CUDA graph and replayed K times on the card
(``training/graphs.py``), run eagerly on the CPU. ``fit`` builds the state
and hands it to ``loop.run_loop``, with the chunk when ``scan_chunk > 1``.

Under a ``parallel.mesh.Mesh`` (``mesh=``) each rank holds its rows of the
global batch. The JAX step draws the noise of the global batch from one
key and each device computes its rows; here each rank draws the global
batch's draws from the shared generator (every rank seeds it alike) and
keeps its own rows, so that two ranks together take the step one rank
takes on the concatenated batch. The gradients are averaged over the data
group (``TrainState.descend``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from smd_tpu_torch.diffusion import losses as losses_lib
from smd_tpu_torch.models.layers import init_parameters
from smd_tpu_torch.parallel import mesh as mesh_lib
from smd_tpu_torch.training import graphs
from smd_tpu_torch.training import loop as loop_lib
from smd_tpu_torch.training.optimizer import make_optimizer
from smd_tpu_torch.training.state import TrainState
from smd_tpu_torch.utils import logging as log_lib

__all__ = ["TrainConfig", "objective_by_name", "create_train_state",
           "make_loss_fn", "make_train_step", "make_train_chunk",
           "make_eval_step", "evaluate", "fit"]

OBJECTIVES = {
    "dsm": losses_lib.denoising_score_matching_loss,
    "ssm": losses_lib.sliced_score_matching_loss,
    "ddpm": losses_lib.diffusion_loss,
}


def objective_by_name(name: str) -> Callable:
    if name not in OBJECTIVES:
        raise ValueError(f"Unsupported objective {name}")
    return OBJECTIVES[name]


@dataclasses.dataclass
class TrainConfig:
    loss: str = "ddpm"
    continuous_noise: bool = True
    learning_rate: float = 1e-3
    batch_size: int = 64
    epochs: int = 10
    max_steps: Optional[int] = None
    early_stopping: bool = False
    grad_clip: float = 1.0
    lr_gamma: float = 0.98
    lr_schedule_interval: int = 10000
    lr_warmup: int = 0
    # Adam's first moment in bf16; the EMA always stays fp32.
    adam_m_bf16: bool = False
    ema: bool = True
    mu: float = 0.999
    logging_freq: int = 100
    snapshot_freq: int = 5000
    checkpoints_to_keep: int = 50
    save_ckpt: bool = True
    verbose: bool = True
    resume: bool = True
    # torch.profiler trace of this many steps (0 = off), and anomaly
    # detection with a finite-loss check.
    profile_steps: int = 0
    profile_start_step: int = 10
    debug_nans: bool = False
    # Steps a chunk (JAX: one lax.scan dispatch; here, K replays of the
    # step captured in a CUDA graph on the card, K eager steps on the CPU);
    # snapshots and checkpoints land at the same steps either way.
    scan_chunk: int = 1


def create_train_state(model, config: TrainConfig, seed: int = 0,
                       init: bool = True, mesh=None) -> TrainState:
    """The state of a fresh run: params drawn from ``seed`` (Flax's
    initializers; ``init=False`` keeps the model's current params, e.g.
    ones carried over from the JAX package), the optimizer's zero state,
    the EMA copy, and a generator on the model's device seeded with
    ``seed`` for the steps' draws.

    Under ``mesh`` the params must be equal on every rank (checked with a
    broadcast checksum); then each rank keeps its blocks of the split
    ones (``parallel.mesh.shard_params``), and the optimizer state and EMA
    are made of the blocks."""
    if init:
        init_parameters(model, seed)
    specs = {}
    if mesh is not None:
        mesh_lib.check_replicas_equal(model.parameters())
        specs = mesh_lib.shard_params(model, mesh)
    device = next(model.parameters()).device
    tx = make_optimizer(config.learning_rate, config.grad_clip,
                        config.lr_gamma, config.lr_schedule_interval,
                        config.lr_warmup, adam_m_bf16=config.adam_m_bf16)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState.create(model, tx, generator, ema=config.ema,
                             ema_mu=config.mu, mesh=mesh, specs=specs)


def _schedule(objective, sigmas):
    """``on(device) -> (sigmas, kwargs)``: the schedule as a float32 tensor
    and what the objective takes beside it (the DDPM loss's padded ᾱ
    table), copied to each device once, not at every step."""
    kwargs = {}
    if objective is losses_lib.diffusion_loss:
        kwargs["alphas_prod"] = losses_lib.padded_alphas_prod(sigmas)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32)
    cache = {}

    def on(device):
        if device not in cache:
            cache[device] = (sigmas.to(device),
                             {k: v.to(device) for k, v in kwargs.items()})
        return cache[device]

    return on


def _rank_draws(objective, sig, batch, generator, continuous_noise, draws,
                mesh):
    """This rank's rows of the global batch's draws: ``draws`` (global) as
    given, or drawn from ``generator`` for the global batch. Without a
    data axis, ``draws`` as given (None: the objective draws)."""
    if mesh is None or mesh.data == 1:
        return draws
    rows = batch.shape[0]
    if draws is None:
        draws = losses_lib.draws_for(
            objective, (rows * mesh.data, *batch.shape[1:]), sig, generator,
            continuous_noise, batch.device, batch.dtype)
    lo = mesh.data_index * rows
    return tuple(None if d is None else torch.as_tensor(d)[lo:lo + rows]
                 for d in draws)


def make_loss_fn(objective, sigmas, continuous_noise: bool, mesh=None):
    """``loss_fn(model, batch, generator, draws=None)``: the train step's
    mean loss of this rank's rows (see ``make_train_step``)."""
    schedule = _schedule(objective, sigmas)

    def loss_fn(model, batch, generator, draws=None):
        sig, kwargs = schedule(batch.device)
        draws = _rank_draws(objective, sig, batch, generator,
                            continuous_noise, draws, mesh)
        return objective(batch, model, sig, generator, continuous_noise,
                         "mean", draws=draws, **kwargs)

    return loss_fn


def make_train_step(objective, sigmas, continuous_noise: bool, mesh=None):
    """``train_step(state, batch, draws=None) -> (state, metrics)``.

    ``sigmas`` is the schedule: the betas for ``ddpm``, the noise levels for
    ``dsm`` and ``ssm``. ``draws`` replays pre-drawn draws (see each
    objective in ``diffusion/losses.py``); without it the step draws from
    ``state.generator``. Under ``mesh`` ``batch`` is this rank's rows and
    ``draws`` the global batch's.
    """
    loss_fn = make_loss_fn(objective, sigmas, continuous_noise, mesh)

    def train_step(state: TrainState, batch, draws=None):
        loss = loss_fn(state.model, batch, state.generator, draws)
        return state, state.descend(loss)

    return train_step


def make_train_chunk(objective, sigmas, continuous_noise: bool, mesh=None):
    """``train_chunk(state, batches, draws=None) -> (state, metrics)``: K
    train steps on a (K, batch, ...) stack, each metric a (K,) row (row i
    step i's), the LR and Adam's bias corrections staged per step
    (``graphs.TrainChunk``): on the card the step is captured in a CUDA
    graph once and replayed K times, on the CPU it runs K times. The steps
    draw from ``state.generator`` as K eager steps would, or replay
    ``draws`` (a tuple of (K, ...) stacks of the objective's draws). Under
    any ``mesh``, ``batches`` is this rank's rows of each step's global
    batch (``mesh.shard_chunk``; the ranks of a model group take the same
    rows) and ``draws`` the global batch's, as for ``make_train_step``;
    each of the step's collectives runs eagerly between two of its
    captured graphs (``graphs.TrainChunk``). A ``remat`` model's layers are
    recomputed inside the captured backward."""
    loss_fn = make_loss_fn(objective, sigmas, continuous_noise, mesh)
    return graphs.TrainChunk(
        lambda state, batch, draws: loss_fn(state.model, batch,
                                            state.generator, draws),
        "diffusion train step")


def make_eval_step(objective, sigmas, continuous_noise: bool, mesh=None):
    """``eval_step(model, batch, generator) -> summed loss`` (this rank's
    rows' under ``mesh``, with the global batch's draws, as the train
    step)."""
    schedule = _schedule(objective, sigmas)

    @torch.no_grad()
    def eval_step(model, batch, generator=None, draws=None):
        sig, kwargs = schedule(batch.device)
        draws = _rank_draws(objective, sig, batch, generator,
                            continuous_noise, draws, mesh)
        return objective(batch, model, sig, generator, continuous_noise,
                         "sum", draws=draws, **kwargs)

    return eval_step


evaluate = loop_lib.evaluate


def fit(model,
        sigmas,
        train_data: Callable[[], Iterable],
        eval_data: Callable[[], Iterable],
        input_shape,
        config: TrainConfig,
        model_dir: Optional[str] = None,
        mesh=None,
        seed: int = 0,
        snapshot_callback: Optional[Callable] = None,
        step_callback: Optional[Callable] = None):
    """Train a diffusion model; see ``loop.run_loop`` for the loop.

    Args:
        model: the port's module with ``(x, cond)`` signature, on the device
            to train on; its params are drawn anew from ``seed``.
        sigmas: noise schedule (the DDPM betas, or the sigmas of dsm and
            ssm).
        train_data/eval_data: zero-arg callables returning a fresh iterable
            of numpy batches per epoch.
        input_shape: per-example shape, e.g. (32, 42); the JAX signature's,
            where the model's shapes come from its init.
        mesh: a ``parallel.mesh.Mesh`` to train over (each rank's data
            iterables yield its rows), or None for one rank.
        snapshot_callback, step_callback: see ``loop.run_loop``.

    Returns:
        The final TrainState.
    """
    del input_shape
    state = create_train_state(model, config, seed, mesh=mesh)
    log_lib.report_params(state.params)
    objective = objective_by_name(config.loss)
    train_step = make_train_step(objective, sigmas, config.continuous_noise,
                                 mesh)
    eval_step = make_eval_step(objective, sigmas, config.continuous_noise,
                               mesh)
    train_chunk = (make_train_chunk(objective, sigmas,
                                    config.continuous_noise, mesh)
                   if config.scan_chunk > 1 else None)
    return loop_lib.run_loop(state, train_step, eval_step, train_data,
                             eval_data, config, model_dir=model_dir,
                             mesh=mesh, snapshot_callback=snapshot_callback,
                             step_callback=step_callback,
                             train_chunk=train_chunk)
