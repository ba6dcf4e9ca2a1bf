"""Diffusion training harness (port of ``smd_tpu/training/diffusion.py``).

The step: loss → gradient → the gradients' unclipped global norm → clip →
Adam → float32 EMA, with the metrics ``loss``, ``grad`` and ``lr`` (as
device tensors, except the LR, a float). The JAX package jits this into one
program; here it is one eager step on the model's device. ``fit`` builds
the state and hands it to ``loop.run_loop``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from smd_tpu_torch.diffusion import losses as losses_lib
from smd_tpu_torch.models.layers import init_parameters
from smd_tpu_torch.training import loop as loop_lib
from smd_tpu_torch.training.optimizer import make_optimizer
from smd_tpu_torch.training.state import TrainState
from smd_tpu_torch.utils import logging as log_lib

__all__ = ["TrainConfig", "objective_by_name", "create_train_state",
           "make_train_step", "make_eval_step", "evaluate", "fit"]

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
    # Steps a dispatch in the JAX package; the port launches each step on
    # its own and keeps the same snapshot and checkpoint steps.
    scan_chunk: int = 1


def create_train_state(model, config: TrainConfig, seed: int = 0,
                       init: bool = True) -> TrainState:
    """The state of a fresh run: params drawn from ``seed`` (Flax's
    initializers; ``init=False`` keeps the model's current params, e.g.
    ones carried over from the JAX package), the optimizer's zero state,
    the EMA copy, and a generator on the model's device seeded with
    ``seed`` for the steps' draws."""
    if init:
        init_parameters(model, seed)
    device = next(model.parameters()).device
    tx = make_optimizer(config.learning_rate, config.grad_clip,
                        config.lr_gamma, config.lr_schedule_interval,
                        config.lr_warmup, adam_m_bf16=config.adam_m_bf16)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState.create(model, tx, generator, ema=config.ema,
                             ema_mu=config.mu)


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


def make_train_step(objective, sigmas, continuous_noise: bool):
    """``train_step(state, batch, draws=None) -> (state, metrics)``.

    ``sigmas`` is the schedule: the betas for ``ddpm``, the noise levels for
    ``dsm`` and ``ssm``. ``draws`` replays pre-drawn draws (see each
    objective in ``diffusion/losses.py``); without it the step draws from
    ``state.generator``.
    """
    schedule = _schedule(objective, sigmas)

    def train_step(state: TrainState, batch, draws=None):
        sig, kwargs = schedule(batch.device)
        loss = objective(batch, state.model, sig, state.generator,
                         continuous_noise, "mean", draws=draws, **kwargs)
        return state, state.descend(loss)

    return train_step


def make_eval_step(objective, sigmas, continuous_noise: bool):
    """``eval_step(model, batch, generator) -> summed loss``."""
    schedule = _schedule(objective, sigmas)

    @torch.no_grad()
    def eval_step(model, batch, generator=None, draws=None):
        sig, kwargs = schedule(batch.device)
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
        snapshot_callback, step_callback: see ``loop.run_loop``.

    Returns:
        The final TrainState.
    """
    del input_shape
    state = create_train_state(model, config, seed)
    log_lib.report_params(state.params)
    objective = objective_by_name(config.loss)
    train_step = make_train_step(objective, sigmas, config.continuous_noise)
    eval_step = make_eval_step(objective, sigmas, config.continuous_noise)
    return loop_lib.run_loop(state, train_step, eval_step, train_data,
                             eval_data, config, model_dir=model_dir,
                             snapshot_callback=snapshot_callback,
                             step_callback=step_callback)
