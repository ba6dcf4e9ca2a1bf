"""The MusicVAE codec's train and eval steps (the steps that the JAX
package's ``scripts/train_musicvae.py`` defines inline, ``:278-345``).

A train step one-hots the batch of token ids, takes the negative ELBO
(``codec.musicvae.elbo_loss``) with scheduled sampling at ``ss_prob``, its
gradient with respect to every parameter, then clips by the global norm 1.0
and takes an Adam step on the warmup-cosine schedule that decays to 0.02 of
the peak (``make_optimizer``): optax's ``chain(clip_by_global_norm(1.0),
adam(warmup_cosine_decay_schedule(0, lr, warmup, steps, end_value=0.02 *
lr)))``. An eval step reads the teacher-forced accuracy and the free-running
round-trip accuracy (the posterior mean decoded at temperature 1e-3), over
all rows and over the rows whose label is not PAD (token 0).

The draws (the encoder's noise, the scheduled-sampling and decode draws)
come from ``generator`` unless given as ``noise``, ``gumbel`` and
``ss_mix`` (see ``codec.musicvae.Decoder``), which is how the tests replay
JAX's.

``make_train_chunk`` takes the steps K at a time, as the JAX script scans
``--scan_chunk`` steps in one dispatch: on the card one step captured in a
CUDA graph (the decoder's Python loop of steps with its Gumbel and
Bernoulli draws included) and replayed K times, with the LR, Adam's bias
corrections and the scheduled-sampling probability staged as per-step
tables; on the CPU K eager steps (``training/graphs.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from smd_tpu_torch.codec.musicvae import MusicVAE, elbo_loss
from smd_tpu_torch.training import graphs
from smd_tpu_torch.training.optimizer import (Optimizer,
                                              warmup_cosine_decay_schedule)

__all__ = ["make_optimizer", "one_hot", "train_step", "make_train_chunk",
           "eval_step"]

END_FRACTION = 0.02   # the codec trainer's cosine end value, of the peak


def make_optimizer(learning_rate: float, warmup_steps: int,
                   steps: int) -> Optimizer:
    """Clip at global norm 1.0, then Adam on the codec's schedule: linear
    warmup over ``min(warmup_steps, max(steps // 10, 1))`` steps, then a
    cosine decay to 0.02 of ``learning_rate`` at ``steps``."""
    warmup = min(warmup_steps, max(steps // 10, 1))
    return Optimizer(warmup_cosine_decay_schedule(
        learning_rate, warmup, steps, end_fraction=END_FRACTION),
        grad_clip=1.0)


def one_hot(batch: torch.Tensor, depth: int) -> torch.Tensor:
    """Float32 one-hot rows of a batch of token ids (B, T); a batch that is
    one-hot already (B, T, depth) is returned as float32."""
    if batch.ndim == 2:
        return torch.nn.functional.one_hot(batch.long(), depth).float()
    return batch.float()


def train_step(model: MusicVAE, optimizer: Optimizer, opt_state: dict,
               batch: torch.Tensor, ss_prob: float = 0.0,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               gumbel: Optional[torch.Tensor] = None,
               ss_mix: Optional[torch.Tensor] = None,
               hyper: Optional[Dict[str, torch.Tensor]] = None):
    """One optimizer step, in place on the model's parameters and on
    ``opt_state``; returns (loss, {"rec", "kl"}) as device tensors.
    ``hyper``: the step's LR and bias corrections as tensors
    (``Optimizer.apply``), as a captured step takes them."""
    cfg = model.config
    x = one_hot(batch, cfg.depth)
    logits, mu, sigma = model(x, generator, noise, ss_prob, gumbel, ss_mix)
    loss, aux = elbo_loss(logits, x, mu, sigma, free_bits=cfg.free_bits,
                          beta=cfg.beta)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.apply(params, dict(zip(params, grads)), opt_state, hyper=hyper)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def make_train_chunk(model: MusicVAE, optimizer: Optimizer, opt_state: dict,
                     generator: Optional[torch.Generator] = None,
                     scheduled_sampling: bool = False):
    """``train_chunk(batches, ss_probs) -> {"loss", "rec", "kl", "lr"}``:
    ``train_step`` on each batch of a (K, B, T[, depth]) stack, each step's
    scheduled-sampling probability from ``ss_probs`` (K floats), each
    metric a (K,) row; ``opt_state``'s count advanced by K. With
    ``scheduled_sampling`` every step draws the scheduled-sampling tokens
    (its probability a tensor, as in JAX's scan), else none does (the
    probabilities must then be 0). ``train_chunk.close()`` frees the
    graph."""
    params = dict(model.named_parameters())

    def step(slot):
        loss, aux = train_step(
            model, optimizer, opt_state, slot["batch"],
            slot["ss_prob"] if scheduled_sampling else 0.0, generator,
            hyper=slot)
        return {"loss": loss, **aux, "lr": slot["lr"]}

    chunk = graphs.StepChunk(
        step, lambda: optimizer.tensors(params, opt_state), generator,
        "codec train step")

    def train_chunk(batches, ss_probs):
        ss_probs = np.asarray(ss_probs, np.float32)
        if not scheduled_sampling and ss_probs.any():
            raise ValueError("scheduled-sampling probabilities above 0 "
                             "need scheduled_sampling=True")
        k = len(ss_probs)
        tables = optimizer.tables(opt_state["count"], k)
        tables["ss_prob"] = ss_probs
        metrics = chunk({"batch": batches}, tables)
        opt_state["count"] += k
        return metrics

    train_chunk.close = chunk.close
    return train_chunk


@torch.no_grad()
def eval_step(model: MusicVAE, batch: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None,
              gumbel: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """Teacher-forced and round-trip accuracy of one batch, float32 device
    scalars: ``tf_acc``, ``fr_acc`` over every row, ``tf_acc_nonpad``,
    ``fr_acc_nonpad`` over the rows whose label is not token 0 (every row
    when the batch is one-hot already, as in the JAX trainer)."""
    x = one_hot(batch, model.config.depth)
    logits, mu, _ = model(x, generator, noise)
    labels = x.argmax(-1)
    mask = labels != 0 if batch.ndim == 2 else torch.ones_like(
        labels, dtype=torch.bool)
    count = mask.sum().clamp_min(1).float()
    tf_hit = logits.argmax(-1) == labels
    _, samples = model.decode(mu, 1e-3, generator=generator, gumbel=gumbel)
    fr_hit = samples == labels
    return {"tf_acc": tf_hit.float().mean(),
            "fr_acc": fr_hit.float().mean(),
            "tf_acc_nonpad": (tf_hit & mask).sum().float() / count,
            "fr_acc_nonpad": (fr_hit & mask).sum().float() / count}
