"""The training loop (port of ``smd_tpu/training/loop.py``).

One loop: logging cadence, snapshot eval, checkpoint and resume, early
stopping, the max-steps cutoff and the forced final save. The
model-specific pieces (state, train and eval steps) are injected.

The JAX loop fuses ``scan_chunk`` steps into one ``lax.scan`` dispatch; the
port launches every step on its own, so ``scan_chunk`` changes nothing
here: snapshots and checkpoints land at ``snapshot_freq`` and ``max_steps``
either way, which is what the chunked JAX loop preserves. Capturing the
step in a CUDA graph is queued in ``ROADMAP.md`` (D.2).
"""
from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from smd_tpu_torch.training.state import EarlyStopping
from smd_tpu_torch.utils import checkpoints as ckpt_lib
from smd_tpu_torch.utils import logging as log_lib

__all__ = ["evaluate", "run_loop", "device_prefetch"]

log = logging.getLogger("smd_tpu_torch")


def device_prefetch(iterator, device, size: int = 2):
    """Keep ``size`` batches in flight on ``device`` ahead of compute.

    On a CUDA device each host batch is pinned and copied without blocking,
    so the copy of the next batch runs while the current step computes.
    """
    device = torch.device(device)
    queue = collections.deque()

    def put(batch):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cuda":
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def evaluate(eval_step, model, dataset: Iterable, generator=None):
    """Mean per-example loss over a dataset; ``eval_step`` returns a summed
    loss."""
    device = next(model.parameters()).device
    count, total = 0, 0.0
    for batch in dataset:
        batch = torch.as_tensor(np.asarray(batch), device=device)
        total += float(eval_step(model, batch, generator))
        count += batch.shape[0]
    return {"loss": total / max(count, 1)}


def run_loop(state,
             train_step: Callable,
             eval_step: Callable,
             train_data: Callable[[], Iterable],
             eval_data: Callable[[], Iterable],
             config,
             model_dir: Optional[str] = None,
             snapshot_callback: Optional[Callable] = None,
             step_callback: Optional[Callable] = None):
    """Run the epoch/step loop; returns the final state.

    ``train_step(state, batch) -> (state, metrics)`` draws from
    ``state.generator``; ``eval_step(model, batch, generator) -> summed
    loss``. ``snapshot_callback(state, eval_metrics, sampling_step)`` runs at
    each snapshot, as in the JAX loop; ``step_callback(global_step,
    metrics)`` after each step, with the metrics as device tensors (read
    nothing back there unless you mean to wait for the device).
    """
    if getattr(config, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
    profile_steps = getattr(config, "profile_steps", 0)
    profile_start = getattr(config, "profile_start_step", 10)
    profiler = None
    early_stop = EarlyStopping(patience=1)
    manager = train_writer = eval_writer = None
    if model_dir is not None:
        manager = ckpt_lib.CheckpointManager(f"{model_dir}/ckpt",
                                             keep=config.checkpoints_to_keep)
        if config.resume and manager.latest_step is not None:
            state = manager.restore_latest(state)
        train_writer = log_lib.SummaryWriter(f"{model_dir}/train")
        eval_writer = log_lib.SummaryWriter(f"{model_dir}/eval")

    device = next(state.model.parameters()).device
    global_step = state.step
    sampling_step = -1
    stop = False

    def handle_profiler():
        nonlocal profiler
        if profile_steps <= 0 or model_dir is None:
            return
        if profile_start <= global_step < profile_start + profile_steps \
                and profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    f"{model_dir}/profile"))
            profiler.start()
        elif profiler is not None and \
                global_step >= profile_start + profile_steps:
            profiler.stop()
            profiler = None

    def log_train(metrics, step_in_epoch, start_time):
        elapsed = time.time() - start_time
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["batch/s"] = (step_in_epoch + 1) / elapsed
        metrics["ms/batch"] = elapsed * 1000 / (step_in_epoch + 1)
        log_lib.log_metrics(metrics, global_step, config.max_steps or -1,
                            epoch=None, summary_writer=train_writer,
                            verbose=config.verbose)

    def snapshot_or_end():
        """Eval + checkpoint + early-stop bookkeeping; returns stop."""
        nonlocal sampling_step, early_stop
        at_snapshot = (global_step % config.snapshot_freq == 0
                       and global_step > 0)
        at_end = (config.max_steps is not None
                  and global_step >= config.max_steps)
        if at_snapshot or at_end:
            sampling_step += 1
            eval_metrics = evaluate(eval_step, state.model, eval_data(),
                                    state.generator)
            log_lib.log_metrics(eval_metrics, global_step,
                                config.max_steps or -1,
                                summary_writer=eval_writer,
                                verbose=config.verbose)
            improved, early_stop = early_stop.update(eval_metrics["loss"])

            if manager is not None and config.save_ckpt and \
                    (not config.early_stopping or improved):
                manager.save(global_step, state)

            if snapshot_callback is not None:
                snapshot_callback(state, eval_metrics, sampling_step)

            if config.early_stopping and early_stop.should_stop:
                return True
        return at_end

    for _ in range(config.epochs):
        if stop:
            break
        start_time = time.time()
        for step, batch in enumerate(device_prefetch(train_data(), device)):
            if config.max_steps is not None and \
                    global_step >= config.max_steps:
                stop = True   # e.g. resumed from a completed run
                break
            handle_profiler()
            state, metrics = train_step(state, batch)
            global_step += 1
            if getattr(config, "debug_nans", False) and \
                    not torch.isfinite(metrics["loss"]):
                raise FloatingPointError(
                    f"non-finite loss at step {global_step}")
            if step_callback is not None:
                step_callback(global_step, metrics)

            if step % config.logging_freq == 0:
                log_train(metrics, step, start_time)

            stop = snapshot_or_end()
            if stop:
                break

    if profiler is not None:
        profiler.stop()
    if manager is not None:
        if manager.latest_step != global_step:
            manager.save(global_step, state, force=True)
        manager.wait()
        manager.close()
    for writer in (train_writer, eval_writer):
        if writer is not None:
            writer.flush()
    return state
