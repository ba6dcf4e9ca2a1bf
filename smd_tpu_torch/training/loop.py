"""The training loop (port of ``smd_tpu/training/loop.py``).

One loop: logging cadence, snapshot eval, checkpoint and resume, early
stopping, the max-steps cutoff and the forced final save. The
model-specific pieces (state, train and eval steps) are injected.

With ``train_chunk`` and ``scan_chunk`` K > 1 the loop takes its steps K
at a time, as the JAX loop runs K steps in one ``lax.scan`` dispatch: up to
K host batches are stacked and handed to ``train_chunk`` (on the card one
step captured in a CUDA graph and replayed K times, ``training/graphs.py``;
on the CPU K eager steps). Chunks are cut short where a snapshot or
``max_steps`` falls, so snapshots, checkpoints and the end land where the
per-step loop puts them; the loop logs at chunk granularity (the row of the
step that crosses a logging boundary), and ``debug_nans`` checks the
chunk's (K,) losses in place of autograd's anomaly mode, which a graph
cannot capture. Under a mesh the chunk runs on every rank, each on its
rows of the K step batches (the data iterables yield them, as for a step;
the ranks of a model group share theirs), every collective of the step
(the gradients' all-reduce over the data group, the column-parallel
gathers and reduces and the norm's all-reduce over the model group)
eagerly between the step's captured graphs (``utils/graphs.py``
``collective``). Every rank takes the same chunks in lockstep: the
warm-up steps before a capture run the collectives.

Under a ``parallel.mesh.Mesh`` every rank runs the loop in step: the eval
loss and its example count are summed over the data group, so early
stopping decides alike everywhere; every rank resumes from the newest
checkpoint and takes part in each save (the split leaves are gathered),
and rank 0 alone writes checkpoints, summaries and the profile, as the
JAX loop writes on process 0.
"""
from __future__ import annotations

import collections
import itertools
import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from smd_tpu_torch.parallel import mesh as mesh_lib
from smd_tpu_torch.training.state import EarlyStopping
from smd_tpu_torch.utils import checkpoints as ckpt_lib
from smd_tpu_torch.utils import logging as log_lib
from smd_tpu_torch.utils import profiling

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


def evaluate(eval_step, model, dataset: Iterable, generator=None,
             mesh=None):
    """Mean per-example loss over a dataset; ``eval_step`` returns a summed
    loss. Under ``mesh`` the sum and the count are the data group's."""
    device = next(model.parameters()).device
    count, total = 0, 0.0
    for batch in dataset:
        batch = torch.as_tensor(np.asarray(batch), device=device)
        total += float(eval_step(model, batch, generator))
        count += batch.shape[0]
    if mesh is not None and mesh.data > 1:
        sums = torch.tensor([total, count], dtype=torch.float64,
                            device=device)
        torch.distributed.all_reduce(sums, group=mesh.data_group)
        total, count = sums.tolist()
    return {"loss": total / max(count, 1)}


def run_loop(state,
             train_step: Callable,
             eval_step: Callable,
             train_data: Callable[[], Iterable],
             eval_data: Callable[[], Iterable],
             config,
             model_dir: Optional[str] = None,
             snapshot_callback: Optional[Callable] = None,
             step_callback: Optional[Callable] = None,
             mesh=None,
             train_chunk: Optional[Callable] = None):
    """Run the epoch/step loop; returns the final state.

    ``train_step(state, batch) -> (state, metrics)`` draws from
    ``state.generator``; ``eval_step(model, batch, generator) -> summed
    loss``. ``snapshot_callback(state, eval_metrics, sampling_step)`` runs at
    each snapshot, as in the JAX loop; ``step_callback(global_step,
    metrics)`` after each step, with the metrics as device tensors (read
    nothing back there unless you mean to wait for the device). ``mesh``:
    the ``parallel.mesh.Mesh`` the steps run over (see the module's
    docstring), or None for one rank. ``train_chunk(state, (K, batch, ...)
    stack) -> (state, (K,)-metrics)``: the steps K at a time when
    ``config.scan_chunk`` is K > 1 (see the module's docstring); then
    ``step_callback`` runs after each chunk, once for each of its steps.
    """
    scan_chunk = getattr(config, "scan_chunk", 1)
    use_chunk = train_chunk is not None and scan_chunk > 1
    debug_nans = getattr(config, "debug_nans", False)
    if debug_nans and not use_chunk:
        torch.autograd.set_detect_anomaly(True)
    profile_steps = getattr(config, "profile_steps", 0)
    profile_start = getattr(config, "profile_start_step", 10)
    profiler = None
    early_stop = EarlyStopping(patience=1)
    writes = mesh is None or mesh.rank == 0
    manager = train_writer = eval_writer = None
    saved_step = None
    if model_dir is not None:
        manager = ckpt_lib.CheckpointManager(f"{model_dir}/ckpt",
                                             keep=config.checkpoints_to_keep,
                                             write=writes)
        saved_step = manager.latest_step
        if config.resume and saved_step is not None:
            state = manager.restore_latest(state)
        if writes:
            train_writer = log_lib.SummaryWriter(f"{model_dir}/train")
            eval_writer = log_lib.SummaryWriter(f"{model_dir}/eval")

    device = next(state.model.parameters()).device
    global_step = state.step
    sampling_step = -1
    stop = False

    def handle_profiler():
        nonlocal profiler
        if profile_steps <= 0 or model_dir is None or not writes:
            return
        if profile_start <= global_step < profile_start + profile_steps \
                and profiler is None:
            profiler = profiling.Trace(f"{model_dir}/profile", device)
            profiler.start()
        elif profiler is not None and \
                global_step >= profile_start + profile_steps:
            profiler.stop()
            profiler = None

    def save(step):
        nonlocal saved_step
        manager.save(step, state)
        saved_step = step

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
                                    state.generator, mesh)
            log_lib.log_metrics(eval_metrics, global_step,
                                config.max_steps or -1,
                                summary_writer=eval_writer,
                                verbose=config.verbose and writes)
            improved, early_stop = early_stop.update(eval_metrics["loss"])

            if manager is not None and config.save_ckpt and \
                    (not config.early_stopping or improved):
                save(global_step)

            if snapshot_callback is not None:
                snapshot_callback(state, eval_metrics, sampling_step)

            if config.early_stopping and early_stop.should_stop:
                return True
        return at_end

    def run_chunks(start_time):
        """One epoch K steps at a time; returns stop."""
        nonlocal state, global_step
        it = iter(train_data())
        step_in_epoch = 0
        while True:
            if config.max_steps is not None and \
                    global_step >= config.max_steps:
                return True   # e.g. resumed from a completed run
            k = min(scan_chunk, config.snapshot_freq -
                    global_step % config.snapshot_freq)
            if config.max_steps is not None:
                k = min(k, config.max_steps - global_step)
            batches = [np.asarray(b) for b in itertools.islice(it, max(k, 1))]
            if not batches:
                return False   # epoch exhausted
            handle_profiler()
            state, metrics = train_chunk(state, batches)
            prev_step = global_step
            global_step += len(batches)
            step_in_epoch += len(batches)
            if debug_nans and not torch.isfinite(metrics["loss"]).all():
                raise FloatingPointError(
                    f"non-finite loss in steps {prev_step + 1} to "
                    f"{global_step}: {metrics['loss'].tolist()}")
            if step_callback is not None:
                for j in range(len(batches)):
                    step_callback(prev_step + j + 1,
                                  {n: v[j] for n, v in metrics.items()})
            if writes and (prev_step == 0 or prev_step // config.logging_freq
                           != global_step // config.logging_freq):
                log_train({n: v[-1] for n, v in metrics.items()},
                          step_in_epoch - 1, start_time)
            if snapshot_or_end():
                return True

    for _ in range(config.epochs):
        if stop:
            break
        start_time = time.time()
        if use_chunk:
            stop = run_chunks(start_time)
            continue
        for step, batch in enumerate(device_prefetch(train_data(), device)):
            if config.max_steps is not None and \
                    global_step >= config.max_steps:
                stop = True   # e.g. resumed from a completed run
                break
            handle_profiler()
            state, metrics = train_step(state, batch)
            global_step += 1
            if debug_nans and not torch.isfinite(metrics["loss"]):
                raise FloatingPointError(
                    f"non-finite loss at step {global_step}")
            if step_callback is not None:
                step_callback(global_step, metrics)

            if step % config.logging_freq == 0 and writes:
                log_train(metrics, step, start_time)

            stop = snapshot_or_end()
            if stop:
                break

    if profiler is not None:
        profiler.stop()
    if manager is not None:
        if saved_step != global_step:
            save(global_step)
        manager.wait()
        manager.close()
    for writer in (train_writer, eval_writer):
        if writer is not None:
            writer.flush()
    # The last checkpoint is on disk before any rank returns.
    mesh_lib.barrier(mesh)
    return state
