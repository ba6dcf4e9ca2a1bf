"""Chunks of training steps: one step captured in a CUDA graph and replayed
once a step (the port's counterpart of the JAX package's ``jax.jit`` over
``lax.scan``, ``make_train_chunk``).

The JAX package runs ``scan_chunk`` optimizer steps as one program, so the
host dispatches once for K steps. ``TrainChunk`` runs them through a
``StepChunk`` (``utils/graphs.py``, which the sampler chains share), which
captures ONE step in a ``torch.cuda.CUDAGraph`` and replays it K times: the
host enqueues a replay a step where the eager step launches 1,300-7,900
kernels.

- **Static slots.** The chunk's inputs (the ``(K, batch, ...)`` stack and
  any replayed draws) are staged into static buffers of ``slots`` rows, its
  per-step scalars (the LR, Adam's bias corrections, the scheduled-sampling
  probability) into a ``(slots, n)`` float32 table, so every K up to
  ``slots`` replays the one graph: chunks cut short at a snapshot or at
  ``max_steps`` need no new capture.
- **Metrics.** The step writes each metric into a static ``(slots,)`` row
  at ``i``; a chunk returns the first K entries of each row.
- **Warm-up without training.** The warm-up steps before a capture run on
  the real state, which is saved first and restored after (the tensors
  ``state.tensors`` names and the generator's state).
- **The generator.** The state's own CUDA generator is registered with the
  graph, so a replay draws what the next eager step would draw.
- **Across ranks.** Under any (data, model) mesh every collective of the
  step goes through ``utils/graphs.collective``, which cuts the capture
  there: the step is captured as a list of graphs and each collective runs
  eagerly between two of them, on its group, with whichever backend it
  has. On a model axis those are each column-parallel Dense's all-gather
  in the forward and its input gradient's all-reduce in the backward
  (``parallel/column.py``; the backward's cuts fall on autograd's device
  thread) and the norm's all-reduce; on a data axis the flat all-reduce
  of the gradients and the loss (``TrainState.gradients``). The same
  arithmetic as the per-step run: a chunk is bit-equal to the ranks'
  single steps.
- **Remat.** A model built with ``remat`` checkpoints each transformer
  layer (``models/ddpm.py``, as JAX's ``nn.remat`` under ``lax.scan``):
  the captured forward keeps no layer activations, and the captured
  backward runs each layer again on autograd's device thread, its kernels
  (``fused_ln_attention`` in the fused layout) launched a second time, its
  memory from the graph's pool and its launches counted at each replay.
  The checkpoint stashes no generator state, since a layer draws nothing.
  On a model axis the recompute's all-gathers cut the capture like the
  forward's.
- **Things that cannot be captured** raise: autograd's anomaly mode
  (``debug_nans``: the loop checks the chunk's losses instead, as JAX's
  ``debug_nans`` does inside a scan), a state tensor rebound since the
  capture. On the card a capture or replay that fails raises; no chunk
  falls back to eager steps.

On a CPU the same step runs K times eagerly, reading its slots from the same
staged buffers: the plain version, which the tests hold against the JAX
package's chunk. The cached graph is keyed by the inputs' shapes and dtypes.
"""
from __future__ import annotations

from typing import Callable

from smd_tpu_torch.utils.graphs import StepChunk

__all__ = ["StepChunk", "TrainChunk"]


class TrainChunk:
    """``train_chunk(state, batches, draws=None) -> (state, metrics)``: K
    steps of ``loss_fn(state, batch, draws)`` → ``state.descend`` on a
    ``TrainState``, through a ``StepChunk`` (captured on the card); the
    metrics ``loss``, ``grad`` and ``lr`` as (K,) rows.

    ``batches`` is a (K, batch, ...) stack (or K batches); ``draws`` a
    tuple of (K, ...) stacks of replayed draws (each step gets its row of
    each), or None to draw from ``state.generator``. The LR and Adam's bias
    corrections are staged per step (``Optimizer.tables``), and the state
    counts the K steps after them. ``close()`` frees the graph.
    """

    def __init__(self, loss_fn: Callable, label: str):
        self.loss_fn = loss_fn
        self.label = label
        self._state = self._chunk = None

    def __call__(self, state, batches, draws=None):
        if self._state is not state:
            self.close()
            self._state = state
            self._chunk = StepChunk(
                lambda slot: self._step(state, slot), state.tensors,
                state.generator, self.label)
        inputs = {"batch": batches}
        if draws is not None:
            inputs.update({f"draw{j}": d for j, d in enumerate(draws)})
        k = len(batches)
        metrics = self._chunk(inputs, state.tx.tables(
            state.opt_state["count"], k))
        state.advance(k)
        return state, metrics

    def _step(self, state, slot):
        draws = tuple(slot[n] for n in sorted(slot)
                      if n.startswith("draw")) or None
        loss = self.loss_fn(state, slot["batch"], draws)
        return state.descend(loss, hyper=slot)

    def close(self):
        if self._chunk is not None:
            self._chunk.close()
        self._state = self._chunk = None
