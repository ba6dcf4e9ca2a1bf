"""Chunks of training steps: one step captured in a CUDA graph and replayed
once a step (the port's counterpart of the JAX package's ``jax.jit`` over
``lax.scan``, ``make_train_chunk``).

The JAX package runs ``scan_chunk`` optimizer steps as one program, so the
host dispatches once for K steps. Here ``StepChunk`` captures ONE step in a
``torch.cuda.CUDAGraph`` and replays it K times: the host enqueues a replay
a step where the eager step launches 1,300-7,900 kernels.

- **Static slots.** The chunk's inputs (the ``(K, batch, ...)`` stack and
  any replayed draws) are staged with one host-to-device copy each into
  static buffers of ``slots`` rows, its per-step scalars (the LR, Adam's
  bias corrections, the scheduled-sampling probability) with one more into
  a ``(slots, n)`` float32 table. The captured step reads row ``i`` through
  a device index that it then advances, so every K up to ``slots`` replays
  the one graph: chunks cut short at a snapshot or at ``max_steps`` need no
  new capture. A larger K captures anew.
- **Metrics.** The step writes each metric into a static ``(slots,)`` row
  at ``i``; a chunk returns the first K entries of each row.
- **Warm-up without training.** PyTorch wants a few eager runs on a side
  stream before a capture. They run on the real state, which is saved
  first and restored after (the tensors ``mutable`` names and the
  generator's state), so the capture leaves the training where it was.
- **The generator.** The state's own CUDA generator is registered with the
  graph (``CUDAGraph.register_generator_state``); each replay reads its
  seed and offset and advances it as the eager step would, so a replay
  draws what the next eager step would draw.
- **Launch counters.** A capture launches nothing: the kernels' wrapper
  counts (``ops``) that the capture raised are taken back and added once
  at each replay. The warm-up's launches are real and stay counted.
- **Things that cannot be captured** raise with their name: a mode named
  in ``unsupported`` (``remat``, whose ``torch.utils.checkpoint`` saves the
  generator's state), autograd's anomaly mode (``debug_nans``: the loop
  checks the chunk's losses instead, as JAX's ``debug_nans`` does inside a
  scan), a state tensor rebound since the capture. On the card a capture or
  replay that fails raises; no chunk falls back to eager steps.

On a CPU the same step runs K times eagerly, reading its slots from the same
staged buffers: the plain version, which the tests hold against the JAX
package's chunk. The cached graph is keyed by the inputs' shapes and dtypes.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["StepChunk", "TrainChunk", "launch_counters", "uncapturable"]

WARMUP_STEPS = 2


def launch_counters():
    """(object, attribute) of every kernel wrapper's launch count."""
    from smd_tpu_torch.ops import flash_attention as fa
    from smd_tpu_torch.ops import fused_attention as fat
    from smd_tpu_torch.ops import fused_film_resblock as ffr
    from smd_tpu_torch.ops import quant_matmul as qmm
    return ((fat.fused_ln_attention, "launches"),
            (fat.fused_ln_attention, "tc_launches"),
            (ffr.fused_ln_film_swish_dense, "launches"),
            (qmm.w8a8_dense, "launches"),
            (qmm.transpose_weight, "launches"),
            (fa.flash_attention, "launches"))


def uncapturable(state):
    """The modes of ``state.model`` that a CUDA graph cannot capture:
    ``remat`` (``torch.utils.checkpoint`` reads the generator's state)."""
    return ("remat",) if any(getattr(m, "remat", False)
                             for m in state.model.modules()) else ()


def _read_counters():
    return [getattr(obj, attr) for obj, attr in launch_counters()]


def _add_counters(deltas):
    for (obj, attr), delta in zip(launch_counters(), deltas):
        setattr(obj, attr, getattr(obj, attr) + delta)


def _stack(values, device) -> torch.Tensor:
    """A (K, ...) stack (ndarray, tensor, or a sequence of either) as one
    tensor; host data pinned when it goes to a CUDA device."""
    if isinstance(values, (list, tuple)):
        if all(torch.is_tensor(v) for v in values):
            return torch.stack([v.to(device) for v in values])
        values = np.stack([np.asarray(v) for v in values])
    if torch.is_tensor(values):
        return values
    values = torch.from_numpy(np.ascontiguousarray(values))
    return values.pin_memory() if device.type == "cuda" else values


class _Slots:
    """The static buffers of one input layout, and its graph once
    captured."""

    def __init__(self, slots: int, inputs: Dict[str, torch.Tensor],
                 table_names: Sequence[str], device: torch.device):
        self.slots = slots
        self.inputs = {n: torch.empty((slots, *v.shape[1:]), dtype=v.dtype,
                                      device=device)
                       for n, v in inputs.items()}
        self.table_names = tuple(table_names)
        self.tables = torch.zeros((slots, len(self.table_names)),
                                  dtype=torch.float32, device=device)
        self.index = torch.zeros((1,), dtype=torch.long, device=device)
        self.rows: Optional[Dict[str, torch.Tensor]] = None
        self.graph = None
        self.deltas = None
        self.pointers = None

    def stage(self, inputs, tables):
        k = next(iter(inputs.values())).shape[0]
        for name, value in inputs.items():
            self.inputs[name][:k].copy_(value, non_blocking=True)
        table = np.stack([np.asarray(tables[n], np.float32)
                          for n in self.table_names], axis=1)
        table = torch.from_numpy(table)
        if self.tables.device.type == "cuda":
            table = table.pin_memory()
        self.tables[:k].copy_(table, non_blocking=True)
        self.index.zero_()

    def body(self, step):
        """One step on slot ``index``: its metrics written at ``index``,
        then the index advanced."""
        i = self.index
        slot = {n: buf.index_select(0, i)[0]
                for n, buf in self.inputs.items()}
        row = self.tables.index_select(0, i)[0]
        slot.update({n: row[j] for j, n in enumerate(self.table_names)})
        metrics = step(slot)
        if self.rows is None:
            self.rows = {n: torch.zeros((self.slots,), dtype=v.dtype,
                                        device=v.device)
                         for n, v in metrics.items()}
        for name, value in metrics.items():
            self.rows[name].index_copy_(0, i, value.detach().reshape(1))
        i.add_(1)

    def close(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.rows = None


class StepChunk:
    """K steps of ``step(slot) -> {name: 0-d tensor}``.

    ``slot`` maps each input's name to its row of the chunk (a batch, or a
    step's draws) and each table's name to its 0-d float32 value at this
    step. ``mutable()`` lists the tensors a step writes in place (saved and
    restored around the warm-up; their storage checked before each chunk);
    ``generator`` is the step's generator; ``unsupported`` names modes of
    the step that cannot be captured (raised on the card); ``label`` names
    the step in errors.
    """

    def __init__(self, step: Callable, mutable: Callable[[], List],
                 generator: Optional[torch.Generator], label: str,
                 unsupported: Sequence[str] = ()):
        self.step = step
        self.mutable = mutable
        self.generator = generator
        self.label = label
        self.unsupported = tuple(unsupported)
        self._cache: Dict[tuple, _Slots] = {}

    def __call__(self, inputs: Dict[str, object],
                 tables: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Run as many steps as the inputs' stacks have rows (K); returns
        each metric's (K,) row."""
        device = self.mutable()[0].device
        inputs = {n: _stack(v, device) for n, v in inputs.items()}
        k = next(iter(inputs.values())).shape[0]
        key = tuple((n, tuple(v.shape[1:]), v.dtype)
                    for n, v in inputs.items()) + tuple(sorted(tables))
        slots = self._cache.get(key)
        if slots is None or slots.slots < k:
            if slots is not None:
                slots.close()
            slots = self._cache[key] = _Slots(k, inputs, sorted(tables),
                                              device)
        slots.stage(inputs, tables)
        if device.type != "cuda":
            for _ in range(k):
                slots.body(self.step)
        else:
            if slots.graph is None:
                self._capture(slots)
            self._replay(slots, k)
        return {n: r[:k].clone() for n, r in slots.rows.items()}

    def close(self):
        """Free every captured graph and its memory pool."""
        for slots in self._cache.values():
            slots.close()
        self._cache.clear()

    def _capture(self, slots: _Slots):
        if self.unsupported:
            raise ValueError(
                f"the {self.label} cannot be captured in a CUDA graph with "
                f"{', '.join(self.unsupported)}; train with scan_chunk=1")
        if torch.is_anomaly_enabled():
            raise ValueError(
                f"the {self.label} cannot be captured in a CUDA graph under "
                "autograd's anomaly mode (debug_nans); the loop checks each "
                "chunk's losses instead")
        mutable = self.mutable()
        generator = self.generator
        gen_state = None if generator is None else generator.get_state()
        saved = [t.clone() for t in mutable]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    slots.index.zero_()
                    slots.body(self.step)
        finally:
            torch.cuda.current_stream().wait_stream(side)
            with torch.no_grad():
                torch._foreach_copy_(mutable, saved)
            if generator is not None:
                generator.set_state(gen_state)
        del saved
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = _read_counters()
        slots.index.zero_()
        try:
            with torch.cuda.graph(graph):
                slots.body(self.step)
        except Exception as e:
            raise RuntimeError(f"capturing the {self.label} in a CUDA graph "
                               f"failed: {e}") from e
        finally:
            if generator is not None:
                generator.set_state(gen_state)
        deltas = [a - b for a, b in zip(_read_counters(), before)]
        _add_counters([-d for d in deltas])
        slots.graph, slots.deltas = graph, deltas
        slots.pointers = [t.data_ptr() for t in mutable]

    def _replay(self, slots: _Slots, k: int):
        if [t.data_ptr() for t in self.mutable()] != slots.pointers:
            raise RuntimeError(
                f"a tensor of the {self.label}'s state was replaced since "
                "its CUDA graph was captured; write states in place")
        for _ in range(k):
            slots.graph.replay()
            _add_counters(slots.deltas)


class TrainChunk:
    """``train_chunk(state, batches, draws=None) -> (state, metrics)``: K
    steps of ``loss_fn(state, batch, draws)`` → ``state.descend`` on a
    ``TrainState``, through a ``StepChunk`` (captured on the card); the
    metrics ``loss``, ``grad`` and ``lr`` as (K,) rows.

    ``batches`` is a (K, batch, ...) stack (or K batches); ``draws`` a
    tuple of (K, ...) stacks of replayed draws (each step gets its row of
    each), or None to draw from ``state.generator``. The LR and Adam's bias
    corrections are staged per step (``Optimizer.tables``), and the state
    counts the K steps after them. What of the state's model cannot be
    captured raises on the card (``uncapturable``). ``close()`` frees the
    graph.
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
                state.generator, self.label, uncapturable(state))
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
