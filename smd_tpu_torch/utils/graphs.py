"""Steps captured in a CUDA graph and replayed once a step: the port's
counterpart of the JAX package's ``lax.scan`` programs, for the trainers'
chunks (``training/graphs.py``, ``make_train_chunk``) and for the sampler
chains and MDN decodes (``diffusion/samplers.py``,
``sampling/mdn_decode.py``).

The JAX package runs K steps as one program, so the host dispatches once
for K steps. Here ``StepChunk`` captures ONE step in a
``torch.cuda.CUDAGraph`` and replays it K times: the host enqueues a replay
a step where the eager step launches hundreds to thousands of kernels.

- **Static slots.** A chunk's per-step inputs (a ``(K, batch, ...)`` stack,
  replayed draws) are staged with one host-to-device copy each into static
  buffers of ``slots`` rows, its per-step scalars with one more into a
  ``(slots, n)`` float32 table. The captured step reads row ``i`` through a
  device index that it then advances, so every K up to ``slots`` replays
  the one graph. A larger K captures anew.
- **Per-call buffers** (``statics``: a chain's state, its snapshot
  collection, the infill samples and masks, a KV cache) are copied into
  static buffers at every call and may be written in place by the step;
  ``StepChunk.statics()`` reads them after the call. A value may be an
  expanded zero (``zeros``), which costs no memory to stage from.
- **Variants.** A step whose work depends on the step (a draw made only
  before the last step, the first step of a chain) names a hashable
  ``variant`` per step; each variant is its own graph, all in one memory
  pool, replayed in the order the steps ask for them.
- **Metrics.** The step writes each metric (a tensor of any shape) into a
  static ``(slots, ...)`` row at ``i``; a chunk returns the first K rows.
- **Warm-up without side effects.** PyTorch wants a few eager runs on a
  side stream before a capture: ``WARMUP_STEPS`` a graph, counted in
  ``warmup_steps``. They run on the real state, which is saved first and
  restored after (the tensors ``mutable`` names, the generator's state, the
  staged buffers), so the capture leaves everything where it was.
- **The generator.** The step's CUDA generator is registered with each
  graph (``CUDAGraph.register_generator_state``); a replay reads its seed
  and offset and advances it as the eager step would.
- **Launch counters.** A capture launches nothing: the kernels' wrapper
  counts (``ops``) that a capture raised are taken back and added once at
  each replay. The warm-up's launches are real and stay counted.
- **Collectives cut the capture.** Every ``torch.distributed`` call on a
  step's path goes through ``collective(fn, *buffers)``: outside a capture
  it calls ``fn()`` at once (the CPU, eager steps, the warm-up, so every
  rank of a group runs them in lockstep); inside one it ends the running
  graph, records ``(fn, buffers)`` (the buffers stay alive, so their
  memory in the pool is never handed out again) and begins the next graph
  in the same pool, ``fn`` not run. A step is then a list of graphs, each
  captured in turn, and a replay runs graph 0, ``fn`` 0, graph 1, ...
  (gloo cannot run inside a capture, and NCCL refuses two ranks on one
  card). A cut may fall on autograd's device thread (a collective in an
  ``autograd.Function``'s backward): the graphs are captured in CUDA's
  relaxed mode, which lets a thread end a capture that another began, and
  that thread's current stream is the capture stream, where the forward
  ran.
- **Recomputed layers.** A step whose model checkpoints its layers
  (``remat``) runs each layer again in its backward, on autograd's device
  thread: the recompute's launches go to the capture stream, its memory
  comes from the graph's pool, its kernel launches are counted with the
  rest of the capture's, and its collectives cut the capture as the
  backward's do.
- **Failures raise.** Autograd's anomaly mode, a state tensor rebound since
  the capture, or a capture, replay or collective that fails raises with
  the step's label; nothing falls back to eager steps.

On a CPU the same step runs eagerly, reading its slots from the same staged
buffers: the plain version, which the tests hold against the JAX package.
On the card, ``eager()`` runs the steps that way too: the yardstick a
captured chain is held against, never a serving path.

``chain`` keeps the sampler chains' chunks across calls, as a jitted JAX
sampler compiles once: a second call with the same label, model function
and options replays the graphs the first captured (``MAX_CHAINS`` kept,
least recently used first out; ``release()`` frees them all). The codec's
recurrences (``codec/musicvae.py``) keep theirs in a pool of their own
(``group="codec"``, ``MAX_CODEC_CHAINS``), so a noise -> MIDI call (a
sampler chain, then the codec's conductor and decoder) replays every one of
its graphs at its second call however many sampler chains ran between.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import (Callable, Dict, Hashable, List, NamedTuple,
                    Optional, Sequence)

import numpy as np
import torch

__all__ = ["StepChunk", "WARMUP_STEPS", "launch_counters", "eager",
           "zeros", "chain", "release", "collective", "Point",
           "MAX_CHAINS", "MAX_CODEC_CHAINS"]

WARMUP_STEPS = 2
MAX_CHAINS = 4
# One codec's recurrences: its encoder, its conductor and its decoder in
# each of three modes (free-running, teacher-forced, scheduled sampling).
MAX_CODEC_CHAINS = 5

# Eager warm-up steps run before captures since the module was loaded.
warmup_steps = 0
_EAGER = False
# The capture under way (a ``_Capture``), read by ``collective`` on any
# thread: autograd runs a backward's CUDA nodes on a thread of its own.
_CAPTURE = None


@contextlib.contextmanager
def eager():
    """Run every chunk's steps eagerly on the card too (the yardstick a
    captured chain is held against); no CLI exposes it."""
    global _EAGER
    was, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = was


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


def _read_counters():
    return [getattr(obj, attr) for obj, attr in launch_counters()]


def _add_counters(deltas):
    for (obj, attr), delta in zip(launch_counters(), deltas):
        setattr(obj, attr, getattr(obj, attr) + delta)


class Point(NamedTuple):
    """A collective recorded at a cut: ``fn()`` runs it on ``buffers``."""
    fn: Callable[[], object]
    buffers: tuple


def collective(fn: Callable[[], object], *buffers: torch.Tensor) -> None:
    """Run ``fn()``, a ``torch.distributed`` collective on ``buffers`` in
    place, where a step reaches it: at once, or, inside a ``StepChunk``'s
    capture, between two of the step's graphs at every replay (see the
    module's docstring). ``buffers`` names every tensor ``fn`` reads or
    writes; each must have been made before the call."""
    capture = _CAPTURE
    if capture is None:
        fn()
    else:
        capture.cut(Point(fn, buffers))


class _Capture:
    """One step's graphs as they are captured into ``pool``, and the
    points between them."""

    def __init__(self, pool, generator):
        self.pool = pool
        self.generator = generator
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.points: List[Point] = []
        self.open = False

    def begin(self):
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        self.graphs.append(graph)
        graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")
        self.open = True

    def end(self):
        self.open = False
        self.graphs[-1].capture_end()

    def cut(self, point: Point):
        self.end()
        self.points.append(point)
        self.begin()


def zeros(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """A per-call buffer's zero start: one element expanded to ``shape``."""
    return torch.zeros((), dtype=dtype, device=device).expand(*shape)


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
    """The static buffers of one layout, and its graphs once captured."""

    def __init__(self, slots: int, inputs: Dict[str, torch.Tensor],
                 table_names: Sequence[str],
                 statics: Dict[str, torch.Tensor], device: torch.device):
        self.slots = slots
        self.inputs = {n: torch.empty((slots, *v.shape[1:]), dtype=v.dtype,
                                      device=device)
                       for n, v in inputs.items()}
        self.statics = {n: torch.empty(v.shape, dtype=v.dtype, device=device)
                        for n, v in statics.items()}
        self.table_names = tuple(table_names)
        self.tables = torch.zeros((slots, len(self.table_names)),
                                  dtype=torch.float32, device=device)
        self.index = torch.zeros((1,), dtype=torch.long, device=device)
        self.rows: Optional[Dict[str, torch.Tensor]] = None
        # variant -> (graphs, the points between them, counter deltas)
        self.graphs: Dict[Hashable, tuple] = {}
        self.pool = None
        self.pointers = None

    def stage(self, k, inputs, tables, statics):
        for name, value in inputs.items():
            self.inputs[name][:k].copy_(value, non_blocking=True)
        for name, value in statics.items():
            self.statics[name].copy_(value, non_blocking=True)
        if self.table_names:
            table = np.stack([np.asarray(tables[n], np.float32)[:k]
                              for n in self.table_names], axis=1)
            table = torch.from_numpy(table)
            if self.tables.device.type == "cuda":
                table = table.pin_memory()
            self.tables[:k].copy_(table, non_blocking=True)
        self.index.zero_()

    def run(self, step, variant=None):
        """One step on slot ``index``: the step sees each input's row, each
        table's 0-d value, the per-call buffers, the index as ``step`` and
        the step's ``variant``; its metrics are written at ``index`` and
        the index advances."""
        i = self.index
        slot = {n: buf.index_select(0, i)[0]
                for n, buf in self.inputs.items()}
        if self.table_names:
            row = self.tables.index_select(0, i)[0]
            slot.update({n: row[j] for j, n in enumerate(self.table_names)})
        slot.update(self.statics)
        slot["step"] = i
        if variant is not None:
            slot["variant"] = variant
        metrics = step(slot)
        if self.rows is None:
            self.rows = {n: torch.zeros((self.slots, *v.shape),
                                        dtype=v.dtype, device=v.device)
                         for n, v in metrics.items()}
        for name, value in metrics.items():
            self.rows[name].index_copy_(0, i, value.detach().unsqueeze(0))
        i.add_(1)

    def close(self):
        for pieces, _, _ in self.graphs.values():
            for graph in pieces:
                graph.reset()
        self.graphs = {}
        self.rows = self.pool = None


class StepChunk:
    """K steps of ``step(slot) -> {name: tensor}``.

    ``slot`` maps each input's name to its row of the chunk (a batch, or a
    step's draws), each table's name to its 0-d float32 value at this step,
    each per-call buffer's name to the buffer, ``step`` to the (1,) device
    index of the step and, where the call names variants, ``variant`` to
    this step's. ``mutable()`` lists the tensors a step writes in place
    beside the per-call buffers (saved and restored around the warm-up;
    their storage checked before each chunk); ``generator`` is the step's
    generator; ``label`` names the step in errors. The step's collectives
    go through ``collective`` (see the module's docstring).
    """

    def __init__(self, step: Callable, mutable: Callable[[], List],
                 generator: Optional[torch.Generator], label: str):
        self.step = step
        self.mutable = mutable
        self.generator = generator
        self.label = label
        self._cache: Dict[tuple, _Slots] = {}
        self._last: Optional[_Slots] = None

    def __call__(self, inputs: Dict[str, object],
                 tables: Dict[str, np.ndarray],
                 statics: Optional[Dict[str, torch.Tensor]] = None,
                 variants: Optional[Sequence[Hashable]] = None,
                 ) -> Dict[str, torch.Tensor]:
        """Run K steps: one a variant where ``variants`` is given, else as
        many as the inputs' stacks (or the tables) have rows. Returns each
        metric's (K, ...) rows."""
        statics = dict(statics or {})
        device = self._device(statics)
        inputs = {n: _stack(v, device) for n, v in inputs.items()}
        if variants is not None:
            k = len(variants)
        elif inputs:
            k = next(iter(inputs.values())).shape[0]
        else:
            k = len(next(iter(tables.values())))
        key = tuple((n, tuple(v.shape[1:]), v.dtype)
                    for n, v in inputs.items()) + tuple(sorted(tables)) + \
            tuple((n, tuple(v.shape), v.dtype) for n, v in statics.items())
        slots = self._cache.get(key)
        if slots is None or slots.slots < k:
            if slots is not None:
                slots.close()
            slots = self._cache[key] = _Slots(max(k, 1), inputs,
                                              sorted(tables), statics,
                                              device)
        self._last = slots
        if k == 0:
            slots.stage(0, inputs, tables, statics)
            return {n: r[:0].clone() for n, r in (slots.rows or {}).items()}
        order = [None] * k if variants is None else list(variants)
        slots.stage(k, inputs, tables, statics)
        if device.type != "cuda" or _EAGER:
            for variant in order:
                slots.run(self.step, variant)
        else:
            missing = [v for v in dict.fromkeys(order)
                       if v not in slots.graphs]
            for variant in missing:
                self._capture(slots, variant)
            if missing:   # the warm-up wrote the per-call buffers
                slots.stage(k, inputs, tables, statics)
            self._replay(slots, order)
        return {n: r[:k].clone() for n, r in slots.rows.items()}

    def statics(self) -> Dict[str, torch.Tensor]:
        """The last call's per-call buffers, as its steps left them (reused
        by the next call)."""
        return self._last.statics

    def close(self):
        """Free every captured graph and its memory pool."""
        for slots in self._cache.values():
            slots.close()
        self._cache.clear()
        self._last = None

    def _device(self, statics):
        if statics:
            return next(iter(statics.values())).device
        return self.mutable()[0].device

    def _capture(self, slots: _Slots, variant):
        global warmup_steps, _CAPTURE
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
                    slots.run(self.step, variant)
        except Exception as e:
            raise RuntimeError(f"the warm-up of the {self.label} before its "
                               f"CUDA graph's capture failed: {e}") from e
        finally:
            torch.cuda.current_stream().wait_stream(side)
            if mutable:
                with torch.no_grad():
                    torch._foreach_copy_(mutable, saved)
            if generator is not None:
                generator.set_state(gen_state)
        warmup_steps += WARMUP_STEPS
        del saved
        if slots.pool is None:
            slots.pool = torch.cuda.graph_pool_handle()
        before = _read_counters()
        slots.index.zero_()
        capture = _Capture(slots.pool, generator)
        torch.cuda.synchronize()
        try:
            with torch.cuda.stream(side):
                _CAPTURE = capture
                try:
                    capture.begin()
                    slots.run(self.step, variant)
                    capture.end()
                finally:
                    _CAPTURE = None
                    if capture.open:   # a failure inside a piece
                        try:
                            capture.end()
                        except Exception:   # the error above is raised
                            pass
        except Exception as e:
            for graph in capture.graphs:
                graph.reset()
            raise RuntimeError(
                f"capturing the {self.label} in CUDA graphs failed in "
                f"piece {len(capture.graphs) - 1}: {e}") from e
        finally:
            torch.cuda.current_stream().wait_stream(side)
            if generator is not None:
                generator.set_state(gen_state)
        deltas = [a - b for a, b in zip(_read_counters(), before)]
        _add_counters([-d for d in deltas])
        slots.graphs[variant] = (capture.graphs, capture.points, deltas)
        slots.pointers = [t.data_ptr() for t in mutable]

    def _replay(self, slots: _Slots, order):
        if [t.data_ptr() for t in self.mutable()] != slots.pointers:
            raise RuntimeError(
                f"a tensor of the {self.label}'s state was replaced since "
                "its CUDA graph was captured; write states in place")
        try:
            for variant in order:
                pieces, points, deltas = slots.graphs[variant]
                for j, graph in enumerate(pieces):
                    graph.replay()
                    if j < len(points):
                        points[j].fn()
                _add_counters(deltas)
        except Exception as e:
            raise RuntimeError(f"replaying the {self.label}'s CUDA graphs "
                               f"failed: {e}") from e


# -- sampler chains kept across calls -----------------------------------------

def _fingerprint(fn) -> tuple:
    """What a captured call of ``fn`` would read stale: the storage of every
    tensor of the modules and containers ``fn`` holds (a module itself, a
    bound method's module, a closure's cells, a partial's arguments), and
    those modules' ``training`` and ``plain`` switches."""
    out = []

    def visit(obj, depth):
        if isinstance(obj, torch.nn.Module):
            out.extend(t.data_ptr() for t in obj.parameters())
            out.extend(t.data_ptr() for t in obj.buffers())
            out.extend((m.training, getattr(m, "plain", None))
                       for m in obj.modules())
        elif torch.is_tensor(obj):
            out.append(obj.data_ptr())
        elif depth <= 0:
            return
        elif isinstance(obj, dict):
            for v in obj.values():
                visit(v, depth - 1)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                visit(v, depth - 1)
        elif hasattr(obj, "func") and hasattr(obj, "args"):   # partial
            for v in (obj.func, *obj.args, *obj.keywords.values()):
                visit(v, depth - 1)
        else:
            if getattr(obj, "__self__", None) is not None:
                visit(obj.__self__, depth - 1)
            for cell in getattr(obj, "__closure__", None) or ():
                try:
                    visit(cell.cell_contents, depth - 1)
                except ValueError:   # an empty cell
                    pass

    visit(fn, 3)
    return tuple(out)


class _Chain:
    """A chain's chunk, its own generator (the caller's state is moved in
    before the steps and out after, so a graph serves every caller's
    generator) and what its model function held at the capture."""

    def __init__(self, make_step, label, model_fn, device):
        self.generator = torch.Generator(device=device)
        self.fingerprint = _fingerprint(model_fn)
        self.chunk = StepChunk(make_step(self.generator), lambda: [],
                               self.generator if device.type == "cuda"
                               else None, label)

    def __call__(self, generator, inputs, tables, statics, variants):
        if generator is None:
            generator = _default_generator(self.generator.device)
        self.generator.set_state(generator.get_state())
        with torch.no_grad():
            refresh = getattr(self.chunk.step, "refresh", None)
            if refresh is not None:
                refresh()
            metrics = self.chunk(inputs, tables, statics, variants)
        generator.set_state(self.generator.get_state())
        return self.chunk.statics(), metrics

    def close(self):
        self.chunk.close()


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        return torch.cuda.default_generators[index]
    return torch.default_generator


_CHAINS: "OrderedDict[tuple, _Chain]" = OrderedDict()
_CODEC_CHAINS: "OrderedDict[tuple, _Chain]" = OrderedDict()
_GROUPS = {"sampler": (_CHAINS, lambda: MAX_CHAINS),
           "codec": (_CODEC_CHAINS, lambda: MAX_CODEC_CHAINS)}


def chain(label: str, model_fn, options: tuple, device: torch.device,
          make_step: Callable[[torch.Generator], Callable],
          group: str = "sampler") -> _Chain:
    """The kept chain of ``label`` over ``model_fn`` with ``options`` (which
    fix everything ``make_step`` bakes into the step), made with
    ``make_step(generator)`` when there is none or when ``model_fn`` now
    holds other tensors. A step function may carry ``refresh()``, run
    before each call's steps, outside any graph: it rewrites in place what
    the step derives from the parameters (the codec's gate kernels, joined
    side by side), so a replay never reads a copy older than the call.
    ``group`` names the pool and its bound (``"sampler"``, MAX_CHAINS;
    ``"codec"``, MAX_CODEC_CHAINS). Call it as ``chain(...)(generator,
    inputs, tables, statics, variants)`` -> (per-call buffers, metrics)."""
    chains, bound = _GROUPS[group]
    device = torch.device(device)
    key = (label, model_fn, options, device)
    entry = chains.get(key)
    if entry is not None and entry.fingerprint != _fingerprint(model_fn):
        entry.close()
        entry = None
    if entry is None:
        name = getattr(model_fn, "__qualname__", None) or \
            type(model_fn).__name__
        entry = _Chain(make_step, f"{label} step of {name}", model_fn,
                       device)
        chains[key] = entry
        while len(chains) > bound():
            chains.popitem(last=False)[1].close()
    chains.move_to_end(key)
    return entry


def release():
    """Free every kept chain (the samplers' and the codec's), its graphs
    and its buffers."""
    for chains, _ in _GROUPS.values():
        while chains:
            chains.popitem()[1].close()
