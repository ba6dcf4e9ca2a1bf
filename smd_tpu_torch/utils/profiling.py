"""Op-level profiling (port of ``smd_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` run (CPU activity, and CUDA
activity on a CUDA device) and writes its Chrome trace into a directory;
``op_profile`` reads the newest trace there back into a table of device
time by operation, the counterpart of the JAX package's xplane parser, and
``format_op_profile`` prints it in the JAX package's layout. A device
kernel is charged to the PyTorch operation that launched it (the trace's
``External id``); a kernel launched outside one (the port's own kernels,
called through ``ctypes``) is its own category. A trace without device
activity (a CPU run) has no device time to report, and ``op_profile``
raises. ``trace_summary`` reads a ``torch.profiler`` run in memory: the
device-busy time (the union of the device events' intervals), the span and
the idle share, and ``host_launches`` counts the host's calls that enqueue
device work (kernel and graph launches, copies and fills), which a
captured step cuts to a few a step.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time

import torch

from smd_tpu_torch.device import resolve_device

__all__ = ["Trace", "trace", "op_profile", "format_op_profile",
           "busy_us", "trace_summary", "host_launches"]

# Chrome-trace categories of device activity.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# CUDA API calls (cuda* and cu*) that enqueue device work.
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


class Trace:
    """A ``torch.profiler`` run between ``start`` and ``stop``; ``stop``
    writes ``{log_dir}/trace-{time}-{pid}.json`` and returns its path.
    ``device`` is ``cuda`` unless the caller passes ``"cpu"``."""

    def __init__(self, log_dir: str, device=None):
        self.log_dir = log_dir
        self.device = resolve_device(device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)

    def start(self):
        self.profiler.start()

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"trace-{time.time_ns()}-"
                                          f"{os.getpid()}.json")
        self.profiler.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Context manager: profile the block into ``log_dir``; yields the
    ``torch.profiler.profile`` object."""
    run = Trace(log_dir, device)
    run.start()
    try:
        yield run.profiler
    finally:
        run.stop()


def _find_trace(log_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(log_dir, "trace-*.json")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace-*.json under {log_dir}")
    return paths[-1]


def op_profile(log_dir: str):
    """The newest trace under ``log_dir`` as a table of device time.

    Returns ``(total_ms, rows)``: ``total_ms`` the device time of every
    device event; rows, heaviest first, dicts with ``category`` (the
    launching operation, or the kernel's name), ``ms`` (its device time),
    ``occurrences`` (its device events), ``share`` (of ``total_ms``) and
    ``top`` (its five heaviest kernels, (name, ms)). Raises ValueError for
    a trace without device activity.
    """
    with open(_find_trace(log_dir)) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "External id" in e.get("args", {}):
            ops[e["args"]["External id"]] = e["name"]
    by_category = collections.defaultdict(
        lambda: {"ms": 0.0, "occurrences": 0,
                 "kernels": collections.Counter()})
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATEGORIES:
            continue
        ms = float(e.get("dur", 0.0)) / 1e3
        category = ops.get(e.get("args", {}).get("External id"), e["name"])
        row = by_category[category]
        row["ms"] += ms
        row["occurrences"] += 1
        row["kernels"][e["name"]] += ms
    if not by_category:
        raise ValueError(f"the trace under {log_dir} holds no device "
                         "activity (a CPU run has no device time)")
    total_ms = sum(r["ms"] for r in by_category.values())
    rows = [{"category": name, "ms": r["ms"],
             "occurrences": r["occurrences"], "share": r["ms"] / total_ms,
             "top": r["kernels"].most_common(5)}
            for name, r in sorted(by_category.items(),
                                  key=lambda kv: -kv[1]["ms"])]
    return total_ms, rows


def format_op_profile(total_ms: float, rows, steps: int = 1) -> str:
    """Human-readable table; pass ``steps`` to normalize per step."""
    lines = [f"total {total_ms / steps:.3f} ms/step"]
    for r in rows:
        if r["ms"] / steps < 1e-3:
            continue
        lines.append(f"  {r['ms'] / steps:8.3f} ms  "
                     f"x{r['occurrences'] / steps:5.1f}  {r['category']}")
        for name, ms in r["top"]:
            if ms / steps < 5e-3:
                continue
            lines.append(f"      {ms / steps:8.3f} ms  {name}")
    return "\n".join(lines)


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_summary(prof):
    """(device events, device-busy us, span us, idle share) of a
    ``torch.profiler`` run: busy is the union of the device events'
    intervals, the span runs from the first event to the last, host or
    device, and the idle share is 1 - busy / span. Raises ValueError for a
    run without device events."""
    device, spans = [], []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append(evt)
        spans.append((evt.time_range.start, evt.time_range.end))
    if not device:
        raise ValueError("the profiler recorded no device time")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device])
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    return device, busy, span, 1 - busy / span


def host_launches(prof) -> int:
    """The host's calls in a ``torch.profiler`` run that enqueue device
    work: kernel and graph launches, copies and fills."""
    return sum(evt.device_type == torch.autograd.DeviceType.CPU and
               evt.name.startswith(_LAUNCH_CALLS) for evt in prof.events())
