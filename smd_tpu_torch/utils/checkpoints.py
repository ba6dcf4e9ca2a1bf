"""Checkpointing with resume (port of ``smd_tpu/utils/checkpoints.py``).

The JAX package keeps its train state with an Orbax ``CheckpointManager``;
the port keeps the same interface over ``torch.save``: one file a step,
``{directory}/{step}.pt``, holding the state's ``state_dict()``. The format
is not Orbax's, so neither package reads the other's checkpoints. A save
writes a temporary file and renames it, so a checkpoint is either whole or
absent, as Orbax commits atomically. Saves are synchronous, so ``wait`` and
``close`` have nothing to do. Across ranks every rank calls ``save`` (the
state's ``state_dict`` may gather split parameters) and the manager made
with ``write=True``, rank 0's, writes.
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Save and restore a train state by step, keeping the newest ``keep``."""

    def __init__(self, directory: str, keep: int = 50, write: bool = True):
        self._dir = os.path.abspath(os.path.expanduser(directory))
        self._keep = keep
        self._write = write
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir))
                      if m)

    def save(self, step: int, state: Any, force: bool = False):
        """Write ``state.state_dict()`` as step ``step`` (taken on every
        rank, written where ``write``); ``force`` is accepted for the
        interface (every save is written)."""
        del force
        saved = state.state_dict()
        if not self._write:
            return
        tmp = self._path(step) + ".tmp"
        torch.save(saved, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self._keep]:
            os.remove(self._path(old))

    def wait(self):
        pass

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, target: Any) -> Any:
        """Load the newest checkpoint into ``target`` (a state with
        ``load_state_dict``) and return it; ``target`` unchanged when there
        is none."""
        step = self.latest_step
        if step is None:
            return target
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return target.load_state_dict(saved)

    def close(self):
        pass
