"""Pickle save/load helpers (port of ``smd_tpu/utils/io.py``)."""
from __future__ import annotations

import logging
import os
import pickle

__all__ = ["save", "load"]

log = logging.getLogger(__name__)


def save(obj, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    log.info("Saved to %s", path)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)
