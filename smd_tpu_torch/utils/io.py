"""Pickle save/load helpers (port of ``smd_tpu/utils/io.py``).

``load`` reads the JAX package's pickles too. The shipped codec bundles
(``checkpoints/musicvae-*.pkl``) hold numpy arrays and one class of the JAX
package, ``smd_tpu.codec.musicvae.MusicVAEConfig``, and the JAX package's
``generate_compressed_transform`` pickles ``smd_tpu.data.transforms``'
``PCATransform``; ``load`` maps these to the port's copies. Any other global
of the JAX package or of the JAX ecosystem raises, naming it: the port
imports none of them.
"""
from __future__ import annotations

import logging
import os
import pickle

__all__ = ["save", "load"]

log = logging.getLogger(__name__)

# (module, name) in a pickle of the JAX package -> the port's (module, name).
_JAX_CLASSES = {
    ("smd_tpu.codec.musicvae", "MusicVAEConfig"):
        ("smd_tpu_torch.codec.musicvae", "MusicVAEConfig"),
    ("smd_tpu.data.transforms", "PCATransform"):
        ("smd_tpu_torch.data.transforms", "PCATransform"),
}
_REFUSED = ("smd_tpu", "jax", "jaxlib", "flax", "optax", "orbax")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _JAX_CLASSES:
            module, name = _JAX_CLASSES[module, name]
        elif module.split(".")[0] in _REFUSED:
            raise pickle.UnpicklingError(
                f"{module}.{name}: the pickle needs a global of the JAX "
                "package or its ecosystem, which smd_tpu_torch does not "
                "import")
        return super().find_class(module, name)


def save(obj, path):
    """Pickle ``obj`` to ``path`` through a temporary file renamed into
    place, so that a reader (another rank) finds the whole file or none."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    os.replace(tmp, path)
    log.info("Saved to %s", path)


def load(path):
    with open(path, "rb") as f:
        return _Unpickler(f).load()
