"""Host C++ libraries of ``native/``, built with ``g++`` at first use.

A source is read where it stands (``native/*.cpp``, shared with the JAX
package) and compiled with the JAX package's flags (``native/Makefile``)
into ``smd_tpu_torch/_build/`` (git-ignored), never into ``native/``. The
library's name carries a hash of the source and the flags, so an edited
source builds anew. Each build goes to a temporary name and is moved into
place, so processes that build at once never load a half-written library;
a failed build raises with g++'s message.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

__all__ = ["ROOT", "BUILD_DIR", "CXXFLAGS", "library_path", "build"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(ROOT, "smd_tpu_torch", "_build")
CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(source: str, stem: str, build_dir: str = BUILD_DIR) -> str:
    """Where the library of ``source`` and the flags is built:
    ``{build_dir}/{stem}-{hash}.so``."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS).encode())
    return os.path.join(build_dir, f"{stem}-{digest.hexdigest()[:12]}.so")


def build(source: str, stem: str, build_dir: str = BUILD_DIR) -> str:
    """The path of ``source``'s library, built first if it is not there;
    raises RuntimeError if ``g++`` fails."""
    so_path = library_path(source, stem, build_dir)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        result = subprocess.run(["g++", *CXXFLAGS, source, "-o", tmp],
                                capture_output=True, text=True)
        if result.returncode:
            raise RuntimeError(f"building {source} with g++ failed:\n"
                               f"{result.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path
