"""Build the CUDA kernels of ``csrc/`` with nvcc and call them through ctypes.

The sources include CUDA's headers only, never PyTorch's, and export plain
``extern "C"`` launchers that take raw pointers, the sizes and the stream and
return ``cudaGetLastError()``. At first use each ``.cu`` file is compiled by
its own ``nvcc`` process, all started together, and the objects are linked
into one shared library under ``smd_tpu_torch/_build/<hash>/``, where the
hash covers the sources and the flags; a later process finds it there.
Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["build", "library", "launch", "check_cuda_args", "dtype_code",
           "FLOATS", "INT8", "SOURCES", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("errors.cu", "fused_film_resblock.cu", "fused_attention.cu",
           "quant_matmul.cu", "flash_attention.cu")
HEADERS = ("common.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libsmd_tpu_torch_kernels.so"

FLOATS = (torch.float32, torch.bfloat16)
INT8 = (torch.int8,)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (number of pointer arguments, number of int arguments); every
# launcher then takes the stream.
_LAUNCHERS = {
    "smd_fused_ln_film_swish_dense": (9, 7),
    "smd_fused_ln_attention": (8, 8),
    "smd_w8a8_dense": (7, 7),
    "smd_int8_transpose": (2, 2),
    "smd_flash_attention": (4, 16),
}

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of smd_tpu_torch are "
                       "built with the CUDA toolkit's nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Build the library if it is not there yet.

    Returns its path, the seconds spent building (0 when it was there) and
    what ptxas said about each kernel (registers, shared memory, spills).
    """
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / _LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib_path.exists():
        return lib_path, 0.0, log_path.read_text() if log_path.exists() else ""
    start = time.perf_counter()
    nvcc = _nvcc()
    work = out_dir / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = work / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n" +
                           "\n".join(logs))
    tmp_lib = work / _LIB_NAME
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc failed to link the kernels:\n" + link.stdout)
    log = "\n".join(logs)
    log_path.write_text(log)
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    return lib_path, time.perf_counter() - start, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, (n_ptr, n_int) in _LAUNCHERS.items():
            fn = getattr(lib, name)
            fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
            fn.restype = ctypes.c_int
        lib.smd_error_string.argtypes = [ctypes.c_int]
        lib.smd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPE_CODES[t.dtype]


def check_cuda_args(device: torch.device, **args) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device) with the
    expected shape and dtype, contiguous and 16-byte aligned.

    ``args`` maps a name to ``(tensor or None, shape, allowed dtypes)``.
    """
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {device}")
    for name, (t, shape, dtypes) in args.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                             f"{dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the current stream; raise on a CUDA error.

    Tensors pass as their data pointers (None as NULL), ints as ints.
    """
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    c_args.append(torch.cuda.current_stream().cuda_stream)
    rc = getattr(lib, name)(*c_args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} "
                           f"({lib.smd_error_string(rc).decode()})")
