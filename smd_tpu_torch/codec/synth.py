"""Audio synthesis: NoteSequence -> PCM through the native C++ renderer
(port of ``smd_tpu/codec/synth.py``).

The renderer is ``native/smd_synth.cpp`` (additive synthesis over a C ABI,
called through ctypes), read where it stands and compiled at first use with
``g++ -O3 -shared -fPIC -std=c++17``, the JAX package's flags, into
``smd_tpu_torch/_build/`` (git-ignored), never into ``native/``. Unlike the
JAX package's ``synthesize``, which falls back to a numpy renderer when the
library cannot be built, this one raises: a WAV made by another renderer
would sound different without saying so. ``_numpy_render``, a copy of the
JAX package's fallback, is kept as the plain version the tests hold the
native render against.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from smd_tpu_torch.utils import native

__all__ = ["synthesize", "note_sequence_to_wav", "library_path",
           "load_library"]

SOURCE = os.path.join(native.ROOT, "native", "smd_synth.cpp")
BUILD_DIR = native.BUILD_DIR
_LIB = None


def library_path() -> str:
    """Where the library of the current source and flags is built: the
    name carries a hash of both."""
    return native.library_path(SOURCE, "libsmd_synth", BUILD_DIR)


def load_library():
    """The renderer's ctypes library, built first if need be; raises if
    ``g++`` fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so_path = native.build(SOURCE, "libsmd_synth", BUILD_DIR)
    lib = ctypes.CDLL(so_path)
    lib.synth_render.restype = ctypes.c_int
    lib.synth_render.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32,
    ]
    _LIB = lib
    return lib


def _numpy_render(pitches, velocities, starts, ends, programs, is_drum,
                  n_samples, sample_rate):
    """The plain version: sine tones with a linear attack and an
    exponential release, noise bursts for drums, soft-clipped."""
    out = np.zeros(n_samples, np.float32)
    t_axis = np.arange(n_samples) / sample_rate
    for p, v, s, e, prog, drum in zip(pitches, velocities, starts, ends,
                                      programs, is_drum):
        if e <= s:
            continue
        mask = (t_axis >= s) & (t_axis < e + 0.1)
        t = t_axis[mask] - s
        if drum:
            rng = np.random.default_rng(int(p))
            sig = rng.uniform(-1, 1, mask.sum()) * np.exp(-t / 0.08)
        else:
            freq = 440.0 * 2 ** ((p - 69) / 12.0)
            env = np.minimum(t / 0.01, 1.0) * np.exp(-np.maximum(
                t - (e - s), 0) / 0.1)
            sig = np.sin(2 * np.pi * freq * t) * env
        out[mask] += (v / 127.0) * sig * 0.12
    return np.tanh(out)


def _note_arrays(ns):
    notes = ns.notes
    return (np.array([n.pitch for n in notes], np.int32),
            np.array([n.velocity for n in notes], np.float32),
            np.array([n.start_time for n in notes], np.float32),
            np.array([n.end_time for n in notes], np.float32),
            np.array([n.program for n in notes], np.int32),
            np.array([n.is_drum for n in notes], np.uint8))


def synthesize(ns, sample_rate: int = 44100, tail: float = 0.5) -> np.ndarray:
    """Render a NoteSequence to mono float32 PCM in [-1, 1] with the native
    renderer (raises if it cannot be built)."""
    n_samples = int((ns.total_time + tail) * sample_rate) + 1
    if not ns.notes:
        return np.zeros(n_samples, np.float32)
    pitches, velocities, starts, ends, programs, is_drum = _note_arrays(ns)
    lib = load_library()
    out = np.zeros(n_samples, np.float32)
    lib.synth_render(
        pitches.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        velocities.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        programs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        is_drum.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(len(pitches)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.int64(n_samples), np.int32(sample_rate))
    return out


def note_sequence_to_wav(ns, path: str, sample_rate: int = 44100):
    """Render and write a 16-bit PCM WAV (reference used 44.1kHz int16)."""
    from scipy.io import wavfile
    pcm = synthesize(ns, sample_rate)
    wavfile.write(path, sample_rate, (pcm * 32767).astype(np.int16))
