"""Compact multi-instrument GRID tokenization (1-bar chunks) — legacy
alternative (a copy of ``smd_tpu/codec/multitrack.py``).

The parity converter for the reference's multitrack configs is
``smd_tpu_torch.codec.performance.MultiInstrumentPerformanceConverter``
(performance-event streams with velocity bins, matching ``config.py:50-64``);
that is what ``MUSIC_VAE_CONFIG`` and ``generate_song_data --mode=multi``
use. This module remains as a deliberately simpler, denser representation:
each bar as a fixed grid of per-instrument monophonic-track events — regular
MXU-friendly tensors, no velocity, useful for quick experiments.

Layout per bar: up to ``max_instruments`` tracks x 16 steps, each step a
one-hot over the melody vocabulary (90) plus a per-track program id channel.
Tensor shape: (16, max_instruments * 91).
"""
from __future__ import annotations

from typing import List

import numpy as np

from smd_tpu_torch.codec.melody import (MelodyConverter, NO_EVENT,
                                        VOCAB_SIZE, MIN_PITCH)
from smd_tpu_torch.codec.note_sequence import (NoteSequence, Tempo,
                                               TimeSignature)
from smd_tpu_torch.codec.melody import ConverterOutput

__all__ = ["MultitrackConverter", "multitrack_default_1bar_converter",
           "multitrack_zero_1bar_converter"]

_TRACK_DEPTH = VOCAB_SIZE + 1  # events + normalized program id channel


class MultitrackConverter:
    """NoteSequence <-> per-instrument event grids, 1 bar per chunk."""

    def __init__(self, steps_per_quarter=4, hop_size_bars=1,
                 min_num_instruments=2, max_num_instruments=8,
                 qpm: float = 120.0):
        self.steps_per_quarter = steps_per_quarter
        self.steps_per_bar = steps_per_quarter * 4
        self.hop_size_bars = hop_size_bars
        self.min_num_instruments = min_num_instruments
        self.max_num_instruments = max_num_instruments
        self.qpm = qpm
        self.depth = self.max_num_instruments * _TRACK_DEPTH
        self.seq_len = self.steps_per_bar * hop_size_bars
        self._mel = MelodyConverter(steps_per_quarter=steps_per_quarter,
                                    slice_bars=hop_size_bars, qpm=qpm)

    def to_tensors(self, ns: NoteSequence) -> ConverterOutput:
        instruments = ns.instruments()[:self.max_num_instruments]
        tracks, programs = [], []
        for inst in instruments:
            track = ns.extract_instrument(inst)
            events = self._mel._events_from_ns(track)
            if events is None:
                continue
            tracks.append(events)
            programs.append(track.notes[0].program if track.notes else 0)
        if len(tracks) < max(self.min_num_instruments, 1):
            return ConverterOutput(inputs=[])

        num_steps = max(len(t) for t in tracks)
        num_bars = -(-num_steps // self.seq_len)
        segments = []
        for bar in range(num_bars):
            lo, hi = bar * self.seq_len, (bar + 1) * self.seq_len
            grid = np.zeros((self.seq_len, self.depth), np.float32)
            has_note = False
            for ti, events in enumerate(tracks):
                seg = events[lo:hi]
                off = ti * _TRACK_DEPTH
                for s, ev in enumerate(seg):
                    grid[s, off + ev] = 1.0
                grid[len(seg):, off + NO_EVENT] = 1.0
                grid[:, off + VOCAB_SIZE] = programs[ti] / 127.0
                if (seg >= 2).any():
                    has_note = True
            if has_note:
                segments.append(grid)
        return ConverterOutput(inputs=segments)

    def from_tensors(self, tensors) -> List[NoteSequence]:
        out = []
        spb = 60.0 / self.qpm / self.steps_per_quarter
        for t in tensors:
            t = np.asarray(t)
            ns = NoteSequence(tempos=[Tempo(qpm=self.qpm)],
                             time_signatures=[TimeSignature()])
            for ti in range(self.max_num_instruments):
                off = ti * _TRACK_DEPTH
                track = t[:, off:off + VOCAB_SIZE]
                if track.max() <= 0:
                    continue
                events = track.argmax(-1)
                program = int(round(float(t[0, off + VOCAB_SIZE]) * 127))
                pitch, start = None, 0
                for step, ev in enumerate(events):
                    if ev == NO_EVENT:
                        continue
                    if pitch is not None:
                        ns.add_note(pitch, 80, start * spb, step * spb,
                                    program=program, instrument=ti)
                        pitch = None
                    if ev >= 2:
                        pitch = int(ev) - 2 + MIN_PITCH
                        start = step
                if pitch is not None:
                    ns.add_note(pitch, 80, start * spb, len(events) * spb,
                                program=program, instrument=ti)
            ns.total_time = t.shape[0] * spb
            out.append(ns)
        return out


multitrack_default_1bar_converter = MultitrackConverter(
    min_num_instruments=2, max_num_instruments=8)
multitrack_zero_1bar_converter = MultitrackConverter(
    min_num_instruments=0, max_num_instruments=8)
