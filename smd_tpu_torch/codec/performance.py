"""Multi-instrument performance-event tokenization, 1-bar chunks (a copy of
``smd_tpu/codec/performance.py``).

A from-scratch equivalent of Magenta's ``MultiInstrumentPerformanceConverter``
as configured by the reference (``config.py:50-64``): per-instrument
*performance-event streams* — NOTE_ON / NOTE_OFF / TIME_SHIFT / VELOCITY with
``num_velocity_bins=8`` — at 1-bar hops, up to 8 instruments, 64 events per
instrument. This replaces the round-1 per-track grid simplification
(``multitrack.py``), which discarded velocity and used a melody-vocabulary
grid instead of event streams.

Event vocabulary per instrument stream (one-hot depth = 490):

    0                     PAD (stream end)
    1   .. 128            NOTE_ON  pitch 0..127
    129 .. 256            NOTE_OFF pitch 0..127
    257 .. 256+S          TIME_SHIFT of 1..S quantized steps
                          (S = steps_per_bar = 96 at 24 steps/quarter, so one
                          silent bar is a single event)
    257+S .. 256+S+8      VELOCITY bin 1..8 (changes the current velocity)
    265+S .. 392+S        PROGRAM 0..127 — the stream's first event
    393+S                 DRUMS — program token for drum tracks

The PROGRAM/DRUMS leading token carries what Magenta models as separate
conditioning, keeping each chunk a single self-contained tensor.

Chunk tensor: ``(max_num_instruments * max_events_per_instrument, 490)`` =
``(512, 490)`` one-hot rows, instrument-major — i.e. 8 segments of 64 events,
matching the hier-multiperf VAE layout (a conductor step per instrument, see
``smd_tpu_torch/config.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from smd_tpu_torch.codec.melody import ConverterOutput
from smd_tpu_torch.codec.note_sequence import (NoteSequence, Tempo,
                                               TimeSignature)

__all__ = [
    "MultiInstrumentPerformanceConverter",
    "multiperf_default_1bar_converter",
    "multiperf_zero_1bar_converter",
]

PAD = 0
_NOTE_ON0 = 1
_NOTE_OFF0 = 129
_TIME_SHIFT0 = 257


@dataclasses.dataclass(frozen=True)
class _Vocab:
    max_shift_steps: int
    num_velocity_bins: int

    @property
    def velocity0(self):
        return _TIME_SHIFT0 + self.max_shift_steps

    @property
    def program0(self):
        return self.velocity0 + self.num_velocity_bins

    @property
    def drums(self):
        return self.program0 + 128

    @property
    def depth(self):
        return self.drums + 1


class MultiInstrumentPerformanceConverter:
    """NoteSequence <-> per-instrument performance-event streams, 1-bar hops.

    Args mirror the reference's converter (``config.py:50-64``):
        num_velocity_bins: velocity quantization (8).
        hop_size_bars: chunk hop (1).
        min_num_instruments: chunks with fewer active instruments are skipped.
        max_num_instruments: instrument streams per chunk (8).
        max_events_per_instrument: events per stream (64).
        min_total_events: chunks with fewer events total are skipped.
        drop_tracks_and_truncate: overflowing streams are truncated and extra
            instruments dropped (the reference's ``multitrack_zero``
            behavior) instead of invalidating the chunk.
    """

    def __init__(self, num_velocity_bins: int = 8, hop_size_bars: int = 1,
                 min_num_instruments: int = 2, max_num_instruments: int = 8,
                 max_events_per_instrument: int = 64,
                 min_total_events: int = 1,
                 drop_tracks_and_truncate: bool = False,
                 steps_per_quarter: int = 24, qpm: float = 120.0):
        self.num_velocity_bins = num_velocity_bins
        self.hop_size_bars = hop_size_bars
        self.min_num_instruments = min_num_instruments
        self.max_num_instruments = max_num_instruments
        self.max_events_per_instrument = max_events_per_instrument
        self.min_total_events = min_total_events
        self.drop_tracks_and_truncate = drop_tracks_and_truncate
        self.steps_per_quarter = steps_per_quarter
        self.steps_per_bar = steps_per_quarter * 4
        self.qpm = qpm
        self._vocab = _Vocab(self.steps_per_bar * hop_size_bars,
                             num_velocity_bins)
        self.depth = self._vocab.depth
        self.seq_len = max_num_instruments * max_events_per_instrument

    # -- velocity quantization --------------------------------------------

    def _velocity_bin(self, velocity: int) -> int:
        v = int(np.clip(velocity, 1, 127))
        return (v * self.num_velocity_bins) // 128 + 1

    def _bin_velocity(self, bin_: int) -> int:
        # bin center
        return int((2 * bin_ - 1) * 128 / (2 * self.num_velocity_bins))

    # -- NoteSequence -> tensors ------------------------------------------

    def _stream_events(self, notes, bar_start: int, bar_len: int,
                       program: int, is_drum: bool) -> Optional[List[int]]:
        """Performance-event stream for one instrument within one chunk.

        ``notes``: quantized notes of this instrument overlapping the chunk,
        truncated to it. Returns None when the stream overflows and
        truncation is not allowed.
        """
        vocab = self._vocab
        # (step, order, kind, pitch): note-offs sort before note-ons at the
        # same step so retriggers are unambiguous.
        points = []
        for n in notes:
            s = max(n.quantized_start_step - bar_start, 0)
            e = min(n.quantized_end_step - bar_start, bar_len)
            if e <= s and n.quantized_end_step > n.quantized_start_step:
                continue
            points.append((s, 1, "on", n.pitch, self._velocity_bin(
                n.velocity)))
            points.append((max(e, s + 1), 0, "off", n.pitch, 0))
        points.sort(key=lambda p: (p[0], p[1]))

        events = [vocab.drums if is_drum else
                  vocab.program0 + int(np.clip(program, 0, 127))]
        step = 0
        velocity_bin = 0
        for s, _, kind, pitch, vbin in points:
            if s > bar_len:
                break
            shift = s - step
            while shift > 0:
                d = min(shift, vocab.max_shift_steps)
                events.append(_TIME_SHIFT0 + d - 1)
                shift -= d
            step = s
            if kind == "on":
                if vbin != velocity_bin:
                    events.append(vocab.velocity0 + vbin - 1)
                    velocity_bin = vbin
                events.append(_NOTE_ON0 + pitch)
            else:
                events.append(_NOTE_OFF0 + pitch)

        if len(events) > self.max_events_per_instrument:
            if not self.drop_tracks_and_truncate:
                return None
            events = events[:self.max_events_per_instrument]
        return events

    def to_tensors(self, ns: NoteSequence) -> ConverterOutput:
        q = ns.quantize(self.steps_per_quarter) \
            if ns.quantization_info_steps_per_quarter == 0 else ns
        notes = [n for n in q.notes if n.quantized_end_step is not None]
        if not notes:
            return ConverterOutput(inputs=[])

        bar_len = self.steps_per_bar * self.hop_size_bars
        last_step = max(n.quantized_end_step for n in notes)
        num_chunks = -(-last_step // bar_len)

        # Group notes by instrument, preserving first-seen order.
        by_inst, order = {}, []
        for n in notes:
            if n.instrument not in by_inst:
                by_inst[n.instrument] = []
                order.append(n.instrument)
            by_inst[n.instrument].append(n)

        chunks = []
        for c in range(num_chunks):
            lo, hi = c * bar_len, (c + 1) * bar_len
            streams = []
            for inst in order:
                inst_notes = [n for n in by_inst[inst]
                              if n.quantized_start_step < hi and
                              max(n.quantized_end_step,
                                  n.quantized_start_step + 1) > lo]
                if not inst_notes:
                    continue
                ev = self._stream_events(
                    inst_notes, lo, bar_len,
                    inst_notes[0].program, any(n.is_drum for n in inst_notes))
                if ev is None:   # overflow without truncation: drop chunk
                    streams = None
                    break
                streams.append(ev)
            if streams is None:
                continue
            # Canonical segment order: sort streams lexicographically by
            # their event ids (the leading PROGRAM/DRUMS token dominates, so
            # this is program-major with drums last). Without this, which
            # conductor segment an instrument lands in depends on the NOTE
            # ORDER of the input NoteSequence — in-memory sequences list
            # notes instrument-by-instrument while MIDI files read back
            # time-interleaved, and a codec trained on one ordering measured
            # note-F1 0.16 on the other (round-2 "timing OOD" cliff: it was
            # segment order, not timing — the streams matched as a set).
            # Sorting BEFORE truncation keeps the kept-subset order-invariant
            # too (truncating first would keep whichever 8 instruments were
            # seen first in note order).
            streams.sort()
            if len(streams) > self.max_num_instruments:
                if not self.drop_tracks_and_truncate:
                    continue
                streams = streams[:self.max_num_instruments]
            if len(streams) < self.min_num_instruments:
                continue
            total_events = sum(len(s) - 1 for s in streams)  # sans program
            if total_events < self.min_total_events:
                continue
            grid = np.zeros((self.seq_len, self.depth), np.float32)
            for ti, ev in enumerate(streams):
                off = ti * self.max_events_per_instrument
                rows = np.arange(len(ev))
                grid[off + rows, np.asarray(ev)] = 1.0
                grid[off + len(ev):off + self.max_events_per_instrument,
                     PAD] = 1.0
            for ti in range(len(streams), self.max_num_instruments):
                off = ti * self.max_events_per_instrument
                grid[off:off + self.max_events_per_instrument, PAD] = 1.0
            chunks.append(grid)
        return ConverterOutput(inputs=chunks)

    # -- tensors -> NoteSequence ------------------------------------------

    def from_tensors(self, tensors) -> List[NoteSequence]:
        vocab = self._vocab
        spb = 60.0 / self.qpm / self.steps_per_quarter
        bar_len = self.steps_per_bar * self.hop_size_bars
        out = []
        for t in tensors:
            t = np.asarray(t)
            events = t.argmax(-1) if t.ndim == 2 else t
            ns = NoteSequence(tempos=[Tempo(qpm=self.qpm)],
                              time_signatures=[TimeSignature()])
            for ti in range(self.max_num_instruments):
                off = ti * self.max_events_per_instrument
                stream = events[off:off + self.max_events_per_instrument]
                program, is_drum = 0, False
                step = 0
                velocity = self._bin_velocity(max(
                    1, self.num_velocity_bins // 2))
                active = {}   # pitch -> (start_step, velocity)
                for ev in stream:
                    ev = int(ev)
                    if ev == PAD:
                        continue
                    if ev >= vocab.drums:
                        is_drum = True
                    elif ev >= vocab.program0:
                        program = ev - vocab.program0
                    elif ev >= vocab.velocity0:
                        velocity = self._bin_velocity(ev - vocab.velocity0
                                                      + 1)
                    elif ev >= _TIME_SHIFT0:
                        step += ev - _TIME_SHIFT0 + 1
                    elif ev >= _NOTE_OFF0:
                        pitch = ev - _NOTE_OFF0
                        if pitch in active:
                            s, v = active.pop(pitch)
                            ns.add_note(pitch, v, s * spb,
                                        max(step, s + 1) * spb,
                                        program=program, instrument=ti,
                                        is_drum=is_drum)
                    else:
                        pitch = ev - _NOTE_ON0
                        if pitch in active:   # retrigger closes the old note
                            s, v = active.pop(pitch)
                            ns.add_note(pitch, v, s * spb, step * spb,
                                        program=program, instrument=ti,
                                        is_drum=is_drum)
                        active[pitch] = (step, velocity)
                for pitch, (s, v) in sorted(active.items()):
                    ns.add_note(pitch, v, s * spb,
                                max(bar_len, s + 1) * spb, program=program,
                                instrument=ti, is_drum=is_drum)
            ns.total_time = bar_len * spb
            out.append(ns)
        return out


multiperf_default_1bar_converter = MultiInstrumentPerformanceConverter(
    num_velocity_bins=8, hop_size_bars=1, min_num_instruments=2,
    max_num_instruments=8, max_events_per_instrument=64)

multiperf_zero_1bar_converter = MultiInstrumentPerformanceConverter(
    num_velocity_bins=8, hop_size_bars=1, min_num_instruments=0,
    max_num_instruments=8, min_total_events=0,
    max_events_per_instrument=64, drop_tracks_and_truncate=True)
