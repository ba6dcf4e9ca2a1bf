"""Melody tokenization: NoteSequence <-> one-hot event tensors (a copy of
``smd_tpu/codec/melody.py``).

A from-scratch equivalent of Magenta's ``OneHotMelodyConverter`` as configured
by the reference (``config.py:23-30``: ``melody_2bar_converter`` —
steps_per_quarter=4, slice_bars=2, max_tensors_per_notesequence=None) plus the
melody extraction pipeline (``utils/song_utils.py:55-93``).

Event vocabulary (90 classes, matching cat-mel_2bar_big):
    0 = no-event (sustain), 1 = note-off, 2..89 = note-on for pitches 21..108.
Two bars at 4 steps/quarter in 4/4 = 32 steps per segment; ``to_tensors``
emits segments at every bar boundary (stride 1 bar), so taking ``[::2]``
yields non-overlapping 2-bar chunks exactly like the reference's
``Song.chunks`` (``song_utils.py:320-325``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from smd_tpu_torch.codec.note_sequence import (NoteSequence, Tempo,
                                               TimeSignature)

__all__ = ["MelodyConverter", "melody_2bar_converter", "extract_melodies",
           "ConverterOutput"]

NO_EVENT = 0
NOTE_OFF = 1
MIN_PITCH = 21
MAX_PITCH = 108
VOCAB_SIZE = 2 + MAX_PITCH - MIN_PITCH + 1  # 90


@dataclasses.dataclass
class ConverterOutput:
    inputs: list  # list of (steps, depth) float32 one-hot arrays


class MelodyConverter:
    """NoteSequence <-> one-hot melody segments."""

    def __init__(self, steps_per_quarter: int = 4, slice_bars: int = 2,
                 steps_per_bar: int = 16, qpm: float = 120.0,
                 skip_polyphony: bool = False):
        self.steps_per_quarter = steps_per_quarter
        self.slice_bars = slice_bars
        self.steps_per_bar = steps_per_bar
        self.qpm = qpm
        self.skip_polyphony = skip_polyphony
        self.depth = VOCAB_SIZE
        self.seq_len = slice_bars * steps_per_bar

    # -- NoteSequence -> tensors ------------------------------------------

    def _events_from_ns(self, ns: NoteSequence) -> Optional[np.ndarray]:
        """Melody event id per step over the whole sequence (monophonic)."""
        out = self._events_and_polyphony(ns)
        return None if out is None else out[0]

    def _events_and_polyphony(self, ns: NoteSequence):
        """(events, per-step polyphony mask) for the whole sequence.

        The mask marks steps where more than one note sounds — the signal the
        nopoly converter uses to *skip* segments, matching magenta's
        ``skip_polyphony=True`` (reference ``config.py:32-39``) instead of
        the standard converter's highest-note reduction.
        """
        q = ns.quantize(self.steps_per_quarter) \
            if ns.quantization_info_steps_per_quarter == 0 else ns
        notes = [n for n in q.notes
                 if not n.is_drum and MIN_PITCH <= n.pitch <= MAX_PITCH]
        if not notes:
            return None
        last_step = max(n.quantized_end_step for n in notes)
        # Round the length up to whole bars.
        num_steps = int(np.ceil(last_step / self.steps_per_bar)
                        ) * self.steps_per_bar
        events = np.zeros(num_steps, np.int32)  # NO_EVENT
        sounding = np.zeros(num_steps, np.int32)

        # Monophonic reduction: at conflicts keep the highest pitch
        # (ignore_polyphonic_notes=True in the reference's converter).
        notes.sort(key=lambda n: (n.quantized_start_step, -n.pitch))
        active_end = -1
        active_pitch = None
        for n in notes:
            s, e = n.quantized_start_step, n.quantized_end_step
            sounding[s:max(e, s + 1)] += 1
            if s < active_end and active_pitch is not None and \
                    n.pitch <= active_pitch:
                continue  # lower simultaneous note: ignored
            events[s] = 2 + n.pitch - MIN_PITCH
            # note-off where the note ends, unless a new onset overwrites it
            if e < num_steps and events[e] == NO_EVENT:
                events[e] = NOTE_OFF
            active_end = e
            active_pitch = n.pitch
        return events, sounding > 1

    def to_tensors(self, ns: NoteSequence) -> ConverterOutput:
        out = self._events_and_polyphony(ns)
        if out is None:
            return ConverterOutput(inputs=[])
        events, poly = out
        num_bars = len(events) // self.steps_per_bar
        segments = []
        for bar in range(0, num_bars - self.slice_bars + 1):
            lo = bar * self.steps_per_bar
            hi = (bar + self.slice_bars) * self.steps_per_bar
            if self.skip_polyphony and poly[lo:hi].any():
                continue   # magenta's nopoly: drop polyphonic segments
            seg = events[lo:hi]
            if (seg >= 2).any():  # keep segments containing at least one note
                onehot = np.zeros((self.seq_len, self.depth), np.float32)
                onehot[np.arange(self.seq_len), seg] = 1.0
                segments.append(onehot)
        # Edge case: shorter than one slice — pad to slice length.
        if not segments and (events >= 2).any() and \
                not (self.skip_polyphony and poly.any()):
            seg = np.zeros(self.seq_len, np.int32)
            seg[:len(events)] = events[:self.seq_len]
            onehot = np.zeros((self.seq_len, self.depth), np.float32)
            onehot[np.arange(self.seq_len), seg] = 1.0
            segments.append(onehot)
        return ConverterOutput(inputs=segments)

    # -- tensors -> NoteSequence ------------------------------------------

    def from_tensors(self, tensors) -> List[NoteSequence]:
        out = []
        seconds_per_step = 60.0 / self.qpm / self.steps_per_quarter
        for t in tensors:
            t = np.asarray(t)
            events = t.argmax(-1) if t.ndim == 2 else t
            ns = NoteSequence(tempos=[Tempo(qpm=self.qpm)],
                             time_signatures=[TimeSignature()])
            current_pitch = None
            start_step = 0
            for step, ev in enumerate(events):
                if ev == NO_EVENT:
                    continue
                if current_pitch is not None:
                    ns.add_note(current_pitch, 80,
                                start_step * seconds_per_step,
                                step * seconds_per_step)
                    current_pitch = None
                if ev >= 2:
                    current_pitch = int(ev) - 2 + MIN_PITCH
                    start_step = step
            if current_pitch is not None:
                ns.add_note(current_pitch, 80, start_step * seconds_per_step,
                            len(events) * seconds_per_step)
            ns.total_time = len(events) * seconds_per_step
            out.append(ns)
        return out


melody_2bar_converter = MelodyConverter(steps_per_quarter=4, slice_bars=2)


def extract_melodies(ns: NoteSequence,
                     keep_longest_split: bool = False,
                     min_unique_pitches: int = 3,
                     min_notes: int = 5) -> List[NoteSequence]:
    """Extract monophonic melodies per instrument.

    Mirrors ``song_utils.extract_melodies``: quantize, split by instrument,
    monophonic reduction, filter trivial lines. (Time-signature splitting is
    approximated by requiring a single 4/4 grid; Lakh outliers are skipped.)
    """
    melodies = []
    conv = melody_2bar_converter
    for instrument in ns.instruments():
        track = ns.extract_instrument(instrument)
        if any(n.is_drum for n in track.notes):
            continue
        events = conv._events_from_ns(track)
        if events is None:
            continue
        pitches = events[events >= 2]
        if len(pitches) < min_notes or \
                len(np.unique(pitches)) < min_unique_pitches:
            continue
        melody_ns = conv.from_tensors([events])[0]
        melodies.append(melody_ns)

    if keep_longest_split and melodies:
        melodies = [max(melodies, key=lambda m: len(m.notes))]
    return melodies
