"""A minimal NoteSequence layer (a copy of ``smd_tpu/codec/note_sequence.py``).

The reference leans on Magenta's ``note_seq`` protobuf + helpers (``Song``
wrapper at ``utils/song_utils.py:272``, trimming in ``utils/metrics.py:86``).
That package is not available here, so this module provides the subset the
framework needs as plain dataclasses: notes with absolute times, tempo,
quantization, trimming, splitting, and concatenation. ``midi_io`` handles
Standard MIDI File round-trips.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["Note", "Tempo", "TimeSignature", "NoteSequence",
           "trim_note_sequence", "concatenate_sequences"]

STANDARD_PPQ = 220


@dataclasses.dataclass
class Note:
    pitch: int
    velocity: int
    start_time: float
    end_time: float
    program: int = 0
    instrument: int = 0
    is_drum: bool = False

    # set by quantization
    quantized_start_step: Optional[int] = None
    quantized_end_step: Optional[int] = None


@dataclasses.dataclass
class Tempo:
    time: float = 0.0
    qpm: float = 120.0


@dataclasses.dataclass
class TimeSignature:
    time: float = 0.0
    numerator: int = 4
    denominator: int = 4


@dataclasses.dataclass
class NoteSequence:
    notes: List[Note] = dataclasses.field(default_factory=list)
    total_time: float = 0.0
    tempos: List[Tempo] = dataclasses.field(default_factory=list)
    time_signatures: List[TimeSignature] = dataclasses.field(
        default_factory=list)
    ticks_per_quarter: int = STANDARD_PPQ
    quantization_info_steps_per_quarter: int = 0

    @property
    def qpm(self) -> float:
        return self.tempos[0].qpm if self.tempos else 120.0

    def add_note(self, pitch, velocity, start_time, end_time, **kw) -> Note:
        note = Note(pitch, velocity, start_time, end_time, **kw)
        self.notes.append(note)
        self.total_time = max(self.total_time, end_time)
        return note

    def instruments(self):
        return sorted({n.instrument for n in self.notes})

    def programs(self):
        return sorted({n.program for n in self.notes if not n.is_drum})

    def extract_instrument(self, instrument) -> "NoteSequence":
        ns = NoteSequence(tempos=list(self.tempos),
                         time_signatures=list(self.time_signatures),
                         ticks_per_quarter=self.ticks_per_quarter)
        for n in self.notes:
            if n.instrument == instrument:
                ns.add_note(n.pitch, n.velocity, n.start_time, n.end_time,
                            program=n.program, instrument=n.instrument,
                            is_drum=n.is_drum)
        return ns

    def quantize(self, steps_per_quarter: int = 4) -> "NoteSequence":
        """Snap note boundaries to a fixed grid (relative quantization)."""
        qpm = self.qpm
        steps_per_second = steps_per_quarter * qpm / 60.0
        out = NoteSequence(tempos=list(self.tempos),
                          time_signatures=list(self.time_signatures),
                          ticks_per_quarter=self.ticks_per_quarter)
        out.quantization_info_steps_per_quarter = steps_per_quarter
        for n in self.notes:
            start = int(round(n.start_time * steps_per_second))
            end = int(round(n.end_time * steps_per_second))
            end = max(end, start + 1)
            note = out.add_note(n.pitch, n.velocity, n.start_time, n.end_time,
                                program=n.program, instrument=n.instrument,
                                is_drum=n.is_drum)
            note.quantized_start_step = start
            note.quantized_end_step = end
        out.total_time = self.total_time
        return out

    def shift(self, seconds: float) -> "NoteSequence":
        out = NoteSequence(tempos=list(self.tempos),
                          time_signatures=list(self.time_signatures),
                          ticks_per_quarter=self.ticks_per_quarter)
        for n in self.notes:
            out.add_note(n.pitch, n.velocity, n.start_time + seconds,
                         n.end_time + seconds, program=n.program,
                         instrument=n.instrument, is_drum=n.is_drum)
        return out


def trim_note_sequence(ns: NoteSequence, start: float,
                       end: float) -> NoteSequence:
    """Keep notes overlapping [start, end), clipped, re-based at 0 offset.

    Matches ``note_seq.sequences_lib.trim_note_sequence`` semantics closely
    enough for the framewise metrics: notes starting inside the window are
    kept with times clipped to the window (not re-based).
    """
    out = NoteSequence(tempos=list(ns.tempos),
                      time_signatures=list(ns.time_signatures),
                      ticks_per_quarter=ns.ticks_per_quarter)
    for n in ns.notes:
        if n.start_time < end and n.start_time >= start:
            out.add_note(n.pitch, n.velocity, n.start_time,
                         min(n.end_time, end), program=n.program,
                         instrument=n.instrument, is_drum=n.is_drum)
    out.total_time = min(ns.total_time, end)
    return out


def concatenate_sequences(seqs: List[NoteSequence]) -> NoteSequence:
    """Concatenate sequences back-to-back in time."""
    out = NoteSequence()
    offset = 0.0
    for ns in seqs:
        if not out.tempos and ns.tempos:
            out.tempos = list(ns.tempos)
        for n in ns.notes:
            out.add_note(n.pitch, n.velocity, n.start_time + offset,
                         n.end_time + offset, program=n.program,
                         instrument=n.instrument, is_drum=n.is_drum)
        offset += ns.total_time
    out.total_time = offset
    return out
