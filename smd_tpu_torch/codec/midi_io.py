"""Standard MIDI File read/write for NoteSequence (pure Python; a copy of
``smd_tpu/codec/midi_io.py``, which writes the same bytes).

Replaces the reference's dependency on ``note_seq``/``pretty_midi`` MIDI I/O
(``utils/song_utils.py:402-415`` download, Beam pipelines' NoteSequence
parsing). Supports format 0/1 files, running status, tempo maps with
mid-file tempo changes, and note on/off pairing per channel.
"""
from __future__ import annotations

import io
import struct
from typing import Dict, List, Tuple

from smd_tpu_torch.codec.note_sequence import (NoteSequence, Tempo,
                                               TimeSignature)

__all__ = ["midi_to_note_sequence", "note_sequence_to_midi",
           "read_midi_file", "write_midi_file"]

_DRUM_CHANNEL = 9


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _write_varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def midi_to_note_sequence(data: bytes) -> NoteSequence:
    """Parse a Standard MIDI File into a NoteSequence."""
    if data[:4] != b"MThd":
        raise ValueError("Not a MIDI file (missing MThd)")
    header_len = struct.unpack(">I", data[4:8])[0]
    fmt, ntracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    pos = 8 + header_len

    # First pass: gather (tick, event) per track; collect tempo events.
    tempo_events: List[Tuple[int, float]] = []   # (tick, us_per_quarter)
    note_events = []  # (tick, kind, channel, pitch, velocity, program)
    time_sigs: List[Tuple[int, int, int]] = []
    final_tick = 0  # last tick of any event (incl. end-of-track metas)

    for _ in range(ntracks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError("Bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        track = data[pos + 8:pos + 8 + tlen]
        pos += 8 + tlen

        tick = 0
        p = 0
        running_status = 0
        program_by_channel: Dict[int, int] = {}
        while p < len(track):
            delta, p = _read_varlen(track, p)
            tick += delta
            status = track[p]
            if status & 0x80:
                p += 1
                running_status = status
            else:
                status = running_status
            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0x90:  # note on
                pitch, vel = track[p], track[p + 1]
                p += 2
                ev = "on" if vel > 0 else "off"
                note_events.append((tick, ev, channel, pitch, vel,
                                    program_by_channel.get(channel, 0)))
            elif kind == 0x80:  # note off
                pitch, vel = track[p], track[p + 1]
                p += 2
                note_events.append((tick, "off", channel, pitch, vel,
                                    program_by_channel.get(channel, 0)))
            elif kind in (0xA0, 0xB0, 0xE0):  # 2-byte args
                p += 2
            elif kind == 0xC0:  # program change
                program_by_channel[channel] = track[p]
                p += 1
            elif kind == 0xD0:  # channel pressure
                p += 1
            elif status == 0xFF:  # meta
                meta_type = track[p]
                p += 1
                length, p = _read_varlen(track, p)
                payload = track[p:p + length]
                p += length
                if meta_type == 0x51 and length == 3:
                    us = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                    tempo_events.append((tick, float(us)))
                elif meta_type == 0x58 and length >= 2:
                    time_sigs.append((tick, payload[0], 2**payload[1]))
            elif status in (0xF0, 0xF7):  # sysex
                length, p = _read_varlen(track, p)
                p += length
            else:
                raise ValueError(f"Unhandled MIDI status 0x{status:02x}")
        final_tick = max(final_tick, tick)

    # Build tick -> seconds map from the tempo events.
    tempo_events.sort()
    if not tempo_events or tempo_events[0][0] > 0:
        tempo_events.insert(0, (0, 500000.0))  # default 120 qpm

    def tick_to_seconds(tick: int) -> float:
        seconds = 0.0
        for i, (t0, us) in enumerate(tempo_events):
            t1 = tempo_events[i + 1][0] if i + 1 < len(tempo_events) else None
            if t1 is None or tick <= t1:
                return seconds + (tick - t0) * us / 1e6 / division
            seconds += (t1 - t0) * us / 1e6 / division
        return seconds

    ns = NoteSequence(ticks_per_quarter=division)
    for t, us in tempo_events:
        ns.tempos.append(Tempo(time=tick_to_seconds(t), qpm=6e7 / us))
    for t, num, den in sorted(time_sigs):
        ns.time_signatures.append(
            TimeSignature(time=tick_to_seconds(t), numerator=num,
                          denominator=den))

    # Pair note on/off per (channel, pitch).
    note_events.sort(key=lambda e: (e[0], e[1] == "on"))
    active: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
    for tick, ev, channel, pitch, vel, program in note_events:
        key = (channel, pitch)
        if ev == "on":
            active.setdefault(key, []).append((tick, vel, program))
        else:
            if active.get(key):
                start_tick, on_vel, program = active[key].pop(0)
                ns.add_note(pitch, on_vel, tick_to_seconds(start_tick),
                            tick_to_seconds(tick), program=program,
                            instrument=channel,
                            is_drum=channel == _DRUM_CHANNEL)
    # Close dangling notes at the end of the file.
    for (channel, pitch), starts in active.items():
        for start_tick, vel, program in starts:
            ns.add_note(pitch, vel, tick_to_seconds(start_tick),
                        tick_to_seconds(final_tick), program=program,
                        instrument=channel, is_drum=channel == _DRUM_CHANNEL)
    ns.notes.sort(key=lambda n: (n.start_time, n.pitch))
    return ns


def note_sequence_to_midi(ns: NoteSequence) -> bytes:
    """Serialize a NoteSequence to a format-1 Standard MIDI File."""
    division = ns.ticks_per_quarter or 220
    qpm = ns.qpm

    def sec_to_tick(s: float) -> int:
        return max(0, int(round(s * qpm / 60.0 * division)))

    # Track 0: tempo + time signature.
    meta = []
    us = int(round(6e7 / qpm))
    meta.append((0, b"\xFF\x51\x03" + struct.pack(">I", us)[1:]))
    num, den = (4, 4)
    if ns.time_signatures:
        num, den = ns.time_signatures[0].numerator, \
            ns.time_signatures[0].denominator
    den_pow = max(0, den.bit_length() - 1)
    meta.append((0, b"\xFF\x58\x04" + bytes([num, den_pow, 24, 8])))
    meta.append((sec_to_tick(ns.total_time), b"\xFF\x2F\x00"))
    tracks = [meta]

    # One track per instrument.
    instruments: Dict[int, list] = {}
    for n in ns.notes:
        instruments.setdefault(n.instrument, []).append(n)

    for idx, (instrument, notes) in enumerate(sorted(instruments.items())):
        channel = _DRUM_CHANNEL if notes[0].is_drum else \
            (idx % 15 if idx % 16 != _DRUM_CHANNEL else 10) % 16
        if notes[0].is_drum:
            channel = _DRUM_CHANNEL
        events = []
        program = notes[0].program & 0x7F
        events.append((0, bytes([0xC0 | channel, program])))
        for n in notes:
            pitch = int(n.pitch) & 0x7F
            vel = max(1, int(n.velocity)) & 0x7F
            events.append((sec_to_tick(n.start_time),
                           bytes([0x90 | channel, pitch, vel])))
            events.append((sec_to_tick(n.end_time),
                           bytes([0x80 | channel, pitch, 0])))
        events.sort(key=lambda e: e[0])
        events.append((events[-1][0] if events else 0, b"\xFF\x2F\x00"))
        tracks.append(events)

    out = io.BytesIO()
    out.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), division))
    for events in tracks:
        body = io.BytesIO()
        last_tick = 0
        for tick, payload in events:
            body.write(_write_varlen(tick - last_tick))
            body.write(payload)
            last_tick = tick
        data = body.getvalue()
        out.write(b"MTrk" + struct.pack(">I", len(data)) + data)
    return out.getvalue()


def read_midi_file(path: str) -> NoteSequence:
    with open(path, "rb") as f:
        return midi_to_note_sequence(f.read())


def write_midi_file(ns: NoteSequence, path: str):
    with open(path, "wb") as f:
        f.write(note_sequence_to_midi(ns))
