"""Song abstraction and latent encode/decode helpers (a copy of
``smd_tpu/codec/song.py``).

Capability parity with the reference's ``utils/song_utils.py``: the ``Song``
wrapper (:272), ``chunks_to_embeddings`` (:142, zero vectors for rest chunks),
``embeddings_to_chunks``/``embeddings_to_song`` (:177-228, zero-norm -> rest),
``encode_songs`` (:231, returns [3, n_chunks, 512] stacks),
``spherical_interpolation`` (:27), ``count_measures`` (:40), and the
instrument-fixing helpers (:117-139).
"""
from __future__ import annotations

from typing import List

import numpy as np

from smd_tpu_torch.codec import midi_io
from smd_tpu_torch.codec.melody import melody_2bar_converter
from smd_tpu_torch.codec.note_sequence import (NoteSequence,
                                               concatenate_sequences)

__all__ = [
    "spherical_interpolation", "count_measures",
    "fix_instruments_for_concatenation", "chunks_to_embeddings",
    "embeddings_to_chunks", "embeddings_to_song", "encode_songs", "Song",
]


def spherical_interpolation(p0, p1, alpha):
    """Spherical linear interpolation between batches of vectors."""
    assert p0.shape == p1.shape and p0.ndim == 2
    unit_p0 = p0 / np.linalg.norm(p0, axis=1, keepdims=True)
    unit_p1 = p1 / np.linalg.norm(p1, axis=1, keepdims=True)
    omega = np.arccos(np.clip(np.sum(unit_p0 * unit_p1, axis=1), -1, 1))
    so = np.sin(omega)
    so = np.where(so == 0, 1e-9, so)
    c1 = (np.sin((1.0 - alpha) * omega) / so)[:, np.newaxis]
    c2 = (np.sin(alpha * omega) / so)[:, np.newaxis]
    return c1 * p0 + c2 * p1


def count_measures(ns: NoteSequence) -> float:
    """Approximate number of measures in the sequence."""
    ts = ns.time_signatures[0] if ns.time_signatures else None
    numerator = ts.numerator if ts else 4
    denominator = ts.denominator if ts else 4
    quarters_per_bar = 4 * numerator / denominator
    seconds_per_bar = 60 * quarters_per_bar / ns.qpm
    return ns.total_time / seconds_per_bar


def generate_shifted_sequences(song, resolution=1):
    """Shifted, overlapping versions of a Song (ref ``song_utils.py:96-113``).

    Offsets are uniformly spaced over a 2-second window; each shift drops
    the first ``offset*step`` seconds.
    """
    offset = 2.0 / resolution
    results = []
    for step in range(resolution):
        shifted = song.note_sequence.shift(-offset * step)
        shifted.notes = [n for n in shifted.notes if n.start_time >= 0]
        shifted.total_time = max(
            [n.end_time for n in shifted.notes], default=0.0)
        results.append(Song(shifted, song.data_converter, chunk_length=1))
    return results


def fix_instruments_for_concatenation(note_sequences: List[NoteSequence]):
    """Map programs to stable instrument slots across chunks (ref :117-139)."""
    instruments = {}
    for ns in note_sequences:
        for note in ns.notes:
            if not note.is_drum:
                if note.program not in instruments:
                    if len(instruments) >= 8:
                        instruments[note.program] = len(instruments) + 2
                    else:
                        instruments[note.program] = len(instruments) + 1
                note.instrument = instruments[note.program]
            else:
                note.instrument = 9


def chunks_to_embeddings(sequences, model, data_converter):
    """Encode chunks; full-rest chunks get zero vectors (ref :142-174)."""
    assert model is not None, "No model provided."
    latent_dims = model.latent_dims
    idx, tensors = [], []
    zs = np.zeros((len(sequences), latent_dims))
    mus = np.zeros((len(sequences), latent_dims))
    sigmas = np.zeros((len(sequences), latent_dims))
    for i, chunk in enumerate(sequences):
        inputs = data_converter.to_tensors(chunk).inputs
        if len(inputs) > 0:
            idx.append(i)
            tensors.append(inputs[0])
    if tensors:
        z, mu, sigma = model.encode_tensors(tensors)
        for i, mean in enumerate(mu):
            zs[idx[i]] = z[i]
            mus[idx[i]] = mean
            sigmas[idx[i]] = sigma[i]
    return zs, mus, sigmas


def embeddings_to_chunks(embeddings, model, temperature=1e-3):
    """Decode latents to chunks; zero-norm embeddings become rests."""
    assert model is not None and len(embeddings) > 0
    chunks = model.decode(embeddings, temperature=temperature,
                          length=model.config.max_seq_len)
    norms = np.linalg.norm(np.asarray(embeddings), axis=1)
    for i in np.where(norms == 0)[0]:
        rest = NoteSequence()
        rest.total_time = chunks[i].total_time
        chunks[i] = rest
    return chunks


def embeddings_to_song(embeddings, model, data_converter,
                       fix_instruments=True, temperature=1e-3):
    chunks = embeddings_to_chunks(embeddings, model, temperature)
    if fix_instruments:
        fix_instruments_for_concatenation(chunks)
    return Song(concatenate_sequences(chunks), data_converter,
                reconstructed=True)


def encode_songs(model, songs, chunk_length=None, programs=None):
    """Batch-encode songs into [3, n_chunks, latent] stacks (ref :231-269)."""
    assert model is not None and len(songs) > 0
    chunks, splits = [], []
    data_converter = songs[0].data_converter
    i = 0
    for song in songs:
        _, chunk_sequences = song.chunks(chunk_length=chunk_length,
                                         programs=programs)
        chunks.extend(chunk_sequences)
        splits.append(i)
        i += len(chunk_sequences)

    z, mu, sigma = chunks_to_embeddings(chunks, model, data_converter)

    encoding = []
    for i in range(len(splits)):
        j = splits[i]
        k = None if i + 1 == len(splits) else splits[i + 1]
        encoding.append(np.stack([z[j:k], mu[j:k], sigma[j:k]]))
    return encoding


class Song:
    """NoteSequence + data converter with chunk/encode/select utilities."""

    def __init__(self, note_sequence, data_converter=None, chunk_length=2,
                 multitrack=False, reconstructed=False):
        self.note_sequence = note_sequence
        self.data_converter = data_converter or melody_2bar_converter
        self.chunk_length = chunk_length
        self.reconstructed = reconstructed
        self.multitrack = multitrack

    def encode(self, model, chunk_length=None, programs=None):
        _, chunk_sequences = self.chunks(chunk_length=chunk_length,
                                         programs=programs)
        z, _, _ = chunks_to_embeddings(chunk_sequences, model,
                                       self.data_converter)
        return z

    def chunks(self, chunk_length=None, programs=None, fix_instruments=True):
        assert not self.reconstructed, \
            "Not safe to tokenize reconstructed Songs."
        data = self.note_sequence
        step_size = chunk_length if chunk_length is not None \
            else self.chunk_length
        if programs is not None:
            data = self.select_programs(programs)
        tensors = self.data_converter.to_tensors(data).inputs[::step_size]
        sequences = self.data_converter.from_tensors(tensors)
        if fix_instruments and self.multitrack:
            fix_instruments_for_concatenation(sequences)
        return tensors, sequences

    def count_chunks(self, chunk_length=None):
        length = self.chunk_length if chunk_length is None else chunk_length
        return count_measures(self.note_sequence) // length

    @property
    def programs(self):
        return list({n.program for n in self.note_sequence.notes})

    def select_programs(self, programs):
        assert len(programs) > 0 and all(p >= 0 for p in programs)
        ns = NoteSequence(tempos=list(self.note_sequence.tempos),
                         time_signatures=list(
                             self.note_sequence.time_signatures),
                         ticks_per_quarter=self.note_sequence.
                         ticks_per_quarter)
        for note in self.note_sequence.notes:
            if note.program in programs:
                ns.add_note(note.pitch, note.velocity, note.start_time,
                            note.end_time, program=note.program,
                            instrument=note.instrument, is_drum=note.is_drum)
        return ns

    def truncate(self, chunks=0, offset=0):
        tensors = self.data_converter.to_tensors(
            self.note_sequence).inputs[::self.chunk_length]
        sequences = self.data_converter.from_tensors(
            tensors)[offset:offset + chunks]
        fix_instruments_for_concatenation(sequences)
        return Song(concatenate_sequences(sequences), self.data_converter,
                    chunk_length=self.chunk_length)

    def _count_melody_chunks(self, program):
        ns = self.select_programs([program])
        tensors = melody_2bar_converter.to_tensors(ns).inputs[::2]
        return len(melody_2bar_converter.from_tensors(tensors))

    def find_programs(self):
        """Programs whose melody-chunk count matches the song length."""

        def heuristic(program):
            expected = self.count_chunks(chunk_length=2)
            extracted = self._count_melody_chunks(program)
            return extracted > 0 and \
                abs(extracted - expected) < 0.5 * expected

        return [p for p in self.programs if heuristic(p)]

    def stripped_song(self):
        return Song(self.select_programs(self.find_programs()),
                    self.data_converter, self.chunk_length)

    def download(self, filename, preprocessed=True, programs=None):
        """Write the song as a MIDI file."""
        data = self.note_sequence
        if programs is not None:
            data = self.select_programs(programs)
        if not self.reconstructed and preprocessed:
            _, chunks = self.chunks(programs=programs)
            data = concatenate_sequences(chunks)
        midi_io.write_midi_file(data, filename)
