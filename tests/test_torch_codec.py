"""The port's numpy codec layer against ``smd_tpu``'s, on seeded pieces.

NoteSequences, MIDI bytes, the melody, performance and grid converters,
melody extraction and the ``song`` helpers must give what the JAX package
gives, exactly: the modules are copies, and these tests keep them so. The
pieces are the JAX package's synthetic corpora (``scripts/make_*_corpus``)
at fixed seeds, built once in each package's NoteSequence.
"""
import dataclasses

import numpy as np
import pytest

from scripts import make_melody_corpus, make_multitrack_corpus
from smd_tpu import config as jconfig
from smd_tpu.codec import melody as jmelody
from smd_tpu.codec import midi_io as jmidi
from smd_tpu.codec import multitrack as jmultitrack
from smd_tpu.codec import note_sequence as jns
from smd_tpu.codec import performance as jperf
from smd_tpu.codec import song as jsong
from smd_tpu_torch import config
from smd_tpu_torch.codec import melody, midi_io, multitrack
from smd_tpu_torch.codec import note_sequence as tns
from smd_tpu_torch.codec import performance, song

SEEDS = (0, 1, 2)


def to_port(ns: jns.NoteSequence) -> tns.NoteSequence:
    """The same sequence as the port's NoteSequence."""
    out = tns.NoteSequence(
        tempos=[tns.Tempo(**dataclasses.asdict(t)) for t in ns.tempos],
        time_signatures=[tns.TimeSignature(**dataclasses.asdict(t))
                         for t in ns.time_signatures],
        ticks_per_quarter=ns.ticks_per_quarter,
        quantization_info_steps_per_quarter=(
            ns.quantization_info_steps_per_quarter),
        total_time=ns.total_time)
    out.notes = [tns.Note(**dataclasses.asdict(n)) for n in ns.notes]
    return out


def as_tuple(ns):
    """Every field of a NoteSequence of either package, comparable."""
    return (tuple(tuple(dataclasses.astuple(n)) for n in ns.notes),
            ns.total_time, tuple(dataclasses.astuple(t) for t in ns.tempos),
            tuple(dataclasses.astuple(t) for t in ns.time_signatures),
            ns.ticks_per_quarter, ns.quantization_info_steps_per_quarter)


def melody_piece(seed):
    return make_melody_corpus.make_song(np.random.default_rng(seed),
                                        min_bars=6, max_bars=12)


def multitrack_piece(seed):
    ns = make_multitrack_corpus.make_song(np.random.default_rng(seed))
    # A drum track and a tempo change exercise the MIDI channel and tempo
    # map paths.
    for i in range(8):
        ns.add_note(36 + i % 3, 100, 0.25 * i, 0.25 * i + 0.1,
                    instrument=9, is_drum=True)
    ns.tempos.append(jns.Tempo(time=1.0, qpm=90.0))
    return ns


def _assert_tensors_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("piece", [melody_piece, multitrack_piece])
def test_midi_bytes_and_parse_equal_jax(piece, seed):
    ns = piece(seed)
    data = jmidi.note_sequence_to_midi(ns)
    assert midi_io.note_sequence_to_midi(to_port(ns)) == data
    assert as_tuple(midi_io.midi_to_note_sequence(data)) == \
        as_tuple(jmidi.midi_to_note_sequence(data))


def test_midi_files_equal_jax(tmp_path):
    ns = multitrack_piece(3)
    jmidi.write_midi_file(ns, str(tmp_path / "jax.mid"))
    midi_io.write_midi_file(to_port(ns), str(tmp_path / "port.mid"))
    assert (tmp_path / "jax.mid").read_bytes() == \
        (tmp_path / "port.mid").read_bytes()
    assert as_tuple(midi_io.read_midi_file(str(tmp_path / "jax.mid"))) == \
        as_tuple(jmidi.read_midi_file(str(tmp_path / "jax.mid")))


@pytest.mark.parametrize("seed", SEEDS)
def test_note_sequence_ops_equal_jax(seed):
    ns = multitrack_piece(seed)
    port = to_port(ns)
    assert as_tuple(port.quantize(4)) == as_tuple(ns.quantize(4))
    assert as_tuple(port.shift(-0.5)) == as_tuple(ns.shift(-0.5))
    assert as_tuple(port.extract_instrument(ns.instruments()[0])) == \
        as_tuple(ns.extract_instrument(ns.instruments()[0]))
    assert as_tuple(tns.trim_note_sequence(port, 1.0, 3.0)) == \
        as_tuple(jns.trim_note_sequence(ns, 1.0, 3.0))
    assert as_tuple(tns.concatenate_sequences([port, port])) == \
        as_tuple(jns.concatenate_sequences([ns, ns]))


@pytest.mark.parametrize("name", ["melody_2bar_converter",
                                  "mel_2bar_nopoly_converter",
                                  "melody_16bar_converter"])
@pytest.mark.parametrize("seed", SEEDS)
def test_melody_converters_equal_jax(name, seed):
    ours, ref = getattr(config, name), getattr(jconfig, name)
    chunks = 0
    # The nopoly converter drops the polyphonic piece's every segment.
    for ns in (melody_piece(seed), multitrack_piece(seed)):
        tensors = ref.to_tensors(ns).inputs
        chunks += len(tensors)
        _assert_tensors_equal(ours.to_tensors(to_port(ns)).inputs, tensors)
        assert [as_tuple(s) for s in ours.from_tensors(tensors)] == \
            [as_tuple(s) for s in ref.from_tensors(tensors)]
    assert chunks, "pieces with no chunks test nothing"


@pytest.mark.parametrize("seed", SEEDS)
def test_extract_melodies_equals_jax(seed):
    ns = multitrack_piece(seed)
    for longest in (False, True):
        ref = jmelody.extract_melodies(ns, keep_longest_split=longest)
        assert ref
        assert [as_tuple(m) for m in melody.extract_melodies(
            to_port(ns), keep_longest_split=longest)] == \
            [as_tuple(m) for m in ref]


@pytest.mark.parametrize("name", ["multiperf_default_1bar_converter",
                                  "multiperf_zero_1bar_converter"])
@pytest.mark.parametrize("seed", SEEDS)
def test_performance_converters_equal_jax(name, seed):
    ours, ref = getattr(performance, name), getattr(jperf, name)
    ns = multitrack_piece(seed)
    tensors = ref.to_tensors(ns).inputs
    assert tensors
    _assert_tensors_equal(ours.to_tensors(to_port(ns)).inputs, tensors)
    assert [as_tuple(s) for s in ours.from_tensors(tensors)] == \
        [as_tuple(s) for s in ref.from_tensors(tensors)]


@pytest.mark.parametrize("name", ["multitrack_default_1bar_converter",
                                  "multitrack_zero_1bar_converter"])
def test_grid_converters_equal_jax(name):
    ours, ref = getattr(multitrack, name), getattr(jmultitrack, name)
    for seed in SEEDS:
        ns = multitrack_piece(seed)
        tensors = ref.to_tensors(ns).inputs
        assert tensors
        _assert_tensors_equal(ours.to_tensors(to_port(ns)).inputs, tensors)
        assert [as_tuple(s) for s in ours.from_tensors(tensors)] == \
            [as_tuple(s) for s in ref.from_tensors(tensors)]


class _FakeCodec:
    """Stands in for a TrainedMusicVAE of either package: the song helpers
    use only these members. Encoding hashes each chunk's tokens into a
    latent; decoding returns the melody converter's sequences of tokens
    drawn from the latent's signs."""

    latent_dims = 8

    class config:
        max_seq_len = 32

    def __init__(self, converter):
        self.converter = converter

    def encode_tensors(self, tensors):
        tokens = np.stack(tensors).argmax(-1).astype(np.float64)
        z = np.stack([np.cos(tokens[:, i::8].sum(-1)) for i in range(8)], -1)
        return z, z + 1.0, np.abs(z) + 0.5

    def decode(self, z, temperature=1e-3, length=None):
        z = np.asarray(z)
        tokens = np.where(np.repeat(z, 4, axis=1) > 0, 2 + 30, 0)
        tokens[:, 0] = 2 + 20
        return self.converter.from_tensors(tokens)


def test_song_helpers_equal_jax():
    rng = np.random.default_rng(7)
    p0, p1 = rng.normal(size=(4, 8)), rng.normal(size=(4, 8))
    for alpha in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(
            song.spherical_interpolation(p0, p1, alpha),
            jsong.spherical_interpolation(p0, p1, alpha))

    pieces = [melody_piece(s) for s in SEEDS]
    jcodec = _FakeCodec(jmelody.melody_2bar_converter)
    codec = _FakeCodec(melody.melody_2bar_converter)
    jsongs = [jsong.Song(ns) for ns in pieces]
    songs = [song.Song(to_port(ns)) for ns in pieces]
    for ours, ref in zip(songs, jsongs):
        assert song.count_measures(ours.note_sequence) == \
            jsong.count_measures(ref.note_sequence)
        assert ours.count_chunks() == ref.count_chunks()
        tensors, seqs = ours.chunks()
        ref_tensors, ref_seqs = ref.chunks()
        _assert_tensors_equal(tensors, ref_tensors)
        assert [as_tuple(s) for s in seqs] == [as_tuple(s) for s in ref_seqs]
        assert ours.find_programs() == ref.find_programs()
        assert as_tuple(ours.truncate(2, 1).note_sequence) == \
            as_tuple(ref.truncate(2, 1).note_sequence)
        np.testing.assert_array_equal(ours.encode(codec), ref.encode(jcodec))

    for ours, ref in zip(song.encode_songs(codec, songs),
                         jsong.encode_songs(jcodec, jsongs)):
        np.testing.assert_array_equal(ours, ref)
    # A zero latent decodes to a rest.
    z = rng.normal(size=(5, 8))
    z[2] = 0.0
    chunks = song.embeddings_to_chunks(z, codec)
    assert chunks[2].notes == [] and chunks[1].notes
    assert [as_tuple(c) for c in chunks] == \
        [as_tuple(c) for c in jsong.embeddings_to_chunks(z, jcodec)]
    assert as_tuple(song.embeddings_to_song(
        z, codec, codec.converter).note_sequence) == as_tuple(
        jsong.embeddings_to_song(z, jcodec, jcodec.converter).note_sequence)

    multi = [multitrack_piece(s) for s in SEEDS]
    ports = [to_port(ns) for ns in multi]
    song.fix_instruments_for_concatenation(ports)
    jsong.fix_instruments_for_concatenation(multi)
    assert [as_tuple(p) for p in ports] == [as_tuple(m) for m in multi]
    shifted = song.generate_shifted_sequences(song.Song(to_port(multi[0])), 2)
    ref = jsong.generate_shifted_sequences(jsong.Song(multi[0]), 2)
    assert [as_tuple(s.note_sequence) for s in shifted] == \
        [as_tuple(s.note_sequence) for s in ref]
