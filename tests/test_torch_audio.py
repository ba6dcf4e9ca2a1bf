"""The port's audio and corpus scripts against ``smd_tpu``'s, on the CPU.

``codec.synth`` builds ``native/smd_synth.cpp`` with the JAX package's
``g++`` flags into ``smd_tpu_torch/_build/`` and renders what the JAX
package's native renderer renders, bit for bit (the JAX side builds the
same source with the same flags in a temporary directory, so ``native/``
is left as it is); its WAV bytes are the JAX package's; a failed build
raises instead of falling back. The numpy plain version, another
synthesizer, plays the same notes at the same times. ``sample_audio``
writes MIDI files and non-silent WAVs as a subprocess; the corpus scripts
write the JAX scripts' MIDI bytes.
"""
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from smd_tpu.codec import midi_io as jmidi
from smd_tpu.codec import note_sequence as jns
from smd_tpu.codec import synth as jsynth
from smd_tpu_torch.codec import midi_io, synth
from smd_tpu_torch.codec import note_sequence as tns

ROOT = Path(__file__).resolve().parent.parent
SR = 22050


def _sequence(module, seed=0):
    """Notes of several programs and drums, some overlapping, of
    ``module``'s NoteSequence."""
    rng = np.random.default_rng(seed)
    ns = module.NoteSequence(tempos=[module.Tempo(qpm=120)])
    t = 0.0
    for i in range(24):
        dur = float(rng.choice([0.1, 0.25, 0.5]))
        drum = i % 7 == 3
        ns.add_note(int(rng.integers(36, 90)), int(rng.integers(30, 127)),
                    t, t + dur, program=int(rng.integers(0, 128)),
                    is_drum=drum, instrument=9 if drum else i % 3)
        t += dur * float(rng.choice([0.5, 1.0]))
    return ns


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native renderer built from the same source with
    its own flags in ``tmp_path`` (its ``native/`` untouched)."""
    shutil.copy(ROOT / "native" / "smd_synth.cpp", tmp_path)
    monkeypatch.setattr(jsynth, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(jsynth, "_LIB", None)
    monkeypatch.setattr(jsynth, "_LIB_TRIED", False)
    assert jsynth._load_native() is not None
    return jsynth


@pytest.mark.parametrize("seed", [0, 1])
def test_native_render_equals_jax(jax_native, seed):
    ours = synth.synthesize(_sequence(tns, seed), SR)
    ref = jax_native.synthesize(_sequence(jns, seed), SR)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    assert np.abs(ours).max() > 0.1
    assert Path(synth.library_path()).parent == \
        ROOT / "smd_tpu_torch" / "_build"


def test_wav_bytes_equal_jax(jax_native, tmp_path):
    synth.note_sequence_to_wav(_sequence(tns), str(tmp_path / "ours.wav"),
                               SR)
    jax_native.note_sequence_to_wav(_sequence(jns), str(tmp_path / "ref.wav"),
                                    SR)
    assert (tmp_path / "ours.wav").read_bytes() == \
        (tmp_path / "ref.wav").read_bytes()


def test_empty_sequence_is_silence():
    ns = tns.NoteSequence(total_time=1.0)
    out = synth.synthesize(ns, SR)
    assert out.shape == (int(1.5 * SR) + 1,) and not out.any()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No quiet switch to the numpy renderer: a source g++ refuses
    raises, and nothing is written outside the build directory."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(synth, "SOURCE", str(bad))
    monkeypatch.setattr(synth, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(synth, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        synth.synthesize(_sequence(tns), SR)
    assert os.listdir(tmp_path / "build") == []


def _peak_hz(x, sr):
    spectrum = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.argmax(spectrum) * sr / len(x)


def test_plain_version_plays_the_same_notes():
    """The numpy plain version is another synthesizer (one sine, no
    harmonics, another envelope), so it is held to the native render by
    what both must share: each note's strongest frequency is its
    fundamental within one FFT bin in both, and both are silent before
    the first note and after the last note's release."""
    ns = tns.NoteSequence(tempos=[tns.Tempo(qpm=120)])
    for i, pitch in enumerate((57, 64, 69, 76, 81)):
        ns.add_note(pitch, 100, 0.6 * i + 0.1, 0.6 * i + 0.5,
                    program=8 * i)
    native = synth.synthesize(ns, SR)
    plain = synth._numpy_render(*synth._note_arrays(ns),
                                len(native), SR).astype(np.float32)
    assert plain.shape == native.shape
    for note in ns.notes:
        span = slice(int((note.start_time + 0.05) * SR),
                     int((note.end_time - 0.02) * SR))
        fundamental = 440.0 * 2 ** ((note.pitch - 69) / 12)
        bin_hz = SR / (span.stop - span.start)
        for out in (native, plain):
            assert abs(_peak_hz(out[span], SR) - fundamental) <= bin_hz
    first = int(0.1 * SR)
    tail = int((ns.notes[-1].end_time + 0.3) * SR)
    for out in (native, plain):
        assert not out[:first].any() and not out[tail:].any()
        assert np.abs(out).max() <= 1.0


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(module, argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]


@pytest.mark.parametrize("name,args,kwargs", [
    ("make_melody_corpus", ["--min_bars=4", "--max_bars=9"], (4, 9)),
    ("make_multitrack_corpus", [], ())])
def test_corpus_scripts_write_the_jax_scripts_bytes(name, args, kwargs,
                                                    tmp_path):
    n, seed = 5, 11
    _run(f"smd_tpu_torch.scripts.{name}",
         [f"--output_dir={tmp_path}", f"--n_songs={n}", f"--seed={seed}",
          *args])
    # The JAX script's main, its lines as they are there: one generator,
    # make_song after make_song, each written by the JAX package's writer.
    jax_script = _load_script(name)
    rng = np.random.default_rng(seed)
    for i in range(n):
        ref = jmidi.note_sequence_to_midi(jax_script.make_song(rng, *kwargs))
        assert (tmp_path / f"song_{i:05d}.mid").read_bytes() == ref, i


def test_sample_audio_writes_wavs(tmp_path):
    from scipy.io import wavfile

    from smd_tpu_torch.utils import io as io_lib
    rng = np.random.default_rng(12)
    io_lib.save(rng.normal(size=(3, 2, 512)).astype(np.float32),
                str(tmp_path / "in" / "generated.pkl"))
    out = tmp_path / "audio"
    _run("smd_tpu_torch.scripts.sample_audio",
         [f"--input={tmp_path / 'in'}", f"--output={out}",
          f"--vae_params={ROOT / 'checkpoints' / 'musicvae-melody.pkl'}",
          "--n_synth=3", "--sample_rate=16000", "--device=cpu"])
    for group in ("generated", "prior"):
        for i in range(3):
            base = out / group / f"{i:03d}"
            rate, pcm = wavfile.read(f"{base}.wav")
            ns = midi_io.read_midi_file(f"{base}.mid")
            assert rate == 16000 and ns.notes
            # The MIDI file ends at its last note off; the song may end on
            # a rest.
            assert len(pcm) >= int((ns.total_time + 0.5) * rate) + 1
            assert np.abs(pcm).max() > 1000   # not silent (int16)
            assert (Path(f"{base}.png")).stat().st_size > 0


# -- the scripts' flags ------------------------------------------------------

SCRIPTS = ("train_musicvae", "eval_codec", "sample_audio",
           "make_melody_corpus", "make_multitrack_corpus")


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_flags_match_the_jax_scripts(name, monkeypatch):
    """Each port script defines the JAX script's flags, names, defaults
    and help text alike, plus ``--device`` where it runs a model. The JAX
    script's flags go to a FlagValues of their own (absl's global one is
    left alone)."""
    import importlib

    from absl import app, flags  # noqa: F401  (app's own flags first)
    jax_flags = flags.FlagValues()
    for kind in ("string", "integer", "float", "bool", "boolean", "enum"):
        define = getattr(flags, f"DEFINE_{kind}")
        monkeypatch.setattr(
            flags, f"DEFINE_{kind}",
            lambda *a, _define=define, **kw: _define(
                *a, flag_values=jax_flags, **kw))
    script = _load_script(name)
    if hasattr(script, "_define_flags"):   # the corpus scripts
        script._define_flags()
    ours = importlib.import_module(f"smd_tpu_torch.scripts.{name}").FLAGS
    names = set(jax_flags)
    extra = set(ours.names()) - names
    assert extra == (set() if name.startswith("make_") else {"device"})
    assert names <= set(ours.names())
    for flag in names:
        ref, mine = jax_flags[flag], ours._flags[flag]
        assert mine.default == ref.default, flag
        help_text = ref.help
        if isinstance(ref, flags.EnumFlag):
            # absl prefixes an enum's help with its choices; the port
            # takes each of them.
            prefix = f"<{'|'.join(ref.parser.enum_values)}>: "
            assert help_text.startswith(prefix)
            help_text = help_text[len(prefix):]
            for value in ref.parser.enum_values:
                ours(["prog", f"--{flag}={value}"])
        assert mine.help == help_text, flag
