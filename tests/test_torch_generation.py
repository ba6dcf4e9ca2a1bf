"""Noise -> latents -> MIDI, and MIDI -> latents, with the port on the CPU.

The port's bundle writer writes the JAX package's bundle format: a bundle
that either package wrote is served by the JAX package's ``load_model_fn``
(in a subprocess, its absl flags being global) and by the port's to the
same output. The four codec CLIs (``package_generation_bundle``,
``generate_melodies``, ``generate_song_data``, ``decode_dataset``) run once
each as subprocesses with ``--device=cpu`` at tiny widths: a 1-layer
flagship and a codec with 8-unit LSTMs.
"""
import glob
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from smd_tpu_torch.codec import midi_io
from smd_tpu_torch.codec import musicvae as mv
from smd_tpu_torch.codec import note_sequence as tns
from smd_tpu_torch.data import tfrecord_native
from smd_tpu_torch.models import get_model
from smd_tpu_torch.scripts import generate_melodies, generate_song_data
from smd_tpu_torch.utils import io as io_lib
from smd_tpu_torch.utils.flax_params import flatten, random_flax_params
from test_torch_codec import multitrack_piece, to_port
from test_torch_sample_cli import _checkpointed_run, _run

ROOT = Path(__file__).resolve().parent.parent
# The keys of the JAX package's bundle (scripts/package_generation_bundle.py).
BUNDLE_KEYS = {"kind", "arch", "params", "schedule", "sample_shape",
               "out_channels", "slice_idx", "normalize", "data_min",
               "data_max", "provenance", "consistency"}
ARCH = {"architecture": "TransformerDDPM", "num_layers": 1, "num_heads": 2,
        "num_mlp_layers": 1, "mlp_dims": 16}
# Both packages in float32 on the CPU from the same fp16 leaves; the x5000
# noise encoding's one-ulp exp differences reach the output at ~1e-5 of its
# norm (tests/test_torch_model.py holds the flagship to 1e-4).
SERVE_RTOL = 1e-4


def _fp16(tree):
    return {k: _fp16(v) if isinstance(v, dict) else v.astype(np.float16)
            for k, v in tree.items()}


def _codec_bundle(path, **kw):
    """A codec bundle as train_musicvae writes one: Flax-layout fp16 leaves
    from a seed and the config; 8-unit LSTMs over 512-d latents."""
    cfg = mv.MusicVAEConfig(**{"latent_dims": 512, "enc_units": 8,
                               "dec_units": (8,), "conductor_units": 8,
                               **kw})
    with torch.device("meta"):
        shapes = mv.MusicVAE(cfg)
    io_lib.save({"params": _fp16(random_flax_params(shapes, seed=4)),
                 "config": cfg}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def port_bundle(tmp_path_factory):
    """A tiny flagship's step-1 checkpoint, a consistency pack beside it,
    and the bundle the port's packer wrote of them (run as a subprocess)."""
    from smd_tpu_torch import cli
    from smd_tpu_torch.diffusion import schedules
    from smd_tpu_torch.models.layers import init_parameters
    from smd_tpu_torch.training.distill import distill_grid
    tmp = tmp_path_factory.mktemp("bundle")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)
        argv, model_dir = _checkpointed_run(tmp)
        student = init_parameters(cli.model_from_flags(42), seed=1)
        betas = schedules.noise_schedule(cli.FLAGS.sigma_begin,
                                         cli.FLAGS.sigma_end,
                                         cli.FLAGS.num_sigmas, "linear")
        io_lib.save({"params": {n: p.detach() for n, p in
                                student.named_parameters()},
                     "grid": np.asarray(distill_grid(betas, 4))},
                    str(model_dir / "distilled" / "consistency.pkl"))
        path = tmp / "bundle.pkl"
        _run("smd_tpu_torch.scripts.package_generation_bundle",
             [*argv, f"--output={path}", "--provenance=test"])
        _, state = cli.restore_state_for_sampling((32, 42))
    return path, state.sampling_params, student


def test_package_generation_bundle_writes_the_jax_format(port_bundle):
    path, params, student = port_bundle
    bundle = io_lib.load(str(path))
    assert set(bundle) == BUNDLE_KEYS
    assert bundle["kind"] == "smd-tpu-generation-bundle"
    assert bundle["arch"]["architecture"] == "TransformerDDPM"
    assert bundle["sample_shape"] == [32, 42] and bundle["out_channels"] == 512
    assert bundle["provenance"] == "test" and bundle["normalize"]
    assert bundle["slice_idx"].shape == (42,)
    for tree, ref in ((bundle["params"], params),
                      (bundle["consistency"]["params"],
                       dict(student.named_parameters()))):
        leaves = flatten(tree)
        assert set(leaves) == set(ref)
        for name, leaf in leaves.items():
            assert leaf.dtype == np.float16
            np.testing.assert_array_equal(
                leaf, ref[name].detach().numpy().astype(np.float16))
    assert bundle["consistency"]["grid"].shape == (5,)


# JAX's load_model_fn in one process: its absl flags are global.
_JAX_SERVER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import scripts.generate_melodies as g
    from smd_tpu.utils import io as io_lib
    data = np.load({inputs!r})
    outs = {{}}
    for i, (path, which) in enumerate({runs!r}):
        fn = g.load_model_fn(io_lib.load(path), which)
        outs[str(i)] = np.asarray(fn(data["x"], data["cond"]))
    np.savez({out!r}, **outs)
""")


def _jax_bundle(path):
    """A bundle as the JAX packer writes one: numpy fp16 leaves of a
    Flax-layout tree (seeded), numpy slice, a consistency pack."""
    model = get_model("TransformerDDPM", device="cpu", data_channels=42,
                      **{k: v for k, v in ARCH.items()
                         if k != "architecture"})

    def fp16(seed):
        return _fp16(random_flax_params(model, seed))
    bundle = {"kind": "smd-tpu-generation-bundle", "arch": dict(ARCH),
              "params": fp16(5),
              "schedule": {"sigma_begin": 1e-6, "sigma_end": 0.01,
                           "num_sigmas": 20, "kind": "linear"},
              "sample_shape": [32, 42], "out_channels": 512,
              "slice_idx": np.arange(42), "normalize": True,
              "data_min": -2.0, "data_max": 2.0, "provenance": "jax",
              "consistency": {"params": fp16(6),
                              "grid": np.linspace(1.0, 0.01, 5)}}
    with open(path, "wb") as f:
        pickle.dump(bundle, f, protocol=4)
    return str(path)


def test_bundles_serve_alike_in_both_packages(port_bundle, tmp_path):
    """A bundle the port wrote and one the JAX packer's format holds, each
    served by JAX's load_model_fn and the port's, base model and
    consistency pack."""
    runs = [(str(port_bundle[0]), "params"),
            (str(port_bundle[0]), "consistency"),
            (_jax_bundle(tmp_path / "jax.pkl"), "params"),
            (_jax_bundle(tmp_path / "jax.pkl"), "consistency")]
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 32, 42)).astype(np.float32)
    cond = rng.uniform(0.05, 1.0, size=(3, 1, 1)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", x=x, cond=cond)
    code = _JAX_SERVER.format(root=str(ROOT), inputs=str(tmp_path /
                                                         "inputs.npz"),
                              runs=runs, out=str(tmp_path / "jax.npz"))
    env = {**os.environ, "SMD_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
           "TF_CPP_MIN_LOG_LEVEL": "3"}
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(tmp_path / "jax.npz")
    for i, (path, which) in enumerate(runs):
        fn = generate_melodies.load_model_fn(io_lib.load(path), which,
                                             device="cpu")
        with torch.no_grad():
            ours = fn(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
        err = np.linalg.norm(ours - ref[str(i)]) / np.linalg.norm(ref[str(i)])
        assert err < SERVE_RTOL, (path, which, err)


def _read_notes(path):
    return [(n.pitch, n.start_time, n.end_time)
            for n in midi_io.read_midi_file(path).notes]


def test_generate_melodies_cli(port_bundle, tmp_path, monkeypatch):
    codec = _codec_bundle(tmp_path / "codec.pkl")
    out = tmp_path / "mid"
    _run("smd_tpu_torch.scripts.generate_melodies",
         [f"--bundle={port_bundle[0]}", f"--vae_params={codec}",
          f"--output_dir={out}", "--n=2", "--sampler=dpmpp", "--steps=2",
          "--device=cpu"])
    assert sorted(os.listdir(out)) == ["melody_000.mid", "melody_001.mid"]
    for name in os.listdir(out):
        notes = _read_notes(str(out / name))
        # 32 two-bar chunks at 120 qpm: 128 s.
        assert all(21 <= p <= 108 and 0 <= s < e <= 128.0 + 1e-6
                   for p, s, e in notes)

    # In process: the consistency pack, the ancestral sampler, the same
    # files again from the same seed, and a bundle with no pack.
    paths = generate_melodies.main([
        "prog", f"--bundle={port_bundle[0]}", f"--vae_params={codec}",
        f"--output_dir={tmp_path / 'cm'}", "--n=1", "--sampler=consistency",
        "--steps=1", "--device=cpu"])
    assert [os.path.basename(p) for p in paths] == ["melody_000.mid"]
    again = generate_melodies.main([
        "prog", f"--bundle={port_bundle[0]}", f"--vae_params={codec}",
        f"--output_dir={tmp_path / 'cm2'}", "--n=1",
        "--sampler=consistency", "--steps=1", "--device=cpu"])
    assert Path(again[0]).read_bytes() == Path(paths[0]).read_bytes()
    generate_melodies.main([
        "prog", f"--bundle={port_bundle[0]}", f"--vae_params={codec}",
        f"--output_dir={tmp_path / 'anc'}", "--n=1", "--sampler=ancestral",
        "--device=cpu"])
    bundle = io_lib.load(str(port_bundle[0]))
    bundle["consistency"] = None
    io_lib.save(bundle, str(tmp_path / "nocm.pkl"))
    with pytest.raises(SystemExit, match="no consistency pack"):
        generate_melodies.main(["prog", f"--bundle={tmp_path / 'nocm.pkl'}",
                                f"--vae_params={codec}", "--device=cpu"])


def _long_melody(seed):
    """40 bars of quarter and eighth notes: two 16-bar chunks."""
    rng = np.random.default_rng(seed)
    ns = tns.NoteSequence(tempos=[tns.Tempo(qpm=120.0)])
    t = 0.0
    while t < 80.0:
        dur = float(rng.choice([0.25, 0.5]))
        ns.add_note(int(rng.integers(55, 80)), 80, t, t + dur * 0.9)
        t += dur
    return ns


def _records(path):
    return [pickle.loads(r) for r in tfrecord_native.iter_records(path)]


@pytest.mark.parametrize("fault", ["division 0", "truncated", "not MIDI"])
def test_parse_midi_skips_a_malformed_file(tmp_path, fault):
    """A file the parser refuses, whatever it raises, is skipped with its
    error (as the JAX package's ``_parse_one`` does): it does not abort the
    pool's run over the corpus."""
    path = tmp_path / "song.mid"
    midi_io.write_midi_file(to_port(multitrack_piece(0)), str(path))
    data = path.read_bytes()
    data = {"division 0": data[:12] + b"\0\0" + data[14:],
            "truncated": data[:len(data) // 2],
            "not MIDI": b"RIFF" + data[4:]}[fault]
    path.write_bytes(data)
    if fault == "division 0":
        with pytest.raises(ZeroDivisionError):
            midi_io.read_midi_file(str(path))
    got_path, chunks, err = generate_song_data.parse_midi(str(path))
    assert got_path == str(path) and chunks == []
    assert err.startswith("parse error: ")


def test_generate_song_data_and_decode_dataset_clis(tmp_path):
    """Seeded MIDI files -> latent records (melody mode, a subprocess; the
    melody16 and multi modes in process) -> token records; every record
    finite and of its shape, the latents those of the codec."""
    midi = tmp_path / "midi"
    midi.mkdir()
    for seed in range(5):
        midi_io.write_midi_file(to_port(multitrack_piece(seed)),
                                str(midi / f"song_{seed}.mid"))
    codec = _codec_bundle(tmp_path / "codec.pkl")
    out = tmp_path / "encoded"
    _run("smd_tpu_torch.scripts.generate_song_data",
         [f"--input={midi}/*.mid", f"--output={out}", f"--vae_params={codec}",
          "--workers=2", "--eval_fraction=0.4", "--device=cpu"])
    vae = mv.TrainedMusicVAE(params=io_lib.load(codec), device="cpu")
    expected = []
    for path in sorted(glob.glob(f"{midi}/*.mid")):
        expected += generate_song_data.parse_midi(path)[1]
    songs = _records(f"{out}/eval_seqs.tfrecord-00000") + \
        _records(f"{out}/training_seqs.tfrecord-00000")
    assert len(songs) == len(expected)
    for song, chunks in zip(songs, expected):
        assert song.shape == (3, len(chunks), 512) and np.isfinite(song).all()
        _, mu, sigma = vae.encode_tensors(chunks)
        np.testing.assert_allclose(song[1], mu, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(song[2], sigma, rtol=1e-5, atol=1e-6)

    dec = tmp_path / "decoded"
    _run("smd_tpu_torch.scripts.decode_dataset",
         [f"--encoded_data={out}", f"--output={dec}",
          f"--vae_params={codec}", "--device=cpu"])
    decoded = _records(f"{dec}/decoded-eval.tfrecord-00000") + \
        _records(f"{dec}/decoded-train.tfrecord-00000")
    assert len(decoded) == len(songs)
    for tokens, song in zip(decoded, songs):
        assert tokens.dtype == bool and tokens.shape == (song.shape[1] * 32,
                                                         90)
        assert (tokens.sum(-1) == 1).all()

    # The hierarchical modes, at tiny widths of their shapes.
    for mode, kw, pieces in (
            ("melody16", dict(max_seq_len=256, hier_segments=16, depth=90),
             [_long_melody(s) for s in (0, 1)]),
            ("multi", dict(max_seq_len=512, hier_segments=8, depth=490),
             [to_port(multitrack_piece(s)) for s in (5, 6)])):
        src = tmp_path / mode
        src.mkdir()
        for i, ns in enumerate(pieces):
            midi_io.write_midi_file(ns, str(src / f"{i}.mid"))
        count, skipped = generate_song_data.main([
            "prog", f"--input={src}/*.mid", f"--output={tmp_path}/{mode}-out",
            f"--mode={mode}", "--workers=1", "--device=cpu",
            f"--vae_params={_codec_bundle(tmp_path / f'{mode}.pkl', **kw)}"])
        assert count == 2 and skipped == 0
        for song in _records(f"{tmp_path}/{mode}-out/"
                             "training_seqs.tfrecord-00000") + _records(
                f"{tmp_path}/{mode}-out/eval_seqs.tfrecord-00000"):
            assert song.shape[0] == 3 and song.shape[2] == 512
            assert np.isfinite(song).all()
