"""Render sampled latents to MIDI, WAV and piano-roll plots (port of
``scripts/sample_audio.py``).

    python -m smd_tpu_torch.scripts.sample_audio --input=SAMPLING_DIR/ncsn \\
        --output=./audio --vae_params=CODEC

Loads ``{real,generated,collection}.pkl`` latent pickles, builds the
baselines (prior = randn, spherical interpolation between bars, infill
re-insertion of fixed bars), decodes every sequence to a NoteSequence
through the MusicVAE codec on ``cuda`` (``--device=cpu`` on the CPU), writes
its MIDI file, then renders WAVs (44.1 kHz int16 through the native
renderer, ``codec.synth``) and piano rolls on a ``spawn`` process pool.
``--include_plots`` (on by default) needs matplotlib and raises without it;
pass ``--noinclude_plots`` there.
"""
from __future__ import annotations

import concurrent.futures
import logging
import multiprocessing
import os
import sys

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_string("input", None, "Directory with {real,generated}.pkl.")
FLAGS.DEFINE_string("output", "./audio", "Output directory.")
FLAGS.DEFINE_integer("n_synth", 10, "Number of samples to render.")
FLAGS.DEFINE_boolean("include_wav", True, "Render WAV audio.")
FLAGS.DEFINE_boolean("include_plots", True, "Render piano-roll plots.")
FLAGS.DEFINE_boolean("gen_interpolations", False,
                     "Build spherical-interpolation baseline.")
FLAGS.DEFINE_boolean("include_collection", False,
                     "Also render intermediate sampling steps "
                     "(collection.pkl).")
FLAGS.DEFINE_boolean("infill", False, "Re-insert real fixed bars (infill).")
FLAGS.DEFINE_integer("sample_rate", 44100, "WAV sample rate.")
FLAGS.DEFINE_string("vae_params", "", "Optional pickled MusicVAE params.")
FLAGS.DEFINE_integer("checkpoint_seed", 0, "Seed for VAE weights.")
FLAGS.DEFINE_float("melody_temperature", 1e-3, "Decode temperature.")
FLAGS.DEFINE_string("device", "cuda",
                    "Device to run on: cuda (the default; raises without a "
                    "GPU) or cpu.")

log = logging.getLogger("smd_tpu_torch")


def _render_one(args):
    """Pool worker: NoteSequence pickle -> WAV and plot."""
    ns_path, out_base, sample_rate, include_wav, include_plots = args
    from smd_tpu_torch.codec import synth
    from smd_tpu_torch.utils import io as io_lib

    ns = io_lib.load(ns_path)
    if include_wav:
        synth.note_sequence_to_wav(ns, out_base + ".wav", sample_rate)
    if include_plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(8, 3), dpi=120)
        for n in ns.notes:
            plt.plot([n.start_time, n.end_time], [n.pitch, n.pitch],
                     lw=3, solid_capstyle="butt")
        plt.xlabel("seconds")
        plt.ylabel("pitch")
        plt.tight_layout()
        fig.savefig(out_base + ".png")
        plt.close(fig)
    return out_base


def latent_groups(base):
    """{name: latents (N, chunks, latent)} of the pickles under ``base``
    and the baselines built from them."""
    from smd_tpu_torch.codec import song as song_lib
    from smd_tpu_torch.utils import io as io_lib

    groups = {}
    for name in ("real", "generated"):
        path = os.path.join(base, f"{name}.pkl")
        if os.path.exists(path):
            latents = np.asarray(io_lib.load(path))
            if latents.ndim == 2:   # 1seq problems: one latent per sample
                latents = latents[:, None, :]
            groups[name] = latents[:FLAGS.n_synth]
    if "real" not in groups and "generated" not in groups:
        raise FileNotFoundError(f"No real.pkl/generated.pkl under {base}")

    # Intermediate sampling steps (collection.pkl), a few evenly spaced.
    coll_path = os.path.join(base, "collection.pkl")
    if FLAGS.include_collection and os.path.exists(coll_path):
        coll = np.asarray(io_lib.load(coll_path))
        for step_idx in np.linspace(0, len(coll) - 1, 4).astype(int):
            latents = coll[step_idx]
            if latents.ndim == 2:
                latents = latents[:, None, :]
            groups[f"collection_{step_idx:03d}"] = latents[:FLAGS.n_synth]

    # Baselines (reference sample_audio.py:158-180).
    ref = groups.get("generated", groups.get("real"))
    groups["prior"] = np.random.randn(*ref.shape)
    if FLAGS.gen_interpolations and "real" in groups:
        interp = []
        for seq in groups["real"]:
            interp.append(
                np.stack([
                    song_lib.spherical_interpolation(
                        seq[7:8], seq[24:25], a).squeeze(0)
                    for a in np.linspace(0, 1, len(seq))
                ]))
        groups["interpolation"] = np.stack(interp)
    if FLAGS.infill and "real" in groups and "generated" in groups:
        fixed = groups["generated"].copy()
        fixed[:, :8] = groups["real"][:, :8]
        fixed[:, -8:] = groups["real"][:, -8:]
        groups["infill"] = fixed
    return groups


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program), decode and render;
    returns the output base paths (``.mid``, ``.wav``, ``.png`` beside
    each)."""
    from smd_tpu_torch.codec import midi_io, song as song_lib, synth
    from smd_tpu_torch.codec.musicvae import TrainedMusicVAE
    from smd_tpu_torch.device import resolve_device
    from smd_tpu_torch.eval import plots
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    if not FLAGS.input:
        raise FlagsError("flag --input must have a value")
    if FLAGS.include_plots:
        plots.require("--include_plots")
    device = resolve_device(FLAGS.device)
    params = io_lib.load(FLAGS.vae_params) if FLAGS.vae_params else None
    model = TrainedMusicVAE(params=params, seed=FLAGS.checkpoint_seed,
                            device=device)
    groups = latent_groups(FLAGS.input)

    os.makedirs(FLAGS.output, exist_ok=True)
    jobs = []
    for name, latents in groups.items():
        out_dir = os.path.join(FLAGS.output, name)
        os.makedirs(out_dir, exist_ok=True)
        for i, seq in enumerate(latents):
            song = song_lib.embeddings_to_song(
                np.asarray(seq, np.float64), model, model.converter,
                temperature=FLAGS.melody_temperature)
            out_base = os.path.join(out_dir, f"{i:03d}")
            midi_io.write_midi_file(song.note_sequence, out_base + ".mid")
            io_lib.save(song.note_sequence, out_base + ".ns.pkl")
            jobs.append((out_base + ".ns.pkl", out_base, FLAGS.sample_rate,
                         FLAGS.include_wav, FLAGS.include_plots))
        log.info("Decoded %d sequences for %s", len(latents), name)

    if FLAGS.include_wav:
        synth.load_library()   # built once here, not in every worker
    rendered = []
    with concurrent.futures.ProcessPoolExecutor(
            min(len(jobs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for out_base in pool.map(_render_one, jobs):
            log.info("Rendered %s", out_base)
            rendered.append(out_base)
    return rendered


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
