"""Encode MIDI files into MusicVAE latent TFRecords (port of
``scripts/generate_song_data.py``).

    python -m smd_tpu_torch.scripts.generate_song_data \\
        --input='data/lmd/**/*.mid' --output=./output/encoded --mode=melody

A process pool parses and tokenizes the MIDI files on the host while the
MusicVAE encoder runs batched on the card (``--device=cpu`` on the CPU).
Each song (melody modes: each extracted melody) becomes one record, a
pickled [3, n_chunks, 512] array (z, mu, sigma), in
``training_seqs.tfrecord-00000`` or, for the first ``--eval_fraction`` of
the files, ``eval_seqs.tfrecord-00000``; written without TensorFlow.
Modes: ``melody`` (non-overlapping 2-bar chunks), ``melody16`` (16-bar
chunks through the hierdec codec), ``multi`` (1-bar multi-instrument
performance chunks through the hier-multiperf codec).
"""
from __future__ import annotations

import concurrent.futures
import functools
import glob
import logging
import multiprocessing
import os
import pickle
import sys

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_string("input", None, "Glob of input MIDI files.")
FLAGS.DEFINE_string("output", "./output/encoded", "Output directory.")
FLAGS.DEFINE_enum("mode", "melody", ["melody", "melody16", "multi"],
                  "Encoding mode (melody16: non-overlapping 16-bar chunks "
                  "through the hierdec codec, reference config.py:41-48).")
FLAGS.DEFINE_integer("checkpoint_seed", 0,
                     "Seed for VAE weights when no checkpoint is given.")
FLAGS.DEFINE_string("vae_params", "",
                    "Optional pickled MusicVAE params to load.")
FLAGS.DEFINE_integer("max_songs", None, "Maximum number of songs.")
FLAGS.DEFINE_integer("encode_batch", 1024, "Chunks per encode batch.")
FLAGS.DEFINE_enum("codec_dtype", "bfloat16", ["float32", "bfloat16"],
                  "MusicVAE compute dtype on the card (float32 on the CPU).")
FLAGS.DEFINE_integer("workers", None, "MIDI parser processes.")
FLAGS.DEFINE_float("max_song_seconds", 3600.0,
                   "Skip songs longer than this (ref :61).")
FLAGS.DEFINE_float("eval_fraction", 0.1, "Fraction of songs for eval split.")
FLAGS.DEFINE_string("device", "cuda",
                    "Device to run on: cuda (the default; raises without a "
                    "GPU) or cpu.")

log = logging.getLogger("smd_tpu_torch")


def parse_midi(path, mode="melody", max_song_seconds=3600.0):
    """Host side: MIDI -> (path, [chunk tensors of each song group], error).

    melody modes: each monophonic melody, cut into non-overlapping chunks
    (2-bar converter at stride 2, or 16-bar at stride 16, over 1-bar-hop
    segments); multi: the whole sequence's 1-bar performance chunks, one
    group per song. Runs in the pool's worker processes.
    """
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec.melody import (extract_melodies,
                                            melody_2bar_converter)
    from smd_tpu_torch.codec.performance import (
        multiperf_default_1bar_converter)
    try:
        ns = midi_io.read_midi_file(path)
    except Exception as e:   # malformed files are common in Lakh
        return path, [], f"parse error: {e!r}"
    if ns.total_time > max_song_seconds:
        return path, [], "too long"

    songs_chunks = []
    if mode in ("melody", "melody16"):
        if mode == "melody":
            converter, stride = melody_2bar_converter, 2
        else:
            from smd_tpu_torch.config import melody_16bar_converter
            converter, stride = melody_16bar_converter, 16
        for melody in extract_melodies(ns):
            chunk_tensors = converter.to_tensors(melody).inputs[::stride]
            if chunk_tensors:
                songs_chunks.append(chunk_tensors)
    else:
        out = multiperf_default_1bar_converter.to_tensors(ns)
        if out.inputs:
            songs_chunks.append(out.inputs)
    return path, songs_chunks, None


def codec_from_flags(device):
    """The mode's ``TrainedMusicVAE`` on ``device``."""
    import torch

    from smd_tpu_torch.codec.musicvae import TrainedMusicVAE
    from smd_tpu_torch.utils import io as io_lib

    dtype = torch.bfloat16 if (FLAGS.codec_dtype == "bfloat16" and
                               device.type != "cpu") else torch.float32
    params = io_lib.load(FLAGS.vae_params) if FLAGS.vae_params else None
    kw = dict(params=params, seed=FLAGS.checkpoint_seed, compute_dtype=dtype,
              device=device)
    if FLAGS.mode in ("multi", "melody16"):
        from smd_tpu_torch.config import MUSIC_VAE_CONFIG
        entry = MUSIC_VAE_CONFIG[
            "multi-1-big" if FLAGS.mode == "multi" else "melody-16-big"]
        return TrainedMusicVAE(config=entry.model,
                               converter=entry.data_converter, **kw)
    return TrainedMusicVAE(**kw)


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and encode; returns
    (songs encoded, files skipped)."""
    from smd_tpu_torch.data.records import TFRecordWriter
    from smd_tpu_torch.device import resolve_device

    FLAGS(argv)
    if not FLAGS.input:
        raise FlagsError("flag --input must have a value")
    device = resolve_device(FLAGS.device)
    files = sorted(glob.glob(os.path.expanduser(FLAGS.input), recursive=True))
    if FLAGS.max_songs:
        files = files[:FLAGS.max_songs]
    log.info("Encoding %d MIDI files", len(files))
    model = codec_from_flags(device)

    n_eval = max(1, int(len(files) * FLAGS.eval_fraction)) \
        if len(files) > 1 else 0
    parse = functools.partial(parse_midi, mode=FLAGS.mode,
                              max_song_seconds=FLAGS.max_song_seconds)
    count = skipped = 0
    with TFRecordWriter(os.path.join(
            FLAGS.output, "training_seqs.tfrecord-00000")) as train, \
            TFRecordWriter(os.path.join(
                FLAGS.output, "eval_seqs.tfrecord-00000")) as eval_, \
            concurrent.futures.ProcessPoolExecutor(
                FLAGS.workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
        for path, songs_chunks, err in pool.map(parse, files, chunksize=4):
            if err or not songs_chunks:
                skipped += 1
                continue
            writer = eval_ if count < n_eval else train
            for chunk_tensors in songs_chunks:
                # Batched encode of all chunks of this melody on the card.
                parts = [model.encode_tensors(
                    chunk_tensors[i:i + FLAGS.encode_batch])
                    for i in range(0, len(chunk_tensors), FLAGS.encode_batch)]
                encoding = np.stack([np.concatenate(p) for p in zip(*parts)])
                writer.write(pickle.dumps(encoding))
            count += 1
            if count % 100 == 0:
                log.info("Encoded %d songs (%d skipped)", count, skipped)
    log.info("Done: %d songs encoded, %d skipped", count, skipped)
    return count, skipped


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
