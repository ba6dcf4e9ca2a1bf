"""Evaluate a MusicVAE codec artifact: token- and note-level fidelity (port
of ``scripts/eval_codec.py``).

    python -m smd_tpu_torch.scripts.eval_codec --mode=multi \\
        --vae_params=checkpoints/musicvae-multi.pkl \\
        --input='corpus_multi/*.mid' --max_chunks=1024

Token accuracy (position-wise) is the train-time metric, but it is brittle
for performance-event streams: one inserted or dropped event misaligns every
later position even when the decoded music is nearly identical. So each
chunk is also encoded, its posterior mean decoded at temperature 1e-3, and
both the input and the round trip turned back into notes, scored by
note-level precision, recall and F1 on (instrument stream, pitch, onset
step) (``score_batch``). The codec runs on ``cuda`` (``--device=cpu`` on the
CPU); without ``--vae_params`` it is the mode's shipped codec from
``checkpoints/`` where that is present.
"""
from __future__ import annotations

import glob
import logging
import os
import sys

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError
from smd_tpu_torch.eval.midi_metrics import note_f1

FLAGS = Flags()
FLAGS.DEFINE_string("input", None, "Glob of evaluation MIDI files.")
FLAGS.DEFINE_string("vae_params", None,
                    "Codec artifact; defaults to the shipped codec for the "
                    "chosen mode.")
FLAGS.DEFINE_enum("mode", "melody", ["melody", "melody16", "multi"],
                  "Codec family (melody16: the 16-bar hierdec codec).")
FLAGS.DEFINE_integer("max_chunks", 1024, "Evaluation chunk cap.")
FLAGS.DEFINE_integer("batch_size", 256, "Encode/decode batch size.")
FLAGS.DEFINE_integer("seed", 0, "Shuffle seed.")
FLAGS.DEFINE_string("device", "cuda",
                    "Device to run on: cuda (the default; raises without a "
                    "GPU) or cpu.")

log = logging.getLogger("smd_tpu_torch")

NAMES = ("token_acc", "token_acc_nonpad", "note_precision", "note_recall",
         "note_f1")


def score_batch(labels, tokens, converter, steps_per_quarter):
    """One batch's scores from its label tokens and the round trip's tokens
    (B, T): (token accuracy, non-PAD token accuracy, [note precision],
    [note recall], [note F1]), a note score for each chunk."""
    hits = tokens == labels
    mask = labels != 0
    scores = ([], [], [])
    for real_ns, dec_ns in zip(converter.from_tensors(labels),
                               converter.from_tensors(tokens)):
        for out, value in zip(scores, note_f1(real_ns, dec_ns,
                                              steps_per_quarter)):
            out.append(value)
    return (hits.mean(), (hits * mask).sum() / max(mask.sum(), 1), *scores)


def codec_for_mode(mode, params, device):
    """(TrainedMusicVAE, steps per quarter) of ``mode``: ``params`` (a
    bundle) or else the mode's shipped codec."""
    from smd_tpu_torch.codec import musicvae as mv
    if mode in ("multi", "melody16"):
        from smd_tpu_torch.config import MUSIC_VAE_CONFIG
        entry = MUSIC_VAE_CONFIG["multi-1-big" if mode == "multi"
                                 else "melody-16-big"]
        converter, config = entry.data_converter, entry.model
        spq = converter.steps_per_quarter
    else:
        from smd_tpu_torch.codec.melody import melody_2bar_converter
        converter, config, spq = melody_2bar_converter, mv.MEL_2BAR_BIG, 4
    vae = mv.TrainedMusicVAE(params=params, config=config,
                             converter=converter, device=device)
    if vae.random_weights:
        raise ValueError("no trained codec params found for this mode")
    return vae, spq


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program), evaluate and print the
    five scores; returns them by name."""
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec.melody import extract_melodies
    from smd_tpu_torch.device import resolve_device
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    if not FLAGS.input:
        raise FlagsError("flag --input must have a value")
    device = resolve_device(FLAGS.device)
    params = io_lib.load(FLAGS.vae_params) if FLAGS.vae_params else None
    vae, spq = codec_for_mode(FLAGS.mode, params, device)
    converter = vae.converter

    files = sorted(glob.glob(os.path.expanduser(FLAGS.input), recursive=True))
    rng = np.random.default_rng(FLAGS.seed)
    rng.shuffle(files)
    chunks = []
    for path in files:
        try:
            ns = midi_io.read_midi_file(path)
        except Exception:
            continue
        if FLAGS.mode == "multi":
            chunks.extend(converter.to_tensors(ns).inputs)
        else:
            stride = converter.slice_bars   # non-overlapping chunks
            for m in extract_melodies(ns):
                chunks.extend(converter.to_tensors(m).inputs[::stride])
        if len(chunks) >= FLAGS.max_chunks:
            break
    chunks = chunks[:FLAGS.max_chunks]
    if not chunks:
        raise ValueError("no chunks extracted")
    log.info("Evaluating %d chunks", len(chunks))

    tok_accs, tok_np_accs, ps, rs, f1s = [], [], [], [], []
    for i in range(0, len(chunks), FLAGS.batch_size):
        batch = chunks[i:i + FLAGS.batch_size]
        _, mu, _ = vae.encode_tensors(batch)
        tokens = vae.decode_to_tensors(mu)
        labels = np.stack([c.argmax(-1) for c in batch])
        acc, acc_np, p, r, f1 = score_batch(labels, tokens, converter, spq)
        tok_accs.append(acc)
        tok_np_accs.append(acc_np)
        ps += p
        rs += r
        f1s += f1

    scores = dict(zip(NAMES, (float(np.mean(v)) for v in (
        tok_accs, tok_np_accs, ps, rs, f1s))))
    for name, value in scores.items():
        print(f"{name:<20} {value:.4f}")
    return scores


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
