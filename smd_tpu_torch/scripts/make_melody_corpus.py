"""Generate a synthetic melodic MIDI corpus for codec training (port of
``scripts/make_melody_corpus.py``; numpy and the port's MIDI writer only).

    python -m smd_tpu_torch.scripts.make_melody_corpus --output_dir=corpus \\
        --n_songs=2000

Structured melodies (major, minor, modal, pentatonic and blues scales, motif
repetition with transposition, varied rhythms with rests, phrase contours),
rich enough to train the codec (``python -m
smd_tpu_torch.scripts.train_musicvae``) to a measured reconstruction
accuracy. The same ``--seed`` writes the same MIDI bytes as the JAX
package's script.
"""
import logging
import os
import sys

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_string("output_dir", None, "Directory for .mid files.")
FLAGS.DEFINE_integer("n_songs", 2000, "Number of songs to generate.")
FLAGS.DEFINE_integer("seed", 0, "PRNG seed.")
FLAGS.DEFINE_integer("min_bars", 12, "Minimum song length in bars.")
FLAGS.DEFINE_integer("max_bars", 40, "Maximum song length in bars "
                     "(exclusive). Raise both for 16-bar-chunk corpora: "
                     "the melody16 converter needs >=16-bar melodies and "
                     "strides 16 bars per chunk.")

log = logging.getLogger("smd_tpu_torch")

SCALES = {
    "major": [0, 2, 4, 5, 7, 9, 11],
    "minor": [0, 2, 3, 5, 7, 8, 10],
    "dorian": [0, 2, 3, 5, 7, 9, 10],
    "mixolydian": [0, 2, 4, 5, 7, 9, 10],
    "pent_major": [0, 2, 4, 7, 9],
    "pent_minor": [0, 3, 5, 7, 10],
    "blues": [0, 3, 5, 6, 7, 10],
}

# 1-bar rhythm patterns in quarter notes (positive = note, negative = rest).
RHYTHMS = [
    [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
    [1.0, 0.5, 0.5, 1.0, 1.0],
    [0.25, 0.25, 0.5, 0.5, 0.5, 0.25, 0.25, 0.5, 1.0],
    [1.5, 0.5, 1.0, 1.0],
    [0.5, -0.5, 0.5, 0.5, 0.5, -0.5, 0.5, 0.5],
    [2.0, 1.0, 1.0],
    [0.75, 0.75, 0.5, 1.0, -0.5, 0.5],
    [1.0, -1.0, 1.0, 1.0],
    [0.25] * 8 + [0.5, 0.5, 1.0],
]


def make_motif(rng, scale_len):
    """A short melodic cell as scale-degree offsets."""
    length = int(rng.integers(3, 6))
    steps = rng.choice([-2, -1, -1, 0, 1, 1, 2, 3], size=length)
    return np.cumsum(steps)


def make_song(rng, min_bars=12, max_bars=40):
    from smd_tpu_torch.codec.note_sequence import (NoteSequence, Tempo,
                                                   TimeSignature)
    scale_name = rng.choice(list(SCALES))
    scale = SCALES[scale_name]
    key = int(rng.integers(53, 72))
    qpm = float(rng.choice([80, 96, 100, 120, 120, 132, 140]))
    ns = NoteSequence(tempos=[Tempo(qpm=qpm)],
                      time_signatures=[TimeSignature()])
    spq = 60.0 / qpm   # seconds per quarter

    motif = make_motif(rng, len(scale))
    degree = int(rng.integers(0, len(scale)))
    t = 0.0
    n_bars = int(rng.integers(min_bars, max_bars))
    bars_done = 0
    while bars_done < n_bars:
        rhythm = RHYTHMS[int(rng.integers(0, len(RHYTHMS)))]
        # Phrase logic: repeat the motif (possibly transposed) or walk.
        mode = rng.random()
        if mode < 0.4:
            offsets = motif + int(rng.integers(-2, 3))
        elif mode < 0.5:
            motif = make_motif(rng, len(scale))
            offsets = motif
        else:
            offsets = np.cumsum(rng.choice([-2, -1, 0, 1, 1, 2],
                                           size=len(rhythm)))
        oi = 0
        for dur_q in rhythm:
            if dur_q < 0:   # rest
                t += -dur_q * spq
                continue
            degree = int(np.clip(degree + offsets[oi % len(offsets)] -
                                 (offsets[(oi - 1) % len(offsets)]
                                  if oi else 0), 0, 2 * len(scale)))
            oi += 1
            pitch = key + scale[degree % len(scale)] + 12 * (degree
                                                             // len(scale))
            pitch = int(np.clip(pitch, 36, 96))
            vel = int(rng.integers(64, 112))
            dur = dur_q * spq
            ns.add_note(pitch, vel, t, t + dur * float(rng.uniform(0.8, 0.98)))
            t += dur
        bars_done += sum(abs(d) for d in rhythm) / 4.0
    return ns


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and write the corpus;
    returns the paths written."""
    from smd_tpu_torch.codec import midi_io
    FLAGS(argv)
    if not FLAGS.output_dir:
        raise FlagsError("flag --output_dir must have a value")
    rng = np.random.default_rng(FLAGS.seed)
    os.makedirs(FLAGS.output_dir, exist_ok=True)
    paths = []
    for i in range(FLAGS.n_songs):
        ns = make_song(rng, FLAGS.min_bars, FLAGS.max_bars)
        paths.append(os.path.join(FLAGS.output_dir, f"song_{i:05d}.mid"))
        midi_io.write_midi_file(ns, paths[-1])
        if (i + 1) % 500 == 0:
            log.info("wrote %d/%d", i + 1, FLAGS.n_songs)
    log.info("Corpus written to %s", FLAGS.output_dir)
    return paths


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
