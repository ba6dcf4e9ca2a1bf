"""Generate a synthetic multi-instrument MIDI corpus for codec training
(port of ``scripts/make_multitrack_corpus.py``; numpy and the port's MIDI
writer only).

    python -m smd_tpu_torch.scripts.make_multitrack_corpus \\
        --output_dir=corpus_multi --n_songs=3000

Structured multi-track songs (lead melody, bass line, block or arpeggiated
chords, drum patterns; 2-5 instruments with varied programs, velocities,
keys and rhythms), so ``python -m smd_tpu_torch.scripts.train_musicvae
--mode=multi`` can train the hier-multiperf codec. The same ``--seed``
writes the same MIDI bytes as the JAX package's script.
"""
import logging
import os
import sys

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_string("output_dir", None, "Directory for .mid files.")
FLAGS.DEFINE_integer("n_songs", 3000, "Number of songs to generate.")
FLAGS.DEFINE_integer("seed", 0, "PRNG seed.")

log = logging.getLogger("smd_tpu_torch")

SCALES = {
    "major": [0, 2, 4, 5, 7, 9, 11],
    "minor": [0, 2, 3, 5, 7, 8, 10],
    "dorian": [0, 2, 3, 5, 7, 9, 10],
    "pent_minor": [0, 3, 5, 7, 10],
}

# Chord progressions as scale-degree roots (triads stacked in-scale).
PROGRESSIONS = [[0, 3, 4, 0], [0, 5, 3, 4], [0, 4, 5, 3], [5, 3, 0, 4],
                [0, 0, 3, 4], [0, 3, 0, 4]]

LEAD_PROGRAMS = [0, 4, 11, 24, 25, 40, 56, 65, 73, 80]
BASS_PROGRAMS = [32, 33, 34, 35, 38]
CHORD_PROGRAMS = [0, 4, 16, 24, 48, 50, 88]

# 1-bar drum patterns: (pitch, [16th-note slots]) — GM kick 36, snare 38,
# closed hat 42, open hat 46.
DRUM_PATTERNS = [
    [(36, [0, 8]), (38, [4, 12]), (42, [0, 2, 4, 6, 8, 10, 12, 14])],
    [(36, [0, 6, 8]), (38, [4, 12]), (42, [0, 4, 8, 12])],
    [(36, [0, 10]), (38, [4, 12]), (46, [2, 6, 10, 14])],
    [(36, [0, 3, 8, 11]), (38, [4, 12]), (42, list(range(0, 16, 2)))],
]

LEAD_RHYTHMS = [
    [0.5] * 8,
    [1.0, 0.5, 0.5, 1.0, 1.0],
    [0.25, 0.25, 0.5, 1.0, 0.5, 0.5, 1.0],
    [1.5, 0.5, 1.0, 1.0],
    [0.5, -0.5, 0.5, 0.5, 0.5, -0.5, 1.0],
    [2.0, 1.0, 1.0],
]


def _vel(rng, lo=60, hi=112):
    return int(rng.integers(lo, hi))


def make_song(rng):
    """2-5 instrument NoteSequence, 4-12 bars at 120 qpm."""
    from smd_tpu_torch.codec.note_sequence import (NoteSequence, Tempo,
                                                   TimeSignature)

    ns = NoteSequence(tempos=[Tempo(qpm=120.0)],
                      time_signatures=[TimeSignature()])
    scale = SCALES[list(SCALES)[rng.integers(0, len(SCALES))]]
    key = int(rng.integers(48, 60))
    bars = int(rng.integers(4, 13))
    prog_roots = PROGRESSIONS[rng.integers(0, len(PROGRESSIONS))]
    spq = 0.5  # seconds per quarter at 120 qpm
    bar_s = 4 * spq

    def chord_degrees(bar):
        root = prog_roots[bar % len(prog_roots)]
        return [root, root + 2, root + 4]

    def scale_pitch(degree, octave=0):
        return int(np.clip(
            key + scale[degree % len(scale)] + 12 * (degree // len(scale))
            + 12 * octave, 24, 100))

    inst = 0
    # Lead melody (always present).
    lead_prog = int(LEAD_PROGRAMS[rng.integers(0, len(LEAD_PROGRAMS))])
    degree = int(rng.integers(5, 12))
    for bar in range(bars):
        t = bar * bar_s
        rhythm = LEAD_RHYTHMS[rng.integers(0, len(LEAD_RHYTHMS))]
        chord = chord_degrees(bar)
        for dur_q in rhythm:
            if t >= (bar + 1) * bar_s - 1e-6:
                break
            if dur_q < 0:
                t += -dur_q * spq
                continue
            step = int(rng.choice([-2, -1, -1, 0, 1, 1, 2]))
            degree = int(np.clip(degree + step, 3, 17))
            if rng.random() < 0.3:   # snap to a chord tone
                degree = chord[rng.integers(0, 3)] + 7
            ns.add_note(scale_pitch(degree), _vel(rng), t,
                        t + dur_q * spq * float(rng.uniform(0.8, 0.98)),
                        program=lead_prog, instrument=inst)
            t += dur_q * spq
    inst += 1

    # Bass (usually).
    if rng.random() < 0.9:
        bass_prog = int(BASS_PROGRAMS[rng.integers(0, len(BASS_PROGRAMS))])
        pattern = rng.integers(0, 3)
        for bar in range(bars):
            t = bar * bar_s
            root = chord_degrees(bar)[0]
            if pattern == 0:      # whole-bar roots
                ns.add_note(scale_pitch(root, -2), _vel(rng, 70, 110), t,
                            t + bar_s * 0.95, program=bass_prog,
                            instrument=inst)
            elif pattern == 1:    # quarter pulse root/fifth
                for q in range(4):
                    d = root if q % 2 == 0 else root + 4
                    ns.add_note(scale_pitch(d, -2), _vel(rng, 70, 110),
                                t + q * spq, t + (q + 0.9) * spq,
                                program=bass_prog, instrument=inst)
            else:                 # eighth walk
                for e in range(8):
                    d = root + [0, 0, 4, 0, 2, 0, 4, 5][e]
                    ns.add_note(scale_pitch(d, -2), _vel(rng, 65, 105),
                                t + e * spq / 2, t + (e + 0.85) * spq / 2,
                                program=bass_prog, instrument=inst)
        inst += 1

    # Chords: block or arpeggiated (often).
    if rng.random() < 0.75:
        chord_prog = int(CHORD_PROGRAMS[rng.integers(0, len(CHORD_PROGRAMS))])
        arp = rng.random() < 0.4
        for bar in range(bars):
            t = bar * bar_s
            degs = chord_degrees(bar)
            if arp:
                seq = degs + [degs[1]]
                for e in range(8):
                    d = seq[e % len(seq)]
                    ns.add_note(scale_pitch(d, 0), _vel(rng, 50, 90),
                                t + e * spq / 2, t + (e + 0.9) * spq / 2,
                                program=chord_prog, instrument=inst)
            else:
                for d in degs:
                    ns.add_note(scale_pitch(d, 0), _vel(rng, 45, 85), t,
                                t + bar_s * float(rng.uniform(0.5, 0.98)),
                                program=chord_prog, instrument=inst)
        inst += 1

    # Drums (often).
    if rng.random() < 0.7:
        pat = DRUM_PATTERNS[rng.integers(0, len(DRUM_PATTERNS))]
        for bar in range(bars):
            t = bar * bar_s
            for pitch, slots in pat:
                for s in slots:
                    if rng.random() < 0.06:
                        continue   # humanize: occasional dropped hit
                    ns.add_note(pitch, _vel(rng, 70, 115), t + s * spq / 4,
                                t + (s + 0.8) * spq / 4, program=0,
                                instrument=9, is_drum=True)
        inst += 1

    # Occasional counter-melody.
    if rng.random() < 0.35 and inst < 8:
        prog = int(LEAD_PROGRAMS[rng.integers(0, len(LEAD_PROGRAMS))])
        degree = int(rng.integers(8, 14))
        for bar in range(bars):
            t = bar * bar_s
            for q in range(2):
                degree = int(np.clip(
                    degree + int(rng.choice([-1, 0, 1])), 6, 18))
                ns.add_note(scale_pitch(degree, 0), _vel(rng, 45, 80),
                            t + q * 2 * spq, t + (q * 2 + 1.8) * spq,
                            program=prog, instrument=inst + 1)

    ns.total_time = bars * bar_s
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
        ns = make_song(rng)
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
