"""Perceptual MIDI metrics: framewise statistics + Overlapping Area (a
numpy and ``scipy.special`` copy of ``smd_tpu/eval/midi_metrics.py``).

Capability parity with the reference's ``utils/metrics.py:80-244``: per-second
framewise note statistics (note density, pitch range, mean/var pitch, mean/var
duration), feature vectors, and pairwise perceptual similarity via the
Gaussian Overlapping Area metric — the ISMIR 2021 paper's
consistency/variance measure. Fixes the reference's
``perceptual_midi_histograms`` bug of passing an ``interval=`` kwarg its stat
functions don't accept (SURVEY.md §7 item 9): here frame/hop sizes thread
through uniformly.

Operates on ``smd_tpu_torch.codec.note_sequence.NoteSequence`` objects.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.special

from smd_tpu_torch.codec.note_sequence import trim_note_sequence

__all__ = [
    "framewise_statistic", "note_density", "pitch_range", "mean_pitch",
    "var_pitch", "mean_note_duration", "var_note_duration",
    "perceptual_midi_histograms", "perceptual_midi_statistics",
    "perceptual_similarity", "overlapping_area", "oa_consistency_variance",
    "note_f1",
]


def framewise_statistic(ns, stat_fn, hop_size=1, frame_size=1):
    total_time = int(math.ceil(ns.total_time))
    frames = []
    trim = frame_size - hop_size
    for i in range(0, max(total_time - trim, 0), hop_size):
        chunk = trim_note_sequence(ns, i, i + frame_size)
        frames.append(stat_fn(chunk.notes))
    return np.array(frames if frames else [0.0])


def note_density(ns, hop_size=1, frame_size=1):
    return framewise_statistic(ns, lambda notes: len(notes),
                               hop_size=hop_size, frame_size=frame_size)


def pitch_range(ns, hop_size=1, frame_size=1):
    def stat(notes):
        pitches = [n.pitch for n in notes]
        return max(pitches) - min(pitches) if pitches else 0
    return framewise_statistic(ns, stat, hop_size=hop_size,
                               frame_size=frame_size)


def mean_pitch(ns, hop_size=1, frame_size=1):
    def stat(notes):
        pitches = np.array([n.pitch for n in notes])
        return pitches.mean() if len(pitches) else 0
    return framewise_statistic(ns, stat, hop_size=hop_size,
                               frame_size=frame_size)


def var_pitch(ns, hop_size=1, frame_size=1):
    def stat(notes):
        pitches = np.array([n.pitch for n in notes])
        return pitches.var() if len(pitches) else 0
    return framewise_statistic(ns, stat, hop_size=hop_size,
                               frame_size=frame_size)


def mean_note_duration(ns, hop_size=1, frame_size=1):
    def stat(notes):
        d = np.array([n.end_time - n.start_time for n in notes])
        return d.mean() if len(d) else 0
    return framewise_statistic(ns, stat, hop_size=hop_size,
                               frame_size=frame_size)


def var_note_duration(ns, hop_size=1, frame_size=1):
    def stat(notes):
        d = np.array([n.end_time - n.start_time for n in notes])
        return d.var() if len(d) else 0
    return framewise_statistic(ns, stat, hop_size=hop_size,
                               frame_size=frame_size)


def perceptual_midi_histograms(ns, interval=1):
    """Histograms for each MIDI feature over ``interval``-second frames."""
    kw = dict(hop_size=interval, frame_size=interval)
    return dict(
        nd=note_density(ns, **kw),
        pr=pitch_range(ns, **kw),
        mp=mean_pitch(ns, **kw),
        vp=var_pitch(ns, **kw),
        md=mean_note_duration(ns, **kw),
        vd=var_note_duration(ns, **kw),
    )


def perceptual_midi_statistics(ns, interval=1, vector=False):
    """(mean, var) per feature histogram; optionally as a flat vector."""
    features = {}
    histograms = perceptual_midi_histograms(ns, interval=interval)
    for key, h in histograms.items():
        features[key] = (h.mean(), h.var())
    if vector:
        return np.array(list(features.values())).reshape(-1)
    return features


def overlapping_area(mu1, mu2, var1, var2):
    """Overlapping area of two Gaussian pdfs (reference :215-244)."""
    idx = mu2 < mu1
    mu_a = mu2 * idx + np.logical_not(idx) * mu1
    mu_b = mu1 * idx + np.logical_not(idx) * mu2
    var_a = var2 * idx + np.logical_not(idx) * var1
    var_b = var1 * idx + np.logical_not(idx) * var2

    c_sqrt_factor = (mu_a - mu_b)**2 + 2 * (var_a - var_b) * np.log(
        np.sqrt(var_a + 1e-6) / np.sqrt(var_b + 1e-6))
    c_sqrt_factor = np.sqrt(np.maximum(c_sqrt_factor, 0.0))
    c = mu_b * var_a - np.sqrt(var_b) * (mu_a * np.sqrt(var_b) +
                                         np.sqrt(var_a) * c_sqrt_factor)
    c = c / (var_a - var_b + 1e-6)
    # Equal variances make the quadratic crossing degenerate (the reference
    # formula divides by ~0 there); the true crossing is the midpoint.
    c = np.where(np.abs(var_a - var_b) < 1e-9, (mu_a + mu_b) / 2.0, c)

    sqrt_2 = np.sqrt(2)
    oa = 1 - 0.5 * scipy.special.erf(
        (c - mu_a) / (sqrt_2 * np.sqrt(var_a + 1e-6)))
    oa = oa + 0.5 * scipy.special.erf(
        (c - mu_b) / (sqrt_2 * np.sqrt(var_b + 1e-6)))
    return oa


def perceptual_similarity(ns1, ns2, interval=1):
    """Pairwise OA similarity per feature between two NoteSequences."""
    stats1 = perceptual_midi_statistics(ns1, interval, vector=False)
    stats2 = perceptual_midi_statistics(ns2, interval, vector=False)
    return {
        key: overlapping_area(stats1[key][0], stats2[key][0], stats1[key][1],
                              stats2[key][1])
        for key in stats1
    }


def oa_consistency_variance(sequences, interval=1):
    """Paper-style aggregate: mean OA between adjacent (consistency) and all
    pairs (variance proxy) of generated sequences, per feature.

    Returns dict feature -> (consistency, variance).
    """
    stats = [perceptual_midi_statistics(ns, interval) for ns in sequences]
    out = {}
    keys = stats[0].keys() if stats else []
    for key in keys:
        adjacent, pairs = [], []
        for i in range(len(stats)):
            for j in range(i + 1, len(stats)):
                oa = overlapping_area(stats[i][key][0], stats[j][key][0],
                                      stats[i][key][1], stats[j][key][1])
                pairs.append(oa)
                if j == i + 1:
                    adjacent.append(oa)
        out[key] = (float(np.mean(adjacent)) if adjacent else 0.0,
                    float(np.mean(pairs)) if pairs else 0.0)
    return out


def _note_onset_set(ns, seconds_per_step):
    """Comparable note set: (instrument, pitch, onset step)."""
    out = set()
    for n in ns.notes:
        out.add((n.instrument, n.pitch,
                 int(round(n.start_time / seconds_per_step))))
    return out


def note_f1(real_ns, decoded_ns, steps_per_quarter, qpm=120.0):
    """Note-level precision/recall/F1 on (instrument, pitch, onset step).

    The fair codec-fidelity metric for performance-event streams, where
    position-wise token accuracy collapses after a single inserted or
    dropped event (``scripts/eval_codec.py``).
    """
    spq = 60.0 / qpm / steps_per_quarter
    a = _note_onset_set(real_ns, spq)
    b = _note_onset_set(decoded_ns, spq)
    if not a and not b:
        return 1.0, 1.0, 1.0
    tp = len(a & b)
    precision = tp / max(len(b), 1)
    recall = tp / max(len(a), 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return precision, recall, f1
