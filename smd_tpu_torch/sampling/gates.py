"""Serve-time convergence gates for autoregressive decoding (a copy of
``smd_tpu/sampling/gates.py``, numpy only).

The MDN's NLL never bounds mixture variance and teacher forcing never shows
the model its own samples, so a checkpoint can pass training and still
decode badly. The gate has two legs:

- NLL leg (before decoding): the held-out teacher-forced NLL a position
  must beat the closed-form diagonal-Gaussian baseline
  (``gaussian_baseline_nll``) by a margin; catches gross non-learning.
- Probe leg (after decoding): the decoded samples' marginal mean and std
  per (position, channel) must match the real data's within a relative
  deviation (``marginal_deviation``); catches autoregressive drift, which
  teacher-forced NLL cannot see.
"""
from __future__ import annotations

import numpy as np

__all__ = ["gaussian_baseline_nll", "marginal_deviation"]


def gaussian_baseline_nll(real, fit_on=None):
    """Per-position NLL of a diagonal Gaussian fit, evaluated on ``real``.

    The score of an "AR" model that learned only the per-position
    marginals. ``fit_on`` defaults to ``real`` itself.

    Shapes: (N, S, D). Returns the mean over (N, S) of the per-position NLL
    summed over D, the units of ``losses.mdn_nll(..., "mean")``.
    """
    real = np.asarray(real, np.float32)
    fit = real if fit_on is None else np.asarray(fit_on, np.float32)
    mu = fit.mean(0)
    var = fit.var(0) + 1e-12
    return float(np.mean(np.sum(
        0.5 * ((real - mu) ** 2 / var + np.log(2 * np.pi * var)), axis=-1)))


def marginal_deviation(real, generated):
    """Relative marginal mean + std deviation of generated samples vs real.

    The mean over (position, channel) of |std_gen - std_real| / std_real,
    plus the same for the means (both over the real std, so scale-free).
    ~0 for draws of one distribution; O(1) and beyond when free-running
    decode drifts or detonates.
    """
    real = np.asarray(real, np.float32)
    generated = np.asarray(generated, np.float32)
    denom = real.std(0) + 1e-6
    return float(
        np.mean(np.abs(generated.std(0) - real.std(0)) / denom) +
        np.mean(np.abs(generated.mean(0) - real.mean(0)) / denom))
