"""Synthetic problems used as integration smoke tests.

A numpy copy of ``smd_tpu/data/synthetic.py``, kept here because the port
imports nothing of the JAX package.

Parity with the reference's toy generators
(``scripts/transform_encoded_data.py:135-157``): the 2-D two-Gaussian mixture
0.2·N(-5,1) + 0.8·N(+5,1) and its sequence variant. Seeded via
``numpy.random.Generator`` instead of global numpy state.
"""
from __future__ import annotations

import numpy as np

__all__ = ["toy_distribution", "toy_sequence_distribution", "TOY_MIXTURE"]

# (weight, mean, std) per component in each of the 2 dims.
TOY_MIXTURE = ((0.8, 5.0, 1.0), (0.2, -5.0, 1.0))


def toy_distribution(batch_size=512, rng=None):
    """Samples from 0.2 * N(-5, 1) + 0.8 * N(5, 1) in 2-D."""
    rng = rng if rng is not None else np.random.default_rng()
    c1 = rng.normal(size=(batch_size, 2)) + 5
    c2 = rng.normal(size=(batch_size, 2)) - 5
    mask = (rng.uniform(size=batch_size) < 0.8)[:, np.newaxis]
    return (mask * c1 + (1 - mask) * c2).astype(np.float32)


def toy_sequence_distribution(trajectory_length=10, batch_size=512, rng=None):
    """Linear trajectories anchored at the mixture centers."""
    rng = rng if rng is not None else np.random.default_rng()
    c1 = 0.01 * rng.normal(size=(batch_size, 2)) + 5
    c2 = 0.01 * rng.normal(size=(batch_size, 2)) - 5
    mask = (rng.uniform(size=batch_size) < 0.8)[:, np.newaxis]
    center = mask * c1 + (1 - mask) * c2
    step = 0.1 * rng.normal(size=(batch_size, 2))
    deltas = (step[:, None, :].repeat(trajectory_length, axis=1) *
              np.arange(trajectory_length).reshape(trajectory_length, 1))
    center = center[:, None, :].repeat(trajectory_length, axis=1)
    return (center + deltas).astype(np.float32)
