"""Latent-space compression transforms: slice, dimension weights, PCA.

A numpy copy of ``smd_tpu/data/transforms.py``, kept here because the port
imports nothing of the JAX package.

Parity with the reference's transform stack:
- slice + dim-weight map (``input_pipeline.py:43-48``),
- PCA forward/inverse (``input_pipeline.py:66-105``),
- ``SliceTransform`` fitter keeping top-variance dims and sigma-based dim
  weights (``scripts/generate_compressed_transform.py:59-109``),
- PCA fitter (StandardScaler + PCA, ``:129-143``).

The shipped reference artifacts (``checkpoints/slice-mel-512.pkl`` = 42 int64
indices, ``slice-multi-fb512.pkl`` = 146) load directly via ``utils.io.load``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "slice_transform", "inverse_data_transform", "data_transform",
    "normalize", "SliceTransform", "fit_pca", "PCATransform",
]


def normalize(batch, data_min, data_max):
    """Map to [-1, 1] given dataset min/max (``input_pipeline.py:36-40``)."""
    batch = (batch - data_min) / (data_max - data_min)
    return 2.0 * batch - 1.0


def slice_transform(batch, slice_idx=None, dim_weights=None):
    """Apply dim weights then gather the kept dims (forward transform)."""
    if dim_weights is not None:
        batch = batch * dim_weights
    if slice_idx is not None:
        batch = np.take(batch, slice_idx, axis=-1)
    return batch


def data_transform(batch, pca=None):
    """PCA forward transform on flattened trailing dims."""
    if pca is not None:
        if batch.ndim > 2:
            init_shape = batch.shape
            batch = pca.transform(batch.reshape(batch.shape[0], -1))
            batch = batch.reshape(*init_shape)
        else:
            batch = pca.transform(batch)
    return batch


def inverse_data_transform(batch, normalize_flag=True, pca=None, data_min=0.0,
                           data_max=1.0, slice_idx=None, dim_weights=None,
                           out_channels=512, rng=None):
    """Undo normalize -> PCA -> slice -> dim weights.

    Dropped dims are filled with standard-normal noise — the MusicVAE prior —
    matching ``input_pipeline.py:103-105`` (but seedable via ``rng``).
    """
    batch = np.asarray(batch)
    if normalize_flag:
        batch = (batch + 1.0) / 2.0
        batch = (data_max - data_min) * batch + data_min

    if pca is not None:
        batch = pca.inverse_transform(batch)

    if slice_idx is not None:
        rng = rng if rng is not None else np.random.default_rng()
        filled = rng.standard_normal((*batch.shape[:-1], out_channels))
        filled = filled.astype(batch.dtype)
        filled[..., slice_idx] = batch
        batch = filled

    if dim_weights is not None:
        batch = batch / dim_weights
    return batch


class SliceTransform:
    """Keep the top-variance dimensions of a latent space.

    Fitted over a [N, 512] latent matrix; ``keep`` dims are selected by
    variance (reference ``generate_compressed_transform.py:59-82``). The
    ``indices`` attribute round-trips with the reference's pickled index
    arrays.
    """

    def __init__(self, indices):
        self.indices = np.asarray(indices)

    @classmethod
    def fit(cls, data, keep=42):
        var = np.var(np.asarray(data), axis=0)
        idx = np.argsort(var)[::-1][:keep]
        return cls(np.sort(idx))

    def transform(self, batch):
        return np.take(batch, self.indices, axis=-1)

    def inverse_transform(self, batch, out_channels=512, rng=None):
        return inverse_data_transform(batch, normalize_flag=False,
                                      slice_idx=self.indices,
                                      out_channels=out_channels, rng=rng)


def sigma_dim_weights(sigma_matrix):
    """Per-dimension weights from encoder sigmas: w_d = 1/mean(sigma_d).

    Dimensions the encoder is confident about (small sigma) are amplified
    (reference ``generate_compressed_transform.py:99-109``).
    """
    mean_sigma = np.mean(np.asarray(sigma_matrix), axis=0)
    return 1.0 / (mean_sigma + 1e-12)


class PCATransform:
    """StandardScaler + PCA with exact inverse (reference ``:129-143``)."""

    def __init__(self, scaler, pca):
        self.scaler = scaler
        self.pca = pca

    def transform(self, batch):
        return self.pca.transform(self.scaler.transform(batch))

    def inverse_transform(self, batch):
        return self.scaler.inverse_transform(self.pca.inverse_transform(batch))


class StandardScaler:
    """Per-feature standardization, scikit-learn's ``StandardScaler``:
    mean and population standard deviation (1 where it is 0)."""

    def fit(self, data):
        data = np.asarray(data, np.float64)
        self.mean_ = data.mean(axis=0)
        scale = data.std(axis=0)
        self.scale_ = np.where(scale == 0, 1.0, scale)
        return self

    def transform(self, batch):
        return (np.asarray(batch) - self.mean_) / self.scale_

    def inverse_transform(self, batch):
        return np.asarray(batch) * self.scale_ + self.mean_


class PCA:
    """Principal components by a full SVD of the centered data, each
    component's sign fixed so its largest entry is positive (scikit-learn's
    ``svd_flip`` on the components)."""

    def __init__(self, n_components):
        self.n_components = n_components

    def fit(self, data):
        data = np.asarray(data, np.float64)
        self.mean_ = data.mean(axis=0)
        _, _, vt = np.linalg.svd(data - self.mean_, full_matrices=False)
        signs = np.sign(vt[np.arange(len(vt)), np.abs(vt).argmax(axis=1)])
        self.components_ = (vt * signs[:, None])[:self.n_components]
        return self

    def transform(self, batch):
        return (np.asarray(batch) - self.mean_) @ self.components_.T

    def inverse_transform(self, batch):
        return np.asarray(batch) @ self.components_ + self.mean_


def fit_pca(data, n_components=42):
    """StandardScaler then PCA, in numpy (the JAX package fits them with
    scikit-learn; its pickles of those load where scikit-learn does)."""
    scaler = StandardScaler().fit(data)
    pca = PCA(n_components).fit(scaler.transform(data))
    return PCATransform(scaler, pca)
