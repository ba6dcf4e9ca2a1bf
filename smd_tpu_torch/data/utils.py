"""Embedding-matrix utilities (reference ``utils/data_utils.py:194-309``).

A numpy copy of ``smd_tpu/data/utils.py``, kept here because the port
imports nothing of the JAX package.

Self-similarity matrices, upper-triangle (un)rolling, bar erase/infill, and
simple batching/shuffling helpers.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "truncate_embeddings", "self_similarity", "unroll_upper_triangular",
    "roll_upper_triangular", "erase_bars", "infill_bars", "batches",
    "shuffle",
]


def truncate_embeddings(embeddings, length):
    """Truncate or zero-pad an embedding matrix to ``length`` rows."""
    embeddings = np.asarray(embeddings)
    pad_length = length - len(embeddings)
    if pad_length <= 0:
        return embeddings[:length]
    padding = np.zeros((pad_length, embeddings.shape[-1]),
                       embeddings.dtype)
    return np.concatenate((embeddings, padding))


def self_similarity(embeddings, normalized=True, max_len=80):
    """Self-similarity (optionally cosine) matrix for an embedding sequence."""
    embeddings = truncate_embeddings(embeddings, max_len)
    if normalized:
        norms = np.linalg.norm(embeddings, ord=2, axis=1, keepdims=True)
        norm_embeddings = np.divide(embeddings, norms,
                                    out=np.zeros_like(embeddings),
                                    where=norms != 0)
        return norm_embeddings @ norm_embeddings.T
    return embeddings @ embeddings.T


def unroll_upper_triangular(matrix):
    matrix = np.asarray(matrix)
    rows, cols = matrix.shape
    assert rows == cols, "Not a square matrix."
    row_idx, col_idx = np.triu_indices(rows, 1)
    return list(matrix[row_idx, col_idx])


def roll_upper_triangular(vector, size):
    matrix = np.ones((size, size))
    offset = 0
    for i in range(size):
        row = np.asarray(vector[offset:offset + size - (i + 1)])
        matrix[i, i + 1:size] = row
        matrix[i + 1:size, i] = row
        offset += len(row)
    assert offset == len(vector)
    return matrix


def erase_bars(embeddings, indices):
    out = np.array(embeddings)
    out[np.asarray(indices)] = 0
    return out


def infill_bars(embeddings, chunk_params, erased_chunk_indices):
    assert len(chunk_params) == len(erased_chunk_indices)
    out = np.array(embeddings)
    out[np.asarray(erased_chunk_indices)] = chunk_params
    return out


def batches(data, labels=None, batch_size=32):
    num_batches = data.shape[0] // batch_size
    for i in range(num_batches):
        j, k = i * batch_size, (i + 1) * batch_size
        if labels is not None:
            assert len(data) == len(labels)
            yield data[j:k], labels[j:k]
        else:
            yield data[j:k]


def shuffle(data, labels=None, rng=None):
    rng = rng if rng is not None else np.random.default_rng()
    idx = rng.permutation(len(data))
    if labels is not None:
        assert len(data) == len(labels)
        return data[idx], labels[idx]
    return data[idx]
