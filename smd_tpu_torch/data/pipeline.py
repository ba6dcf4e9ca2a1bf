"""Input pipeline: TFRecord latents -> transformed, normalized numpy batches
(port of ``smd_tpu/data/pipeline.py``, without TensorFlow).

``get_dataset`` keeps the JAX package's semantics for ``problem`` in
``vae``/``toy``: the files ``{dataset}/{split}-*.tfrecord``, read a record
from each of up to 40 in turn (tf.data's interleave of 40, which with
``deterministic=False`` may also take another order); batches of
``batch_size`` with the remainder dropped; PCA, then dim weights, then the
slice, in float32; [-1, 1] normalization by each split's own min/max of
the transformed batches, cached at ``{dataset}/cache/{split}_{config}_
{stat}.pkl``; the batch count cached beside them; ``shard_index`` of
``shard_count`` taking every ``shard_count``-th example; the eval split
kept after its first pass.

Shuffling: each pass shuffles the file order and the examples through a
buffer of 8·batch_size, TF's algorithm, with a numpy ``Generator`` seeded
by ``seed``; the order is not TF's. ``mnist`` and ``tokens`` are not
ported (``ROADMAP.md`` queue A).
"""
from __future__ import annotations

import dataclasses
import glob
import itertools
import logging
import os
from typing import Callable, Iterator, List, Optional

import numpy as np

from smd_tpu_torch.data import tfrecord_native, transforms
from smd_tpu_torch.utils import io as io_lib

__all__ = ["Dataset", "get_dataset", "inverse_data_transform"]

log = logging.getLogger("smd_tpu_torch")

inverse_data_transform = transforms.inverse_data_transform


@dataclasses.dataclass
class Dataset:
    """A batched dataset plus its normalization statistics.

    ``batches`` makes one pass of numpy batches; with ``cache`` the first
    whole pass is kept and every later pass replays it.
    """
    batches: Callable[[], Iterator[np.ndarray]]
    min: float = 0.0
    max: float = 1.0
    examples: int = -1   # number of batches per epoch (reference semantics)
    cache: bool = False
    _kept: Optional[List[np.ndarray]] = dataclasses.field(default=None,
                                                          repr=False)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._kept is not None:
            yield from self._kept
            return
        kept = [] if self.cache else None
        for batch in self.batches():
            if kept is not None:
                kept.append(batch)
            yield batch
        if kept is not None:
            self._kept = kept

    def take_examples(self, n: Optional[int]) -> np.ndarray:
        """Unbatch and materialize up to n examples as one array."""
        out, count = [], 0
        for batch in self:
            out.append(batch)
            count += batch.shape[0]
            if n is not None and count >= n:
                break
        arr = np.concatenate(out, axis=0)
        return arr[:n] if n is not None else arr


def _cache_path(cache_dir, split, config, stat):
    return os.path.join(cache_dir, f"cache/{split}_{config}_{stat}.pkl")


def _shuffled(items, rng, buffer_size):
    """TF's shuffle: a buffer of ``buffer_size``; each new item replaces a
    random one, which is yielded; the rest go out in random order."""
    buffer = []
    for item in items:
        if len(buffer) < buffer_size:
            buffer.append(item)
            continue
        i = rng.integers(len(buffer))
        yield buffer[i]
        buffer[i] = item
    rng.shuffle(buffer)
    yield from buffer


def _interleave(files, cycle_length=40):
    """The records of ``files`` as tf.data's ``interleave(cycle_length=40)``
    takes them: one record from each of up to 40 open files in turn, the
    next file opening as one runs out."""
    pending = iter(files)
    active = [tfrecord_native.iter_records(f)
              for f in itertools.islice(pending, cycle_length)]
    while active:
        for i, it in enumerate(active):
            record = next(it, None)
            if record is None:
                nxt = next(pending, None)
                active[i] = None if nxt is None else \
                    tfrecord_native.iter_records(nxt)
                record = None if active[i] is None else next(active[i], None)
            if record is not None:
                yield record
        active = [it for it in active if it is not None]


def _examples(files, shape, rng, buffer_size, shard_index, shard_count):
    """Decoded examples of ``files``, shuffled when ``rng`` is given, then
    sharded."""
    if rng is not None:
        files = [files[i] for i in rng.permutation(len(files))]
    records = _interleave(files)
    if rng is not None:
        records = _shuffled(records, rng, buffer_size)
    for i, record in enumerate(records):
        if i % shard_count != shard_index:
            continue
        ex = tfrecord_native.parse_example(record)
        yield ex["inputs"].reshape(tuple(ex["input_shape"])).reshape(shape)


def _transform(batch, pca, dim_weights, slice_idx):
    """PCA, dim weights, slice, in float32, in the JAX pipeline's order."""
    if pca is not None:
        flat = batch.reshape(batch.shape[0], -1)
        z = (flat - pca.scaler.mean_.astype(np.float32)) / \
            pca.scaler.scale_.astype(np.float32)
        batch = (z - pca.pca.mean_.astype(np.float32)) @ \
            pca.pca.components_.astype(np.float32).T
    if dim_weights is not None:
        batch = batch * np.asarray(dim_weights, np.float32)
    if slice_idx is not None:
        batch = np.take(batch, np.asarray(slice_idx, np.int64), axis=-1)
    return batch.astype(np.float32, copy=False)


def _compute_min_max(batches, split, cache_dir, config):
    min_p = _cache_path(cache_dir, split, config, "min")
    max_p = _cache_path(cache_dir, split, config, "max")
    if os.path.exists(min_p) and os.path.exists(max_p):
        log.info("Using cached dataset min/max at %s", cache_dir)
        return io_lib.load(min_p), io_lib.load(max_p)
    ds_min, ds_max = np.float32(np.inf), np.float32(-np.inf)
    for batch in batches():
        ds_min = min(ds_min, batch.min())
        ds_max = max(ds_max, batch.max())
    ds_min, ds_max = float(ds_min), float(ds_max)
    if cache_dir:
        io_lib.save(ds_min, min_p)
        io_lib.save(ds_max, max_p)
    return ds_min, ds_max


def _compute_cardinality(files, batch_size, shard_index, shard_count, split,
                         cache_dir):
    path = _cache_path(cache_dir, split, str(batch_size), "cardinality")
    if os.path.exists(path):
        return io_lib.load(path)
    total = sum(len(tfrecord_native.scan_records(f)) for f in files)
    n = (total - shard_index + shard_count - 1) // shard_count // batch_size
    if cache_dir:
        io_lib.save(n, path)
    return n


def get_dataset(dataset="",
                data_shape=(2,),
                problem="vae",
                batch_size=128,
                normalize=True,
                pca_ckpt="",
                slice_ckpt="",
                dim_weights_ckpt="",
                include_cardinality=True,
                shuffle=True,
                shard_index=0,
                shard_count=1,
                seed=0):
    """Build (train, eval) Datasets reading ``{dataset}/{split}-*.tfrecord``
    for ``problem`` 'vae' or 'toy'."""
    if problem in ("mnist", "tokens"):
        raise NotImplementedError(
            f"problem={problem!r} is not ported to smd_tpu_torch yet: see "
            "ROADMAP.md, queue A")
    if problem not in ("vae", "toy"):
        raise ValueError(f"Unknown problem type: {problem}")
    shape = tuple(int(s) for s in data_shape)
    root = os.path.expanduser(dataset)

    pca = io_lib.load(os.path.expanduser(pca_ckpt)) if pca_ckpt else None
    slice_idx = io_lib.load(
        os.path.expanduser(slice_ckpt)) if slice_ckpt else None
    dim_weights = io_lib.load(
        os.path.expanduser(dim_weights_ckpt)) if dim_weights_ckpt else None

    rng = np.random.default_rng(seed) if shuffle else None
    config_name = "".join(
        p.split("/")[-1].split(".")[0]
        for p in (pca_ckpt, slice_ckpt, dim_weights_ckpt))
    cache_dir = root if dataset else ""

    def split_dataset(split):
        files = sorted(glob.glob(f"{root}/{split}-*.tfrecord"))
        if not files:
            raise FileNotFoundError(f"no {root}/{split}-*.tfrecord files")

        def raw():
            batch = []
            for ex in _examples(files, shape, rng, 8 * batch_size,
                                shard_index, shard_count):
                batch.append(ex)
                if len(batch) == batch_size:
                    yield _transform(np.stack(batch), pca, dim_weights,
                                     slice_idx)
                    batch = []

        lo, hi = 0.0, 1.0
        if normalize:
            lo, hi = _compute_min_max(raw, split, cache_dir, config_name)

        def batches():
            for b in raw():
                yield transforms.normalize(b, lo, hi) if normalize else b

        ds = Dataset(batches, lo, hi, cache=split == "eval")
        if include_cardinality:
            ds.examples = _compute_cardinality(files, batch_size, shard_index,
                                               shard_count, split, cache_dir)
        return ds

    if normalize:
        log.info("Normalizing dataset to have range [-1, 1].")
    return split_dataset("train"), split_dataset("eval")
