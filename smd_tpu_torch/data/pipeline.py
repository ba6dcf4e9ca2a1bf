"""Input pipeline: TFRecord latents -> transformed, normalized numpy batches
(port of ``smd_tpu/data/pipeline.py``, without TensorFlow).

``get_dataset`` keeps the JAX package's semantics for ``problem`` in
``vae``/``toy``/``tokens``: the files ``{dataset}/{split}-*.tfrecord``, read
a record from each of up to 40 in turn (tf.data's interleave of 40, which
with ``deterministic=False`` may also take another order); batches of
``batch_size`` with the remainder dropped; PCA, then dim weights, then the
slice, in float32; [-1, 1] normalization by each split's own min/max of
the transformed batches, cached at ``{dataset}/cache/{split}_{config}_
{stat}.pkl``; the batch count cached beside them; ``shard_index`` of
``shard_count`` taking every ``shard_count``-th example; the eval split
kept after its first pass. ``tokens`` records hold a bool tensor
(``records.parse_tensor``) and take no transform and no normalization:
their batches are bool. ``mnist`` reads ``$MNIST_NPZ`` (keras'
``x_train``/``x_test`` layout) or else scikit-learn's digits upscaled to
28x28, as the JAX package does offline, in batches of (B, 784) scaled to
2·x/255 − 1.

Across ranks (``shard_count`` > 1) every shard yields the same number of
batches, the smallest shard's, so that the ranks step together; and the
normalization statistics are the whole split's, equal on every rank and
to one rank's (the JAX pipeline takes each shard's own).

Shuffling: each pass shuffles the file order and the examples through a
buffer of 8·batch_size (mnist's training images through one of 10,000),
TF's algorithm; the order is not TF's. Every pass of every split draws
from a numpy ``Generator`` of its own, seeded by (``seed``, split, pass
number), the min/max pass being number 0: a pass's order depends on how
many passes came before it, never on how far they were read. So ranks
that stop a pass at different points (the one-example look-ahead that
ends a shard, a peek at the eval split) still read disjoint shards of
one order in every later pass, and a cached statistic leaves the passes'
order as it was.
"""
from __future__ import annotations

import dataclasses
import glob
import itertools
import logging
import os
from typing import Callable, Iterator, List, Optional

import numpy as np

from smd_tpu_torch.data import records as records_lib
from smd_tpu_torch.data import tfrecord_native, transforms
from smd_tpu_torch.utils import io as io_lib

__all__ = ["Dataset", "get_dataset", "inverse_data_transform",
           "compute_dataset_statistics"]

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


def _pass_rng(seed, split, number):
    """The generator of pass ``number`` of ``split`` (0 is the min/max
    pass)."""
    return np.random.default_rng([seed, ("train", "eval").index(split),
                                  number])


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
        inputs = ex["inputs"]
        if isinstance(inputs, bytes):   # a token record's bool tensor
            inputs = records_lib.parse_tensor(inputs)
        yield inputs.reshape(tuple(ex["input_shape"])).reshape(shape)


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


def compute_dataset_statistics(ds, split="train", cache_dir="", config=""):
    """Mean/std over a batched dataset, pickle-cached
    (reference ``utils/data_utils.py:93-125``): the batches' elementwise
    mean and std in float64, each of a batch's shape."""
    mean_p = _cache_path(cache_dir, split, config, "mean")
    std_p = _cache_path(cache_dir, split, config, "stddev")
    if os.path.exists(mean_p) and os.path.exists(std_p):
        return io_lib.load(mean_p), io_lib.load(std_p)
    count, total, total_sq = 0, 0.0, 0.0
    for batch in ds:
        count += 1
        total += np.asarray(batch).astype(np.float64)
        total_sq += np.asarray(batch).astype(np.float64)**2
    mean = total / max(count, 1)
    std = np.sqrt(total_sq / max(count, 1) - mean**2)
    if cache_dir:
        io_lib.save(mean, mean_p)
        io_lib.save(std, std_p)
    return mean, std


def _shard_batches(total, batch_size, shard_count):
    """Batches a pass of every shard yields: the smallest shard's whole
    batches (all of them on one shard)."""
    return total // shard_count // batch_size


def _compute_cardinality(files, batch_size, shard_count, split, cache_dir):
    # One shard's count is JAX's file; a shard of several has its own.
    config = str(batch_size) if shard_count == 1 else \
        f"{batch_size}x{shard_count}"
    path = _cache_path(cache_dir, split, config, "cardinality")
    if os.path.exists(path):
        return io_lib.load(path)
    total = sum(len(tfrecord_native.scan_records(f)) for f in files)
    n = _shard_batches(total, batch_size, shard_count)
    if cache_dir:
        io_lib.save(n, path)
    return n


def _sklearn_digits_as_mnist():
    """sklearn's bundled 1797 8x8 digits upscaled to MNIST's 28x28 uint8.

    The offline stand-in for tfds MNIST (reference input_pipeline.py:122-124)
    when no $MNIST_NPZ file is provided: real handwritten-digit images with
    the same tensor contract (N, 28, 28) uint8 0..255. scikit-learn is
    imported here, when called.
    """
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise RuntimeError(
            "MNIST problem needs $MNIST_NPZ (x_train/x_test arrays) or "
            "scikit-learn's bundled digits") from e
    images = load_digits().images.astype(np.float32)   # (1797, 8, 8), 0..16
    images = np.kron(images, np.ones((1, 3, 3), np.float32))   # -> 24x24
    images = np.pad(images, ((0, 0), (2, 2), (2, 2)))
    images = np.clip(images * (255.0 / 16.0), 0, 255).astype(np.uint8)
    n_eval = len(images) // 10
    return images[n_eval:], images[:n_eval]


def _mnist(batch_size, shuffle, shard_index, shard_count, seed,
           include_cardinality):
    """(train, eval) Datasets of MNIST images, (B, 784) in [-1, 1]."""
    npz_path = os.environ.get("MNIST_NPZ", "")
    if npz_path and os.path.exists(npz_path):
        with np.load(npz_path) as d:
            x_train, x_test = d["x_train"], d["x_test"]
    else:
        x_train, x_test = _sklearn_digits_as_mnist()

    def split_dataset(split, images, shuffled, cache):
        n = _shard_batches(len(images), batch_size, shard_count)
        passes = itertools.count(1)

        def batches():
            order = range(len(images))
            if shuffled:
                rng = _pass_rng(seed, split, next(passes))
                order = _shuffled(order, rng, 10000)
            mine = itertools.islice(
                (i for j, i in enumerate(order)
                 if j % shard_count == shard_index), n * batch_size)
            idx = np.fromiter(mine, np.int64)
            for b in range(n):
                batch = images[idx[b * batch_size:(b + 1) * batch_size]]
                yield (2.0 * (batch.reshape(batch_size, -1)
                              .astype(np.float32) / 255.0) - 1.0
                       ).astype(np.float32)

        ds = Dataset(batches, 0.0, 1.0, cache=cache)
        if include_cardinality:
            ds.examples = n
        return ds

    return (split_dataset("train", x_train, shuffle, cache=False),
            split_dataset("eval", x_test, False, cache=True))


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
    """Build (train, eval) Datasets: 'vae' | 'toy' | 'tokens' read
    ``{dataset}/{split}-*.tfrecord``; 'mnist' reads ``$MNIST_NPZ`` or
    scikit-learn's digits."""
    if problem == "mnist":
        return _mnist(batch_size, shuffle, shard_index, shard_count, seed,
                      include_cardinality)
    if problem not in ("vae", "toy", "tokens"):
        raise ValueError(f"Unknown problem type: {problem}")
    tokens = problem == "tokens"
    shape = tuple(int(s) for s in data_shape)
    root = os.path.expanduser(dataset)

    pca = io_lib.load(os.path.expanduser(pca_ckpt)) if pca_ckpt else None
    slice_idx = io_lib.load(
        os.path.expanduser(slice_ckpt)) if slice_ckpt else None
    dim_weights = io_lib.load(
        os.path.expanduser(dim_weights_ckpt)) if dim_weights_ckpt else None

    config_name = "".join(
        p.split("/")[-1].split(".")[0]
        for p in (pca_ckpt, slice_ckpt, dim_weights_ckpt))
    cache_dir = root if dataset else ""

    def split_dataset(split):
        files = sorted(glob.glob(f"{root}/{split}-*.tfrecord"))
        if not files:
            raise FileNotFoundError(f"no {root}/{split}-*.tfrecord files")
        examples = None
        if include_cardinality or shard_count > 1:
            examples = _compute_cardinality(files, batch_size, shard_count,
                                            split, cache_dir)
        limit = examples if shard_count > 1 else None
        passes = itertools.count(1)

        def raw(index=shard_index, count=shard_count, limit=limit,
                number=None):
            rng = None
            if shuffle:
                number = next(passes) if number is None else number
                rng = _pass_rng(seed, split, number)
            batch, made = [], 0
            for ex in _examples(files, shape, rng, 8 * batch_size, index,
                                count):
                if made == limit:
                    return
                batch.append(ex)
                if len(batch) == batch_size:
                    batch = np.stack(batch)
                    yield batch if tokens else _transform(
                        batch, pca, dim_weights, slice_idx)
                    batch, made = [], made + 1

        lo, hi = 0.0, 1.0
        if normalize and not tokens:
            # Over the whole split on every rank, as pass 0.
            lo, hi = _compute_min_max(lambda: raw(0, 1, None, 0),
                                      split, cache_dir, config_name)

        def batches():
            for b in raw():
                yield transforms.normalize(b, lo, hi) \
                    if normalize and not tokens else b

        ds = Dataset(batches, lo, hi, cache=split == "eval")
        if include_cardinality:
            ds.examples = examples
        return ds

    if normalize and not tokens:
        log.info("Normalizing dataset to have range [-1, 1].")
    return split_dataset("train"), split_dataset("eval")
