"""The port's TF-free data input against ``smd_tpu``'s, on the CPU.

Records written by the port's writer read back through the JAX package's
TF-free parser and its native CRC-verifying scanner; ``get_dataset``
without shuffling against the JAX TensorFlow pipeline and its transforms
on the same records; the numpy copies against their originals.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from smd_tpu.data import pipeline as jpipeline
from smd_tpu.data import synthetic as jsynthetic
from smd_tpu.data import tfrecord_native as jtn
from smd_tpu.data import transforms as jtransforms
from smd_tpu.data import utils as jdata_utils
from smd_tpu_torch.data import pipeline, records, synthetic, tfrecord_native
from smd_tpu_torch.data import transforms
from smd_tpu_torch.data import utils as data_utils
from smd_tpu_torch.training import loop

SHAPE = (4, 16)


def _latents(n, seed):
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.5, 3.0, SHAPE[1]).astype(np.float32)
    return (rng.normal(size=(n, *SHAPE)) * scale).astype(np.float32)


@pytest.fixture
def dataset(tmp_path):
    """train (24 examples in 2 files) and eval (9) in the reference's
    schema, written by the port, plus slice and dim-weight pickles."""
    root = tmp_path / "ds"
    train, evals = _latents(24, 0), _latents(9, 1)
    records.write_tfrecord(str(root / "train-0.tfrecord"), train[:15])
    records.write_tfrecord(str(root / "train-1.tfrecord"), train[15:])
    records.write_tfrecord(str(root / "eval-0.tfrecord"), evals)
    with open(tmp_path / "slice-x.pkl", "wb") as f:
        pickle.dump(np.asarray([1, 4, 5, 9, 15], np.int64), f)
    with open(tmp_path / "weights-x.pkl", "wb") as f:
        pickle.dump(np.linspace(0.5, 2.0, SHAPE[1]).astype(np.float32), f)
    return root, train, evals


def test_crc32c_check_value():
    # The CRC32C of "123456789" (RFC 3720's check value).
    data = np.frombuffer(b"123456789", np.uint8)[None]
    assert int(records.crc32c(data)[0]) == 0xE3069283


def test_writer_is_read_by_the_jax_parser(dataset):
    root, train, _ = dataset
    path = str(root / "train-0.tfrecord")
    # The native scanner verifies every length and payload CRC.
    assert jtn._load_native() is not None
    assert len(jtn.scan_records(path, verify_crc=True)) == 15
    assert jtn.read_records(path) == list(tfrecord_native.iter_records(path))
    for i, rec in enumerate(jtn.read_records(path)):
        ex, ours = jtn.parse_example(rec), tfrecord_native.parse_example(rec)
        assert set(ex) == set(ours) == {"inputs", "input_shape"}
        np.testing.assert_array_equal(ex["input_shape"], SHAPE)
        np.testing.assert_array_equal(ex["inputs"].reshape(SHAPE), train[i])
        np.testing.assert_array_equal(ours["inputs"], ex["inputs"])


def test_writer_with_targets_is_read_by_tensorflow(tmp_path):
    import tensorflow as tf
    x, y = _latents(3, 2), _latents(3, 3)[:, :2]
    path = str(tmp_path / "t.tfrecord")
    records.write_tfrecord(path, x, targets=y)
    for i, raw in enumerate(tf.data.TFRecordDataset(path)):
        ex = tf.train.Example.FromString(raw.numpy()).features.feature
        np.testing.assert_array_equal(
            np.asarray(ex["inputs"].float_list.value).reshape(SHAPE), x[i])
        np.testing.assert_array_equal(
            np.asarray(ex["targets"].float_list.value).reshape(2, 16), y[i])
        assert list(ex["target_shape"].int64_list.value) == [2, 16]


@pytest.mark.parametrize("transform", ["slice", "weights+slice", "pca"])
def test_get_dataset_matches_jax_pipeline(dataset, tmp_path, transform):
    """No shuffling: the same batches, min/max, cache files and batch
    counts as the JAX TensorFlow pipeline, and the JAX transforms applied
    to the records by hand."""
    root, train, evals = dataset
    kw = {}
    if "slice" in transform:
        kw["slice_ckpt"] = str(tmp_path / "slice-x.pkl")
    if "weights" in transform:
        kw["dim_weights_ckpt"] = str(tmp_path / "weights-x.pkl")
    if transform == "pca":
        pca = jtransforms.fit_pca(train.reshape(len(train), -1), 6)
        with open(tmp_path / "pca-x.pkl", "wb") as f:
            pickle.dump(pca, f)
        kw["pca_ckpt"] = str(tmp_path / "pca-x.pkl")
    jroot = tmp_path / "jax_ds"
    jroot.mkdir()
    for f in os.listdir(root):
        (jroot / f).write_bytes((root / f).read_bytes())

    ours = pipeline.get_dataset(str(root), SHAPE, "vae", 4, shuffle=False,
                                **kw)
    ref = jpipeline.get_dataset(str(jroot), SHAPE, "vae", 4, shuffle=False,
                                **kw)
    for o, r, data in zip(ours, ref, (train, evals)):
        ob, rb = list(o), list(r)
        assert len(ob) == len(rb) == len(data) // 4 == o.examples == \
            r.examples
        if data is train:
            # TF interleaves the two files with deterministic=False: the
            # same examples (24, no remainder), in an order of its own.
            ob, rb = [_sorted_rows(np.concatenate(b)) for b in (ob, rb)]
        # float32; PCA's product sums in another order.
        for a, b in zip(ob, rb):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose([o.min, o.max], [r.min, r.max],
                                   rtol=1e-6)
        # By hand, the JAX transforms (drop_remainder: whole batches only).
        kept = data[:len(data) // 4 * 4]
        if transform == "pca":
            x = jtransforms.data_transform(kept.reshape(len(kept), -1), pca)
        else:
            x = jtransforms.slice_transform(
                kept, np.asarray([1, 4, 5, 9, 15]),
                np.linspace(0.5, 2.0, 16).astype(np.float32)
                if "weights" in transform else None)
        np.testing.assert_allclose(o.min, x.min(), rtol=1e-5)
        np.testing.assert_allclose(o.max, x.max(), rtol=1e-5)
        x = jtransforms.normalize(x, x.min(), x.max())
        np.testing.assert_allclose(
            np.concatenate(ob) if data is evals else ob,
            x if data is evals else _sorted_rows(x), rtol=1e-5, atol=1e-5)
    assert sorted(os.listdir(root / "cache")) == \
        sorted(os.listdir(jroot / "cache"))


# The two train files (15 and 9 examples) read a record from each in turn.
READ_ORDER = [0, 15, 1, 16, 2, 17, 3, 18, 4, 19, 5, 20, 6, 21, 7, 22, 8, 23,
              9, 10, 11, 12, 13, 14]


def _sorted_rows(x):
    flat = x.reshape(len(x), -1)
    return flat[np.lexsort(flat.T)]


def test_files_are_read_in_turn(dataset):
    root, train, _ = dataset
    ds, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 1, normalize=False,
                                 shuffle=False)
    order = [int(np.argmin(((train - b[0]) ** 2).sum((1, 2)))) for b in ds]
    assert order == READ_ORDER


def test_min_max_and_cardinality_come_from_the_cache(dataset, tmp_path):
    root, _, _ = dataset
    kw = dict(slice_ckpt=str(tmp_path / "slice-x.pkl"), shuffle=False)
    first, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 4, **kw)
    with open(root / "cache" / "train_slice-x_min.pkl", "wb") as f:
        pickle.dump(-7.0, f)
    with open(root / "cache" / "train_4_cardinality.pkl", "wb") as f:
        pickle.dump(99, f)
    again, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 4, **kw)
    assert again.min == -7.0 and again.max == first.max
    assert again.examples == 99


def test_shuffled_passes_are_seeded_permutations(dataset):
    root, train, _ = dataset

    def epochs(seed):
        ds, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 24,
                                     normalize=False, seed=seed)
        return [next(iter(ds)) for _ in range(2)]

    a, b = epochs(0), epochs(0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for x in a:   # one batch of all 24 examples, in another order
        np.testing.assert_array_equal(_sorted_rows(x), _sorted_rows(train))
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], epochs(1)[0])


def test_shards_split_the_examples(dataset):
    root, train, _ = dataset
    parts = [np.concatenate(list(pipeline.get_dataset(
        str(root), SHAPE, "vae", 1, normalize=False, shuffle=False,
        shard_index=i, shard_count=2)[0])) for i in (0, 1)]
    # Every other example of the stream, as tf.data's shard(2, i).
    np.testing.assert_array_equal(parts[0], train[READ_ORDER[0::2]])
    np.testing.assert_array_equal(parts[1], train[READ_ORDER[1::2]])


def test_eval_split_keeps_its_first_pass(dataset):
    root, _, _ = dataset
    _, evald = pipeline.get_dataset(str(root), SHAPE, "vae", 3, seed=4)
    first, second = list(evald), list(evald)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(evald.take_examples(5),
                                  np.concatenate(first)[:5])


def test_unported_problems_raise(dataset):
    root, _, _ = dataset
    for problem in ("mnist", "tokens"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pipeline.get_dataset(str(root), SHAPE, problem, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        records.serialize_example(np.zeros(3), tokens=True)


def test_device_prefetch_keeps_order_and_values():
    batches = [np.full((2, 3), i, np.float32) for i in range(5)]
    out = list(loop.device_prefetch(iter(batches), "cpu", size=2))
    assert [int(b[0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b, torch.Tensor) for b in out)


def test_numpy_copies_match_the_jax_package():
    rng = np.random.default_rng
    np.testing.assert_array_equal(
        synthetic.toy_distribution(64, rng(0)),
        jsynthetic.toy_distribution(64, rng(0)))
    np.testing.assert_array_equal(
        synthetic.toy_sequence_distribution(5, 8, rng(1)),
        jsynthetic.toy_sequence_distribution(5, 8, rng(1)))
    batch = rng(2).uniform(-1, 1, (3, 4, 5)).astype(np.float32)
    idx = np.asarray([0, 3, 7, 9, 11])
    w = rng(3).uniform(0.5, 2, 12).astype(np.float32)
    np.testing.assert_array_equal(
        transforms.inverse_data_transform(batch, True, None, -2.0, 3.0, idx,
                                          w, 12, rng(4)),
        jtransforms.inverse_data_transform(batch, True, None, -2.0, 3.0, idx,
                                           w, 12, rng(4)))
    emb = rng(6).normal(size=(7, 5))
    np.testing.assert_array_equal(data_utils.self_similarity(emb, max_len=9),
                                  jdata_utils.self_similarity(emb, max_len=9))
    vec = data_utils.unroll_upper_triangular(rng(7).normal(size=(4, 4)))
    np.testing.assert_array_equal(data_utils.roll_upper_triangular(vec, 4),
                                  jdata_utils.roll_upper_triangular(vec, 4))
    st = transforms.SliceTransform.fit(rng(5).normal(size=(50, 12)), keep=4)
    assert np.array_equal(st.indices, jtransforms.SliceTransform.fit(
        rng(5).normal(size=(50, 12)), keep=4).indices)


@pytest.mark.parametrize("shape", [(2000, 64), (100, 40)])
def test_fit_pca_matches_the_jax_package(shape):
    """The port fits StandardScaler + PCA in numpy (an exact SVD); the JAX
    package with scikit-learn, which takes the covariance's
    eigendecomposition for tall data and a full SVD for small data: the
    same components, signs included, to rounding."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1])) \
        * 0.1 + rng.normal(size=shape[1])
    ours, ref = transforms.fit_pca(x, 12), jtransforms.fit_pca(x, 12)
    y, y_ref = ours.transform(x), ref.transform(x)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-10 * np.abs(
        y_ref).max())
    np.testing.assert_allclose(ours.inverse_transform(y),
                               ref.inverse_transform(y_ref), rtol=0,
                               atol=1e-10 * np.abs(x).max())
