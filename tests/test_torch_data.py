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


def test_unported_problems_raise(dataset, tmp_path, monkeypatch):
    """Every problem of the JAX package reads (mnist and tokens too, held
    to JAX below); an unknown one raises JAX's error in both."""
    root, _, _ = dataset
    with pytest.raises(ValueError, match="Unknown problem type: bogus"):
        pipeline.get_dataset(str(root), SHAPE, "bogus", 4)
    with pytest.raises(ValueError, match="Unknown problem type: bogus"):
        jpipeline.get_dataset(str(root), SHAPE, "bogus", 4)
    monkeypatch.setenv("MNIST_NPZ", _mnist_npz(tmp_path))
    train, _ = pipeline.get_dataset("", (784,), "mnist", 4)
    assert next(iter(train)).shape == (4, 784)
    records.write_tfrecord(str(tmp_path / "tok" / "train-0.tfrecord"),
                           np.ones((4, 2, 3), bool), tokens=True)
    records.write_tfrecord(str(tmp_path / "tok" / "eval-0.tfrecord"),
                           np.ones((4, 2, 3), bool), tokens=True)
    train, _ = pipeline.get_dataset(str(tmp_path / "tok"), (2, 3), "tokens",
                                    4)
    assert next(iter(train)).dtype == bool


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


# -- token records, mnist, statistics, CRC checks ------------------------------

@pytest.mark.parametrize("shape", [(8, 5), (), (0, 3), (3, 0), (1,),
                                   (1024, 90), (2, 1, 3)])
def test_token_bytes_equal_tensorflow(shape):
    import tensorflow as tf
    x = np.random.default_rng(len(shape)).random(shape) > 0.5
    data = records.serialize_tensor(x)
    assert data == tf.io.serialize_tensor(tf.constant(x)).numpy()
    back = records.parse_tensor(data)
    assert back.dtype == bool and back.shape == x.shape
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        tf.io.parse_tensor(data, out_type=tf.bool).numpy(), x)
    with pytest.raises(ValueError, match="Type mismatch"):
        records.parse_tensor(tf.io.serialize_tensor(
            tf.constant(x.astype(np.float32))).numpy())


def _tokens(n, seed):
    return np.random.default_rng(seed).random((n, 6, 5)) > 0.6


def test_tokens_batches_equal_the_jax_pipeline(tmp_path):
    """Token records written by the port, read unshuffled by both
    pipelines: bool batches, no transform, no normalization (the port
    skips it for tokens; the JAX pipeline takes none with normalize off
    and raises with it on)."""
    root = tmp_path / "tok"
    train, evals = _tokens(12, 0), _tokens(6, 1)
    records.write_tfrecord(str(root / "train-0.tfrecord"), train[:7],
                           tokens=True)
    records.write_tfrecord(str(root / "train-1.tfrecord"), train[7:],
                           tokens=True)
    records.write_tfrecord(str(root / "eval-0.tfrecord"), evals,
                           tokens=True)
    kw = dict(shuffle=False, normalize=False, include_cardinality=False)
    ref = jpipeline.get_dataset(str(root), (6, 5), "tokens", 2, **kw)
    for normalize in (False, True):
        ours = pipeline.get_dataset(str(root), (6, 5), "tokens", 2,
                                    **{**kw, "normalize": normalize})
        for a, b, data in zip(ours, ref, (train, evals)):
            got, want = list(a), list(b)
            assert len(got) == len(want) == len(data) // 2
            assert all(x.dtype == y.dtype == bool
                       for x, y in zip(got, want))
            if data is train:
                # TF interleaves the two files in an order of its own.
                got, want = ([_sorted_rows(np.concatenate(g).astype(np.uint8))]
                             for g in (got, want))
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)


def _mnist_npz(tmp_path, n_train=24, n_test=12):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "mnist.npz")
    np.savez(path, x_train=rng.integers(0, 256, (n_train, 28, 28),
                                        dtype=np.uint8),
             x_test=rng.integers(0, 256, (n_test, 28, 28), dtype=np.uint8))
    return path


def test_mnist_batches_equal_the_jax_pipeline(tmp_path, monkeypatch):
    """``$MNIST_NPZ`` read by both pipelines: the eval batches equal; the
    JAX pipeline always shuffles the training images, so a pass of them
    holds the same rows."""
    monkeypatch.setenv("MNIST_NPZ", _mnist_npz(tmp_path))
    ref_train, ref_eval = jpipeline.get_dataset("", (784,), "mnist", 4,
                                                shuffle=False)
    train, evald = pipeline.get_dataset("", (784,), "mnist", 4,
                                        shuffle=False)
    assert (train.examples, evald.examples) == \
        (ref_train.examples, ref_eval.examples) == (6, 3)
    assert (evald.min, evald.max) == (ref_eval.min, ref_eval.max)
    ours, ref = list(evald), list(ref_eval)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32 and a.shape == (4, 784)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_sorted_rows(np.concatenate(list(train))),
                                  _sorted_rows(np.concatenate(
                                      list(ref_train))))
    shuffled, _ = pipeline.get_dataset("", (784,), "mnist", 4, seed=3)
    np.testing.assert_array_equal(
        _sorted_rows(np.concatenate(list(shuffled))),
        _sorted_rows(np.concatenate(list(train))))


def test_mnist_falls_back_to_the_digits(monkeypatch):
    """Without ``$MNIST_NPZ``: scikit-learn's digits, upscaled as the JAX
    package upscales them; JAX's error when scikit-learn is missing."""
    import sys
    monkeypatch.delenv("MNIST_NPZ", raising=False)
    for a, b in zip(pipeline._sklearn_digits_as_mnist(),
                    jpipeline._sklearn_digits_as_mnist()):
        assert a.dtype == b.dtype == np.uint8 and a.shape[1:] == (28, 28)
        np.testing.assert_array_equal(a, b)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(RuntimeError, match="MNIST problem needs"):
        pipeline.get_dataset("", (784,), "mnist", 4)


def test_dataset_statistics_equal_the_jax_package(dataset, tmp_path):
    import tensorflow as tf
    root, _, _ = dataset
    ds, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 4, shuffle=False)
    batches = np.stack(list(ds))
    tf_ds = tf.data.Dataset.from_tensor_slices(batches)
    ref = jpipeline.compute_dataset_statistics(
        tf_ds, "train", str(tmp_path / "jax"), "cfg")
    ours = pipeline.compute_dataset_statistics(
        ds, "train", str(tmp_path / "ours"), "cfg")
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == batches.shape[1:]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert sorted(os.listdir(tmp_path / "ours" / "cache")) == \
        sorted(os.listdir(tmp_path / "jax" / "cache")) == \
        ["train_cfg_mean.pkl", "train_cfg_stddev.pkl"]
    again = pipeline.compute_dataset_statistics(
        [], "train", str(tmp_path / "ours"), "cfg")
    np.testing.assert_array_equal(again[0], ours[0])


@pytest.mark.parametrize("where", ["payload", "length"])
def test_corrupt_record_raises_in_both(dataset, tmp_path, where):
    root, train, _ = dataset
    clean = root / "train-0.tfrecord"
    assert tfrecord_native.read_records(str(clean)) == \
        jtn.read_records(str(clean))
    data = bytearray(clean.read_bytes())
    data[3 if where == "length" else 40] ^= 0x10
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(data))
    for scan in (tfrecord_native.scan_records, jtn.scan_records,
                 tfrecord_native.read_records):
        with pytest.raises(ValueError, match="Corrupt TFRecord framing/CRC"):
            scan(str(bad))
    with pytest.raises(ValueError, match="Corrupt TFRecord"):
        list(tfrecord_native.iter_records(str(bad)))
    # Unchecked, a flipped payload byte still frames.
    if where == "payload":
        assert len(tfrecord_native.scan_records(str(bad), False)) == 15
    bad.rename(root / "train-9.tfrecord")
    with pytest.raises(ValueError, match="Corrupt TFRecord"):
        list(pipeline.get_dataset(str(root), SHAPE, "vae", 4,
                                  normalize=False)[0])


def test_native_source_is_a_torch_dataset(dataset, tmp_path):
    root, train, _ = dataset
    paths = [str(root / "train-0.tfrecord"), str(root / "train-1.tfrecord")]
    ours = tfrecord_native.NativeTFRecordSource(paths)
    ref = jtn.NativeTFRecordSource(paths)
    assert isinstance(ours, torch.utils.data.Dataset)
    assert len(ours) == len(ref) == 24
    for i in (0, 14, 15, 23):
        np.testing.assert_array_equal(ours[i]["inputs"], train[i])
        np.testing.assert_array_equal(ours[i]["inputs"], ref[i]["inputs"])
    assert ours[3]["inputs"].shape == SHAPE
    raw = tfrecord_native.NativeTFRecordSource(paths, parse=False)
    assert raw[0] == jtn.read_records(paths[0])[0]
    raw.close()
    tokens = _tokens(3, 4)
    path = str(tmp_path / "t.tfrecord")
    records.write_tfrecord(path, tokens, tokens=True)
    source = tfrecord_native.NativeTFRecordSource(path)
    np.testing.assert_array_equal(source[2]["inputs"], tokens[2])
    ours.close()


def test_the_scanner_builds_into_the_port(monkeypatch, tmp_path):
    """Built from ``native/`` into ``smd_tpu_torch/_build``; a source g++
    refuses raises, with no unchecked way round."""
    from smd_tpu_torch.utils import native
    lib = tfrecord_native.load_library()
    assert lib is not None
    path = native.library_path(tfrecord_native.SOURCE, "libsmd_tfrecord")
    assert os.path.dirname(path) == native.BUILD_DIR and \
        os.path.exists(path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tfrecord_native, "SOURCE", str(bad))
    monkeypatch.setattr(tfrecord_native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tfrecord_native.scan_records(str(tmp_path / "x.tfrecord"))


def test_shards_step_together(tmp_path):
    """Shards of an odd count yield equal batch counts (the smallest
    shard's); every shard normalizes by the whole split's min/max, one
    rank's."""
    root = tmp_path / "odd"
    train = _latents(13, 5)
    records.write_tfrecord(str(root / "train-0.tfrecord"), train)
    records.write_tfrecord(str(root / "eval-0.tfrecord"), _latents(5, 6))
    whole, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 3,
                                    shuffle=False)
    parts = [pipeline.get_dataset(str(root), SHAPE, "vae", 3, shuffle=False,
                                  shard_index=i, shard_count=2)[0]
             for i in (0, 1)]
    # 7 and 6 examples: 2 whole batches of 3 on each shard.
    assert [len(list(p)) for p in parts] == [2, 2]
    assert [p.examples for p in parts] == [2, 2]
    assert all((p.min, p.max) == (whole.min, whole.max) for p in parts)


@pytest.mark.parametrize("problem", ["vae", "mnist"])
def test_shuffled_shards_partition_every_pass(dataset, tmp_path, monkeypatch,
                                              problem):
    """Two shuffled shards that stop reading at different points (rank 0
    peeks at the eval split first; each shard's pass ends on a look-ahead
    at another point of the stream): in each of two passes their union is
    one rank's pass of the global batches, with no example twice."""
    root, _, _ = dataset
    monkeypatch.setenv("MNIST_NPZ", _mnist_npz(tmp_path, n_train=25))

    def get(batch, **shard):
        return pipeline.get_dataset(str(root), SHAPE, problem, batch,
                                    normalize=False, seed=4, **shard)

    shards = [get(4, shard_index=i, shard_count=2) for i in (0, 1)]
    next(iter(shards[0][1]))
    whole, _ = get(8)
    for _ in range(2):
        parts = [np.concatenate(list(train)) for train, _ in shards]
        assert [len(p) for p in parts] == [12, 12]
        union = _sorted_rows(np.concatenate(parts))
        np.testing.assert_array_equal(
            union, _sorted_rows(np.concatenate(list(whole))))
        assert len(np.unique(union, axis=0)) == len(union)


def test_cached_statistics_keep_the_passes_order(dataset):
    """The min/max pass shuffles with a generator of its own: the first
    pass after a cached statistic is the first pass after a computed one,
    so ranks that find the cache at different times read alike."""
    root, _, _ = dataset
    computed, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 4, seed=5)
    assert os.path.exists(root / "cache" / "train__min.pkl")
    cached, _ = pipeline.get_dataset(str(root), SHAPE, "vae", 4, seed=5)
    for a, b in zip(list(computed), list(cached)):
        np.testing.assert_array_equal(a, b)
