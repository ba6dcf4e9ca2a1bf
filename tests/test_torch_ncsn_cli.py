"""The NCSN and dense-network flagfiles through the port's CLIs, and the
port's dataset scripts against the JAX package's, on the CPU.

``python -m smd_tpu_torch.train_ncsn`` then ``python -m
smd_tpu_torch.sample_ncsn`` (``--device=cpu``, tiny widths, a few steps)
on each flagfile the slice ports: as subprocesses for
``configs/mixture/mixture-single-2.cfg`` (ToyNCSN, SSM with continuous
noise, ALD) and ``configs/ncsn-mel-1seq-512.cfg`` (DenseNCSN, DSM, CAS),
in-process for the other four. ``--nosnapshot_sampling`` is passed to
keep these runs short (``test_torch_metrics.py`` runs the snapshots). Then
``python -m smd_tpu_torch.scripts.transform_encoded_data`` (``flatten``,
``sequences``) and ``generate_compressed_transform`` (``slice``,
``dim_weights``) write what ``scripts/`` writes from the same encoded
songs.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from smd_tpu_torch import cli, sample_ncsn, train_ncsn
from smd_tpu_torch.data import records, tfrecord_native
from smd_tpu_torch.data.synthetic import toy_distribution
from smd_tpu_torch.scripts import generate_compressed_transform as gct
from smd_tpu_torch.scripts import transform_encoded_data as ted

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--num_layers=1", "--mlp_dims=32", "--batch_size=8",
        "--max_steps=3", "--snapshot_freq=2", "--num_sigmas=12",
        "--nosnapshot_sampling", "--device=cpu"]
# flagfile -> (problem data width, sampler flags)
FLAGFILES = {
    "mixture/mixture-single-2.cfg": (2, ["--sampling=ald", "--ld_steps=2"]),
    "ncsn-mel-1seq-512.cfg": (512, ["--sampling=cas"]),
    "mixture/mixture-single-ddpm-2.cfg": (2, []),
    "ddpm-mel-1seq-512.cfg": (512, []),
    "ddpm-multi-1seq-512.cfg": (512, []),
    "ncsn-multi-1seq-512.cfg": (512, ["--ld_steps=2"]),
}
SUBPROCESS = ("mixture/mixture-single-2.cfg", "ncsn-mel-1seq-512.cfg")


@pytest.fixture(autouse=True)
def repo_root(monkeypatch):
    """The flagfiles name each other relative to the repository root."""
    monkeypatch.chdir(ROOT)


def _write_dataset(root, width):
    """The toy mixture for width 2, else seeded 512-d latents."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 24), ("eval", 16)):
        data = toy_distribution(n, rng) if width == 2 else \
            rng.normal(size=(n, width)).astype(np.float32)
        records.write_tfrecord(f"{root}/{split}-0.tfrecord", data)


def _run(module, argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]


@pytest.mark.parametrize("flagfile", sorted(FLAGFILES))
def test_flagfile_trains_and_serves(flagfile, tmp_path):
    width, sampling = FLAGFILES[flagfile]
    data, model_dir, out = (tmp_path / "data", tmp_path / "model",
                            tmp_path / "samples")
    _write_dataset(data, width)
    argv = [f"--flagfile=configs/{flagfile}", f"--dataset={data}",
            f"--model_dir={model_dir}", *TINY]
    sample_argv = [*argv, *sampling, f"--sampling_dir={out}",
                   "--sample_size=8"]
    if flagfile in SUBPROCESS:
        _run("smd_tpu_torch.train_ncsn", argv)
        _run("smd_tpu_torch.sample_ncsn", sample_argv)
    else:
        state = train_ncsn.main(["train_ncsn", *argv])
        assert state.step == 3
        sample_ncsn.main(["sample_ncsn", *sample_argv])
    assert sorted(os.listdir(model_dir / "ckpt")) == ["2.pt", "3.pt"]
    with open(out / "ncsn" / "generated.pkl", "rb") as f:
        generated = pickle.load(f)
    assert generated.shape == (8, width) and np.isfinite(generated).all()
    # The architecture, objective and sampler the flagfile names.
    cli.FLAGS(["prog", *sample_argv])
    arch = {"mixture/mixture-single-2.cfg": ("ToyNCSN", "ssm", "ald"),
            "ncsn-mel-1seq-512.cfg": ("DenseNCSN", "dsm", "cas"),
            "ncsn-multi-1seq-512.cfg": ("DenseNCSN", "dsm", "ald")}.get(
        flagfile, ("ToyDDPM" if width == 2 else "DenseDDPM", "ddpm",
                   "ddpm"))
    assert (cli.FLAGS.architecture, cli.FLAGS.loss, cli.FLAGS.sampling) == \
        arch


def test_serving_reads_the_width_by_architecture():
    for arch, params, width in (
            ("DenseNCSN", {"Dense_0.kernel": torch.zeros(512, 64)}, 512),
            ("ConvNCSN", {"Conv_0.kernel": torch.zeros(2, 42, 128)}, 42),
            ("TransformerDDPM", {
                "TransformerEncoder_0.Dense_0.kernel": torch.zeros(42, 128),
                "Dense_0.kernel": torch.zeros(128, 2048)}, 42)):
        cli.FLAGS(["prog", f"--architecture={arch}"])
        assert cli.latent_width(params) == width


# -- the dataset scripts ------------------------------------------------------

def _write_encoded(root):
    """Encoded songs as the codec writes them: each record a pickled
    [3, n, 512] array (z, mu, sigma), some latents zero."""
    rng = np.random.default_rng(1)
    root.mkdir(parents=True)
    for split, songs in (("training_seqs", 5), ("eval_seqs", 2)):
        payloads = []
        for _ in range(songs):
            n = int(rng.integers(6, 12))
            m = rng.normal(size=(3, n, 512)).astype(np.float32)
            m[2] = np.abs(m[2]) + 0.1
            m[:, rng.integers(0, n)] = 0.0
            payloads.append(pickle.dumps(m))
        (root / f"{split}.tfrecord-00000").write_bytes(
            records.frame_records(payloads))
    # Decoded songs: each record a pickled (n, 90) one-hot token grid; the
    # songs of fewer than 896 steps are dropped.
    for split, lengths in (("train", (900, 1024, 700, 960)),
                           ("eval", (1000,))):
        payloads = [pickle.dumps(np.eye(90)[rng.integers(0, 90, n)])
                    for n in lengths]
        (root / f"decoded-{split}.tfrecord-00000").write_bytes(
            records.frame_records(payloads))


def _read(path):
    return [tfrecord_native.parse_example(r)
            for r in tfrecord_native.iter_records(str(path))]


# The JAX scripts in one process each: their absl flags are global, so each
# run names every flag it sets.
_JAX_RUNNER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from absl import flags
    import scripts.{script} as script
    for args in {runs!r}:
        flags.FLAGS(["prog", *args])
        script.main([])
""")


def _run_jax_script(script, runs):
    env = {**os.environ, "SMD_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
           "TF_CPP_MIN_LOG_LEVEL": "3"}
    code = _JAX_RUNNER.format(root=str(ROOT), script=script, runs=runs)
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]


def test_dataset_scripts_match_the_jax_scripts(tmp_path):
    encoded = tmp_path / "encoded"
    _write_encoded(encoded)
    modes = {"flatten": ["--mode=flatten", "--shard_size=16"],
             "sequences": ["--mode=sequences", "--context_length=2",
                           "--stride=1", "--shard_size=1000"],
             "decoded": ["--mode=decoded", "--shard_size=2"]}
    fits = {"slice": ["--transform=slice", "--keep_dims=8"],
            "dim_weights": ["--transform=dim_weights"]}
    _run_jax_script("transform_encoded_data", [
        [f"--encoded_data={encoded}", f"--output_path={tmp_path}/jax-{m}",
         *args] for m, args in modes.items()])
    _run_jax_script("generate_compressed_transform", [
        [f"--encoded_data={encoded}", f"--output_path={tmp_path}/jax-fit",
         f"--name={name}", *args] for name, args in fits.items()])
    for m, args in modes.items():
        ted.main(["prog", f"--encoded_data={encoded}",
                  f"--output_path={tmp_path}/ours-{m}", *args])
        names = sorted(os.listdir(tmp_path / f"jax-{m}"))
        assert names == sorted(os.listdir(tmp_path / f"ours-{m}"))
        # flatten: 33 training latents in shards of 16; decoded: 3 songs
        # kept in shards of 2.
        assert names[0] == "eval-0000.tfrecord"
        assert len(names) == {"flatten": 4, "sequences": 2, "decoded": 3}[m]
        for name in names:
            ref, ours = (_read(tmp_path / f"{who}-{m}" / name)
                         for who in ("jax", "ours"))
            assert len(ours) == len(ref) > 0
            for a, b in zip(ours, ref):
                assert sorted(a) == sorted(b)
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])
    # flatten drops the zero latents: 512-d records, the 1-seq flagfiles'.
    flat = _read(tmp_path / "ours-flatten" / "train-0000.tfrecord")
    assert list(flat[0]["input_shape"]) == [512]
    # decoded: the serialized bool tensors (compared as bytes above) of
    # 1024 padded steps.
    tokens = _read(tmp_path / "ours-decoded" / "train-0000.tfrecord")
    assert list(tokens[0]["input_shape"]) == [1024, 90]
    grid = records.parse_tensor(tokens[0]["inputs"])
    assert grid.dtype == bool and grid.shape == (1024, 90)
    assert grid[900:, 0].all() and grid.sum() == 1024
    for name, args in fits.items():
        gct.main(["prog", f"--encoded_data={encoded}",
                  f"--output_path={tmp_path}/ours-fit", f"--name={name}",
                  *args])
        with open(tmp_path / "jax-fit" / f"{name}.pkl", "rb") as f:
            ref = pickle.load(f)
        with open(tmp_path / "ours-fit" / f"{name}.pkl", "rb") as f:
            ours = pickle.load(f)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
