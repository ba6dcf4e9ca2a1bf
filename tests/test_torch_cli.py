"""The port's flags and ``train_ncsn`` entry point, on the CPU.

The port parses the shipped flagfiles with its own parser (the card has no
absl); here it is held against absl on the JAX package's flag definitions
for every ``configs/ddpm-*.cfg`` and ``configs/ncsn-*.cfg`` with
command-line overrides. ``python -m smd_tpu_torch.train_ncsn --device=cpu``
trains a tiny flagship from ``configs/ddpm-mel-32seq-512.cfg``,
checkpoints, resumes, and its checkpoint is served; with ``--remat`` its
chunked run equals its run by single steps.
"""
import functools
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from absl import flags as absl_flags

import smd_tpu.cli as jcli
from smd_tpu_torch import cli, train_ncsn
from smd_tpu_torch.data import records
from smd_tpu_torch.sampling import generate

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.cfg")
                 if p.name.startswith(("ddpm-", "ncsn-", "mdn-")))
OVERRIDES = ["--max_steps=7", "--noema", "--data_shape=4,8",
             "--learning_rate", "2e-4", "--nonormalize", "--remat",
             "--mixed_precision=true", "--sampling=ddim", "--lr_warmup=3"]
TINY = ["--num_layers=1", "--num_heads=2", "--mlp_dims=32", "--batch_size=4",
        "--num_sigmas=20", "--device=cpu"]


@pytest.fixture(autouse=True)
def repo_root(monkeypatch):
    """The flagfiles name each other relative to the repository root."""
    monkeypatch.chdir(ROOT)


@pytest.fixture
def absl_flag_values(monkeypatch):
    """The JAX package's flags, defined into a FlagValues of their own."""
    values = absl_flags.FlagValues()
    shim = types.SimpleNamespace(**{
        name: functools.partial(getattr(absl_flags, name),
                                flag_values=values)
        for name in ("DEFINE_integer", "DEFINE_float", "DEFINE_string",
                     "DEFINE_boolean", "DEFINE_enum", "DEFINE_list")})
    monkeypatch.setattr(jcli, "flags", shim)
    jcli.define_common_flags()
    jcli.define_diffusion_flags()
    jcli.define_sampling_flags()
    return values


@pytest.fixture
def port_flags(monkeypatch):
    """A fresh registry with every flag of the port's train_ncsn and its
    sampling flags."""
    monkeypatch.setattr(cli, "FLAGS", cli.Flags())
    cli.define_common_flags()
    cli.define_diffusion_flags()
    cli.define_sampling_flags()
    return cli.FLAGS


@pytest.mark.parametrize("overrides", [[], OVERRIDES])
@pytest.mark.parametrize("config", CONFIGS)
def test_flags_match_absl(absl_flag_values, port_flags, config, overrides):
    argv = ["prog", f"--flagfile=configs/{config}", *overrides]
    absl_flag_values(argv)
    port_flags(argv)
    names = list(absl_flag_values)
    assert set(port_flags.names()) - set(names) == {"device"}
    assert set(names) <= set(port_flags.names())
    for name in names:
        ours, ref = getattr(port_flags, name), absl_flag_values[name].value
        assert ours == ref and type(ours) is type(ref), (name, ours, ref)


def test_flag_parser_rules(port_flags):
    port_flags(["prog", "--flagfile=configs/ddpm-mel-32seq-512.cfg",
                "--ema=true", "--snapshot_freq", "7"])
    assert port_flags.ema is True and port_flags.snapshot_freq == 7
    assert port_flags.data_shape == ["32", "512"]
    # Each parse starts from the defaults.
    port_flags(["prog"])
    assert port_flags.loss == "dsm" and port_flags.data_shape == [2]
    for bad in (["--no_such_flag=1"], ["--loss=mse"], ["--batch_size=x"],
                ["--noloss"], ["--ema=maybe"]):
        with pytest.raises(cli.FlagsError):
            port_flags(["prog", *bad])


def test_slice_indices_match_chip_smoke():
    """chip_smoke.py carries the flagship's slice, since a copy of the repo
    for the card leaves checkpoints/ out."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    with open(ROOT / "checkpoints" / "slice-mel-512.pkl", "rb") as f:
        shipped = np.asarray(pickle.load(f))
    assert shipped.dtype == np.int64
    assert tuple(shipped.tolist()) == chip_smoke.SLICE_MEL_512


def _write_dataset(root):
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("eval", 8)):
        records.write_tfrecord(f"{root}/{split}-0.tfrecord",
                               rng.normal(size=(n, 32, 512)).astype(
                                   np.float32))


def test_train_ncsn_trains_checkpoints_resumes_and_serves(tmp_path):
    data, model_dir = tmp_path / "data", tmp_path / "model"
    _write_dataset(data)
    argv = ["--flagfile=configs/ddpm-mel-32seq-512.cfg", f"--dataset={data}",
            "--slice_ckpt=checkpoints/slice-mel-512.pkl",
            f"--model_dir={model_dir}", "--snapshot_freq=2", *TINY]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run(
        [sys.executable, "-m", "smd_tpu_torch.train_ncsn", *argv,
         "--max_steps=3"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert sorted(os.listdir(model_dir / "ckpt")) == ["2.pt", "3.pt"]

    steps = []
    state = train_ncsn.main(["train_ncsn", *argv, "--max_steps=5"],
                            step_callback=lambda s, m: steps.append(s))
    assert steps == [4, 5] and state.step == 5

    model, state = cli.restore_state_for_sampling((32, 42))
    assert state.step == 5
    model_fn = cli.serving_model_fn(state.sampling_params)
    samples, _, _ = generate.sample(
        model_fn, cli.schedule_from_flags(), torch.Generator().manual_seed(0),
        (32, 42), num_samples=2, sampling=cli.FLAGS.sampling,
        collect_steps=0, collect_metrics=False, device="cpu")
    assert samples.shape == (2, 32, 42) and torch.isfinite(samples).all()


def test_train_ncsn_remat_chunk_equals_its_steps(tmp_path):
    """``train_ncsn --remat --scan_chunk=2`` (a chunk of 2, then one step
    cut at max_steps; each layer recomputed in the backward) ends bit-equal
    to the same ``--remat`` run by single steps: params, Adam moments,
    EMA and generator."""
    data = tmp_path / "data"
    _write_dataset(data)
    runs = []
    for scan_chunk in (2, 1):
        state = train_ncsn.main([
            "train_ncsn", "--flagfile=configs/ddpm-mel-32seq-512.cfg",
            f"--dataset={data}", "--slice_ckpt=checkpoints/slice-mel-512.pkl",
            f"--model_dir={tmp_path}/m{scan_chunk}", "--remat",
            f"--scan_chunk={scan_chunk}", "--snapshot_freq=5",
            "--max_steps=3", *TINY])
        assert state.step == 3
        assert state.model.TransformerEncoder_0.remat
        runs.append(state)
    for a, b in zip(runs[0].tensors(), runs[1].tensors()):
        assert torch.equal(a, b)
    assert torch.equal(runs[0].generator.get_state(),
                       runs[1].generator.get_state())


def test_train_ncsn_needs_a_gpu_or_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["train_ncsn", "--flagfile=configs/ddpm-mel-32seq-512.cfg",
            f"--dataset={tmp_path}", f"--model_dir={tmp_path}/m"]
    for extra in ([], ["--distill"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_ncsn.main([*base, *extra])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ncsn.main([*base, "--snapshot_sampling"])
    # --distill and --snapshot_sampling run (tests/test_torch_distill.py,
    # tests/test_torch_metrics.py); a model axis needs as many ranks
    # (tests/test_torch_parallel.py), and one rank raises JAX's mesh error.
    with pytest.raises(ValueError, match="mesh 0x2 does not cover 1"):
        train_ncsn.main([*base, "--model_parallelism=2", "--device=cpu"])


def test_model_from_flags_mixed_precision():
    cli.FLAGS(["prog", "--flagfile=configs/ddpm-mel-32seq-512.cfg",
               "--mixed_precision", *TINY])
    model = cli.model_from_flags(42)
    assert model.TransformerEncoder_0.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    x, t = torch.zeros(2, 32, 42), torch.full((2, 1, 1), 0.5)
    assert model(x, t).dtype == torch.float32
