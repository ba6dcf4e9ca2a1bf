"""``python -m smd_tpu_torch.train_ncsn --distill`` and ``python -m
smd_tpu_torch.sample_ncsn`` with ``--device=cpu``, on a tiny flagship.

A step-1 checkpoint of a 1-layer flagship on seeded latents of 32x512 (the
flagship's slice to 42 dims); each entry point runs once as a subprocess,
the rest in process: the three distillation modes and their bundles, then
every sampler of ``sample_ncsn`` on the checkpoint and the bundles,
``--infill`` (the 8 edge latents held), ``--interpolate``, the flushed
pickles and the error messages of the JAX CLI.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


TINY_FLAGS = ["--num_layers=1", "--num_heads=2", "--mlp_dims=32",
              "--batch_size=4", "--num_sigmas=20", "--device=cpu"]


def _checkpointed_run(tmp_path):
    """A dataset of 32x512 latents (sliced to 42) and a step-1 checkpoint of
    a tiny flagship, written without training."""
    from smd_tpu_torch import cli, train_ncsn  # noqa: F401
    from smd_tpu_torch.data import records
    from smd_tpu_torch.training import diffusion as trainer
    from smd_tpu_torch.utils.checkpoints import CheckpointManager
    data, model_dir = tmp_path / "data", tmp_path / "model"
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("eval", 8)):
        records.write_tfrecord(f"{data}/{split}-0.tfrecord",
                               rng.normal(size=(n, 32, 512)).astype(
                                   np.float32))
    argv = ["--flagfile=configs/ddpm-mel-32seq-512.cfg", f"--dataset={data}",
            "--slice_ckpt=checkpoints/slice-mel-512.pkl",
            f"--model_dir={model_dir}", *TINY_FLAGS]
    cli.FLAGS(["prog", *argv])
    state = trainer.create_train_state(cli.model_from_flags(42),
                                       cli.train_config_from_flags(), seed=0)
    state.step = 1
    manager = CheckpointManager(f"{model_dir}/ckpt")
    manager.save(1, state)
    manager.close()
    return argv, model_dir


def _run(module, argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_distill_and_sample_clis_on_cpu(tmp_path, monkeypatch):
    from smd_tpu_torch import sample_ncsn, train_ncsn
    monkeypatch.chdir(ROOT)
    argv, model_dir = _checkpointed_run(tmp_path)
    _run("smd_tpu_torch.train_ncsn",
         [*argv, "--distill", "--distill_start_steps=4",
          "--distill_end_steps=2", "--distill_stage_steps=2"])
    for n in (2, 4):
        bundle = _load(model_dir / "distilled" / f"{n}.pkl")
        assert sorted(bundle) == ["grid", "num_steps", "params"]
        assert bundle["num_steps"] == n and bundle["grid"].shape == (n + 1,)
        assert all(t.device.type == "cpu" for t in bundle["params"].values())
    for mode, extra in (("consistency", ["--consistency_segments=4"]),
                        ("ct", ["--ct_seg_schedule=2,4"])):
        train_ncsn.main(["train_ncsn", *argv, "--distill",
                         f"--distill_mode={mode}", "--distill_stage_steps=3",
                         *extra])
        bundle = _load(model_dir / "distilled" / "consistency.pkl")
        assert sorted(bundle) == ["grid", "num_segments", "objective",
                                  "params"]
        assert bundle["objective"] == mode and bundle["num_segments"] == 4
        assert bundle["grid"].shape == (5,)
    with pytest.raises(ValueError, match="DDPM checkpoint"):
        train_ncsn.main(["train_ncsn", *argv, "--distill", "--loss=dsm"])

    out = tmp_path / "samples"
    base = [*argv, f"--sampling_dir={out}", "--sample_size=4"]
    _run("smd_tpu_torch.sample_ncsn",
         [*base, "--sampling=distilled", "--ddim_steps=2"])
    generated = _load(out / "ncsn" / "generated.pkl")
    assert generated.shape == (4, 32, 512) and np.isfinite(generated).all()
    assert _load(out / "ncsn" / "real.pkl").shape == (4, 32, 512)

    real = None
    for extra, collects in ((["--sampling=ddim", "--ddim_steps=5"], True),
                            (["--sampling=dpmpp", "--ddim_steps=4",
                              "--infill"], False),
                            (["--sampling=consistency",
                              "--consistency_sampling_steps=1"], False),
                            (["--interpolate"], False)):
        os.makedirs(out, exist_ok=True)
        for f in out.glob("ncsn/*.pkl"):
            f.unlink()
        gen, coll = sample_ncsn.main(["sample_ncsn", *base, *extra])
        assert np.isfinite(gen).all()
        assert (out / "ncsn" / "collection.pkl").exists() == collects
        if "--interpolate" in extra:
            assert gen.shape == (9, 4, 32, 42)
        else:
            assert gen.shape == (4, 32, 42)
        if "--infill" in extra:
            # The first and last 8 latents are the real ones, exactly.
            from smd_tpu_torch import cli
            _, eval_ds = cli.dataset_from_flags(include_cardinality=False)
            real = eval_ds.take_examples(4)
            np.testing.assert_array_equal(gen[:, :8], real[:, :8])
            np.testing.assert_array_equal(gen[:, -8:], real[:, -8:])
            assert not np.array_equal(gen[:, 8:-8], real[:, 8:-8])
    assert real is not None

    with pytest.raises(FileNotFoundError, match=r"available stages: \[2, 4\]"):
        sample_ncsn.main(["sample_ncsn", *base, "--sampling=distilled",
                          "--ddim_steps=8"])
    with pytest.raises(ValueError, match="consistency_sampling_steps=5"):
        sample_ncsn.main(["sample_ncsn", *base, "--sampling=consistency",
                          "--consistency_sampling_steps=5"])
    # --compute_metrics writes the sweep's stats; --animate draws only 2-D
    # data, so on 32x42 latents it writes no animation.
    sample_ncsn.main(["sample_ncsn", *base, "--sampling=consistency",
                      "--consistency_sampling_steps=1", "--compute_metrics",
                      "--compute_final_only", "--animate"])
    stats = json.loads((out / "metrics.json").read_text())
    assert len(stats) == 10 and all(np.isfinite(v) for v in stats.values())
    assert not (out / "animated.gif").exists()


def test_sample_ncsn_needs_a_gpu_or_device_cpu(tmp_path, monkeypatch):
    from smd_tpu_torch import sample_ncsn
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_ncsn.main(["sample_ncsn",
                          "--flagfile=configs/ddpm-mel-32seq-512.cfg",
                          f"--dataset={tmp_path}"])
