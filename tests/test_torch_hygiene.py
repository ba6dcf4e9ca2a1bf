"""The port stands alone and keeps to the device rule.

``smd_tpu_torch/``, ``chip_smoke.py`` and the card scripts beside it import
nothing of JAX, its ecosystem, scikit-learn or the JAX package (the card's
machine has none of them); entry points called
without ``device="cpu"`` raise when there is no GPU.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from smd_tpu_torch.device import resolve_device
from smd_tpu_torch.diffusion import schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.sampling import generate

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow", "absl",
             "sklearn", "msgpack", "grain", "smd_tpu")
# Imported inside the one function that needs it, when it is called: the
# mnist problem's offline digits (JAX's RuntimeError where it is missing).
LAZY = {("smd_tpu_torch/data/pipeline.py", "sklearn.datasets")}


def _port_files():
    files = sorted((ROOT / "smd_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "profile_torch_sampler.py",
              ROOT / "profile_torch_train.py",
              ROOT / "study_torch_tolerances.py"]
    return files


def _imported_modules(path):
    """(module, inside a function) of every import in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nested = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.update(id(n) for n in ast.walk(fn) if n is not fn)
    for node in ast.walk(tree):
        inside = id(node) in nested
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, inside
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, inside
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value, inside


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    new = ("parallel/mesh.py", "parallel/column.py", "dryrun.py",
           "utils/msgpack.py", "utils/convert.py", "utils/profiling.py",
           "utils/native.py", "scripts/convert_reference_checkpoint.py",
           "training/graphs.py")
    assert all(ROOT / "smd_tpu_torch" / f in files for f in new)
    bad, lazy = [], set()
    for path in files:
        rel = str(path.relative_to(ROOT))
        for mod, inside in _imported_modules(path):
            if mod.split(".")[0] not in FORBIDDEN:
                continue
            if (rel, mod) in LAZY and inside:
                lazy.add((rel, mod))
            else:
                bad.append(f"{rel}: {mod}")
    assert not bad, bad
    assert lazy == LAZY


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_rule(no_gpu):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")


def test_entry_points_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("TransformerDDPM", data_channels=8, num_layers=1,
                  mlp_dims=32, embed_channels=16, num_heads=2)
    betas = schedules.noise_schedule(1e-4, 0.02, 4, "linear")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate.sample(lambda x, c: x, betas, None, (4, 2), num_samples=2,
                        sampling="ddpm")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate.make_init(None, 2, (4, 2), "ddpm")


def test_mdn_entry_points_raise_without_gpu(no_gpu):
    from smd_tpu_torch.sampling import mdn_decode
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("TransformerMDN", data_channels=4, num_layers=1,
                  mlp_dims=16, embed_channels=16, num_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mdn_decode.ar_decode(None, lambda t: None, 2, steps=4, channels=4)
    model = get_model("TransformerMDN", device="cpu", data_channels=4,
                      num_layers=1, mlp_dims=16, embed_channels=16,
                      num_heads=2, mdn_mixtures=2)
    out = mdn_decode.ar_decode_cached(torch.Generator().manual_seed(0),
                                      model, 2, steps=4, channels=4)
    assert out.shape == (2, 4, 4) and out.device.type == "cpu"


def test_entry_points_run_on_cpu_when_asked(no_gpu):
    model = get_model("TransformerDDPM", device="cpu", data_channels=8,
                      num_layers=1, mlp_dims=32, embed_channels=16,
                      num_heads=2)
    assert next(model.parameters()).device.type == "cpu"
    betas = schedules.noise_schedule(1e-4, 0.02, 4, "linear")
    state, _, _ = generate.sample(lambda x, c: torch.zeros_like(x), betas,
                                  torch.Generator().manual_seed(0), (4, 2),
                                  num_samples=2, sampling="ddpm",
                                  device="cpu")
    assert state.shape == (2, 4, 2)


def test_kernel_wrappers_take_no_other_device():
    from smd_tpu_torch.ops import _build
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda_args(torch.device("meta"),
                               x=(None, (1,), _build.FLOATS))


def test_w8a8_wrapper_takes_no_other_device():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA raises instead of computing quietly somewhere else."""
    from smd_tpu_torch.ops.quant_matmul import w8a8_dense
    x = torch.empty(32, 64, device="meta")
    w_q = torch.empty(64, 64, dtype=torch.int8, device="meta")
    w_s = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        w8a8_dense(x, w_q, w_s, None, 0.1)


def test_codec_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from smd_tpu_torch.codec import musicvae
    from smd_tpu_torch.scripts import (decode_dataset, generate_melodies,
                                       generate_song_data,
                                       package_generation_bundle)
    tiny = musicvae.MusicVAEConfig(latent_dims=4, enc_units=4,
                                   dec_units=(4,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        musicvae.TrainedMusicVAE(config=tiny)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        musicvae.build_musicvae(tiny)
    for main, argv in (
            (generate_song_data.main, [f"--input={tmp_path}/*.mid"]),
            (decode_dataset.main, [f"--encoded_data={tmp_path}"]),
            (generate_melodies.main, [f"--bundle={tmp_path}/b.pkl"]),
            (package_generation_bundle.main,
             ["--flagfile=configs/ddpm-mel-32seq-512.cfg",
              f"--dataset={tmp_path}", f"--model_dir={tmp_path}"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["prog", *argv])
    vae = musicvae.TrainedMusicVAE(config=tiny, device="cpu")
    z, mu, sigma = vae.encode_tensors([np.eye(90, dtype=np.float32)[
        np.arange(32) % 90]])
    assert z.shape == (1, 4) and vae.decode_to_tensors(mu).shape == (1, 32)


def test_codec_training_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from smd_tpu_torch.scripts import eval_codec, sample_audio, train_musicvae
    for main, argv in (
            (train_musicvae.main, [f"--input={tmp_path}/*.mid"]),
            (eval_codec.main, [f"--input={tmp_path}/*.mid"]),
            (sample_audio.main, [f"--input={tmp_path}",
                                 "--noinclude_plots"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["prog", *argv])


def test_distributed_entry_points_raise_without_gpu(no_gpu, monkeypatch):
    from smd_tpu_torch import dryrun
    from smd_tpu_torch.parallel import mesh as mesh_lib
    from smd_tpu_torch.utils import profiling
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.Trace("unused")
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                        ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_lib.initialize_distributed()
