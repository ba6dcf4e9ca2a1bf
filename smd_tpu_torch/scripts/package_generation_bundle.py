"""Package a trained diffusion model_dir into one generation bundle (port of
``scripts/package_generation_bundle.py``).

    python -m smd_tpu_torch.scripts.package_generation_bundle \\
        --flagfile=configs/ddpm-mel-32seq-512.cfg --dataset=DIR \\
        --slice_ckpt=checkpoints/slice-mel-512.pkl --model_dir=DIR \\
        --output=checkpoints/melody-diffusion.pkl

Run with the flagfile the model was trained with. From the latest
checkpoint of ``python -m smd_tpu_torch.train_ncsn`` (EMA params with
``--ema``) and, when present, ``MODEL_DIR/distilled/consistency.pkl``, it
writes the JAX package's bundle format: ``"kind":
"smd-tpu-generation-bundle"``, the architecture, the params as a
Flax-layout fp16 numpy tree (``utils.flax_params.to_flax_tree``), the noise
schedule, the slice transform and the dataset's normalization range. Either
package's ``generate_melodies`` serves a bundle that either package wrote.
"""
from __future__ import annotations

import logging
import os
import sys

import numpy as np

from smd_tpu_torch import cli

FLAGS = cli.FLAGS
cli.define_common_flags()
cli.define_diffusion_flags()
FLAGS.DEFINE_string("output", "./checkpoints/melody-diffusion.pkl",
                    "Bundle output path.")
FLAGS.DEFINE_string("provenance", "",
                    "Free-form training provenance recorded in the bundle.")

log = logging.getLogger("smd_tpu_torch")


def fp16_tree(params):
    """The Flax-layout numpy tree of ``params`` ({name: tensor}), float32
    leaves as float16, as the JAX packer stores them."""
    from smd_tpu_torch.utils.flax_params import to_flax_tree

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else
                (v.astype(np.float16) if v.dtype == np.float32 else v)
                for k, v in tree.items()}
    return cast(to_flax_tree(params))


def generation_bundle(params, arch, schedule, sample_shape, out_channels,
                      slice_idx, normalize, data_min, data_max,
                      provenance="", consistency=None) -> dict:
    """The JAX package's bundle: ``params`` ({name: tensor}) and the
    consistency pack's params as Flax-layout fp16 trees, beside the
    architecture (``architecture``, ``num_layers``, ``num_heads``,
    ``num_mlp_layers``, ``mlp_dims``), the schedule (``sigma_begin``,
    ``sigma_end``, ``num_sigmas``, ``kind``), the slice and the dataset's
    normalization."""
    return {
        "kind": "smd-tpu-generation-bundle",
        "arch": dict(arch),
        "params": fp16_tree(params),
        "schedule": dict(schedule),
        "sample_shape": list(sample_shape),
        "out_channels": int(out_channels),
        "slice_idx": np.asarray(slice_idx) if slice_idx is not None else None,
        "normalize": normalize,
        "data_min": float(data_min),
        "data_max": float(data_max),
        "provenance": provenance,
        "consistency": None if consistency is None else {
            "params": fp16_tree(consistency["params"]),
            "grid": np.asarray(consistency["grid"])},
    }


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and write the bundle;
    returns it."""
    from smd_tpu_torch.device import resolve_device
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    resolve_device(FLAGS.device)
    train_ds, _ = cli.dataset_from_flags(include_cardinality=False)
    shape = tuple(next(iter(train_ds)).shape[1:])
    _, state = cli.restore_state_for_sampling(shape)
    params = state.sampling_params if FLAGS.ema else state.params
    _, slice_idx, _ = cli.load_transforms_from_flags()
    cm_path = os.path.join(FLAGS.model_dir, "distilled", "consistency.pkl")
    consistency = io_lib.load(cm_path) if os.path.exists(cm_path) else None
    if consistency is not None:
        log.info("Including the consistency bundle (%d segments)",
                 len(consistency["grid"]) - 1)
    bundle = generation_bundle(
        params,
        arch={"architecture": FLAGS.architecture,
              "num_layers": FLAGS.num_layers, "num_heads": FLAGS.num_heads,
              "num_mlp_layers": FLAGS.num_mlp_layers,
              "mlp_dims": FLAGS.mlp_dims},
        schedule={"sigma_begin": FLAGS.sigma_begin,
                  "sigma_end": FLAGS.sigma_end,
                  "num_sigmas": FLAGS.num_sigmas,
                  "kind": FLAGS.schedule_type},
        sample_shape=shape, out_channels=FLAGS.data_shape[-1],
        slice_idx=slice_idx, normalize=FLAGS.normalize,
        data_min=train_ds.min, data_max=train_ds.max,
        provenance=FLAGS.provenance, consistency=consistency)
    io_lib.save(bundle, FLAGS.output)
    log.info("Wrote %s (%.1f MB); sample shape %s, slice %s -> %d dims",
             FLAGS.output, os.path.getsize(FLAGS.output) / 1e6, shape,
             bundle["out_channels"], shape[-1])
    return bundle


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except cli.FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
