"""Convert a reference flax-0.3 checkpoint into a params pickle (port of
``scripts/convert_reference_checkpoint.py``).

    python -m smd_tpu_torch.scripts.convert_reference_checkpoint \\
        --checkpoint=save/mel512-ddpm-32seq/checkpoint_12 \\
        --architecture=TransformerDDPM --num_layers=6 --num_heads=8 \\
        --num_mlp_layers=2 --mlp_dims=2048 --data_shape=32,42 \\
        --output=converted_params.pkl

Reads the msgpack the reference's ``flax.training.checkpoints.
save_checkpoint`` wrote of the ``(optimizer, ema, early_stop)`` tuple
without flax (``utils/msgpack.py``), takes its EMA params (or the live
ones, ``--nouse_ema``) and maps them onto the matching architecture of the
port (``utils/convert.py``; one forward on ``--device``, ``cuda`` unless
``--device=cpu``, records the modules' call order). The pickle holds
``{"params": ...}`` of numpy arrays in the Flax layout: the JAX package and
``utils/flax_params.load_flax_params`` both load it.
"""
from __future__ import annotations

import logging
import sys

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_string("checkpoint", None, "Reference checkpoint file.")
FLAGS.DEFINE_string("output", "converted_params.pkl", "Output pickle.")
FLAGS.DEFINE_string("architecture", "TransformerDDPM", "Architecture name.")
FLAGS.DEFINE_integer("num_layers", 6, "Encoder layers.")
FLAGS.DEFINE_integer("num_heads", 8, "Attention heads.")
FLAGS.DEFINE_integer("num_mlp_layers", 2, "MLP layers.")
FLAGS.DEFINE_integer("mlp_dims", 2048, "MLP width.")
FLAGS.DEFINE_integer("mdn_components", 100, "MDN mixtures.")
FLAGS.DEFINE_list("data_shape", ["32", "42"], "Per-example data shape.")
FLAGS.DEFINE_boolean("use_ema", True, "Prefer EMA params when present.")
FLAGS.DEFINE_string("device", "cuda",
                    "Device of the forward that records the call order: "
                    "cuda (the default; raises without a GPU) or cpu.")

log = logging.getLogger("smd_tpu_torch")


def _find_param_tree(obj, use_ema: bool = True):
    """Locate the old ``nn.Model`` params dict inside the restored tuple."""
    # save_checkpoint((optimizer, ema, early_stop)) restores as a dict
    # {'0': optimizer_state, '1': ema_state, '2': early_stop}.
    candidates = []

    def rec(node, path):
        if isinstance(node, dict):
            if "params" in node and isinstance(node["params"], dict):
                candidates.append((path, node["params"]))
            for k, v in node.items():
                rec(v, path + (k,))

    rec(obj, ())
    if not candidates:
        raise ValueError("No params tree found in checkpoint")
    if use_ema:
        for path, tree in candidates:
            if any("1" == p or "ema" in str(p).lower() for p in path):
                return tree
    # optimizer.target.params is usually the first candidate
    return candidates[0][1]


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program), convert and write the
    pickle; returns the converted tree."""
    import torch

    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils import convert
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    if FLAGS.checkpoint is None:
        raise FlagsError("flag --checkpoint must have a value other than "
                         "None")
    restored = convert.load_reference_checkpoint(FLAGS.checkpoint)
    old_params = _find_param_tree(restored, FLAGS.use_ema)

    shape = tuple(int(s) for s in FLAGS.data_shape)
    model = get_model(FLAGS.architecture, device=FLAGS.device,
                      data_channels=shape[-1], num_layers=FLAGS.num_layers,
                      num_heads=FLAGS.num_heads,
                      num_mlp_layers=FLAGS.num_mlp_layers,
                      mlp_dims=FLAGS.mlp_dims,
                      mdn_mixtures=FLAGS.mdn_components)
    device = next(model.parameters()).device
    x = torch.zeros((1, *shape), device=device)
    if FLAGS.architecture == "TransformerMDN":
        template, order = convert.module_call_order(model, x)
    else:
        cond = torch.zeros((1, *([1] * len(shape))), device=device)
        template, order = convert.module_call_order(model, x, cond)

    new_params = convert.convert_params(old_params, template, order)
    io_lib.save(new_params, FLAGS.output)
    log.info("Wrote converted params to %s", FLAGS.output)
    return new_params


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
