"""Train the autoregressive Transformer-MDN baseline from flags (port of
``train_mdn.py``).

    python -m smd_tpu_torch.train_mdn \\
        --flagfile=configs/mdn-mel-32seq-512.cfg --dataset=... --model_dir=...

Reads the same layered ``configs/mdn-*.cfg`` flagfiles as the JAX package's
``train_mdn.py``, always on the ``vae`` problem, as the reference does, and
``--device`` (``cuda`` unless ``--device=cpu``; no GPU is an error).
Checkpoints go to ``MODEL_DIR/ckpt/{step}.pt``; a rerun resumes, and
``python -m smd_tpu_torch.sample_mdn`` serves the latest. Under
``torchrun`` it trains across processes as ``train_ncsn`` does
(``--batch_size`` global, ``--model_parallelism`` the model axis,
``--scan_chunk`` under any grid).
"""
from __future__ import annotations

import logging
import sys

from smd_tpu_torch import cli
from smd_tpu_torch.device import resolve_device

FLAGS = cli.FLAGS
cli.define_common_flags()

log = logging.getLogger("smd_tpu_torch")


def main(argv, step_callback=None):
    """Parse ``argv`` (``argv[0]`` is the program) and train; returns the
    final TrainState. ``step_callback(global_step, metrics)`` runs after
    each training step (see ``training.loop.run_loop``)."""
    from smd_tpu_torch.training import mdn as trainer

    FLAGS(argv)
    log.info("flags: %s", {n: getattr(FLAGS, n) for n in FLAGS.names()})
    resolve_device(FLAGS.device)
    cli.initialize_from_flags()
    mesh = cli.mesh_from_flags()
    train_ds, eval_ds = cli.dataset_from_flags(problem="vae")
    input_shape = next(iter(eval_ds)).shape[1:]
    model = cli.model_from_flags(input_shape[-1], mdn=True)
    config = cli.train_config_from_flags(mdn=True)
    return trainer.fit(model,
                       train_data=lambda: iter(train_ds),
                       eval_data=lambda: iter(eval_ds),
                       input_shape=input_shape,
                       config=config,
                       model_dir=FLAGS.model_dir,
                       mesh=mesh,
                       seed=FLAGS.seed,
                       step_callback=step_callback)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except cli.FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
