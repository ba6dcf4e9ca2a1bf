"""Train the diffusion model from flags (port of ``train_ncsn.py``).

    python -m smd_tpu_torch.train_ncsn \\
        --flagfile=configs/ddpm-mel-32seq-512.cfg --dataset=... --model_dir=...

Reads the same layered ``configs/*.cfg`` flagfiles as the JAX package's
``train_ncsn.py``, and ``--device`` (``cuda`` unless ``--device=cpu``; no
GPU is an error). The DDPM objective trains; the score-matching objectives,
``--distill`` and ``--snapshot_sampling`` are not ported yet and raise.
"""
from __future__ import annotations

import logging
import sys

from smd_tpu_torch import cli
from smd_tpu_torch.device import resolve_device

FLAGS = cli.FLAGS
cli.define_common_flags()
cli.define_diffusion_flags()

log = logging.getLogger("smd_tpu_torch")


def main(argv, step_callback=None):
    """Parse ``argv`` (``argv[0]`` is the program) and train; returns the
    final TrainState. ``step_callback(global_step, metrics)`` runs after each
    step (see ``training.loop.run_loop``)."""
    from smd_tpu_torch.training import diffusion as trainer

    FLAGS(argv)
    log.info("flags: %s", {n: getattr(FLAGS, n) for n in FLAGS.names()})
    if FLAGS.distill:
        raise NotImplementedError(
            "--distill (progressive and consistency distillation) is not "
            "ported to smd_tpu_torch yet: see ROADMAP.md, queue A, item 7")
    if FLAGS.snapshot_sampling:
        raise NotImplementedError(
            "--snapshot_sampling (in-training sampling, its plots and "
            "sampling metrics) is not ported to smd_tpu_torch yet: see "
            "ROADMAP.md, queue A, items 6 and 10; pass "
            "--nosnapshot_sampling")
    if FLAGS.model_parallelism > 1:
        raise NotImplementedError(
            "--model_parallelism > 1 needs a device mesh (DDP and tensor "
            "parallelism), not ported to smd_tpu_torch yet: see ROADMAP.md, "
            "queue A, item 11")
    resolve_device(FLAGS.device)

    train_ds, eval_ds = cli.dataset_from_flags()
    sigmas = cli.schedule_from_flags()
    sample_batch = next(iter(eval_ds))
    input_shape = sample_batch.shape[1:]
    model = cli.model_from_flags(input_shape[-1])
    config = cli.train_config_from_flags()
    return trainer.fit(model, sigmas,
                       train_data=lambda: iter(train_ds),
                       eval_data=lambda: iter(eval_ds),
                       input_shape=input_shape,
                       config=config,
                       model_dir=FLAGS.model_dir,
                       seed=FLAGS.seed,
                       step_callback=step_callback)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except cli.FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
