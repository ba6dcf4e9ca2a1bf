"""Train the diffusion model from flags (port of ``train_ncsn.py``).

    python -m smd_tpu_torch.train_ncsn \\
        --flagfile=configs/ddpm-mel-32seq-512.cfg --dataset=... --model_dir=...

Reads the same layered ``configs/*.cfg`` flagfiles as the JAX package's
``train_ncsn.py``, and ``--device`` (``cuda`` unless ``--device=cpu``; no
GPU is an error). Every architecture but ``TransformerMDN`` (which
``python -m smd_tpu_torch.train_mdn`` trains) trains, on the DDPM
objective (``--loss=ddpm``) or on denoising or sliced score matching
(``dsm``, ``ssm``) for the NCSN family; ``--distill`` distills
the latest DDPM checkpoint for few-step sampling
(``--distill_mode=progressive``, ``consistency`` or ``ct``) into
``MODEL_DIR/distilled/`` bundles, which ``python -m
smd_tpu_torch.sample_ncsn`` serves. ``--snapshot_sampling`` is not ported
yet and raises.
"""
from __future__ import annotations

import logging
import os
import sys

from smd_tpu_torch import cli
from smd_tpu_torch.device import resolve_device

FLAGS = cli.FLAGS
cli.define_common_flags()
cli.define_diffusion_flags()

log = logging.getLogger("smd_tpu_torch")


def run_distillation(train_ds, eval_ds):
    """``--distill``: distill the latest checkpoint for few-step sampling.

    ``--distill_mode=progressive`` writes each stage to
    ``MODEL_DIR/distilled/{steps}.pkl`` (``params``, ``grid``,
    ``num_steps``); ``consistency`` and ``ct`` write
    ``distilled/consistency.pkl`` (``params``, ``grid``, ``num_segments``,
    ``objective``). ``params`` is {name: tensor} on the CPU. Returns what it
    wrote, by file name.
    """
    import numpy as np

    from smd_tpu_torch.training import consistency, distill
    from smd_tpu_torch.utils import io as io_lib

    input_shape = next(iter(eval_ds)).shape[1:]
    model, state = cli.restore_state_for_sampling(input_shape)
    params = state.sampling_params if FLAGS.ema else state.params
    betas = cli.schedule_from_flags()
    # Distillation teaches the DDIM update on a DDPM beta schedule; an NCSN
    # checkpoint's sigmas (near 1) make cumprod(1 - beta) reach 0 and the
    # lambda grid NaN, so its stages would detonate at sampling time.
    if FLAGS.loss != "ddpm" or float(betas.max()) >= 1.0:
        raise ValueError(
            "--distill requires a DDPM checkpoint (--loss=ddpm with a beta "
            f"schedule < 1); got --loss={FLAGS.loss}, max schedule value "
            f"{float(betas.max()):.4f}. Progressive distillation of "
            "score-matching (ALD) samplers is not supported.")

    def batches():
        while True:
            for batch in train_ds:
                if batch.shape[0] == FLAGS.batch_size:
                    yield batch

    def log_fn(stage_steps, step, loss):
        log.info("distill stage %d-step | step %d | loss %.5f",
                 stage_steps, step, loss)

    def on_cpu(tree):
        return {n: t.detach().cpu() for n, t in tree.items()}

    log_fn = log_fn if FLAGS.verbose else None
    common = dict(learning_rate=FLAGS.distill_lr,
                  lam_max=FLAGS.distill_lam_max, seed=FLAGS.seed,
                  log_fn=log_fn)
    out_dir = os.path.join(FLAGS.model_dir, "distilled")
    bundles = {}
    if FLAGS.distill_mode in ("consistency", "ct"):
        if FLAGS.distill_mode == "ct":
            seg_schedule = tuple(
                int(s) for s in FLAGS.ct_seg_schedule.split(","))
            cd = consistency.consistency_train(
                model, params, betas, batches(),
                steps=FLAGS.distill_stage_steps, seg_schedule=seg_schedule,
                p_mean=FLAGS.ct_p_mean, p_std=FLAGS.ct_p_std, **common)
            num_segments = seg_schedule[-1]
        else:
            cd = consistency.consistency_distill(
                model, params, betas, batches(),
                num_segments=FLAGS.consistency_segments,
                steps=FLAGS.distill_stage_steps, **common)
            num_segments = FLAGS.consistency_segments
        bundles["consistency.pkl"] = {
            "params": on_cpu(cd["params"]), "grid": np.asarray(cd["grid"]),
            "num_segments": num_segments, "objective": FLAGS.distill_mode}
    else:
        stages = distill.progressive_distill(
            model, params, betas, batches(),
            start_steps=FLAGS.distill_start_steps,
            end_steps=FLAGS.distill_end_steps,
            steps_per_stage=FLAGS.distill_stage_steps, **common)
        for num_steps, stage in stages.items():
            bundles[f"{num_steps}.pkl"] = {
                "params": on_cpu(stage["params"]),
                "grid": np.asarray(stage["grid"]), "num_steps": num_steps}
    for name, bundle in bundles.items():
        io_lib.save(bundle, os.path.join(out_dir, name))
        log.info("Saved the %s bundle to %s/%s", FLAGS.distill_mode, out_dir,
                 name)
    return bundles


def main(argv, step_callback=None):
    """Parse ``argv`` (``argv[0]`` is the program) and train; returns the
    final TrainState, or with ``--distill`` the bundles written (see
    ``run_distillation``). ``step_callback(global_step, metrics)`` runs
    after each training step (see ``training.loop.run_loop``)."""
    from smd_tpu_torch.training import diffusion as trainer

    FLAGS(argv)
    log.info("flags: %s", {n: getattr(FLAGS, n) for n in FLAGS.names()})
    resolve_device(FLAGS.device)
    if FLAGS.distill:
        return run_distillation(*cli.dataset_from_flags())
    if FLAGS.snapshot_sampling:
        raise NotImplementedError(
            "--snapshot_sampling (in-training sampling) needs the sampling "
            "metrics (eval/metrics.py) and plots (eval/plots.py), not "
            "ported to smd_tpu_torch yet: see ROADMAP.md, queue A, item 10, "
            "parts 2, 4 and 6; pass --nosnapshot_sampling")
    if FLAGS.model_parallelism > 1:
        raise NotImplementedError(
            "--model_parallelism > 1 needs a device mesh (DDP and tensor "
            "parallelism), not ported to smd_tpu_torch yet: see ROADMAP.md, "
            "queue A, item 11")

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
