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
smd_tpu_torch.sample_ncsn`` serves. ``--snapshot_sampling`` (on in the
NCSN and toy flagfiles) samples ``--eval_samples`` at each snapshot with
the EMA params: the Langevin samplers' per-level statistics go to
``MODEL_DIR/sampling_epoch{n}``, the ``vae`` problem's init, real and
generated latents (inverse transformed) to
``MODEL_DIR/samples/{init,real,fake}/{step}.pkl``, and the scatter plots
and score fields of the ``toy`` problem, and the ``vae`` tiles, to
TensorBoard where matplotlib imports (skipped with a log line where it
does not).

Across processes, under ``torchrun --nproc_per_node=N -m
smd_tpu_torch.train_ncsn ...`` (one card a rank, NCCL; gloo with
``--device=cpu``): ``--batch_size`` is the global batch, each data shard
reads its share, and ``--model_parallelism=M`` splits the Dense layers over
model groups of M ranks; ``--scan_chunk=K`` takes the steps K at a time
under any grid, each of a step's collectives eager between two of its
captured graphs (``utils/graphs.py``). Rank 0 writes the checkpoints,
summaries and snapshots; a checkpoint restores under any grid and serves
on one card.
``--distill`` runs on one rank.
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


def snapshot_sampling_callback(model, sigmas, train_ds, eval_ds, writer,
                               output_dir, write=True):
    """In-training sampling and logging (the JAX package's, reference
    ``train_ncsn.py:405-486``), for ``training.loop.run_loop``'s
    ``snapshot_callback``. Each snapshot samples with a generator seeded
    ``--seed + sampling_step + 1`` on the model's device, through the model
    with the EMA params (``state.sampling_params``). Under a model axis
    every rank of the first model group samples (the split products run
    on all of them) and ``write`` is set on rank 0 alone: the others
    write nothing."""
    import functools

    import numpy as np
    import torch

    from smd_tpu_torch.data import transforms
    from smd_tpu_torch.eval import plots
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.utils import graphs
    from smd_tpu_torch.utils import io as io_lib
    from smd_tpu_torch.utils.logging import log_sampling_metrics

    pca, slice_idx, dim_weights = cli.load_transforms_from_flags()
    device = next(model.parameters()).device
    figures = plots.available()
    if not figures:
        log.info("matplotlib does not import: the snapshot images are "
                 "skipped; the samples and metrics are written")

    def callback(state, eval_metrics, sampling_step):
        params = state.sampling_params

        def model_fn(x, cond):
            return torch.func.functional_call(model, params, (x, cond))

        generator = torch.Generator(device=device).manual_seed(
            FLAGS.seed + sampling_step + 1)
        input_shape = tuple(int(s) for s in FLAGS.data_shape)
        if FLAGS.slice_ckpt:
            input_shape = (*input_shape[:-1], len(slice_idx))
        with torch.no_grad():
            generated, collection, ld_metrics = generate.sample(
                model_fn, sigmas, generator, input_shape,
                num_samples=FLAGS.eval_samples, sampling=FLAGS.sampling,
                epsilon=FLAGS.ld_epsilon, steps=FLAGS.ld_steps,
                denoise=FLAGS.denoise, ddim_steps=FLAGS.ddim_steps,
                ddim_eta=FLAGS.ddim_eta, device=device)
        # Each snapshot's closure is a chain of its own: free its graph.
        graphs.release()
        if not write:
            return
        if ld_metrics is not None:
            log_sampling_metrics(ld_metrics, sampling_step, output_dir)

        init = collection[0].cpu().numpy()
        generated = generated.cpu().numpy()
        real = eval_ds.take_examples(FLAGS.eval_samples)

        inv = functools.partial(transforms.inverse_data_transform,
                                normalize_flag=FLAGS.normalize, pca=pca,
                                data_min=train_ds.min, data_max=train_ds.max,
                                slice_idx=slice_idx, dim_weights=dim_weights)
        real_t = transforms.inverse_data_transform(
            real, FLAGS.normalize, pca, eval_ds.min, eval_ds.max, slice_idx,
            dim_weights)
        init_t, generated_t = inv(init), inv(generated)

        step = int(state.step)
        if FLAGS.problem == "toy" and figures:
            for tag, samples in (("init", init_t), ("real", real_t),
                                 ("fake", generated_t)):
                writer.image(tag, plots.scatter_2d(samples,
                                                   scale=8).getvalue(), step)
            if len(input_shape) == 1 and FLAGS.sampling != "ddpm":
                for sigma in sigmas.cpu().numpy()[:: max(
                        1, len(sigmas) // 8)]:
                    buf = plots.score_field_2d(model_fn, sigma, scale=8,
                                               device=device)
                    writer.image(f"score_sigma={sigma:.4f}", buf.getvalue(),
                                 step)
        elif FLAGS.problem == "vae":
            if figures:
                shape = (input_shape[0], 32) if len(input_shape) > 1 \
                    else (16, 32)
                writer.image("fake", plots.image_tiles(
                    generated_t[:10].reshape(10, -1)[:, :shape[0] *
                                                     shape[1]],
                    shape=shape).getvalue(), step)
            for category, samples in (("init", init_t), ("real", real_t),
                                      ("fake", generated_t)):
                io_lib.save(samples,
                            f"{output_dir}/samples/{category}/{step}.pkl")
        writer.flush()

    return callback


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
    rank, world = cli.initialize_from_flags()
    if FLAGS.distill:
        if world > 1:
            raise ValueError(f"--distill runs on one rank, not {world}: "
                             "its steps take no data axis")
        return run_distillation(*cli.dataset_from_flags())
    mesh = cli.mesh_from_flags()
    train_ds, eval_ds = cli.dataset_from_flags()
    sigmas = cli.schedule_from_flags()
    sample_batch = next(iter(eval_ds))
    input_shape = sample_batch.shape[1:]
    model = cli.model_from_flags(input_shape[-1])
    config = cli.train_config_from_flags()
    callback = None
    if FLAGS.snapshot_sampling and (mesh is None or mesh.data_index == 0):
        from smd_tpu_torch.utils.logging import SummaryWriter
        callback = snapshot_sampling_callback(
            model, sigmas, train_ds, eval_ds,
            SummaryWriter(f"{FLAGS.model_dir}/eval") if rank == 0 else None,
            FLAGS.model_dir, write=rank == 0)
    return trainer.fit(model, sigmas,
                       train_data=lambda: iter(train_ds),
                       eval_data=lambda: iter(eval_ds),
                       input_shape=input_shape,
                       config=config,
                       model_dir=FLAGS.model_dir,
                       mesh=mesh,
                       seed=FLAGS.seed,
                       snapshot_callback=callback,
                       step_callback=step_callback)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except cli.FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
