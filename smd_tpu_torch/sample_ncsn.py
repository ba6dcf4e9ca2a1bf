"""Sample from a trained diffusion model (port of ``sample_ncsn.py``).

    python -m smd_tpu_torch.sample_ncsn \\
        --flagfile=configs/ddpm-mel-32seq-512.cfg --dataset=... \\
        --model_dir=... --sampling=ddim --sampling_dir=...

Reads the JAX package's flags and flagfiles and ``--device`` (``cuda``
unless ``--device=cpu``; no GPU is an error). Unconditional generation,
``--infill`` (the first and last 8 latents held) and ``--interpolate``,
from the latest checkpoint (``ald``, the default, and ``cas`` with
``--ld_steps`` and ``--ld_epsilon`` on the sigma schedule; ``ddpm``,
``ddim``, ``dpmpp`` on the betas) or from a bundle
that ``python -m smd_tpu_torch.train_ncsn --distill`` wrote
(``--sampling=distilled``: ``distilled/{ddim_steps}.pkl``;
``--sampling=consistency``: ``distilled/consistency.pkl`` with
``--consistency_sampling_steps`` steps). ``--flush`` writes the generated,
real and (where the sampler collects one) collection latents, inverse
transformed, to ``SAMPLING_DIR/ncsn/*.pkl``. ``--compute_metrics`` runs
the metric sweep (``evaluate``: PRD, improved precision and recall,
realism, NDB, Fréchet distance, both MMDs) over the sampler's snapshots
(``--compute_final_only``: the final samples) against the real examples,
logs it, writes its scalars to TensorBoard where ``tensorboard`` imports
and the returned stats to ``SAMPLING_DIR/metrics.json``; its PRD plots and
scatter images are drawn only where matplotlib imports. ``--animate``
writes ``SAMPLING_DIR/animated.gif`` of a 2-D sampler's snapshots and needs
matplotlib.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from smd_tpu_torch import cli
from smd_tpu_torch.device import resolve_device

FLAGS = cli.FLAGS
cli.define_common_flags()
cli.define_diffusion_flags()
cli.define_sampling_flags()

log = logging.getLogger("smd_tpu_torch")


def _bundle(name, missing):
    from smd_tpu_torch.utils import io as io_lib
    path = os.path.join(FLAGS.model_dir, "distilled", name)
    if not os.path.exists(path):
        raise FileNotFoundError(missing(path))
    return io_lib.load(path)


def _model_and_grid(shape):
    """(model_fn, distill_grid, steps) for ``--sampling``: a distilled or
    consistency bundle, or the latest checkpoint (of a model taking
    ``shape``)."""
    ddim_steps = FLAGS.ddim_steps
    if FLAGS.sampling == "distilled":
        # Each step count is its own trained stage, picked by --ddim_steps.
        def missing(path):
            have = sorted(int(os.path.splitext(os.path.basename(p))[0])
                          for p in glob.glob(os.path.join(
                              FLAGS.model_dir, "distilled", "[0-9]*.pkl")))
            return (f"No {FLAGS.ddim_steps}-step distilled stage at {path}; "
                    f"available stages: {have or 'none'} (train with "
                    "train_ncsn.py --distill)")
        bundle = _bundle(f"{FLAGS.ddim_steps}.pkl", missing)
        return cli.serving_model_fn(bundle["params"]), bundle["grid"], \
            ddim_steps
    if FLAGS.sampling == "consistency":
        # One bundle for every step count: --consistency_sampling_steps
        # picks k (0 falls back to --ddim_steps).
        bundle = _bundle("consistency.pkl", lambda path: (
            f"No consistency bundle at {path} (train with train_ncsn.py "
            "--distill --distill_mode=consistency)"))
        num_seg = len(bundle["grid"]) - 1
        ddim_steps = FLAGS.consistency_sampling_steps or FLAGS.ddim_steps
        flag_name = ("consistency_sampling_steps"
                     if FLAGS.consistency_sampling_steps else "ddim_steps")
        if not 1 <= ddim_steps <= num_seg:
            raise ValueError(
                f"--{flag_name}={ddim_steps} outside [1, {num_seg}] "
                f"for the {num_seg}-segment consistency bundle")
        return cli.serving_model_fn(bundle["params"]), bundle["grid"], \
            ddim_steps
    _, state = cli.restore_state_for_sampling(shape)
    params = state.sampling_params if FLAGS.ema else state.params
    return cli.serving_model_fn(params), None, ddim_steps


def evaluate(writer, real, collection, baseline, valid_real,
             has_init: bool = True):
    """Metric sweep over sampling-time snapshots (the JAX package's
    ``evaluate``, reference ``sample_ncsn.py:69``), numpy in and out.

    ``has_init=False`` marks a collection made of the final samples only
    (collection-free samplers like dpmpp): the init-PRD "noise" curve is
    skipped. Every model's scalars go to ``writer``; the returned stats are
    the last loop iteration's, the "real" baseline's, as in the reference
    (``sample_ncsn.py:85-91``).
    """
    from smd_tpu_torch.eval import metrics, plots

    assert collection.shape[1:] == real.shape
    gen_test_points = collection[np.linspace(0, len(collection) - 1,
                                             20).astype(np.uint32)]
    if FLAGS.compute_final_only:
        gen_test_points = [gen_test_points[-1]]

    random_points = [np.random.randn(*collection[0].shape)]
    real_points = [valid_real]

    prd_init = (metrics.precision_recall_distribution(real, collection[0])
                if has_init else None)
    prd_perfect = metrics.precision_recall_distribution(real, real)
    figures = plots.available()
    if not figures:
        log.info("matplotlib does not import: the PRD plots and scatter "
                 "images are skipped; the metrics are written")

    stats = {}
    for model_name, test_points in [("baseline", [baseline]),
                                    ("ncsn", gen_test_points),
                                    ("random", random_points),
                                    ("real", real_points)]:
        log_dir = f"{model_name}/"
        if any(point is None for point in test_points):
            continue
        for i, samples in enumerate(test_points):
            prd_dist = metrics.precision_recall_distribution(real, samples)
            if figures:
                if samples.shape[-1] == 2 and samples.ndim == 2:
                    writer.image(f"{log_dir}fake",
                                 plots.scatter_2d(samples).getvalue(), i)
                import io

                import matplotlib.pyplot as plt
                curves = [prd_dist, prd_init, prd_perfect]
                labels = [model_name, "noise", "real"]
                if prd_init is None:
                    curves = [prd_dist, prd_perfect]
                    labels = [model_name, "real"]
                fig = metrics.prd.plot(curves, labels)
                buf = io.BytesIO()
                fig.savefig(buf, format="png")
                plt.close(fig)
                writer.image(f"{log_dir}prd", buf.getvalue(), i)

            recall, precision = metrics.prd_f_beta_score(prd_dist)
            f1 = metrics.f1_score(precision, recall)
            improved_p, improved_r = metrics.precision_recall(real, samples)
            improved_f1 = metrics.f1_score(improved_p, improved_r)
            realism = float(metrics.realism_scores(real, samples).mean())
            ndb = metrics.ndb_score(real, samples, k=50)
            fd = metrics.frechet_distance(real, samples)
            mmd_rbf = metrics.mmd_rbf(real, samples)
            mmd_poly = metrics.mmd_polynomial(real, samples)

            for tag, val in [("precision", precision), ("recall", recall),
                             ("f1", f1),
                             ("improved_precision", improved_p),
                             ("improved_recall", improved_r),
                             ("improved_f1", improved_f1),
                             ("ipr_realism", realism), ("ndb", ndb),
                             ("frechet_distance", fd), ("mmd_rbf", mmd_rbf),
                             ("mmd_polynomial", mmd_poly)]:
                writer.scalar(f"{log_dir}{tag}", val, i)

            # The reference's quirk, kept: the stats returned are whatever
            # the LAST iteration computed (the "real" baseline's).
            stats = {
                "precision": precision, "recall": recall, "f1": f1,
                "improved_precision": improved_p,
                "improved_recall": improved_r, "improved_f1": improved_f1,
                "realism": realism, "frechet_dist": fd, "mmd_rbf": mmd_rbf,
                "mmd_polynomial": mmd_poly,
            }
    writer.flush()
    return stats


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and sample; returns
    (generated, collection) as numpy arrays, before the inverse
    transform."""
    from smd_tpu_torch.data import transforms
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    log.info("flags: %s", {n: getattr(FLAGS, n) for n in FLAGS.names()})
    if FLAGS.animate:
        from smd_tpu_torch.eval import plots
        plots.require("--animate")
    device = resolve_device(FLAGS.device)
    log_dir = FLAGS.sampling_dir
    pca, slice_idx, dim_weights = cli.load_transforms_from_flags()
    train_ds, eval_ds = cli.dataset_from_flags(include_cardinality=False)
    real = eval_ds.take_examples(FLAGS.sample_size)
    shape = real[0].shape

    model_fn, distill_grid, ddim_steps = _model_and_grid(shape)
    sigmas = cli.schedule_from_flags()
    generator = torch.Generator(device=device).manual_seed(FLAGS.sample_seed)
    # --animate and the per-snapshot metric sweep need intermediate
    # snapshots; each sampler keeps its own collection default otherwise.
    want_snaps = FLAGS.animate or (FLAGS.compute_metrics and
                                   not FLAGS.compute_final_only)
    kwargs = dict(num_samples=len(real), sampling=FLAGS.sampling,
                  epsilon=FLAGS.ld_epsilon, steps=FLAGS.ld_steps,
                  denoise=FLAGS.denoise, ddim_steps=ddim_steps,
                  ddim_eta=FLAGS.ddim_eta, distill_grid=distill_grid,
                  ensure_snapshots=want_snaps, device=device)

    t0 = time.time()
    ld_metrics = None
    with torch.no_grad():
        if FLAGS.infill:
            samples, masks = generate.infill_edge_mask(real, FLAGS.problem)
            generated, collection, ld_metrics = generate.sample(
                model_fn, sigmas, generator, shape, infill_samples=samples,
                infill_masks=masks, **kwargs)
        elif FLAGS.interpolate:
            generated, _, _ = generate.interpolate(model_fn, sigmas,
                                                   generator, real,
                                                   device=device)
            collection = generated
        else:
            generated, collection, ld_metrics = generate.sample(
                model_fn, sigmas, generator, shape, **kwargs)
        generated = generated.cpu().numpy()
        collection = None if collection is None else \
            collection.cpu().numpy()
    log.info("Generated samples in %f seconds", time.time() - t0)

    if collection is None and not FLAGS.interpolate:
        if FLAGS.animate:
            log.warning(
                "--animate requested but --sampling=%s collects no "
                "intermediate snapshots; no animation will be written. "
                "Use --sampling=ddim/ddpm for animations.", FLAGS.sampling)
        if FLAGS.compute_metrics and not FLAGS.compute_final_only:
            log.warning(
                "--sampling=%s collects no intermediate snapshots: metrics "
                "cover the final samples only (the per-snapshot sweep and "
                "the init-noise PRD baseline are skipped).", FLAGS.sampling)

    if FLAGS.animate and shape[-1] == 2 and collection is not None:
        from smd_tpu_torch.eval import plots
        buf = plots.animate_scatter_2d(collection[::2], fps=240)
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "animated.gif"), "wb") as f:
            f.write(buf.getvalue())

    if FLAGS.flush:
        def inverse(x, ds):
            return transforms.inverse_data_transform(
                x, FLAGS.normalize, pca, ds.min, ds.max, slice_idx,
                dim_weights)
        if not FLAGS.interpolate and collection is not None:
            io_lib.save(inverse(collection, train_ds),
                        os.path.join(log_dir, "ncsn/collection.pkl"))
        io_lib.save(inverse(real, eval_ds),
                    os.path.join(log_dir, "ncsn/real.pkl"))
        io_lib.save(inverse(generated, train_ds),
                    os.path.join(log_dir, "ncsn/generated.pkl"))

    if FLAGS.compute_metrics:
        from smd_tpu_torch.utils.logging import (SummaryWriter, log_metrics,
                                                 log_sampling_metrics)
        if ld_metrics is not None and not FLAGS.interpolate:
            log_sampling_metrics(ld_metrics, 0, log_dir)
        has_init = collection is not None
        if collection is None:
            collection = generated[None]
        stats = evaluate(SummaryWriter(log_dir), real, collection, None,
                         real, has_init=has_init)
        log_metrics(stats, 1, 1)
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in stats.items()}, f, indent=1)
    return generated, collection


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except cli.FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
