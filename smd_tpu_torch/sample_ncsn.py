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
transformed, to ``SAMPLING_DIR/ncsn/*.pkl``. ``--compute_metrics`` and
``--animate`` are not ported yet and raise.
"""
from __future__ import annotations

import glob
import logging
import os
import sys
import time

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


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and sample; returns
    (generated, collection) as numpy arrays, before the inverse
    transform."""
    from smd_tpu_torch.data import transforms
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    log.info("flags: %s", {n: getattr(FLAGS, n) for n in FLAGS.names()})
    for flag in ("compute_metrics", "animate"):
        if getattr(FLAGS, flag):
            raise NotImplementedError(
                f"--{flag} needs the sampling metrics (eval/metrics.py, "
                "eval/midi_metrics.py) and plots (eval/plots.py), not "
                "ported to smd_tpu_torch yet: see ROADMAP.md, queue A, "
                "item 10, parts 2-4 and 6")
    device = resolve_device(FLAGS.device)
    log_dir = FLAGS.sampling_dir
    pca, slice_idx, dim_weights = cli.load_transforms_from_flags()
    train_ds, eval_ds = cli.dataset_from_flags(include_cardinality=False)
    real = eval_ds.take_examples(FLAGS.sample_size)
    shape = real[0].shape

    model_fn, distill_grid, ddim_steps = _model_and_grid(shape)
    sigmas = cli.schedule_from_flags()
    generator = torch.Generator(device=device).manual_seed(FLAGS.sample_seed)
    kwargs = dict(num_samples=len(real), sampling=FLAGS.sampling,
                  epsilon=FLAGS.ld_epsilon, steps=FLAGS.ld_steps,
                  denoise=FLAGS.denoise, ddim_steps=ddim_steps,
                  ddim_eta=FLAGS.ddim_eta, distill_grid=distill_grid,
                  device=device)

    t0 = time.time()
    with torch.no_grad():
        if FLAGS.infill:
            samples, masks = generate.infill_edge_mask(real, FLAGS.problem)
            generated, collection, _ = generate.sample(
                model_fn, sigmas, generator, shape, infill_samples=samples,
                infill_masks=masks, **kwargs)
        elif FLAGS.interpolate:
            generated, _, _ = generate.interpolate(model_fn, sigmas,
                                                   generator, real,
                                                   device=device)
            collection = generated
        else:
            generated, collection, _ = generate.sample(
                model_fn, sigmas, generator, shape, **kwargs)
        generated = generated.cpu().numpy()
        collection = None if collection is None else \
            collection.cpu().numpy()
    log.info("Generated samples in %f seconds", time.time() - t0)

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
    return generated, collection


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except cli.FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
