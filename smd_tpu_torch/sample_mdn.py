"""Sample from a trained autoregressive MDN (port of ``sample_mdn.py``).

    python -m smd_tpu_torch.sample_mdn \\
        --flagfile=configs/mdn-mel-32seq-512.cfg --dataset=... \\
        --model_dir=... --sampling_dir=...

Reads the JAX package's flags and flagfiles and ``--device`` (``cuda``
unless ``--device=cpu``; no GPU is an error). Restores the latest
checkpoint of ``python -m smd_tpu_torch.train_mdn`` and decodes as many
sequences as it takes eval examples (``--sample_size``): over a KV cache
(``--cached_decode``, the default) or with the reference's full forwards
and final-step resample (``--nocached_decode``), each component's log
stddev capped at ``--mdn_sigma_cap`` (inf: no cap). ``--nll_gate`` (off,
warn, fail) checks the checkpoint before decoding (held-out NLL against the
diagonal-Gaussian baseline, ``--nll_gate_margin``) and the samples after
(marginal deviation from the eval examples, ``--gate_dev_max``).
``--flush`` writes the real and generated latents, inverse transformed, to
``SAMPLING_DIR/mdn/{real,generated}.pkl``.
"""
from __future__ import annotations

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
cli.define_sampling_flags()


def define_mdn_flags():
    """The flags ``sample_mdn.py`` defines beside the shared ones."""
    F = FLAGS
    if "cached_decode" in F:
        return
    F.DEFINE_boolean(
        "cached_decode", True,
        "KV-cached incremental decoding (clean ancestral sampling). Disable "
        "for the reference's exact decode semantics incl. its final-step "
        "full resample.")
    F.DEFINE_float(
        "mdn_sigma_cap", 0.0,
        "Serving-side upper bound on per-component log stddev during "
        "mixture sampling. Set to inf for the reference's exact unguarded "
        "sampling.")
    F.DEFINE_enum(
        "nll_gate", "warn", ["off", "warn", "fail"],
        "Serve-time convergence gate, two legs: the held-out NLL against "
        "the diagonal-Gaussian baseline before decoding, the decoded "
        "samples' marginal deviation after. 'fail' refuses to decode or "
        "flush; 'warn' proceeds loudly.")
    F.DEFINE_float(
        "nll_gate_margin", 8.0,
        "Nats-per-position margin the MDN must beat the Gaussian baseline "
        "by (see --nll_gate).")
    F.DEFINE_float(
        "gate_dev_max", 1.0,
        "Maximum relative marginal mean+std deviation of decoded samples vs "
        "the eval examples (see --nll_gate probe leg).")


define_mdn_flags()

log = logging.getLogger("smd_tpu_torch")


def _heldout_nll(model, real, device):
    """Mean over chunks of ~256 eval examples of the teacher-forced NLL a
    position, as the JAX CLI computes it."""
    from smd_tpu_torch.diffusion import losses as losses_lib
    nlls = []
    with torch.no_grad():
        for chunk in np.array_split(real, max(1, len(real) // 256)):
            batch = torch.as_tensor(chunk, device=device)
            nlls.append(float(losses_lib.mdn_nll(*model(batch), batch,
                                                 "mean")))
    return float(np.mean(nlls))


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and sample; returns
    (generated, gates): the samples as a numpy array before the inverse
    transform, and the gate's readings (``gaussian_nll``, ``heldout_nll``,
    ``marginal_deviation``; empty with ``--nll_gate=off``)."""
    from smd_tpu_torch.data import transforms
    from smd_tpu_torch.sampling import gates, mdn_decode
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    log.info("flags: %s", {n: getattr(FLAGS, n) for n in FLAGS.names()})
    device = resolve_device(FLAGS.device)
    log_dir = FLAGS.sampling_dir
    pca, slice_idx, dim_weights = cli.load_transforms_from_flags()
    train_ds, eval_ds = cli.dataset_from_flags(include_cardinality=False,
                                               problem="vae")
    real = np.asarray(eval_ds.take_examples(FLAGS.sample_size), np.float32)
    steps, channels = real[0].shape

    model, _ = cli.restore_state_for_sampling((steps, channels), mdn=True)
    model.eval()
    readings = {}

    if FLAGS.nll_gate != "off":
        gauss_nll = gates.gaussian_baseline_nll(real)
        heldout = _heldout_nll(model, real, device)
        readings.update(gaussian_nll=gauss_nll, heldout_nll=heldout)
        gate = gauss_nll - FLAGS.nll_gate_margin
        if heldout > gate:
            msg = (f"MDN convergence gate: held-out NLL {heldout:.2f} is "
                   f"above the gate {gate:.2f} (diagonal-Gaussian baseline "
                   f"{gauss_nll:.2f} - margin {FLAGS.nll_gate_margin}); "
                   "this checkpoint is underconverged and free-running "
                   "decode is unreliable — train longer (see train_mdn "
                   "--max_steps) or lower --nll_gate_margin deliberately.")
            if FLAGS.nll_gate == "fail":
                raise SystemExit(f"REFUSING TO DECODE. {msg}")
            log.error("%s (decoding anyway: --nll_gate=warn)", msg)
        else:
            log.info("MDN convergence gate passed: held-out NLL %.2f <= "
                     "gate %.2f (Gaussian baseline %.2f)", heldout, gate,
                     gauss_nll)

    cap = None if np.isinf(FLAGS.mdn_sigma_cap) else FLAGS.mdn_sigma_cap
    generator = torch.Generator(device=device).manual_seed(FLAGS.sample_seed)
    t0 = time.time()
    if FLAGS.cached_decode:
        generated = mdn_decode.ar_decode_cached(
            generator, model, len(real), steps=steps, channels=channels,
            log_sigma_cap=cap)
    else:
        generated = mdn_decode.ar_decode(
            generator, lambda tokens: model(tokens, shift=False), len(real),
            steps=steps, channels=channels, log_sigma_cap=cap, device=device)
    generated = generated.cpu().numpy()
    log.info("Generated samples in %f seconds", time.time() - t0)

    if FLAGS.nll_gate != "off":
        dev = gates.marginal_deviation(real, generated)
        readings["marginal_deviation"] = dev
        if dev > FLAGS.gate_dev_max:
            msg = (f"MDN probe gate: decoded samples' marginal deviation "
                   f"{dev:.3f} exceeds --gate_dev_max={FLAGS.gate_dev_max} "
                   "— free-running decode has drifted off-distribution "
                   "(underconverged checkpoint); train longer before "
                   "serving.")
            if FLAGS.nll_gate == "fail":
                raise SystemExit(f"REFUSING TO FLUSH SAMPLES. {msg}")
            log.error("%s (flushing anyway: --nll_gate=warn)", msg)
        else:
            log.info("MDN probe gate passed: marginal deviation %.3f <= "
                     "%.2f", dev, FLAGS.gate_dev_max)

    if FLAGS.flush:
        generated_t = transforms.inverse_data_transform(
            generated, FLAGS.normalize, pca, train_ds.min, train_ds.max,
            slice_idx, dim_weights)
        real_t = transforms.inverse_data_transform(
            real, FLAGS.normalize, pca, eval_ds.min, eval_ds.max, slice_idx,
            dim_weights)
        io_lib.save(real_t, os.path.join(log_dir, "mdn/real.pkl"))
        io_lib.save(generated_t, os.path.join(log_dir, "mdn/generated.pkl"))
    return generated, readings


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except cli.FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
