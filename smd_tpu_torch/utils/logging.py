"""Metric logging: stdout and TensorBoard (port of
``smd_tpu/utils/logging.py``).

``SummaryWriter`` writes TensorBoard scalars and images through
``torch.utils.tensorboard`` when it imports (it needs the ``tensorboard``
package); without it the writer does nothing and the metrics go to the log
alone, as the JAX package's does without TensorFlow.
"""
from __future__ import annotations

import logging

__all__ = ["SummaryWriter", "log_metrics", "log_sampling_metrics",
           "report_params"]

log = logging.getLogger("smd_tpu_torch")


class SummaryWriter:
    """Scalar writer backed by ``torch.utils.tensorboard`` when available."""

    def __init__(self, log_dir):
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = TBWriter(str(log_dir))

    def scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def image(self, tag, png_bytes, step):
        """A PNG image (the bytes ``eval.plots`` returns); decoded with
        Pillow, which matplotlib brings."""
        if self._writer is not None:
            import io

            import numpy as np
            from PIL import Image
            image = np.asarray(Image.open(io.BytesIO(png_bytes)).convert(
                "RGBA"))
            self._writer.add_image(tag, image, int(step), dataformats="HWC")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()


def log_metrics(metrics, step, total_steps, epoch=None, summary_writer=None,
                verbose=True):
    metrics_str = ""
    for metric, value in metrics.items():
        if metric == "lr":
            metrics_str += "{} {:5.4f} | ".format(metric, value)
        else:
            metrics_str += "{} {:5.2f} | ".format(metric, value)
        if summary_writer is not None:
            writer_step = step if epoch is None else total_steps * epoch + step
            summary_writer.scalar(metric, value, writer_step)

    epoch_str = "| epoch {:3d} ".format(epoch) if epoch is not None else ""
    if verbose:
        log.info("%s| %5d/%5d steps | %s", epoch_str, step, total_steps,
                 metrics_str)


def log_sampling_metrics(ld_metrics, step, output_dir, verbose=False):
    """Per-noise-level sampling statistics to their own TensorBoard dir:
    slope, step, alpha and noise scalars of each level under
    ``{output_dir}/sampling_epoch{step}``."""
    from smd_tpu_torch.diffusion.samplers import collate_sampling_metrics
    collated = collate_sampling_metrics(ld_metrics)
    if not collated:
        return
    writer = SummaryWriter(f"{output_dir}/sampling_epoch{step}")
    for i, sigma_metrics in enumerate(collated):
        for j, metric in enumerate(sigma_metrics):
            log_metrics(metric, j, len(sigma_metrics), epoch=i,
                        summary_writer=writer, verbose=verbose)
    writer.flush()


def report_params(params):
    """Log the parameter count and memory footprint of a {name: tensor}
    dict (or a module's parameters)."""
    if hasattr(params, "parameters"):
        params = dict(params.named_parameters())
    tensors = list(params.values())
    n = sum(p.numel() for p in tensors)
    footprint = sum(p.numel() * p.element_size() for p in tensors)
    log.info("Number of trainable parameters: {:,}".format(n))
    log.info("Memory footprint: %dMB", footprint / 2**20)
    return n, footprint
