"""Plotting utilities (PNG byte-buffers for TensorBoard; a copy of
``smd_tpu/eval/plots.py``).

Capability parity with the reference's ``utils/plot_utils.py``: 2-D scatter
(:27), scatter GIF animation (:64-99), energy contour (:102), score quiver
field (:130), image tile grids (:166).

matplotlib is imported when a figure is drawn, not with the module, so the
package imports where matplotlib is absent. ``available()`` says whether it
imports; ``require(what)`` raises a clear ``ImportError`` naming what
asked for the figure. A figure a user asked for by a flag (``--animate``,
``sample_audio --include_plots``) requires it; a figure that only
accompanies scalars (the PRD plot, the snapshot images) is skipped where
``available()`` is false.
"""
from __future__ import annotations

import functools
import io

import numpy as np

__all__ = ["scatter_2d", "animate_scatter_2d", "energy_contour_2d",
           "score_field_2d", "image_tiles", "available", "require"]


@functools.lru_cache(maxsize=None)
def available() -> bool:
    """Whether matplotlib imports here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def require(what: str):
    """Raise ``ImportError`` unless matplotlib imports; ``what`` names the
    flag or figure that needs it."""
    if not available():
        raise ImportError(f"{what} needs matplotlib to draw its figures, "
                          "and matplotlib does not import here")


def _pyplot():
    require("drawing a figure")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _fig_to_buf(fig):
    plt = _pyplot()
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    buf.seek(0)
    return buf


def scatter_2d(samples, scale=None, alpha=0.3, title=None):
    """Scatter plot of (N, 2) samples; returns a PNG BytesIO."""
    plt = _pyplot()
    samples = np.asarray(samples).reshape(-1, 2)
    fig = plt.figure(figsize=(4, 4), dpi=150)
    plt.scatter(samples[:, 0], samples[:, 1], s=2, alpha=alpha)
    if scale is not None:
        plt.xlim([-scale, scale])
        plt.ylim([-scale, scale])
    if title:
        plt.title(title)
    plt.tight_layout()
    return _fig_to_buf(fig)


def animate_scatter_2d(collection, scale=8, fps=60):
    """GIF of sampling trajectory; collection shape (T, N, 2)."""
    plt = _pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter

    collection = np.asarray(collection)
    fig = plt.figure(figsize=(4, 4), dpi=100)
    ax = plt.gca()
    scat = ax.scatter([], [], s=2, alpha=0.3)
    ax.set_xlim([-scale, scale])
    ax.set_ylim([-scale, scale])

    def update(frame):
        scat.set_offsets(collection[frame].reshape(-1, 2))
        return (scat,)

    anim = FuncAnimation(fig, update, frames=len(collection))
    buf = io.BytesIO()
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".gif") as f:
        anim.save(f.name, writer=PillowWriter(fps=fps))
        f.seek(0)
        buf.write(f.read())
    plt.close(fig)
    buf.seek(0)
    return buf


def energy_contour_2d(energy_fn, scale=8, num=100):
    """Contour plot of a scalar energy over a 2-D grid."""
    xs = np.linspace(-scale, scale, num)
    grid = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    z = np.asarray(energy_fn(grid)).reshape(num, num)
    plt = _pyplot()
    fig = plt.figure(figsize=(4, 4), dpi=150)
    plt.contourf(xs, xs, z, levels=50)
    plt.tight_layout()
    return _fig_to_buf(fig)


def score_field_2d(score_fn, sigma, scale=8, num=20, device=None):
    """Quiver plot of a 2-D score field at a fixed noise level.

    ``score_fn(x, sigma)`` is a torch model function, called without a
    gradient on a float32 grid (N, 2) and sigmas (N, 1) on ``device``, the
    model's (``cuda`` unless ``"cpu"``)."""
    import torch

    from smd_tpu_torch.device import resolve_device
    device = resolve_device(device)
    plt = _pyplot()
    xs = np.linspace(-scale, scale, num)
    grid = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    sig = torch.full((grid.shape[0], 1), float(sigma), device=device)
    with torch.no_grad():
        scores = score_fn(torch.tensor(grid, dtype=torch.float32,
                                       device=device), sig)
    scores = scores.float().cpu().numpy()
    fig = plt.figure(figsize=(4, 4), dpi=150)
    plt.quiver(grid[:, 0], grid[:, 1], scores[:, 0], scores[:, 1])
    plt.title(f"sigma={float(sigma):.4f}")
    plt.tight_layout()
    return _fig_to_buf(fig)


def image_tiles(samples, shape=(28, 28), n_cols=5):
    """Tile flat samples as grayscale images (MNIST / latent heatmaps)."""
    plt = _pyplot()
    samples = np.asarray(samples)
    n = len(samples)
    n_rows = int(np.ceil(n / n_cols))
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(n_cols * 1.5, n_rows * 1.5), dpi=100)
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(samples[i].reshape(shape), cmap="gray")
    plt.tight_layout()
    return _fig_to_buf(fig)
