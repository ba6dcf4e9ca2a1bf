"""Fit latent-compression transforms: slice, PCA or dimension weights
(port of ``scripts/generate_compressed_transform.py``).

    python -m smd_tpu_torch.scripts.generate_compressed_transform \
        --encoded_data=DIR --output_path=DIR --transform=slice

Reads up to ``--max_vectors`` non-zero latents (z, and the encoder's
sigma) from ``training_seqs.tfrecord-*`` without TensorFlow, logs the
share of variance the top ``--keep_dims`` dimensions explain, and pickles
``NAME.pkl`` for the training CLIs' ``--slice_ckpt`` (the kept indices,
int64), ``--pca_ckpt`` (StandardScaler + PCA, fitted in numpy) or
``--dim_weights_ckpt`` (1 / mean sigma per dimension).
"""
from __future__ import annotations

import glob
import logging
import os
import sys

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError
from smd_tpu_torch.scripts.transform_encoded_data import iter_encoded_records

FLAGS = Flags()
FLAGS.DEFINE_string("encoded_data", None,
                    "Directory of encoded-song TFRecords ([3,n,512]).")
FLAGS.DEFINE_string("output_path", "./checkpoints", "Output directory.")
FLAGS.DEFINE_enum("transform", "slice", ["slice", "pca", "dim_weights"],
                  "Transform to fit.")
FLAGS.DEFINE_integer("keep_dims", 42, "Dimensions to keep.")
FLAGS.DEFINE_integer("max_vectors", 200000, "Latent vectors to fit on.")
FLAGS.DEFINE_string("name", "slice-mel-512", "Artifact base name.")

log = logging.getLogger("smd_tpu_torch")


def collect(files, max_vectors):
    """(z, sigma) of the first ``max_vectors`` non-zero latents."""
    zs, sigmas = [], []
    total = 0
    for song in iter_encoded_records(files):
        m = np.asarray(song)
        z, sigma = m[0], m[2]
        keep = np.linalg.norm(z, axis=1) > 1e-6
        zs.append(z[keep])
        sigmas.append(sigma[keep])
        total += keep.sum()
        if total >= max_vectors:
            break
    return (np.concatenate(zs)[:max_vectors],
            np.concatenate(sigmas)[:max_vectors])


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program), fit and save."""
    from smd_tpu_torch.data import transforms
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    if FLAGS.encoded_data is None:
        raise FlagsError("flag --encoded_data must be given")
    files = sorted(glob.glob(os.path.join(
        os.path.expanduser(FLAGS.encoded_data), "training_seqs.tfrecord-*")))
    z, sigma = collect(files, FLAGS.max_vectors)
    log.info("Fitting on %d latent vectors", len(z))

    var = np.var(z, axis=0)
    order = np.argsort(var)[::-1]
    explained = np.cumsum(var[order]) / var.sum()
    log.info("Top-%d dims explain %.1f%% of variance", FLAGS.keep_dims,
             100 * explained[FLAGS.keep_dims - 1])

    os.makedirs(FLAGS.output_path, exist_ok=True)
    out = os.path.join(FLAGS.output_path, FLAGS.name + ".pkl")
    if FLAGS.transform == "slice":
        st = transforms.SliceTransform.fit(z, keep=FLAGS.keep_dims)
        io_lib.save(st.indices.astype(np.int64), out)
    elif FLAGS.transform == "pca":
        io_lib.save(transforms.fit_pca(z, n_components=FLAGS.keep_dims), out)
    else:
        io_lib.save(transforms.sigma_dim_weights(sigma), out)
    log.info("Saved %s transform to %s", FLAGS.transform, out)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
