"""Transform encoded-song TFRecords into training datasets (port of
``scripts/transform_encoded_data.py``).

    python -m smd_tpu_torch.scripts.transform_encoded_data \
        --encoded_data=DIR --output_path=DIR --mode=flatten

Reads ``{training,eval}_seqs.tfrecord-*``, each record a pickled [3, n,
512] array (z, mu, sigma of each latent), without TensorFlow. Modes
``flatten`` (each latent on its own, zero vectors dropped: the 512-d
records the 1-seq flagfiles train on) and ``sequences`` (sliding context
windows and the next latent as target); ``--toy_data`` puts the 2-D toy
mixture in place of each song; shards of ``--shard_size`` examples, as
TFRecords in the reference's example schema or as pickles. ``decoded``
reads ``decoded-{train,eval}.tfrecord-*`` (each record a pickled (n, V)
one-hot token grid), drops songs of fewer than 896 steps, pads the rest to
1024 with the first token, and writes them as token records (a serialized
bool tensor each, ``data/records.serialize_tensor``).
"""
from __future__ import annotations

import glob
import logging
import os
import pickle
import sys

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_boolean("toy_data", False, "Create a toy dataset.")
FLAGS.DEFINE_string("encoded_data", "~/data/encoded_lmd",
                    "Path to encoded data TFRecord directory.")
FLAGS.DEFINE_string("output_path", "./output/transform/", "Output directory.")
FLAGS.DEFINE_integer("shard_size", 2**17, "Number of vectors per shard.")
FLAGS.DEFINE_enum("output_format", "tfrecord", ["tfrecord", "pkl"],
                  "Shard file type.")
FLAGS.DEFINE_enum("mode", "flatten", ["flatten", "sequences", "decoded"],
                  "Transformation mode.")
FLAGS.DEFINE_boolean("remove_zeros", True, "Remove zero vectors.")
FLAGS.DEFINE_integer("context_length", 4,
                     "The length of the context window in a sequence.")
FLAGS.DEFINE_integer("stride", 1, "The stride used for generating sequences.")
FLAGS.DEFINE_integer("max_songs", None, "Maximum number of songs to process.")
FLAGS.DEFINE_integer("max_examples", None,
                     "Maximum number of examples to process.")

log = logging.getLogger("smd_tpu_torch")


def iter_encoded_records(files):
    """The unpickled payload of every record of ``files``, in order."""
    from smd_tpu_torch.data import tfrecord_native
    for path in files:
        for record in tfrecord_native.iter_records(path):
            yield pickle.loads(record)


def _save_shard(contexts, targets, output_path):
    from smd_tpu_torch.data import records
    from smd_tpu_torch.utils import io as io_lib

    if FLAGS.mode in ("flatten", "decoded"):
        dtype = bool if FLAGS.mode == "decoded" else np.float32
        shard_examples = np.stack(targets[:FLAGS.shard_size]).astype(dtype)
        shard_targets = None
        targets = targets[FLAGS.shard_size:]
    else:  # sequences
        shard_examples = np.stack(
            contexts[:FLAGS.shard_size]).astype(np.float32)
        shard_targets = np.stack(
            targets[:FLAGS.shard_size]).astype(np.float32)
        contexts = contexts[FLAGS.shard_size:]
        targets = targets[FLAGS.shard_size:]

    output_path += "." + FLAGS.output_format
    if FLAGS.output_format == "pkl":
        if shard_targets is None:
            io_lib.save(shard_examples, output_path)
        else:
            io_lib.save((shard_examples, shard_targets), output_path)
    else:
        records.write_tfrecord(output_path, shard_examples,
                               targets=shard_targets,
                               tokens=FLAGS.mode == "decoded")
    log.info("Saved to %s", output_path)
    return contexts, targets


def _transform_split(files, split, rng):
    from smd_tpu_torch.data.synthetic import toy_distribution

    contexts, targets = [], []
    count = example_count = songs = discard = 0
    should_terminate = False
    for song_data in iter_encoded_records(files):
        song_embeddings = np.asarray(song_data)
        songs += 1
        if FLAGS.max_songs is not None and songs > FLAGS.max_songs:
            break
        if FLAGS.mode == "decoded":
            song = song_embeddings
            if song.shape[0] < 896:
                discard += 1
                continue
            padding = np.zeros((1024 - song.shape[0], song.shape[-1]))
            padding[:, 0] = 1.0
            song = np.concatenate((song, padding))
            example_count += 1
            targets.append(song)
        elif song_embeddings.ndim != 3 or song_embeddings.shape[0] != 3:
            raise ValueError(f"an encoded song is [3, n, d] (z, mu, sigma), "
                             f"got {song_embeddings.shape}")
        else:
            song = song_embeddings[0]  # z component
        if FLAGS.toy_data:
            song = toy_distribution(batch_size=len(song), rng=rng)

        if FLAGS.mode == "flatten":
            for vec in song:
                if FLAGS.remove_zeros and np.linalg.norm(vec) < 1e-6:
                    continue
                if FLAGS.max_examples is not None and \
                        example_count >= FLAGS.max_examples:
                    should_terminate = True
                    break
                example_count += 1
                targets.append(vec)
        elif FLAGS.mode == "sequences":
            ctx = FLAGS.context_length
            for i in range(0, len(song) - ctx, FLAGS.stride):
                context = song[i:i + ctx]
                if FLAGS.remove_zeros and \
                        (np.linalg.norm(context, axis=1) < 1e-6).any():
                    continue
                if FLAGS.max_examples is not None and \
                        example_count >= FLAGS.max_examples:
                    should_terminate = True
                    break
                example_count += 1
                contexts.append(context)
                targets.append(song[i + ctx])

        if len(targets) >= FLAGS.shard_size:
            contexts, targets = _save_shard(
                contexts, targets, f"{FLAGS.output_path}/{split}-{count:04d}")
            count += 1
        if should_terminate:
            break
    log.info("Discarded %d invalid sequences.", discard)
    if targets:
        _save_shard(contexts, targets,
                    f"{FLAGS.output_path}/{split}-{count:04d}")


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and write the shards."""
    FLAGS(argv)
    if FLAGS.mode == "decoded":
        globs = ("decoded-train.tfrecord-*", "decoded-eval.tfrecord-*")
    else:
        globs = ("training_seqs.tfrecord-*", "eval_seqs.tfrecord-*")
    base = os.path.expanduser(FLAGS.encoded_data)
    rng = np.random.default_rng(0)
    for pattern, split in zip(globs, ("train", "eval")):
        files = sorted(glob.glob(os.path.join(base, pattern)))
        if not files:
            log.warning("No files for split %s (%s)", split, pattern)
            continue
        _transform_split(files, split, rng)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
