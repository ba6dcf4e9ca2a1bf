"""Decode latent TFRecords back into one-hot token grids (port of
``scripts/decode_dataset.py``).

    python -m smd_tpu_torch.scripts.decode_dataset --encoded_data=DIR \\
        --output=./output/decoded

Reads the encoded-song records of ``generate_song_data`` (pickled [3, n,
512] arrays), decodes each song's z through the melody codec on the card
(``--device=cpu`` on the CPU), and writes one record a song, a pickled
boolean (n·32, 90) one-hot array, to ``decoded-{train,eval}.tfrecord-00000``;
without TensorFlow.
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
FLAGS.DEFINE_string("encoded_data", None, "Encoded TFRecord directory.")
FLAGS.DEFINE_string("output", "./output/decoded", "Output directory.")
FLAGS.DEFINE_integer("max_songs", None, "Max songs to decode.")
FLAGS.DEFINE_integer("decode_batch", 128, "Latents per decode batch.")
FLAGS.DEFINE_string("vae_params", "", "Optional pickled MusicVAE params.")
FLAGS.DEFINE_string("device", "cuda",
                    "Device to run on: cuda (the default; raises without a "
                    "GPU) or cpu.")

log = logging.getLogger("smd_tpu_torch")


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and decode; returns
    {split: songs decoded}."""
    from smd_tpu_torch.codec.melody import VOCAB_SIZE
    from smd_tpu_torch.codec.musicvae import TrainedMusicVAE
    from smd_tpu_torch.data import tfrecord_native
    from smd_tpu_torch.data.records import TFRecordWriter
    from smd_tpu_torch.device import resolve_device
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    if not FLAGS.encoded_data:
        raise FlagsError("flag --encoded_data must have a value")
    device = resolve_device(FLAGS.device)
    params = io_lib.load(FLAGS.vae_params) if FLAGS.vae_params else None
    model = TrainedMusicVAE(params=params, device=device)

    base = os.path.expanduser(FLAGS.encoded_data)
    counts = {}
    for pattern, split in (("training_seqs.tfrecord-*", "train"),
                           ("eval_seqs.tfrecord-*", "eval")):
        files = sorted(glob.glob(os.path.join(base, pattern)))
        if not files:
            continue
        out_path = os.path.join(FLAGS.output,
                                f"decoded-{split}.tfrecord-00000")
        count = 0
        with TFRecordWriter(out_path) as writer:
            for record in (r for path in files
                           for r in tfrecord_native.iter_records(path)):
                if FLAGS.max_songs is not None and count >= FLAGS.max_songs:
                    break
                z = np.asarray(pickle.loads(record))[0]
                tokens = []
                for i in range(0, len(z), FLAGS.decode_batch):
                    samples = model.decode_to_tensors(
                        z[i:i + FLAGS.decode_batch])
                    onehot = np.eye(VOCAB_SIZE, dtype=bool)[samples]
                    tokens.append(onehot.reshape(-1, VOCAB_SIZE))
                writer.write(pickle.dumps(np.concatenate(tokens)))
                count += 1
        counts[split] = count
        log.info("Decoded %d songs to %s", count, out_path)
    return counts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
