"""Train the MusicVAE codec on a MIDI corpus (port of
``scripts/train_musicvae.py``).

    python -m smd_tpu_torch.scripts.train_musicvae \\
        --input='corpus/*.mid' --output=./checkpoints/musicvae.pkl

Tokenizes MIDI with the port's converters on a ``spawn`` process pool and
trains ``codec.musicvae.MusicVAE`` with the ELBO (``training.musicvae``) on
``cuda`` (``--device=cpu`` on the CPU; no GPU is an error). The flags are
the JAX script's, with its names, defaults and help, plus ``--device``. The
same ``--seed`` holds out the same chunks and draws the same batches as the
JAX script: both come from one ``np.random.default_rng(seed)``, the batch
indices ``--scan_chunk`` steps at a time. The JAX script runs those steps as
one ``lax.scan`` dispatch (the flag's help, kept as the JAX script's, says
so); here they are one chunk
(``training.musicvae.make_train_chunk``): on the card one step captured in
a CUDA graph and replayed ``--scan_chunk`` times, with the LR and the
scheduled-sampling probability staged per step, on the CPU as many eager
steps; ``--scan_chunk=1`` takes one eager step at a time.

Held-out evaluation reports the teacher-forced token accuracy and the
free-running round-trip accuracy (encode, decode the posterior mean at
temperature 1e-3), over every row and over the non-PAD rows. The artifact
is ``{"params": Flax-layout tree, "config": MusicVAEConfig, "metrics"}``,
float16 leaves unless ``--nohalf_precision_artifact``: the JAX package's
``TrainedMusicVAE`` reads it, and ``--init_from`` reads the JAX script's.
"""
from __future__ import annotations

import concurrent.futures
import glob
import logging
import multiprocessing
import os
import sys
import time

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_string("input", None, "Glob of input MIDI files.")
FLAGS.DEFINE_enum("mode", "melody", ["melody", "melody16", "multi"],
                  "melody: 2-bar monophonic chunks (cat-mel_2bar family). "
                  "melody16: 16-bar chunks with a 16-segment hierdec "
                  "conductor (hierdec-mel_16bar family). "
                  "multi: 1-bar multi-instrument performance-event chunks "
                  "(hier-multiperf family, 8-segment conductor).")
FLAGS.DEFINE_string("output", "./checkpoints/musicvae.pkl",
                    "Output params pickle.")
FLAGS.DEFINE_integer("batch_size", 64, "Batch size.")
FLAGS.DEFINE_integer("steps", 2000, "Training steps.")
FLAGS.DEFINE_float("learning_rate", 1e-3, "Peak learning rate.")
FLAGS.DEFINE_integer("warmup_steps", 200, "LR warmup steps.")
FLAGS.DEFINE_float("beta", 0.2, "KL weight.")
FLAGS.DEFINE_float("free_bits", 48.0, "Free bits for the KL term.")
FLAGS.DEFINE_integer("latent_dims", 512, "Latent dims.")
FLAGS.DEFINE_integer("enc_units", 512, "Encoder LSTM units.")
FLAGS.DEFINE_integer("dec_units", 512, "Decoder LSTM units per layer.")
FLAGS.DEFINE_integer("dec_layers", 2, "Decoder LSTM layers.")
FLAGS.DEFINE_integer("conductor_units", 512,
                     "Conductor LSTM units (multi mode).")
FLAGS.DEFINE_integer("conductor_layers", 2,
                     "Conductor LSTM layers (multi mode).")
FLAGS.DEFINE_integer("log_every", 100, "Logging frequency.")
FLAGS.DEFINE_integer("scan_chunk", 25,
                     "Optimizer steps fused into one dispatch via lax.scan "
                     "(amortizes remote-accelerator round-trips; 1 = one "
                     "dispatch per step).")
FLAGS.DEFINE_integer("seed", 0, "PRNG seed.")
FLAGS.DEFINE_float("eval_frac", 0.05, "Held-out fraction for evaluation.")
FLAGS.DEFINE_integer("eval_batches", 8, "Eval batches per evaluation.")
FLAGS.DEFINE_boolean("half_precision_artifact", True,
                     "Save params as float16 (halves the artifact size; "
                     "restored to float32 at load).")
FLAGS.DEFINE_integer("parse_workers", 8, "Processes for MIDI parsing.")
FLAGS.DEFINE_string("chunk_cache", "",
                    "Optional .npy path: load parsed chunks from it when it "
                    "exists, otherwise parse --input and save there first "
                    "(amortizes the MIDI parse across runs and lets it run "
                    "on CPU while the accelerator is busy).")
FLAGS.DEFINE_boolean("parse_only", False,
                     "Exit right after writing --chunk_cache (no training).")
FLAGS.DEFINE_float("scheduled_sampling", 0.0,
                   "Final scheduled-sampling probability (ramped linearly "
                   "over the first half of training). Feeds the decoder its "
                   "own samples during teacher forcing so free-running "
                   "decode does not drift.")
FLAGS.DEFINE_boolean("keep_best", True,
                     "Ship the params with the best held-out round-trip "
                     "accuracy seen at any eval, not the final step's. Large "
                     "decoders overfit the corpus late in training (measured: "
                     "the 134M cat-mel_2bar_big peaked at step 6k and "
                     "declined for the remaining 24k steps); the best-eval "
                     "snapshot is the artifact users actually want.")
FLAGS.DEFINE_string("init_from", "",
                    "Optional codec pickle to initialize params from "
                    "(fine-tune a shipped artifact on fresh data). The "
                    "architecture flags must match the pickled config; "
                    "fp16 artifacts are restored to fp32.")
FLAGS.DEFINE_boolean("scheduled_sampling_ramp", True,
                     "Ramp scheduled sampling linearly over the first half "
                     "of training (the from-scratch recipe). Set false when "
                     "fine-tuning with --init_from a model already trained "
                     "with scheduled sampling: re-ramping from 0 would spend "
                     "half the run re-learning the teacher-forced regime.")
FLAGS.DEFINE_string("device", "cuda",
                    "Device to run on: cuda (the default; raises without a "
                    "GPU) or cpu.")

log = logging.getLogger("smd_tpu_torch")

# The config fields a fine-tune must share with its --init_from bundle: the
# LSTM and conductor params do not depend on max_seq_len or hier_segments,
# so the shapes alone cannot catch a different chunk length or segment
# count.
ARCH_FIELDS = ("latent_dims", "enc_units", "dec_units", "depth",
               "max_seq_len", "hier_segments", "conductor_units",
               "conductor_layers")


def _parse_one(path):
    """Worker: MIDI file -> list of (32,) uint8 2-bar melody token rows."""
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec.melody import (extract_melodies,
                                            melody_2bar_converter)
    try:
        ns = midi_io.read_midi_file(path)
    except Exception:
        return []
    out = []
    for melody in extract_melodies(ns):
        out.extend(t.argmax(-1).astype(np.uint8) for t in
                   melody_2bar_converter.to_tensors(melody).inputs[::2])
    return out


def _parse_one_16(path):
    """Worker: MIDI file -> list of (256,) uint8 16-bar melody token rows."""
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec.melody import extract_melodies
    from smd_tpu_torch.config import melody_16bar_converter
    try:
        ns = midi_io.read_midi_file(path)
    except Exception:
        return []
    out = []
    for melody in extract_melodies(ns):
        out.extend(t.argmax(-1).astype(np.uint8) for t in
                   melody_16bar_converter.to_tensors(melody).inputs[::16])
    return out


def _parse_one_multi(path):
    """Worker: MIDI file -> list of (512,) uint16 performance-event id
    rows."""
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec.performance import (
        multiperf_default_1bar_converter)
    try:
        ns = midi_io.read_midi_file(path)
    except Exception:
        return []
    return [t.argmax(-1).astype(np.uint16)
            for t in multiperf_default_1bar_converter.to_tensors(ns).inputs]


def load_tensors(files, workers=8, mode="melody"):
    """The token rows of every file, stacked (None when there are none);
    parsed on a ``spawn`` pool of ``workers`` processes, in the calling
    process for fewer than 16 files or ``workers <= 1``."""
    parse = {"melody": _parse_one, "melody16": _parse_one_16,
             "multi": _parse_one_multi}[mode]
    tensors = []
    if workers <= 1 or len(files) < 16:
        for path in files:
            tensors.extend(parse(path))
    else:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            for chunk in pool.map(parse, files, chunksize=16):
                tensors.extend(chunk)
    return np.stack(tensors) if tensors else None


def model_config(mode, data):
    """The mode's ``MusicVAEConfig`` from the flags and the corpus rows."""
    from smd_tpu_torch.codec.melody import VOCAB_SIZE
    from smd_tpu_torch.codec.musicvae import MusicVAEConfig
    common = dict(latent_dims=FLAGS.latent_dims, enc_units=FLAGS.enc_units,
                  dec_units=(FLAGS.dec_units,) * FLAGS.dec_layers,
                  max_seq_len=data.shape[1], free_bits=FLAGS.free_bits,
                  beta=FLAGS.beta)
    if mode == "multi":
        from smd_tpu_torch.codec.performance import (
            multiperf_default_1bar_converter as conv)
        return MusicVAEConfig(
            depth=conv.depth, hier_segments=conv.max_num_instruments,
            conductor_units=FLAGS.conductor_units,
            conductor_layers=FLAGS.conductor_layers, **common)
    if mode == "melody16":
        return MusicVAEConfig(
            depth=VOCAB_SIZE, hier_segments=16,
            conductor_units=FLAGS.conductor_units,
            conductor_layers=FLAGS.conductor_layers, **common)
    depth = VOCAB_SIZE if data.ndim == 2 else data.shape[-1]
    return MusicVAEConfig(depth=depth, **common)


def load_init(path, model, cfg):
    """The params tree of the codec bundle at ``path`` (float16 leaves
    restored to float32), checked against ``model``'s shapes and ``cfg``'s
    architecture fields; raises the JAX script's errors."""
    from smd_tpu_torch.codec.musicvae import normalize_params
    from smd_tpu_torch.utils import io as io_lib
    from smd_tpu_torch.utils.flax_params import flatten
    bundle = io_lib.load(path)
    loaded = {n: np.asarray(v, np.float32)
              if np.asarray(v).dtype == np.float16 else np.asarray(v)
              for n, v in flatten(normalize_params(
                  bundle["params"])).items()}
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if want != {n: v.shape for n, v in loaded.items()}:
        raise ValueError(
            f"--init_from={path} does not match the architecture flags "
            "(param tree shapes differ)")
    old_cfg = bundle.get("config")
    if old_cfg is not None:
        diffs = [
            f"{f}: checkpoint={getattr(old_cfg, f)!r} flags="
            f"{getattr(cfg, f)!r}"
            for f in ARCH_FIELDS
            if hasattr(old_cfg, f) and getattr(old_cfg, f) != getattr(cfg, f)]
        if diffs:
            raise ValueError(
                f"--init_from={path} was trained with a different "
                "architecture/problem than the current flags and corpus: " +
                "; ".join(diffs))
    return loaded


def split_corpus(n, seed, batch_size, eval_frac):
    """(numpy generator, held-out indices, training indices): the JAX
    script's split, from the generator that then draws the batches."""
    rng_np = np.random.default_rng(seed)
    perm = rng_np.permutation(n)
    n_eval = max(batch_size, int(n * eval_frac)) if eval_frac else 0
    # Never let the eval split consume the training data (tiny corpora).
    n_eval = min(n_eval, max(n - batch_size, 0))
    return rng_np, perm[:n_eval], perm[n_eval:]


def ss_probs(step, k_steps):
    """Each step's scheduled-sampling probability, float32 as the JAX
    script hands them to its scan: linear over the first half of training
    unless ``--noscheduled_sampling_ramp``."""
    return [float(np.float32(FLAGS.scheduled_sampling * (min(
        1.0, (step + j) / max(FLAGS.steps // 2, 1))
        if FLAGS.scheduled_sampling_ramp else 1.0)))
        for j in range(k_steps)]


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program), train and save; returns
    a dict: ``metrics`` (as saved), ``eval_index`` (the held-out chunks),
    ``batch_indices`` (each step's batch, indices into the training
    chunks), ``losses`` (each step's ELBO), ``step_seconds`` (wall time in
    the optimizer steps, the card synchronized), ``config`` and
    ``output``; None with ``--parse_only``."""
    import torch

    from smd_tpu_torch.codec.musicvae import build_musicvae
    from smd_tpu_torch.device import resolve_device
    from smd_tpu_torch.training import musicvae as mvtrain
    from smd_tpu_torch.utils import io as io_lib
    from smd_tpu_torch.utils.flax_params import load_flax_params, to_flax_tree

    FLAGS(argv)
    if not FLAGS.input:
        raise FlagsError("flag --input must have a value")
    device = resolve_device(FLAGS.device)
    t0 = time.time()
    if FLAGS.chunk_cache and os.path.exists(FLAGS.chunk_cache):
        data = np.load(FLAGS.chunk_cache)
        log.info("Loaded %d %s chunks from %s in %.1fs", len(data),
                 FLAGS.mode, FLAGS.chunk_cache, time.time() - t0)
    else:
        files = sorted(glob.glob(os.path.expanduser(FLAGS.input),
                                 recursive=True))
        data = load_tensors(files, FLAGS.parse_workers, FLAGS.mode)
        if data is None:
            raise ValueError("No chunks extracted from input")
        log.info("Parsed %d files -> %d %s chunks in %.1fs", len(files),
                 len(data), FLAGS.mode, time.time() - t0)
        if FLAGS.chunk_cache:
            np.save(FLAGS.chunk_cache, data)
            log.info("Chunk cache written to %s", FLAGS.chunk_cache)
    if FLAGS.parse_only:
        return None
    ids_input = data.ndim == 2   # token ids, one-hot on the device

    B = FLAGS.batch_size
    rng_np, eval_index, train_index = split_corpus(
        len(data), FLAGS.seed, B, FLAGS.eval_frac)
    eval_data, train_data = data[eval_index], data[train_index]
    log.info("train %d / eval %d chunks", len(train_data), len(eval_data))

    cfg = model_config(FLAGS.mode, data)
    model = build_musicvae(cfg, seed=FLAGS.seed, device=device)
    if FLAGS.init_from:
        load_flax_params(model, load_init(FLAGS.init_from, model, cfg))
        log.info("Initialized params from %s (fine-tune)", FLAGS.init_from)
    model.train().requires_grad_(True)
    params = dict(model.named_parameters())
    log.info("MusicVAE %s: %.1fM params", cfg,
             sum(p.numel() for p in params.values()) / 1e6)
    opt = mvtrain.make_optimizer(FLAGS.learning_rate, FLAGS.warmup_steps,
                                 FLAGS.steps)
    opt_state = opt.init(params)
    generator = torch.Generator(device=device).manual_seed(FLAGS.seed)

    def to_device(rows):
        return torch.from_numpy(np.ascontiguousarray(rows)).to(device)

    def evaluate():
        """Mean (tf, fr, tf non-PAD, fr non-PAD) accuracy over up to
        ``--eval_batches`` held-out batches."""
        accs = []
        for b in range(min(FLAGS.eval_batches, len(eval_data) // B)):
            out = mvtrain.eval_step(model, to_device(
                eval_data[b * B:(b + 1) * B]), generator)
            accs.append([float(out[k]) for k in (
                "tf_acc", "fr_acc", "tf_acc_nonpad", "fr_acc_nonpad")])
        return [float(np.mean(col)) for col in zip(*accs)]

    def snapshot():
        return {n: p.detach().clone() for n, p in params.items()}

    can_eval = len(eval_data) >= B
    n = len(train_data)
    chunk = max(1, min(FLAGS.scan_chunk, FLAGS.log_every))
    train_chunk = None if chunk == 1 else mvtrain.make_train_chunk(
        model, opt, opt_state, generator, FLAGS.scheduled_sampling > 0)
    step, step_seconds = 0, 0.0
    losses, batch_indices = [], []
    # (best_metric, step, params) — see --keep_best.
    best = (-1.0, 0, None)
    if FLAGS.init_from and FLAGS.keep_best and can_eval:
        # The starting checkpoint's own score seeds keep_best, so a
        # regressive fine-tune never ships an artifact worse than its input.
        tf0, fr0, tf0_np, fr0_np = evaluate()
        sel0 = fr0_np if ids_input else fr0
        best = (sel0, 0, snapshot())
        log.info("init_from baseline: round-trip %.4f seeded as the "
                 "keep_best candidate", sel0)
    t_train = time.time()
    while step < FLAGS.steps:
        k_steps = min(chunk, FLAGS.steps - step)
        idx = rng_np.integers(0, n, (k_steps, B))
        t_chunk = time.perf_counter()
        if train_chunk is not None:
            rows = train_chunk(train_data[idx], ss_probs(step, k_steps))
            losses.append(rows["loss"])
            loss, aux = rows["loss"][-1], {k: rows[k][-1]
                                           for k in ("rec", "kl")}
        else:
            loss, aux = mvtrain.train_step(model, opt, opt_state,
                                           to_device(train_data[idx[0]]),
                                           ss_probs(step, 1)[0], generator)
            losses.append(loss.reshape(1))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_seconds += time.perf_counter() - t_chunk
        batch_indices.extend(idx)
        step += k_steps
        if (step - k_steps) % FLAGS.log_every < k_steps:
            msg = (f"step {step} | elbo {float(loss):.3f} | "
                   f"rec {float(aux['rec']):.3f} | kl {float(aux['kl']):.3f}"
                   f" | {step / max(time.time() - t_train, 1e-9):.1f} "
                   "steps/s")
            if can_eval:
                tf_acc, fr_acc, tf_np, fr_np = evaluate()
                msg += (f" | eval tf_acc {tf_acc:.4f} | "
                        f"eval roundtrip_acc {fr_acc:.4f}")
                if ids_input:
                    msg += (f" | nonpad tf {tf_np:.4f} | "
                            f"nonpad roundtrip {fr_np:.4f}")
                sel = fr_np if ids_input else fr_acc
                if FLAGS.keep_best and sel > best[0]:
                    best = (sel, step, snapshot())
            log.info("%s", msg)
    if train_chunk is not None:
        train_chunk.close()

    metrics = {}
    if can_eval:
        tf_acc, fr_acc, tf_np, fr_np = evaluate()
        final_sel = fr_np if ids_input else fr_acc
        if FLAGS.keep_best and best[2] is not None and best[0] > final_sel:
            log.info("keep_best: shipping step-%d params (round-trip %.4f) "
                     "over final step-%d (%.4f)", best[1], best[0], step,
                     final_sel)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(best[2][name])
            tf_acc, fr_acc, tf_np, fr_np = evaluate()
            metrics["best_step"] = int(best[1])
        metrics.update({"eval_teacher_forced_acc": tf_acc,
                        "eval_roundtrip_acc": fr_acc,
                        "eval_chunks": int(len(eval_data)),
                        "train_chunks": int(len(train_data))})
        if ids_input:
            metrics["eval_teacher_forced_acc_nonpad"] = tf_np
            metrics["eval_roundtrip_acc_nonpad"] = fr_np
        log.info("FINAL eval: teacher-forced acc %.4f | round-trip acc %.4f",
                 tf_acc, fr_acc)
        if ids_input:
            log.info("FINAL eval (non-PAD rows): teacher-forced %.4f | "
                     "round-trip %.4f", tf_np, fr_np)

    tree = to_flax_tree(model)
    if FLAGS.half_precision_artifact:
        def half(node):
            return {k: half(v) if isinstance(v, dict) else
                    (v.astype(np.float16) if v.dtype == np.float32 else v)
                    for k, v in node.items()}
        tree = half(tree)
    io_lib.save({"params": tree, "config": cfg, "metrics": metrics},
                os.path.abspath(FLAGS.output))
    log.info("Saved MusicVAE params to %s", FLAGS.output)
    return {"metrics": metrics, "eval_index": eval_index,
            "batch_indices": np.asarray(batch_indices),
            "losses": torch.cat(losses).cpu().numpy(),
            "step_seconds": step_seconds, "config": cfg,
            "output": FLAGS.output}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
