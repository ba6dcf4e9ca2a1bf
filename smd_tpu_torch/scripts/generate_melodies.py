"""Generate melodies from a generation bundle: noise -> latents -> MIDI
(port of ``scripts/generate_melodies.py``).

    python -m smd_tpu_torch.scripts.generate_melodies --n=8 \\
        --output_dir=./melodies
    python -m smd_tpu_torch.scripts.generate_melodies --sampler=dpmpp \\
        --steps=8 --device=cpu

Loads a bundle of either package's ``package_generation_bundle`` (model,
schedule, slice transform, normalization), builds the model from its
``arch`` (bf16 on the card, float32 on the CPU, as the JAX package's
``load_model_fn``), samples latent sequences with ``consistency`` (the
bundle's consistency pack), ``dpmpp``, ``ddim`` or ``ancestral`` from one
seeded generator, inverts the data transform, decodes each sequence
through the MusicVAE codec (the shipped melody codec, or
``--vae_params``) and writes ``melody_{i:03d}.mid``.
"""
from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np

from smd_tpu_torch.cli import Flags, FlagsError

FLAGS = Flags()
FLAGS.DEFINE_string("bundle", "./checkpoints/melody-diffusion.pkl",
                    "Generation bundle (package_generation_bundle).")
FLAGS.DEFINE_string("output_dir", "./melodies", "Directory for .mid files.")
FLAGS.DEFINE_integer("n", 8, "Number of melodies to generate.")
FLAGS.DEFINE_enum("sampler", "consistency",
                  ["consistency", "dpmpp", "ddim", "ancestral"],
                  "Sampling algorithm.")
FLAGS.DEFINE_integer("steps", 0,
                     "Sampler steps (0 = per-sampler default: consistency "
                     "2, dpmpp 8, ddim 50, ancestral = full schedule).")
FLAGS.DEFINE_integer("seed", 0, "Sampling seed.")
FLAGS.DEFINE_string("vae_params", "",
                    "Optional pickled MusicVAE params (default: the shipped "
                    "melody codec).")
FLAGS.DEFINE_integer("checkpoint_seed", 0,
                     "Seed for VAE weights when no shipped codec exists.")
FLAGS.DEFINE_float("temperature", 1e-3, "Decode temperature.")
FLAGS.DEFINE_string("device", "cuda",
                    "Device to run on: cuda (the default; raises without a "
                    "GPU) or cpu.")

log = logging.getLogger("smd_tpu_torch")


def load_model_fn(bundle, which="params", device=None):
    """A serving closure (x, cond) -> float32 over the bundle's params
    (``which="consistency"``: its consistency pack's): the model computes
    in bf16 with bf16 params on the card, in float32 on the CPU."""
    import torch

    from smd_tpu_torch.device import resolve_device
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import load_flax_params

    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    arch = dict(bundle["arch"])
    model = get_model(arch.pop("architecture"), device=device,
                      data_channels=bundle["sample_shape"][-1], dtype=dtype,
                      **arch)
    load_flax_params(model, bundle["params"] if which == "params"
                     else bundle["consistency"]["params"])
    model = model.to(dtype).eval().requires_grad_(False)
    return lambda x, cond: model(x.to(dtype), cond.to(dtype)).float()


def main(argv):
    """Parse ``argv`` (``argv[0]`` is the program) and generate; returns the
    paths of the MIDI files written."""
    import torch

    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec import song as song_lib
    from smd_tpu_torch.codec.musicvae import TrainedMusicVAE
    from smd_tpu_torch.data import transforms
    from smd_tpu_torch.device import resolve_device
    from smd_tpu_torch.diffusion import samplers, schedules
    from smd_tpu_torch.utils import io as io_lib

    FLAGS(argv)
    device = resolve_device(FLAGS.device)
    if not os.path.exists(FLAGS.bundle):
        raise SystemExit(
            f"No generation bundle at {FLAGS.bundle}. Train one with the "
            "offline pipeline (generate_song_data -> "
            "generate_compressed_transform -> transform_encoded_data -> "
            "train_ncsn [--distill --distill_mode=ct]) and pack it with "
            "package_generation_bundle.")
    bundle = io_lib.load(FLAGS.bundle)
    shape = tuple(bundle["sample_shape"])
    sched = bundle["schedule"]
    betas = schedules.noise_schedule(sched["sigma_begin"], sched["sigma_end"],
                                     sched["num_sigmas"], kind=sched["kind"])

    generator = torch.Generator(device=device).manual_seed(FLAGS.seed)
    init = torch.randn((FLAGS.n, *shape), generator=generator, device=device)

    t0 = time.time()
    with torch.no_grad():
        if FLAGS.sampler == "consistency":
            if not bundle.get("consistency"):
                raise SystemExit(
                    f"{FLAGS.bundle} carries no consistency pack; re-train "
                    "with train_ncsn --distill --distill_mode=ct or use "
                    "--sampler=dpmpp/ddim/ancestral.")
            model_fn = load_model_fn(bundle, "consistency", device)
            out = samplers.consistency_dynamics(
                generator, model_fn, np.asarray(bundle["consistency"]["grid"]),
                init, num_steps=FLAGS.steps or 2)
        else:
            model_fn = load_model_fn(bundle, "params", device)
            if FLAGS.sampler == "dpmpp":
                out = samplers.dpmpp_dynamics(generator, model_fn, betas,
                                              init,
                                              num_steps=FLAGS.steps or 8)
            elif FLAGS.sampler == "ddim":
                out = samplers.ddim_dynamics(generator, model_fn, betas, init,
                                             num_steps=FLAGS.steps or 50,
                                             collect_steps=0)
            else:
                out = samplers.diffusion_dynamics(generator, model_fn, betas,
                                                  init, collect_steps=0,
                                                  collect_metrics=False)
        generated = out.state.cpu().numpy()
    log.info("Sampled %d sequences (%s) in %.2fs", FLAGS.n, FLAGS.sampler,
             time.time() - t0)

    latents = transforms.inverse_data_transform(
        generated, bundle["normalize"], None, bundle["data_min"],
        bundle["data_max"], bundle["slice_idx"],
        out_channels=bundle["out_channels"],
        rng=np.random.default_rng(FLAGS.seed))

    vae_params = io_lib.load(FLAGS.vae_params) if FLAGS.vae_params else None
    codec = TrainedMusicVAE(params=vae_params, seed=FLAGS.checkpoint_seed,
                            device=device)
    if codec.random_weights:
        log.warning("No shipped MusicVAE artifact found: decoding with "
                    "RANDOM codec weights (shape-valid MIDI, not music).")

    os.makedirs(FLAGS.output_dir, exist_ok=True)
    paths = []
    for i in range(FLAGS.n):
        song = song_lib.embeddings_to_song(
            latents[i].astype(np.float64), codec, codec.converter,
            temperature=FLAGS.temperature)
        path = os.path.join(FLAGS.output_dir, f"melody_{i:03d}.mid")
        midi_io.write_midi_file(song.note_sequence, path)
        paths.append(path)
        log.info("Wrote %s (%d notes)", path, len(song.note_sequence.notes))
    log.info("Done: %d melodies in %s (total %.2fs)", FLAGS.n,
             FLAGS.output_dir, time.time() - t0)
    return paths


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        main(sys.argv)
    except FlagsError as e:
        sys.exit(f"FATAL Flags parsing error: {e}")
