#!/usr/bin/env python3
"""Drive the smd_tpu_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main paths are the flagship TransformerDDPM (6 layers, 8 heads, embed
128, MLP 2048, two FiLM resblocks of width 2048) at bf16, served by the
1000-step DDPM ancestral sampler and by the few-step samplers, in three
layouts: on sequences of 32x42
latents (``bench.py``'s workload at a batch of 64 requests) the fused
serving layout, and the standard einsum trunk with the int8 head
(``quantized_head_kernel``, ``bench.py``'s ``BENCH_QUANT_KERNEL=1``); and on
sequences of 512x42 latents (a 1024-bar piece of two-bar chunks, 16
requests) the standard layout, whose attention layers route S >= 512 to the
flash-attention kernel, as the JAX package's do on an accelerator.
Phases, one flushed line each with its seconds:

1. device: needs ``torch.cuda.is_available()``; prints nvidia-smi's card
   name and power limit.
2. build: builds (or finds) the CUDA kernels with nvcc; prints ptxas's
   registers, shared memory and spills for the redesigned kernels (film,
   flash, the tensor-core attention, the w8a8 product and its quantize
   pass), and any spill or serialized wgmma in any kernel.
3. kernels: each kernel at the sampler's shapes (B=1000, or for flash
   attention B=64 and B=16 at S=512, B=32 at S=1024, causal, the packed
   B=1000 S=32 call, and float32 at B=64 and causal at the MDN's B=16
   S=512) against its plain PyTorch version, plus small float32
   cases; times the kernel, the plain version and a one-call PyTorch
   yardstick per eager call between CUDA events (the records' times), and
   the kernel and the yardstick also as calls captured in a CUDA graph and
   replayed (device time alone, no host launch); every kernel beside its
   first version's time; the bench-shape attention call must take the
   tensor-core kernel.
4. model: one fused flagship call on 64x32x42 through the kernels against
   the same call through the plain versions; the launch counts rise by 6
   and 4.
5. serve: ``generate.sample(sampling="ddpm")`` with T=1000 on 64 requests,
   twice, as two requests of one shape: the first call captures the step
   in a CUDA graph after 2 eager warm-up steps (``utils/graphs.py``; the
   counts rise by 1002 model calls' 6 and 4), the second replays it, timed
   (by 6000 and 4000), every attention launch on the tensor-core kernel; a
   20-step run through the kept graph matches one through the plain
   versions, run eagerly, with the same generator. Every serve phase
   (5, 7, 9, 11, 14, 15, 18–19, 21–22, 23b, 24c) times the second call of
   a shape and prints the first call's seconds beside.
6. int8 model: the flagship's standard-layout weights from a seed,
   quantized with ``quantize_head_params`` and calibrated on the card with
   ``calibrate_head_act_scales``, float leaves cast to bf16; one call on
   64x32x42 through the w8a8 kernel against the plain version; the w8a8
   count rises by 4.
7. int8 serve: as 5 with the int8 model; the w8a8 count rises by 4000
   and the weights are transposed no time (the model keeps their K-major
   copies).
8. standard model: the flagship's standard-layout weights from a seed,
   cast to bf16; one call on 16x512x42 through the flash kernel against the
   plain version, the flash count rising by 6; one call on 64x32x42, which
   takes the einsum and launches nothing.
9. standard serve: as 5 on 16 requests of 512x42; the flash count rises by
   6000 (6012 at the first call).

10. train: ``python -m smd_tpu_torch.train_ncsn``'s ``main`` with
    ``configs/ddpm-mel-32seq-512.cfg`` (the flagship, batch 64, T=1000
    linear betas, standard layout, float32) on seeded latents of 32x512
    written as TFRecords (1,280 train, 128 eval examples) with the
    flagship's 42-index slice: 200 steps with evaluations and checkpoints
    at 100 and 200; every loss finite, the last 20 steps' mean below the
    first step's; then resumed to 250, which must start at step 200.
11. serve the checkpoint: ``restore_state_for_sampling`` and
    ``serving_model_fn`` (bf16 on the card) on 64 requests of 32x42
    through the 1000-step DDPM sampler; finite output.
12. mixed precision: 40 steps with ``--mixed_precision`` (bf16 compute,
    float32 params).
13. fused training: the trained params in the fused layout at bf16, batch
    64: one loss gradient through the kernels and one through the plain
    versions, every parameter's gradient present, finite and within the
    stated tolerance; then 25 optimizer steps through the kernels, whose
    forward launches 6 attention and 4 film kernels a step.
    Phases 10, 12 and 13 print wall ms/step next to the card's name and
    power limit.

14. few-step serve: ``generate.sample`` through the fused flagship on 1000
    requests of 32x42 (``bench.py``'s few-step rows, T=1000 linear betas):
    DDIM-50, DPM++-8, distilled on ``distill_grid(betas, 2)`` and
    consistency-1 on ``distill_grid(betas, 32)``, each timed; the counts
    rise by 6 and 4 a model call, every attention launch on the
    tensor-core kernel; each chain through the kernels against the same
    chain through the plain versions (run eagerly: each call's gap is read
    back), same generator, within CHAIN_RTOL of its norm, and every model
    call of the plain chain through the kernels on the same input within
    CALL_RTOL. Then ``generate.interpolate`` on a 20-step schedule (9
    interpolants of 64 pairs, the 9 chains replaying one graph).
15. few-step int8 and flash: DDIM-50 through the int8 flagship (1000
    requests; 200 w8a8 launches, no w_q transpose) and DPM++-8 through the
    standard flagship at 16 x 512x42 (48 flash launches), each against its
    plain chain.
16. distillation: from phase 10's params in the fused layout at bf16,
    ``progressive_distill`` 8 -> 4 -> 2 (20 steps a stage; the teacher
    twice and the student once a step: 18 attention and 12 film launches)
    and 20 ``consistency_distill`` steps (N=32; teacher twice, target,
    student: 24 and 16 a step), both at their default ``scan_chunk`` (50):
    each stage's steps one chunk, the step captured in a CUDA graph once
    a stage after 2 eager warm-up steps (whose launches count) and
    replayed; every logged loss finite; the 2-step and
    1-step students' samples finite; the distillation loss's gradient
    through the kernels against the plain versions at three draw seeds,
    with and without the x0 clip, the worst and the median parameter
    (DISTILL_GRAD_RTOL); then with a one-ulp fault planted in the film
    kernel's output, which the median check must catch.
17. the CLIs: ``train_ncsn --distill`` (progressive 8 -> 2, consistency,
    ct) on phase 10's checkpoint and TFRecords, its bundles written; then
    ``sample_ncsn`` with ddim-50, dpmpp-8 with ``--infill`` (the 8 edge
    latents kept), distilled-2 and consistency-1, 64 requests each, each
    ``ncsn/generated.pkl`` finite and of the right shape.

18. dense DDPM: ``configs/ddpm-mel-1seq-512.cfg`` (DenseDDPM, 6 x 2048,
    batch 64, T=1000) trained 40 steps on seeded 512-d latents written as
    TFRecords (2,560 train, 1,024 eval): every loss finite, the last 10
    steps' mean below the first; one float32 forward on the card against
    the same model on the CPU (CPU_RTOL); the checkpoint served through
    ``sample_ncsn``, 1000 DDPM steps on 1000 requests.
19. NCSN: ``configs/ncsn-mel-1seq-512.cfg`` (DenseNCSN 6 x 2048, DSM, 500
    sigmas from 15, batch 128) trained 40 steps, the loss falling, with the
    flagfile's ``--snapshot_sampling`` (ALD on 256 samples, 2 steps a
    level: ``samples/{init,real,fake}/40.pkl`` written, figures skipped
    with a log line where matplotlib does not import); 5 SSM
    steps of the same network (a double backward), finite loss and
    gradient norm; ``sample_ncsn --sampling=cas`` at the 500 levels and
    ``--sampling=ald`` at the 500 levels with ``--ld_steps`` cut from 100
    to 10, 1000 requests each, with ms per model call (``generate.sample``
    called twice inside the CLI, the generator put back between: the
    second call, a replay, timed).
20. ConvNCSN forward and backward on 64x32x42 against the CPU; the toy
    flagfiles ``mixture-single-2.cfg`` (ToyNCSN, SSM, continuous noise)
    and ``mixture-single-ddpm-2.cfg`` (ToyDDPM) trained 20 steps each on
    the 2-D mixture. No kernel launches in phases 18-20: these networks
    run the plain ``DenseResBlock``, as the JAX package's do.

21. MDN: ``python -m smd_tpu_torch.train_mdn``'s ``main`` with
    ``configs/mdn-mel-32seq-512.cfg`` (TransformerMDN: 6 causal layers, 8
    heads, 2 x 2048 resblocks, 100 mixtures, batch 128, float32) on seeded
    32x512 latents (1,280 train, 1,024 eval) with the flagship's slice:
    60 steps with evaluations and checkpoints at 30 and 60, every loss
    finite, the last 10 steps' mean below the first step's; resumed to 70,
    which must start at step 60; then ``sample_mdn``'s ``main`` on 1000
    requests, KV-cached (flushing ``mdn/{real,generated}.pkl``) and
    ``--nocached_decode``, with ``--nll_gate=warn``: both gate readings
    printed, the samples finite and (1000, 32, 42), each decode timed
    between two synchronizes. S=32 takes the einsum: no launches.
22. MDN at 512 positions: the same width built directly (weights from a
    seed, ``max_decode_length=512``) on 16 x 512x42: one teacher-forced
    float32 call through the causal flash kernel against the plain
    version (the flash count rising by 6), the same at bf16 compute (trunk
    and resblock params in bf16, the head in float32); one NLL gradient
    through the kernel against the plain version, every parameter
    present; a few float32 optimizer steps; ``ar_decode`` at bf16 (512
    full forwards, 511 of them replays of the captured step: 512 x 6 flash
    launches, 514 x 6 at the first call) and ``ar_decode_cached`` (no
    launch).

23. codec and generation. (a) The MusicVAE codec ``melody-2-big`` at full
    width (BiLSTM-2048 encoder, 3 x 2048 LSTM decoder, 512-d latent,
    vocabulary 90) with float32 weights from a seed: 2,048 two-bar chunks
    of 64 seeded pieces, tokenized by the port's converter, encoded and
    their mu decoded at temperature 1e-3, float32 and at bf16 compute, each
    shape served twice as ``_serve_twice`` serves a sampler (the first
    call captures the codec chain's graph, the second replays it and
    captures nothing), in chunks/s between two synchronizes; the decode
    replayed under the profiler at 64 and 2,048 chunks and the encode at
    2,048 (host launches, device operations, wall and device-busy ms a
    step, idle share); on 64 chunks
    the card against the same model on the CPU: mu, sigma and the
    teacher-forced logits within CODEC_RTOL of the norm, and free-running
    tokens with the same Gumbel draws equal up to each row's first near
    tie (CODEC_MARGIN); then 64 latents through ``melody-16-big`` and
    ``multi-1-big``, weights from a seed, each served twice (the
    conductor's and the decoder's graphs) and replayed under the
    profiler. (b) The fused flagship (phase 4's
    weights, bf16) samples 64 requests of 32x42 with DPM++-8 (film +4 and
    attention +6 a model call, all on the tensor-core kernel); the latents
    inverse-transformed through a seeded 42-index slice to 512 dims and
    decoded by (a)'s codec into 64 MIDI files, each read back with one
    note per note-on token. (c) ``generate_melodies`` on a bundle of the
    port's writer (the standard flagship from a seed, 512x42) with
    ``--sampler=dpmpp --steps=8 --n=4``: flash +60 (8 steps and the 2
    warm-up steps of its one call's capture), 2,048 chunks decoded,
    4 MIDI files read back likewise; ``generate_song_data`` on 16 seeded
    MIDI files and ``decode_dataset`` on its records, every record finite
    and of its shape.

24. codec training and the quality path. (a) ``train_musicvae.main`` at
    the shipped ``melody-2-big`` width (BiLSTM-2048, 3 x 2048, 512-d) on a
    seeded corpus of 64 songs from ``make_melody_corpus``: batch 64, 200
    steps in chunks of 25 (its default ``--scan_chunk``: one step captured
    in a CUDA graph, replayed), scheduled sampling 0.2, evaluations every
    50 steps, float32 on the card; every ELBO finite, the last 20 steps'
    mean below the first
    step's; the float16 artifact loaded by ``TrainedMusicVAE`` on the card;
    one narrow train step on the card against the CPU with the same draws
    (CODEC_STEP_RTOL). (b) ``eval_codec.main`` on the artifact over 64
    chunks: five scores finite and in [0, 1]. (c) DPM++-8 on 1000 requests
    of 32x42 through the fused flagship at bf16 (film +32, attention +48,
    all tensor-core) and through the same weights in float32 on the plain
    versions; ``sample_ncsn.evaluate`` on the bf16 samples against seeded
    real latents, every stat finite and FD(real, real) below FD(real,
    samples), the float32 samples' FD beside; ``sample_ncsn
    --compute_metrics --compute_final_only`` on phase 10's checkpoint.
    (d) ``sample_audio`` on the artifact and 16 latents (4 pieces of 4
    chunks) and the prior baseline (numpy's global generator seeded with
    AUDIO_PRIOR_SEED): 8 WAVs written, none silent (``--noinclude_plots``
    where matplotlib does not import).

25. distributed training. (a) ``dryrun.entry()``, the flagship's forward
    on 8x32x42; ``train_ncsn.main`` on ``configs/ddpm-mel-32seq-512.cfg``
    at full width for 20 steps, in chunks of 4 (``--scan_chunk``, the
    step captured) under ``RANK=0 WORLD_SIZE=1`` (an NCCL group of one)
    and by single steps without them: every parameter bit-equal; the group
    destroyed. (b) The data axis on 2 ranks (processes): the fused
    flagship at bf16, global batch 64 split 32 + 32, 3 steps, each rank's
    film +4 and attention +6 a step, all tensor-core; the replicas equal;
    against one rank on the 64 rows with the same draws, its gradient as
    two halves (DDP_RTOL) and as one batch (DDP_ONE_BATCH_RTOL); the same
    3 steps as one chunk from the same start (each step's all-reduce
    eager between its two captured segments: film +20 and attention +30 a
    rank, 3 replays and 2 warm-up steps) bit-equal to the single steps on
    each rank, replicas equal by checksum; wall ms/step of 1 and 2 ranks,
    of the replayed chunk, and peak memory a rank. (c) The model axis on
    2 ranks: the float32 standard flagship split by columns; one forward
    on 64x32x42 against the unsplit model, the first gradient and the
    params after 3 steps (TP_FORWARD_RTOL, TP_RTOL); peak memory a rank.
    Then the chunk on the model axis, for the float32 standard flagship
    and the fused bf16 flagship at full width, and the fused one with each
    transformer layer checkpointed (``remat``: the backward recomputes
    each layer, its attention launch and the all-gather of its MLP's input
    Dense again, one more piece each): 3 single steps, then the
    same 3 steps as one chunk from the same start, capturing and then
    replaying (the step captured in pieces cut at each collective: each
    split Dense's all-gather, its input gradient's all-reduce in the
    backward, the norm's all-reduce; ``utils/graphs.collective``), each
    bit-equal to the single steps (params, Adam moments, EMA, losses,
    generator), the replicated leaves equal across the group by checksum;
    the fused chunk's film and attention launched inside the pieces (+4
    and +6 a step, all tensor-core); a planted fault, the kept chunk
    replayed with one recorded all-gather a no-op on every rank, must
    differ; pieces and collectives a step, launches a rank, and wall ms a
    step replayed, capturing and by single steps. (d)
    ``dryrun_multichip(4)``: a 2 x 2 grid, 2 steps and a chunk of 2 from
    the same start bit-equal to them on every rank. On one card the ranks
    share it over gloo with CUDA tensors, and say so; with a card a rank,
    NCCL. The film and attention launches of (b) and of (c)'s fused runs
    join their records' counts.

26. captured training chunks: five trainers at full width (the fused
    flagship at bf16 and the standard one in float32 on 64 x 32x42, the
    MDN on 128 x 32x42, a progressive-distillation stage 8 -> 4 of the
    fused flagship, the codec ``melody-2-big`` at batch 64 with scheduled
    sampling 0.2), each from one seeded state: 8 steps as one chunk (the
    step captured in a CUDA graph, ``utils/graphs.py``, and replayed)
    against 8 eager steps from the same state and generator state, twice
    (the capturing chunk and a replay of the cached graph): params, EMA,
    Adam state and losses bit-equal, or within CHUNK_SPREAD_FACTOR times
    two eager runs' spread, and the generator where the eager steps leave
    it; the film and attention launches of the chunk those of the eager
    steps (8 x (6, 4) fused, 8 x (18, 12) distillation); a planted fault,
    a chunk whose replays all read slot 0's batch, must read beyond the
    limit. Wall ms a step, host launches a step, device-busy ms, idle
    share and peak memory, eager against captured, beside the card. Then
    the fused, float32 and MDN trainers with ``remat`` by the same checks
    (a fused step launches attention 12 times, 6 of them recomputed), each
    against its plain mode: the activations its captured forward keeps
    must be fewer, and its peak no higher (the captured peak printed as
    the warm-up's and the capture's). The chunks' film and attention
    launches join their records' counts.
26b. remat through the CLIs: ``train_ncsn --remat`` and ``train_mdn
    --remat`` on their flagfiles at full width, 8 steps in chunks of 4
    (captured) and by single steps, every parameter bit-equal; then
    ``train_ncsn --distill --remat`` (progressive 4 -> 2) on the chunked
    run's checkpoint, its stage's chunk captured.

27. captured sampler chains: each chain's step captured in a CUDA graph
    and replayed, against the same chain run eagerly
    (``utils.graphs.eager``) from a generator seeded alike, at full width:
    DDPM-1000 on 64 x 32x42 fused and int8 (w8a8 inside a graph), DDPM-200
    at 16 x 512x42 standard (flash inside a graph; T cut from 1000),
    DDIM-50 at eta 0, and at eta 1 with infill (2 graphs: the last step
    draws nothing), DPM++-8 with collection and metrics, distilled-2,
    consistency-2 (2 graphs), ALD (500 levels, 2 steps a level, cut from
    phase 19's 10) and CAS (2 graphs) through the DenseNCSN flagfile's 6 x
    2048 network on 256 requests with 8 snapshots and the metrics, the
    MDN's ``ar_decode_cached`` at 128 x 32 and 16 x 512 and ``ar_decode``
    at 128 x 32 and 4 x 512 (flash inside a graph): state, collection,
    metrics and the generator's state bit-equal (``torch.equal``) at the
    capturing call; launches the eager chain's, plus the warm-up steps';
    the planted fault: a second call, replaying the kept graph with another
    schedule of the same length (the decodes: another seed), must equal a
    fresh eager chain on it, launch as many kernels, and differ from the
    first. Wall s eager, captured (the replaying call) and first call, the
    captured chain's host launches and device-busy ms a model call (short
    chains under the profiler; the decodes at 32 positions), peak memory,
    beside the card.
    The chains' launches join their records'.

28. captured codec chains: each of the codec's recurrences captured in a
    CUDA graph and replayed (``codec/musicvae.py``), against the same call
    with its steps run eagerly (``utils.graphs.eager``) from a generator
    seeded alike: ``melody-2-big`` float32 and bf16 (seeded weights), the
    encode and the decode at 64 and 2,048 chunks and a teacher-forced
    forward of 64 without gradients; the ``melody-16-big`` and
    ``multi-1-big`` decodes of 64 latents and their conductor embeddings:
    every output (z, mu, sigma, logits, tokens, embeddings) and the
    generator's state bit-equal (``torch.equal``) at the capturing call
    and at a replaying one, the warm-up steps those of the graphs made, no
    port kernel launched. The planted fault: a decode at temperature 1
    through the graph kept from one at 1e-3 must equal a fresh eager
    decode at 1 and differ from the first, and the same call with its
    staged temperature left at the first call's must be caught.

Before each model call, each serve and each training run every launch
count is set to 0, and after it every count is read and checked. Each
phase ends by freeing the kept chains' graphs, the samplers' and the
codec's.

Any failed check exits non-zero. The line before the last is the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository beside it, it fails and prints no
result.
"""
import contextlib
import functools
import glob
import json
import logging
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.perf_counter()

# Published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Special-function (MUFU) results a second: 132 SMs x 16 a clock at ~1.8
# GHz; the FlashAttention-3 paper (Shah et al. 2024) gives 3.9 TFLOPS of
# special functions for the H100 SXM5.
PEAK_SFU = 3.9e12

# The first versions' times (PERF.md section 6, chip_smoke.py on an NVIDIA
# H100 80GB HBM3 at 700 W, eager calls as time_ms takes them), printed
# beside the redesigned kernels' times.
FIRST_VERSION_MS = {"film": 2.643, "film+residual": 2.873,
                    "flash B=64 S=512": 0.320, "flash B=16 S=512": 0.090,
                    "flash B=32 S=1024": 0.649, "flash B=64 S=512 causal":
                    0.209, "flash packed B=1000 S=32": 0.080,
                    "attention": 0.432, "w8a8": 0.537}

SEQ_LEN, CHANNELS = 32, 42
BENCH_BATCH = 1000          # bench.py's NUM_SAMPLES: the kernels' shapes
SERVE_BATCH = 64            # requests served in the serve phases at S=32
LONG_SEQ_LEN = 512          # the standard layout's flash path
LONG_BATCH = 16             # requests served at S=512
FLAGSHIP = dict(num_layers=6, num_heads=8, num_mlp_layers=2, mlp_dims=2048,
                embed_channels=128)
SERVE_STEPS = 1000


# Training (phases 10-13): the shipped flagfile, seeded latents.
FLAGFILE = "configs/ddpm-mel-32seq-512.cfg"
LATENT_SHAPE = (32, 512)
TRAIN_EXAMPLES, EVAL_EXAMPLES = 1280, 128
TRAIN_STEPS, RESUME_STEPS, MIXED_STEPS = 200, 250, 40
FUSED_WARMUP, FUSED_STEPS = 5, 20
# The flagship's slice, checkpoints/slice-mel-512.pkl (a copy for the card
# leaves checkpoints/ out; tests/test_torch_cli.py holds the two equal).
SLICE_MEL_512 = (12, 14, 24, 36, 41, 62, 73, 135, 154, 156, 167, 175, 177,
                 182, 187, 199, 202, 211, 216, 226, 245, 248, 262, 266, 270,
                 283, 294, 298, 345, 367, 370, 371, 377, 384, 387, 458, 471,
                 473, 476, 480, 482, 483)
# Fused-layout gradients through the kernels against the plain versions,
# bf16 params and compute: |g_kernel - g_plain| <= GRAD_RTOL * |g_plain| per
# parameter tensor (norms). The kernels round to bf16 where the plain
# versions sum in float32; a flip of one bf16 ulp (2**-8) in an activation
# carries through the later layers' backward.
GRAD_RTOL = 5e-2

# The tensor-core attention kernel against ``_tc_emulation``, a plain
# PyTorch version of its own bf16 arithmetic, on the same inputs, in bf16
# ulps of the output (``fused_attention.tc_ulp_stats``): the share of
# elements that are not bit-equal, and the mean signed difference. A clean
# kernel differs only where the float32 summation order or exp2f flips a
# rounding, so both sit near 0 and the mean has no sign of its own; a fault
# of one ulp in every output reads (1, +-1). The limits sit above the clean
# readings of the bench-shape call at ATTN_EMU_SEEDS (printed each run),
# and the kernels phase plants that fault and fails unless they catch it.
ATTN_EMU_SEEDS = (100, 101, 102, 103, 104)
# Clean readings over seeds 100-109 (NVIDIA H100 80GB HBM3, 700 W): share
# 0.65-0.84%, mean -0.042..+0.063 ulps (0.3% of elements one ulp off, 0.05%
# three or more: outputs near 0, whose ulps are tiny); the planted fault
# (0.997, 0.96..1.06).
ATTN_EMU_MAX_SHARE = 0.02
ATTN_EMU_MAX_MEAN_ULP = 0.25

KERNELS = ("fused_ln_attention", "fused_ln_film_swish_dense", "w8a8_dense",
           "flash_attention")
LAYOUTS = ("fused", "int8", "standard")


def per_call_launches(layout, seq_len=SEQ_LEN):
    """(attention, film, w8a8, flash) launches of one model call. Fused
    layout: one attention launch per layer and a film launch per head
    matmul; int8 layout: a w8a8 launch per head matmul; standard layout: a
    flash launch per layer at S >= 512, none at S=32 (the einsum)."""
    head = 2 * FLAGSHIP["num_mlp_layers"]
    layers = FLAGSHIP["num_layers"]
    return {"fused": (layers, head, 0, 0), "int8": (0, 0, head, 0),
            "standard": (0, 0, 0, layers if seq_len >= LONG_SEQ_LEN
                         else 0)}[layout]


def say(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check_close(what, got, ref, atol, rtol):
    """max |got - ref|, failing unless |got - ref| <= atol + rtol * |ref|."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite output")
    err = (got - ref).abs()
    worst = float((err - rtol * ref.abs()).max())
    max_err = float(err.max())
    if worst > atol:
        fail(f"{what}: max |err| {max_err:.3e} exceeds atol {atol} + "
             f"rtol {rtol} * |ref|")
    return max_err


def time_ms(fn, iters=20, warmup=3):
    """Median ms of ``iters`` eager calls, each between two CUDA events:
    the records' times, the host's launch included where it exceeds the
    device's time."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def replay_ms(fn, iters=20, reps=5):
    """Device ms of one call alone: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between two CUDA events; the median
    replay over ``iters``. Printed beside ``time_ms``, never recorded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def bound_ms(bytes_moved, ops_by_peak):
    """Least time: the largest of bytes over the memory rate and each unit's
    operations over its peak rate (the units run at the same time).
    ``ops_by_peak`` is [(ops, peak)]."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = max(ops / peak for ops, peak in ops_by_peak)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f"[{self.name}] start")
        return self

    def __exit__(self, *exc):
        # The sampler chains' kept CUDA graphs (and the models their
        # closures hold) go at each phase's end.
        from smd_tpu_torch.utils import graphs
        graphs.release()
        torch.cuda.empty_cache()
        if exc[0] is None:
            say(f"[{self.name}] ok ({time.perf_counter() - self.t0:.1f} s)")
        return False


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"python {sys.version.split()[0]}")
    # float32 products are compared in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from smd_tpu_torch.ops import _build
    path, seconds, log = _build.build()
    _build.library()
    # Spills, and wgmma serialized by ptxas (warning C7515).
    spills = [ln.strip() for ln in log.splitlines()
              if ("spill" in ln and not ln.strip().startswith(
                  "ptxas info    : Used") and " 0 bytes spill stores" not in ln)
              or "Performance Loss" in ln]
    kernels = sum("Compiling entry function" in ln for ln in log.splitlines())
    say(f"built {path.relative_to(_build.BUILD_DIR.parent.parent)} in "
        f"{seconds:.1f} s ({'reused' if seconds == 0 else 'nvcc'}; "
        f"{kernels} kernel entries)")
    for ln in spills:
        say(f"ptxas: {ln}")
    # The redesigned kernels' registers, shared memory and spills.
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" not in ln:
            continue
        name = ln.split("'")[1]
        kernel = next((k for k in ("film_gemm_kernel", "row_stats_kernel",
                                   "flash_bf16_kernel",
                                   "ln_attention_tc_kernel",
                                   "w8a8_gemm_kernel", "quantize_kernel")
                       if k in name), None)
        if kernel is None:
            continue
        # The mangled template arguments, e.g. "ILi16EE" for Dh=16.
        inst = name[name.index(kernel) + len(kernel):].split("EE")[0] + "EE"
        info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "Used" in x or "spill" in x]
        say(f"ptxas {kernel}{inst}: {'; '.join(info)}")


def _film_inputs(B, S, K, N, dtype, gen):
    dev = "cuda"
    x = (torch.randn(B, S, K, generator=gen, device=dev) * 0.5 + 0.3)
    scale = torch.randn(B, 1, K, generator=gen, device=dev) * 0.2 + 1.0
    shift = torch.randn(B, 1, K, generator=gen, device=dev) * 0.2
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    b = torch.randn(N, generator=gen, device=dev) * 0.1
    res = torch.randn(B, S, N, generator=gen, device=dev)
    return x.to(dtype), scale, shift, w.to(dtype), b.to(dtype), res.to(dtype)


def _attn_inputs(B, S, E, dtype, gen):
    dev = "cuda"
    x = torch.randn(B, S, E, generator=gen, device=dev) + 0.2
    ws = [torch.randn(E, 3 * E, generator=gen, device=dev) / E ** 0.5,
          torch.randn(3 * E, generator=gen, device=dev) * 0.1,
          torch.randn(E, E, generator=gen, device=dev) / E ** 0.5,
          torch.randn(E, generator=gen, device=dev) * 0.1,
          1 + 0.1 * torch.randn(E, generator=gen, device=dev),
          0.1 * torch.randn(E, generator=gen, device=dev)]
    return x.to(dtype), [w.to(dtype) for w in ws]


def phase_kernels():
    from smd_tpu_torch.ops import fused_attention as fat
    from smd_tpu_torch.ops import fused_film_resblock as ffr
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}

    # -- fused_ln_film_swish_dense ------------------------------------------
    op = ffr.fused_ln_film_swish_dense
    B, S, K, N = BENCH_BATCH, SEQ_LEN, 2048, 2048
    x, scale, shift, w, b, res = _film_inputs(B, S, K, N, torch.bfloat16, gen)
    # The yardstick: the product alone on the prologue's bf16 output.
    h = torch.nn.functional.silu(torch.nn.functional.layer_norm(
        x.float(), (K,), eps=1e-6) * scale + shift).to(w.dtype)
    errs, ms, plain, bounds = [], [], [], []
    for r in (None, res):
        name = "film" + ("+residual" if r is not None else "")
        out = op(x, scale, shift, w, b, r)
        ref = ffr._reference(x, scale, shift, w, b, r)
        # bf16 out: differently ordered float32 sums may land a result on
        # the other side of a bf16 rounding boundary (2**-8 relative).
        errs.append(check_close(name, out, ref, atol=2e-2, rtol=1e-2))
        ms.append(time_ms(lambda: op(x, scale, shift, w, b, r)))
        replayed = replay_ms(lambda: op(x, scale, shift, w, b, r))
        plain.append(time_ms(lambda: ffr._reference(x, scale, shift, w, b, r),
                             iters=10))
        M = B * S
        moved = 2 * M * K + 2 * 4 * B * K + 2 * K * N + 2 * N + 2 * M * N + \
            (2 * M * N if r is not None else 0)
        # The product on the bf16 tensor cores; the float32 prologue is ~10
        # operations per element of x (LN statistics and normalisation,
        # FiLM affine, swish) on the CUDA cores.
        bounds.append(bound_ms(moved, [(2 * M * K * N, PEAK_BF16_FLOPS),
                                       (10 * M * K, PEAK_FP32_FLOPS)]))
        say(f"{name} B={B} S={S} K={K} N={N} bf16: max|err| {errs[-1]:.3e}, "
            f"kernel {ms[-1]:.4f} ms ({replayed:.4f} ms replayed; first "
            f"version {FIRST_VERSION_MS[name]} ms), plain {plain[-1]:.4f} ms, "
            f"bound {bounds[-1][0]:.4f} ms ({bounds[-1][1]})")
    lib = time_ms(lambda: torch.matmul(h, w))
    say(f"film yardstick torch.matmul bf16 ({B * S}x{K})@({K}x{N}): "
        f"{lib:.4f} ms ({replay_ms(lambda: torch.matmul(h, w)):.4f} ms "
        f"replayed)")
    xs, scs, shs, ws, bs, rs = _film_inputs(4, 32, 256, 256, torch.float32,
                                            gen)
    err32 = check_close("film float32", op(xs, scs, shs, ws, bs, rs),
                        ffr._reference(xs, scs, shs, ws, bs, rs),
                        atol=1e-4, rtol=1e-4)  # float32 sums in other order
    say(f"film float32 B=4 S=32 K=N=256: max|err| {err32:.3e}")
    records["fused_ln_film_swish_dense"] = dict(
        source="smd_tpu_torch/csrc/fused_film_resblock.cu",
        replaces="smd_tpu/ops/fused_film_resblock.py:152",
        max_abs_err=max(errs), ms=statistics.mean(ms),
        plain_ms=statistics.mean(plain),
        bound_ms=statistics.mean(b_[0] for b_ in bounds),
        bound_by=bounds[0][1], library_ms=lib)
    del x, scale, shift, w, b, res, h

    # -- fused_ln_attention -------------------------------------------------
    op = fat.fused_ln_attention
    B, S, E, H = BENCH_BATCH, SEQ_LEN, 128, 8
    Dh = E // H
    x, ws = _attn_inputs(B, S, E, torch.bfloat16, gen)
    tc = op.tc_launches
    out = op(x, *ws, H, False)
    if op.tc_launches != tc + 1:
        fail("the bench-shape attention call did not take the tensor-core "
             "kernel")
    ref = fat._reference(x, *ws, H, False)
    # bf16 LN rows, q, k, v, p and o on the way (a CPU emulation of that
    # arithmetic keeps within this rule), bf16 out.
    err = check_close("attention", out, ref, atol=2e-2, rtol=1e-2)
    _attn_emulation_check(x, ws, out, H)
    t_p = time_ms(lambda: fat._reference(x, *ws, H, False), iters=10)
    R = B * S
    moved = 2 * (2 * R * E) + 2 * (3 * E * E + 3 * E + E * E + 3 * E)
    # What the function needs: the three products on the bf16 tensor cores,
    # one exponential per score on the special-function units, and LN
    # (~8 operations per element of x) and the softmax's other work (~4 per
    # score) on the float32 CUDA cores.
    scores = B * H * S * S
    bnd = bound_ms(moved, [
        (2 * R * E * 3 * E + 2 * 2 * scores * Dh + 2 * R * E * E,
         PEAK_BF16_FLOPS),
        (scores, PEAK_SFU),
        (8 * R * E + 4 * scores, PEAK_FP32_FLOPS)])
    F = torch.nn.functional
    qkv = (F.layer_norm(x.float(), (E,), ws[4].float(), ws[5].float(),
                        eps=1e-6) @ ws[0].float() + ws[1].float()).to(x.dtype)
    q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    kernel, library = (lambda: op(x, *ws, H, False),
                       lambda: F.scaled_dot_product_attention(q, k, v))

    def composite():
        """The block from library calls in bf16; no single call computes
        it, so it is printed, not recorded."""
        h = F.linear(F.layer_norm(x, (E,), ws[4], ws[5], eps=1e-6),
                     ws[0].t(), ws[1])
        qc, kc, vc = (t.reshape(B, S, H, Dh).transpose(1, 2)
                      for t in h.split(E, dim=-1))
        o = F.scaled_dot_product_attention(qc, kc, vc)
        return F.linear(o.transpose(1, 2).reshape(B, S, E), ws[2].t(), ws[3])
    t_k, lib = time_ms(kernel), time_ms(library)
    say(f"attention B={B} S={S} E={E} H={H} bf16 (tensor-core kernel): "
        f"max|err| {err:.3e}, kernel {t_k:.4f} ms ({replay_ms(kernel):.4f} "
        f"ms replayed; first version {FIRST_VERSION_MS['attention']} ms), "
        f"plain {t_p:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), yardstick "
        f"scaled_dot_product_attention bf16 {lib:.4f} ms "
        f"({replay_ms(library):.4f} ms replayed); library composite "
        f"layer_norm, linear, SDPA, linear bf16 {time_ms(composite):.4f} ms "
        f"({replay_ms(composite):.4f} ms replayed)")
    for (b_, s_, e_, h_, causal) in ((8, 32, 128, 8, True),
                                     (6, 20, 64, 2, False)):
        xs, wss = _attn_inputs(b_, s_, e_, torch.float32, gen)
        e32 = check_close(f"attention float32 causal={causal}",
                          op(xs, *wss, h_, causal),
                          fat._reference(xs, *wss, h_, causal),
                          atol=1e-4, rtol=1e-4)  # float32 sums in other order
        say(f"attention float32 B={b_} S={s_} E={e_} H={h_} causal={causal}: "
            f"max|err| {e32:.3e}")
    records["fused_ln_attention"] = dict(
        source="smd_tpu_torch/csrc/fused_attention.cu",
        replaces="smd_tpu/ops/fused_attention.py:135",
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=lib)
    del x, ws, qkv, q, k, v, out, ref
    records["w8a8_dense"] = _w8a8_kernel_checks(gen)
    records["flash_attention"] = _flash_kernel_checks(gen)
    torch.cuda.synchronize()
    return records


def _attn_emulation_check(x, ws, out, H):
    """The bench-shape call ``out`` and calls at ATTN_EMU_SEEDS against
    ``_tc_emulation`` within the limits; then a planted one-ulp fault,
    which must read beyond them."""
    from smd_tpu_torch.ops import fused_attention as fat

    def within(stats):
        return stats[0] <= ATTN_EMU_MAX_SHARE and \
            abs(stats[1]) <= ATTN_EMU_MAX_MEAN_ULP

    readings = [fat.tc_ulp_stats(out, fat._tc_emulation(x, *ws, H, False))]
    for seed in ATTN_EMU_SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)
        xs, wss = _attn_inputs(BENCH_BATCH, SEQ_LEN, x.shape[-1],
                               torch.bfloat16, g)
        readings.append(fat.tc_ulp_stats(
            fat.fused_ln_attention(xs, *wss, H, False),
            fat._tc_emulation(xs, *wss, H, False)))
    say("attention vs its bf16 emulation, bench shape, clean (share not "
        "bit-equal, mean signed ulps): " + ", ".join(
            f"({a:.4e}, {b:+.4e})" for a, b in readings) +
        f"; the first the record's call, then seeds {list(ATTN_EMU_SEEDS)}")
    bad = [r for r in readings if not within(r)]
    if bad:
        fail(f"the tensor-core attention kernel differs from its bf16 "
             f"emulation by {bad} (share, mean ulps), beyond the limits "
             f"({ATTN_EMU_MAX_SHARE}, {ATTN_EMU_MAX_MEAN_ULP})")
    with _attn_one_ulp_up():
        faulty = fat.fused_ln_attention(x, *ws, H, False)
    planted = fat.tc_ulp_stats(faulty, fat._tc_emulation(x, *ws, H, False))
    if within(planted):
        fail(f"a one-ulp fault planted in the attention kernel reads "
             f"{planted} against its emulation, within the limits: the "
             "check cannot see it")
    say(f"planted fault, every attention output one bf16 ulp up: "
        f"({planted[0]:.4e}, {planted[1]:+.4e}), beyond the limits "
        f"({ATTN_EMU_MAX_SHARE}, {ATTN_EMU_MAX_MEAN_ULP}), as it must be")


@contextlib.contextmanager
def _attn_one_ulp_up():
    """A planted fault: each fused-attention kernel launch returns its
    output moved one bf16 ulp towards +inf."""
    from smd_tpu_torch.ops import fused_attention as fat
    launch = fat._launch

    def faulty(*args):
        out = launch(*args)
        return torch.nextafter(out, torch.full_like(out, float("inf")))

    fat._launch = faulty
    try:
        yield
    finally:
        fat._launch = launch


def _w8a8_inputs(M, K, N, dtype, gen, bias=True):
    """x as the head's swish outputs come, w_q and w_s from a quantized
    random kernel, and the static scale that calibration would set. The
    scales and bias take x's dtype, as the served leaves do."""
    from smd_tpu_torch.ops.quant import quantize_weight
    dev = "cuda"
    xf = torch.randn(M, K, generator=gen, device=dev) * 0.8 + 0.3
    x = (xf * torch.sigmoid(xf)).to(dtype)
    w_q, w_s = quantize_weight(torch.randn(K, N, generator=gen, device=dev)
                               / K ** 0.5)
    b = torch.randn(N, generator=gen, device=dev) * 0.1 if bias else None
    a_s = x.float().abs().amax() / 127
    return (x, w_q, w_s.to(dtype), None if b is None else b.to(dtype),
            a_s.to(dtype))


def _w8a8_kernel_checks(gen):
    from smd_tpu_torch.ops import quant_matmul as qmm
    from smd_tpu_torch.ops.quant import int8_codes, int8_matmul
    op = qmm.w8a8_dense
    # The int32 sums, exactly: integer-valued x (its own codes at a scale of
    # 1) with |x| <= 64 keeps every sum below 2**24, so y is the sum itself.
    K, N = 2048, 2048
    xi = torch.randint(-64, 65, (256, K), generator=gen, device="cuda")
    w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                        dtype=torch.int8)
    one = torch.ones((), device="cuda")
    y = op(xi.float(), w_q, torch.ones(N, device="cuda"), None, one)
    sums = int8_matmul(xi.to(torch.int8), w_q)
    if not torch.equal(y, sums):
        fail(f"w8a8 int32 sums differ from the exact sums at "
             f"{int((y != sums).sum())} places")
    say(f"w8a8 int32 sums M=256 K={K} N={N}: equal to the exact sums")

    # The bench's shape, bf16 as served: exact sums and the same epilogue,
    # so the outputs agree to one bf16 rounding.
    M = BENCH_BATCH * SEQ_LEN
    x, w_q, w_s, b, a_s = _w8a8_inputs(M, K, N, torch.bfloat16, gen)
    # As served: the K-major copy made once beside the weight.
    w_t = qmm.transpose_weight(w_q)
    out = op(x, w_q, w_s, b, a_s, w_t=w_t)
    ref = qmm._reference(x, w_q, w_s, b, a_s)
    err = check_close("w8a8", out, ref, atol=1e-6, rtol=2 ** -7)
    t_p = time_ms(lambda: qmm._reference(x, w_q, w_s, b, a_s), iters=10)
    moved = 2 * M * K + K * N + 2 * 2 * N + 2 + 2 * M * N
    # The int8 products on the tensor cores; on the CUDA cores the quantize
    # (divide, round, two clamps per element of x) and the epilogue
    # (convert, scale, bias per element of y).
    bnd = bound_ms(moved, [(2 * M * K * N, PEAK_INT8_OPS),
                           (4 * M * K + 3 * M * N, PEAK_FP32_FLOPS)])
    x_q = int8_codes(x.float(), a_s.float())

    def kernel():
        return op(x, w_q, w_s, b, a_s, w_t=w_t)
    t_k, lib = time_ms(kernel), time_ms(lambda: torch._int_mm(x_q, w_q))
    t_nt = time_ms(lambda: op(x, w_q, w_s, b, a_s))
    if not torch.equal(torch._int_mm(x_q, w_q).float(),
                       int8_matmul(x_q, w_q)):
        fail("torch._int_mm disagrees with the exact int32 sums")
    # cuBLAS takes another route for a column-major w_q, the layout the
    # kernel reads; shown beside the yardstick, not in it.
    w_cm = w_q.t().contiguous().t()
    lib_cm = time_ms(lambda: torch._int_mm(x_q, w_cm))
    say(f"w8a8 M={M} K={K} N={N} bf16: max|err| {err:.3e} (max|y| "
        f"{float(ref.float().abs().max()):.3f}), kernel with the K-major "
        f"copy {t_k:.4f} ms ({replay_ms(kernel):.4f} ms replayed; "
        f"{t_nt:.4f} ms transposing w_q in the call; first version "
        f"{FIRST_VERSION_MS['w8a8']} ms), plain {t_p:.4f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}), yardstick "
        f"torch._int_mm on the quantized operands {lib:.4f} ms "
        f"({lib_cm:.4f} ms with w_q column-major)")
    del x, x_q, w_cm, w_t, out, ref

    # A ragged row count with no bias, and float32 x with float32 leaves.
    for M, dtype, bias in ((1000, torch.bfloat16, False),
                           (4000, torch.float32, True)):
        args = _w8a8_inputs(M, K, N, dtype, gen, bias=bias)
        # float32: the same roundings, so equal up to an ulp or two.
        tol = (1e-6, 1e-6) if dtype == torch.float32 else (1e-6, 2 ** -7)
        e = check_close(f"w8a8 {dtype} M={M}", op(*args),
                        qmm._reference(*args), atol=tol[0], rtol=tol[1])
        say(f"w8a8 M={M} K={K} N={N} {dtype} bias={bias}: max|err| "
            f"{e:.3e}")
    return dict(source="smd_tpu_torch/csrc/quant_matmul.cu",
                replaces="smd_tpu/ops/quant_matmul.py:127",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=lib)


def _kept_pairs(S, causal, block_diag):
    """(query, key) pairs one (batch, head) of a flash call keeps: all, the
    causal triangle, or the squares (triangles) of the groups."""
    sizes = [S] if not block_diag else \
        [min(block_diag, S - i) for i in range(0, S, block_diag)]
    return sum(n * (n + 1) // 2 if causal else n * n for n in sizes)


def check_flash(what, out, ref):
    """float32 within 1e-5 (unit-normal q, k, v; float32 sums in another
    order); bf16 is the float32 result rounded once: within one bf16 ulp of
    |ref| plus that 1e-5. Returns (max |err|, max |err| beyond one ulp)."""
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite output")
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        excess = err
    else:
        _, e = torch.frexp(ref.float().abs())
        excess = err - torch.ldexp(torch.ones_like(err), e - 8)
    if float(excess.max()) > 1e-5:
        fail(f"{what}: max |err| {float(err.max()):.3e}, "
             f"{float(excess.max()):.3e} beyond one {out.dtype} ulp + 1e-5")
    return float(err.max()), float(excess.max())


def _flash_kernel_checks(gen):
    """flash_attention against its plain version, q, k and v unit-normal
    strided views of one (B, S, 3, H, Dh) projection as the attention layer
    passes them. The first case is the record's row."""
    from smd_tpu_torch.ops import flash_attention as fa
    op = fa.flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, Dh = 8, 16
    record = None
    for B, S, causal, dtype, packed in (
            (64, LONG_SEQ_LEN, False, torch.bfloat16, False),
            (LONG_BATCH, LONG_SEQ_LEN, False, torch.bfloat16, False),
            (32, 1024, False, torch.bfloat16, False),
            (64, LONG_SEQ_LEN, True, torch.bfloat16, False),
            (BENCH_BATCH, SEQ_LEN, False, torch.bfloat16, True),
            (64, LONG_SEQ_LEN, False, torch.float32, False),
            # The MDN's float32 causal call (phase 22).
            (MDN_LONG_BATCH, LONG_SEQ_LEN, True, torch.float32, False)):
        q, k, v = torch.randn(B, S, 3, H, Dh, generator=gen,
                              device="cuda").to(dtype).unbind(dim=2)
        if packed:   # (B/G, G*S, H, Dh) with block_diag=S
            g = fa.pack_group(B, S)
            call = (q.reshape(B // g, g * S, H, Dh),
                    k.reshape(B // g, g * S, H, Dh),
                    v.reshape(B // g, g * S, H, Dh), causal, S)
        else:
            call = (q, k, v, causal, 0)
        name = (f"flash {'packed ' if packed else ''}B={B} S={S} H={H} "
                f"Dh={Dh}{' causal' if causal else ''} "
                f"{str(dtype).split('.')[1]}")
        out = op(*call)
        ref = fa._reference_attention(*call)
        err, excess = check_flash(name, out, ref)
        t_p = time_ms(lambda: fa._reference_attention(*call), iters=10)
        Bc, Sc = call[0].shape[:2]
        pairs = Bc * H * _kept_pairs(Sc, causal, call[4])
        # q, k, v read once, o written once.
        moved = 4 * Bc * Sc * H * Dh * out.element_size()
        extra = ""
        if dtype == torch.bfloat16:
            # What the function needs per kept pair: 2*Dh operations for
            # q.k and 2*Dh for p.v on the bf16 tensor cores, one
            # exponential on the special-function units.
            bnd = bound_ms(moved, [(pairs * 4 * Dh, PEAK_BF16_FLOPS),
                                   (pairs, PEAK_SFU)])
            # The design's own extra work, not in the bound: the second
            # p.v product (p in two bf16 terms) and ~3 float32 operations
            # per pair to split p.
            extra = (f", the two-term split's extra work "
                     f"{1e3 * pairs * 2 * Dh / PEAK_BF16_FLOPS:.4f} ms on the "
                     f"tensor cores + {1e3 * pairs * 3 / PEAK_FP32_FLOPS:.4f}"
                     f" ms float32")
        else:
            # float32 on the CUDA cores: 2*Dh multiply-adds for q.k and 2*Dh
            # for p.v per kept pair, and one exponential.
            bnd = bound_ms(moved, [(pairs * (4 * Dh + 1), PEAK_FP32_FLOPS)])
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kernel, library = (
            lambda: op(*call),
            lambda: sdpa(qt, kt, vt, is_causal=causal, scale=1.0))
        t_k, lib = time_ms(kernel), time_ms(library)
        first = FIRST_VERSION_MS.get(
            f"flash {'packed ' if packed else ''}B={B} S={S}"
            f"{' causal' if causal else ''}") if dtype != torch.float32 \
            else None
        say(f"{name}: max|err| {err:.3e} ({excess:.3e} beyond one ulp), "
            f"kernel {t_k:.4f} ms ({replay_ms(kernel):.4f} ms replayed"
            f"{f'; first version {first} ms' if first else ''}), plain "
            f"{t_p:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}{extra}), "
            f"yardstick scaled_dot_product_attention {lib:.4f} ms "
            f"({replay_ms(library):.4f} ms replayed)")
        if record is None:
            record = dict(source="smd_tpu_torch/csrc/flash_attention.cu",
                          replaces="smd_tpu/ops/flash_attention.py:159",
                          max_abs_err=err, ms=t_k, plain_ms=t_p,
                          bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib)
        del q, k, v, qt, kt, vt, call, out, ref
    return record


def _flagship():
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device="cuda",
                      data_channels=CHANNELS, fused_attention=True,
                      fused_head=True, dtype=torch.bfloat16, **FLAGSHIP)
    # Seeded random weights in the Flax layout, carried in by the converter,
    # then cast to bf16 as bench.py casts its params.
    load_flax_params(model, random_flax_params(model, seed=0))
    model = model.to(torch.bfloat16).eval()

    def model_fn(x, cond):
        return model(x.to(torch.bfloat16), cond.to(torch.bfloat16)).float()
    return model, model_fn


def _int8_flagship():
    """The flagship with the int8 head through the w8a8 kernel: weights of
    the standard layout from a seed, quantized and calibrated on the card as
    ``benchmarks/flagship_e2e.py`` does (noise/data mixes at four noise
    levels, seeded random latents in place of data), float leaves then cast
    to bf16 as ``bench.py`` casts them."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.fuse import (calibrate_head_act_scales,
                                           quantize_head_params)
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    std = get_model("TransformerDDPM", device="cpu", data_channels=CHANNELS,
                    **FLAGSHIP)
    tree = quantize_head_params(random_flax_params(std, seed=0))
    del std
    model = get_model("TransformerDDPM", device="cuda",
                      data_channels=CHANNELS, quantized_head=True,
                      quantized_head_kernel=True, dtype=torch.bfloat16,
                      **FLAGSHIP)
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (SERVE_BATCH, SEQ_LEN, CHANNELS)
    noise = torch.randn(shape, generator=gen, device="cuda")
    data = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    cal = [(noise * (1.0 - a) + data * a,
            torch.full((SERVE_BATCH, 1, 1), t, device="cuda"))
           for a, t in ((0.0, 0.99), (0.5, 0.5), (0.9, 0.1), (1.0, 0.02))]
    tree = calibrate_head_act_scales(model, tree, cal)
    load_flax_params(model, tree)
    model = model.to(torch.bfloat16).eval()
    scales = [(m.a1_scale.item(), m.a2_scale.item())
              for m in model.modules() if hasattr(m, "a1_scale")]
    say(f"calibrated (a1_scale, a2_scale) per head resblock, bf16: {scales}")

    def model_fn(x, cond):
        return model(x.to(torch.bfloat16), cond.to(torch.bfloat16)).float()
    return model, model_fn


def _standard_flagship():
    """The flagship in the standard layout (einsum or flash attention, the
    float DenseResBlock head): weights from a seed in the Flax layout,
    carried in by the converter, then cast to bf16 as bench.py casts its
    params."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device="cuda",
                      data_channels=CHANNELS, dtype=torch.bfloat16,
                      **FLAGSHIP)
    load_flax_params(model, random_flax_params(model, seed=0))
    model = model.to(torch.bfloat16).eval()

    def model_fn(x, cond):
        return model(x.to(torch.bfloat16), cond.to(torch.bfloat16)).float()
    return model, model_fn


def _dense_ddpm():
    """``configs/ddpm-mel-1seq-512.cfg``'s DenseDDPM (the flag defaults' 6
    x 2048) with weights from a seed, cast to bf16 as ``sample_ncsn``
    serves it: the input Dense in bf16, the resblocks in float32."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("DenseDDPM", device="cuda", data_channels=FLAT_WIDTH,
                      num_layers=6, mlp_dims=2048)
    load_flax_params(model, random_flax_params(model, seed=0))
    model = model.to(torch.bfloat16).eval()

    def model_fn(x, cond):
        return model(x.to(torch.bfloat16), cond.to(torch.bfloat16)).float()
    return model, model_fn


def _wrappers():
    from smd_tpu_torch.ops import flash_attention as fa
    from smd_tpu_torch.ops import fused_attention as fat
    from smd_tpu_torch.ops import fused_film_resblock as ffr
    from smd_tpu_torch.ops import quant_matmul as qmm
    return (fat.fused_ln_attention, ffr.fused_ln_film_swish_dense,
            qmm.w8a8_dense, fa.flash_attention)


def _counts():
    return tuple(w.launches for w in _wrappers())


def _side_counts():
    """(tensor-core attention launches, w_q transposes)."""
    from smd_tpu_torch.ops import fused_attention as fat
    from smd_tpu_torch.ops import quant_matmul as qmm
    return fat.fused_ln_attention.tc_launches, qmm.transpose_weight.launches


def _reset_counts():
    from smd_tpu_torch.utils import graphs
    for obj, attr in graphs.launch_counters():
        setattr(obj, attr, 0)


def phase_model(model, model_fn, layout, batch=SERVE_BATCH,
                seq_len=SEQ_LEN):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(batch, seq_len, CHANNELS, generator=gen, device="cuda")
    cond = torch.rand(batch, 1, 1, generator=gen, device="cuda") \
        * 0.95 + 0.05
    expected = per_call_launches(layout, seq_len)
    with torch.no_grad():
        _reset_counts()
        out = model_fn(x, cond)
        torch.cuda.synchronize()
        counts = _counts()
        if counts != expected:
            fail(f"one {layout} model call launched (attention, film, w8a8, "
                 f"flash) {counts}, expected {expected}")
        ref = model_fn_plain(model, model_fn, x, cond)
    if out.shape != (batch, seq_len, CHANNELS) or out.dtype != torch.float32:
        fail(f"model output {tuple(out.shape)} {out.dtype}")
    # bf16 rounding flips from differently ordered float32 sums, carried
    # through 6 layers and the head.
    scale = float(ref.abs().max())
    err = check_close("model", out, ref, atol=5e-2 * scale, rtol=0.0)
    say(f"flagship {layout} bf16 call on {batch}x{seq_len}x{CHANNELS}: "
        f"launches (attention, film, w8a8, flash) {counts}, kernels vs plain "
        f"max|err| {err:.3e} (max|out| {scale:.3f})")


def _warmups():
    """Eager warm-up steps run before CUDA graph captures so far."""
    from smd_tpu_torch.utils import graphs
    return graphs.warmup_steps


def _serve_twice(what, run, calls, per_call, graphs_made=1, check_tc=True):
    """``run(first)`` twice, as a user serves two requests of one shape: the
    first call captures the chain's ``graphs_made`` CUDA graphs (each after
    ``graphs.WARMUP_STEPS`` eager warm-up steps, whose launches count), the
    second replays them. Fails unless the first launched ``calls`` model
    calls plus the warm-up's of ``per_call`` and the second ``calls``
    exactly, capturing nothing. Returns (the second call's output, its
    seconds, the first call's seconds, its launch counts)."""
    from smd_tpu_torch.utils import graphs
    before = _warmups()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    run(True)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    made = _warmups() - before
    if made != graphs.WARMUP_STEPS * graphs_made:
        fail(f"{what}: the first call ran {made} warm-up steps, expected "
             f"{graphs.WARMUP_STEPS} for each of {graphs_made} graphs")
    _check_launches(f"{what}, first call ({made} warm-up steps)", _counts(),
                    tuple((calls + made) * n for n in per_call), check_tc)
    _reset_counts()
    t0 = time.perf_counter()
    out = run(False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    if _warmups() != before + made:
        fail(f"{what}: the second call captured again")
    _check_launches(what, counts, tuple(calls * n for n in per_call),
                    check_tc)
    return out, seconds, first, counts


def model_fn_plain(model, model_fn, *args):
    """model_fn with the kernels' layers on their plain versions."""
    model.use_plain_ops(True)
    try:
        return model_fn(*args)
    finally:
        model.use_plain_ops(False)


def phase_serve(model, model_fn, smi, layout, batch=SERVE_BATCH,
                seq_len=SEQ_LEN):
    from smd_tpu_torch.diffusion import schedules
    from smd_tpu_torch.sampling import generate
    betas = schedules.noise_schedule(1e-6, 0.01, SERVE_STEPS, "linear")

    def serve(betas_, seed, fn=model_fn):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state, _, _ = generate.sample(fn, betas_, gen, (seq_len, CHANNELS),
                                      num_samples=batch,
                                      sampling="ddpm", collect_steps=0,
                                      collect_metrics=False, device="cuda")
        return state

    from smd_tpu_torch.utils import graphs
    with torch.no_grad():
        state, seconds, first, counts = _serve_twice(
            f"the {SERVE_STEPS}-step {layout} sample",
            lambda first: serve(betas, 2 if first else 3), SERVE_STEPS,
            per_call_launches(layout, seq_len))
        transposes = _side_counts()[1]
        if not torch.isfinite(state).all():
            fail("served samples are not finite")
        if state.shape != (batch, seq_len, CHANNELS):
            fail(f"served samples have shape {tuple(state.shape)}")
        say(f"served {layout}: {batch} requests of {seq_len}x{CHANNELS} x "
            f"{SERVE_STEPS} DDPM steps in {seconds:.3f} s = "
            f"{batch / seconds:.2f} seqs/s on {smi} (the step captured in a "
            f"CUDA graph, replayed; the first call, with "
            f"{graphs.WARMUP_STEPS} warm-up steps and the capture, "
            f"{first:.3f} s); launches (attention, film, w8a8, flash) "
            f"{counts}, w_q transposes {transposes}")

        # 20 steps replay the same graph; the yardstick runs eagerly.
        betas20 = schedules.noise_schedule(1e-6, 0.01, 20, "linear")
        ours = serve(betas20, 4)
        with graphs.eager():
            ref = serve(betas20, 4, fn=lambda x, c: model_fn_plain(
                model, model_fn, x, c))
    # bf16 flips as in the model phase, carried over 20 steps; x0 is
    # clipped to [-1, 1] and the posterior mean contracts each step.
    err = check_close("20-step sample", ours, ref, atol=5e-2, rtol=5e-2)
    say(f"20-step {layout} sample kernels vs plain, same generator: "
        f"max|err| {err:.3e} (max|state| {float(ref.abs().max()):.3f})")
    return counts


def _write_latents(root, train=TRAIN_EXAMPLES, eval_=EVAL_EXAMPLES):
    """Seeded latents of 32x512 as TFRecords, through the port's writer: each
    dimension a smooth AR(1) walk along the 32 steps with its own scale; and
    the flagship's slice as a pickle."""
    from smd_tpu_torch.data import records
    rng = np.random.default_rng(0)
    steps, dims = LATENT_SHAPE
    scale = rng.uniform(0.2, 2.0, dims).astype(np.float32)
    for split, n in (("train", train), ("eval", eval_)):
        z = np.empty((n, steps, dims), np.float32)
        z[:, 0] = rng.normal(size=(n, dims))
        for t in range(1, steps):
            z[:, t] = 0.9 * z[:, t - 1] + 0.436 * rng.normal(size=(n, dims))
        records.write_tfrecord(f"{root}/{split}-0.tfrecord", z * scale)
    with open(f"{root}/slice.pkl", "wb") as f:
        pickle.dump(np.asarray(SLICE_MEL_512, np.int64), f)


class StepLog:
    """A ``step_callback``: keeps each step's loss on the device, and reads
    the clock after a synchronize at the two steps of ``window``."""

    def __init__(self, window=None):
        self.window = window
        self.steps, self.losses, self.grads, self.marks = [], [], [], {}

    def __call__(self, step, metrics):
        self.steps.append(step)
        self.losses.append(metrics["loss"])
        self.grads.append(metrics["grad"])
        if self.window and step in self.window:
            torch.cuda.synchronize()
            self.marks[step] = time.perf_counter()

    def ms_per_step(self):
        a, b = self.window
        return 1e3 * (self.marks[b] - self.marks[a]) / (b - a)


def _train(argv, window=None, flagfile=FLAGFILE):
    """``train_ncsn.main`` on ``flagfile`` plus ``argv``; fails unless every
    loss is finite and no kernel launched (the standard layout at S=32
    takes the einsum and the float head; the dense and convolutional
    networks run no kernel). Returns (state, log, losses)."""
    from smd_tpu_torch import train_ncsn
    steps = StepLog(window)
    _reset_counts()
    state = train_ncsn.main(["train_ncsn", f"--flagfile={flagfile}", *argv],
                            step_callback=steps)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != per_call_launches("standard"):
        fail(f"training {flagfile} launched (attention, film, w8a8, flash) "
             f"{counts}, expected none")
    losses = torch.stack(steps.losses).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite training loss at steps "
             f"{[s for s, l in zip(steps.steps, losses) if not l.isfinite()]}")
    return state, steps, losses


def phase_train(tmp, smi):
    """The flagship trained from the flagfile, checkpointed and resumed."""
    from smd_tpu_torch import cli
    from smd_tpu_torch import train_ncsn  # noqa: F401  (defines the flags)
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(message)s")
    cli.define_sampling_flags()   # --sampling_dtype for the serve phase
    data = f"{tmp}/data"
    t0 = time.perf_counter()
    _write_latents(data)
    size = sum(os.path.getsize(f"{data}/{f}") for f in os.listdir(data))
    say(f"wrote {TRAIN_EXAMPLES} + {EVAL_EXAMPLES} latents of "
        f"{LATENT_SHAPE[0]}x{LATENT_SHAPE[1]} ({size / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    base = [f"--dataset={data}", f"--slice_ckpt={data}/slice.pkl",
            f"--model_dir={tmp}/fp32", "--snapshot_freq=100",
            "--logging_freq=10"]
    state, steps, losses = _train(base + [f"--max_steps={TRAIN_STEPS}"],
                                  window=(120, 180))
    first, last = float(losses[0]), float(losses[-20:].mean())
    ckpts = sorted(os.listdir(f"{tmp}/fp32/ckpt"))
    if state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"trained {len(losses)} steps to step {state.step}, expected "
             f"{TRAIN_STEPS}")
    if not last < first:
        fail(f"the last 20 steps' mean loss {last:.4f} is not below the "
             f"first step's {first:.4f}")
    if f"{TRAIN_STEPS}.pt" not in ckpts:
        fail(f"no checkpoint at step {TRAIN_STEPS}: {ckpts}")
    say(f"trained float32 {cli.FLAGS.architecture} ({cli.FLAGS.num_layers} "
        f"layers, {cli.FLAGS.num_heads} heads, MLP {cli.FLAGS.mlp_dims}, "
        f"batch {cli.FLAGS.batch_size}, T={cli.FLAGS.num_sigmas}): "
        f"{TRAIN_STEPS} steps, loss first {first:.4f}, mean of the last 20 "
        f"{last:.4f}, min {float(losses.min()):.4f}; checkpoints {ckpts}")
    say(f"train float32: {steps.ms_per_step():.3f} ms/step (wall, steps "
        f"120-180, data input included) on {smi}")

    state, steps, losses = _train(base + [f"--max_steps={RESUME_STEPS}"])
    if steps.steps[0] != TRAIN_STEPS + 1 or state.step != RESUME_STEPS:
        fail(f"the resumed run took steps {steps.steps[0]}..{state.step}, "
             f"expected {TRAIN_STEPS + 1}..{RESUME_STEPS}")
    say(f"resumed from step {steps.steps[0] - 1} to {state.step}: loss mean "
        f"{float(losses.mean()):.4f}; checkpoints "
        f"{sorted(os.listdir(f'{tmp}/fp32/ckpt'))}")
    return state


def phase_train_serve(smi):
    """The checkpoint restored and served as ``sample_ncsn`` would."""
    from smd_tpu_torch import cli
    from smd_tpu_torch.sampling import generate
    model, state = cli.restore_state_for_sampling((SEQ_LEN, CHANNELS))
    if state.step != RESUME_STEPS:
        fail(f"restored step {state.step}, expected {RESUME_STEPS}")
    model_fn = cli.serving_model_fn(state.sampling_params)
    betas = cli.schedule_from_flags()

    def run(first):
        gen = torch.Generator(device="cuda").manual_seed(2 if first else 3)
        return generate.sample(model_fn, betas, gen, (SEQ_LEN, CHANNELS),
                               num_samples=SERVE_BATCH,
                               sampling=cli.FLAGS.sampling, collect_steps=0,
                               collect_metrics=False, device="cuda")[0]

    with torch.no_grad():
        samples, seconds, first, counts = _serve_twice(
            "serving the checkpoint", run, betas.shape[0],
            per_call_launches("standard"))
    if samples.shape != (SERVE_BATCH, SEQ_LEN, CHANNELS) or \
            not torch.isfinite(samples).all():
        fail(f"served samples {tuple(samples.shape)} are not finite or of "
             f"the expected shape")
    say(f"served the step-{state.step} checkpoint ({cli.FLAGS.sampling_dtype}"
        f" serving, {cli.FLAGS.sampling} T={betas.shape[0]}): {SERVE_BATCH} "
        f"requests of {SEQ_LEN}x{CHANNELS} in {seconds:.3f} s (replayed; "
        f"the first call, capture included, {first:.3f} s) on {smi}; "
        f"samples in [{float(samples.min()):.3f}, "
        f"{float(samples.max()):.3f}], std {float(samples.std()):.3f}")


def phase_mixed(tmp, smi):
    data = f"{tmp}/data"
    state, steps, losses = _train(
        [f"--dataset={data}", f"--slice_ckpt={data}/slice.pkl",
         f"--model_dir={tmp}/bf16", "--mixed_precision",
         f"--max_steps={MIXED_STEPS}", f"--snapshot_freq={MIXED_STEPS}",
         "--logging_freq=10"], window=(10, 35))
    dtypes = {p.dtype for p in state.model.parameters()}
    if state.model.TransformerEncoder_0.dtype != torch.bfloat16 or \
            dtypes != {torch.float32}:
        fail(f"--mixed_precision built compute dtype "
             f"{state.model.TransformerEncoder_0.dtype}, params {dtypes}")
    say(f"train mixed precision (bf16 compute, float32 params): "
        f"{steps.ms_per_step():.3f} ms/step (wall, steps 10-35, data input "
        f"included), loss first {float(losses[0]):.4f}, last "
        f"{float(losses[-1]):.4f}, on {smi}")


def _fused_from(state):
    """The trained standard-layout params in the fused layout at bf16."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.fuse import (fuse_attention_params,
                                           fuse_head_params)
    from smd_tpu_torch.utils.flax_params import load_flax_params
    tree = {}
    for name, p in state.params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().float().cpu().numpy()
    model = get_model("TransformerDDPM", device="cuda",
                      data_channels=CHANNELS, fused_attention=True,
                      fused_head=True, dtype=torch.bfloat16, **FLAGSHIP)
    load_flax_params(model, fuse_head_params(fuse_attention_params(
        {"params": tree})))
    return model.to(torch.bfloat16)


def phase_fused_train(state, smi):
    """Gradients and optimizer steps through the fused kernels."""
    from smd_tpu_torch import cli
    from smd_tpu_torch.diffusion import losses as losses_lib
    from smd_tpu_torch.training import diffusion as trainer
    model = _fused_from(state)
    train_ds, _ = cli.dataset_from_flags()
    batches = [torch.from_numpy(b).cuda() for b in train_ds]
    betas = cli.schedule_from_flags()
    T, batch = betas.shape[0], batches[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    draws = (torch.randint(1, T + 1, (batch.shape[0],), generator=gen,
                           device="cuda"),
             torch.rand(batch.shape[0], generator=gen, device="cuda"),
             torch.randn(batch.shape, generator=gen, device="cuda"))
    params = dict(model.named_parameters())

    def grads(plain):
        model.use_plain_ops(plain)
        try:
            loss = losses_lib.diffusion_loss(batch, model, betas, None, True,
                                             draws=draws)
            return loss, torch.autograd.grad(loss, list(params.values()),
                                             allow_unused=True)
        finally:
            model.use_plain_ops(False)

    _reset_counts()
    loss_k, g_k = grads(False)
    torch.cuda.synchronize()
    counts, (tc, _) = _counts(), _side_counts()
    if counts != per_call_launches("fused") or tc != counts[0]:
        fail(f"a fused loss gradient launched (attention, film, w8a8, flash) "
             f"{counts}, {tc} on the tensor-core kernel; expected "
             f"{per_call_launches('fused')}, all")
    loss_p, g_p = grads(True)
    worst, worst_name = 0.0, None
    for name, a, b in zip(params, g_k, g_p):
        if a is None or b is None:
            fail(f"{name} has no gradient through the "
                 f"{'kernels' if a is None else 'plain versions'}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{name}: non-finite gradient")
        rel = float((a.float() - b.float()).norm() /
                    b.float().norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    if worst > GRAD_RTOL:
        fail(f"fused gradient of {worst_name} differs from the plain "
             f"versions' by {worst:.3e} of its norm, more than {GRAD_RTOL}")
    say(f"fused bf16 loss gradient, batch {batch.shape[0]}: loss "
        f"{loss_k.item():.5f} through the kernels, {loss_p.item():.5f} "
        f"through the plain versions; all {len(params)} parameters have a "
        f"finite gradient; worst |g_kernel - g_plain| / |g_plain| "
        f"{worst:.3e} ({worst_name}; tolerance {GRAD_RTOL})")

    config = cli.train_config_from_flags()
    tstate = trainer.create_train_state(model, config, seed=0, init=False)
    train_step = trainer.make_train_step(losses_lib.diffusion_loss, betas,
                                         config.continuous_noise)
    for i in range(FUSED_WARMUP):
        train_step(tstate, batches[i % len(batches)])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses = [train_step(tstate, batches[i % len(batches)])[1]["loss"]
              for i in range(FUSED_STEPS)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / FUSED_STEPS
    counts, (tc, _) = _counts(), _side_counts()
    expected = tuple(FUSED_STEPS * n for n in per_call_launches("fused"))
    if counts != expected or tc != counts[0]:
        fail(f"{FUSED_STEPS} fused train steps launched {counts} ({tc} on "
             f"the tensor-core kernel), expected {expected}")
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        fail("non-finite loss in the fused train steps")
    say(f"train fused layout (bf16 params and compute, the kernels forward, "
        f"their plain versions' gradients backward): {ms:.3f} ms/step (wall, "
        f"{FUSED_STEPS} steps after {FUSED_WARMUP}, batches on the card), "
        f"losses {float(losses[0]):.4f} .. {float(losses[-1]):.4f}, "
        f"launches (attention, film, w8a8, flash) {counts}, on {smi}")
    return counts


# Few-step generation and distillation (phases 14-17): bench.py's
# few-step rows (bench.py:99-145) on its 1000 requests.
FEWSTEP_BATCH = BENCH_BATCH
FEWSTEP = (("ddim", dict(ddim_steps=50), 50),
           ("dpmpp", dict(ddim_steps=8), 8),
           ("distilled", dict(grid_steps=2), 2),
           ("consistency", dict(ddim_steps=1, grid_steps=32), 1))
# A few-step chain is checked twice against the plain versions, in norm.
# Each model call of the plain chain also runs through the kernels on the
# same input: |out_kernel - out_plain| <= CALL_RTOL * |out_plain| for every
# call (0.98% at most on the card, every call of the four fused chains).
# The whole chain through the kernels against the plain chain, same
# generator: |chain_kernel - chain_plain| <= CHAIN_RTOL * |chain_plain|.
# These samplers take x0 = (x - sigma·eps)/alpha at noise levels where
# 1/alpha reaches 12 (T=1000's noisiest), so the bf16 rounding of the
# model's output, which phase 5's DDPM chain contracts, moves single
# elements by up to ~0.5 in one call: the chain reads 2.4-4.8% clean, and a
# planted fault of one bf16 ulp in every film output only 6.25% (DDIM-50),
# so CHAIN_RTOL catches gross faults only; the per-call check is the tight
# one. Readings: study_torch_tolerances.py.
CALL_RTOL = 2e-2
CHAIN_RTOL = 0.1
DISTILL_STAGE_STEPS, CD_STEPS = 20, 20
# The progressive-distillation loss's gradient through the kernels against
# the plain versions (the teacher through each), for each draw seed, with
# and without the x0 clip: (worst parameter, median parameter), each
# |g_kernel - g_plain| / |g_plain| of one parameter tensor. The loss's
# residual, the gap
# between the teacher's two jumps and the student's one, is small at the
# trained params, so the bf16 rounding of both sides is a larger share of
# it than of phase 13's eps residual, most on the input projection,
# downstream of every kernel; the clip adds jumps where an element of x0
# sits at +-1 in one run only. Card readings over seeds 10-19, without the
# clip: worst 5.8-7.2%, median 0.53-0.78%; with it 10.0-15.4%, 1.2-2.1%. A
# bias of one bf16 ulp or of 1% planted in every film output moves the
# median to 1.6-1.8% without the clip and 4.2-5.0% with it
# (study_torch_tolerances.py), so the median limits sit between; phase 16
# plants the one-ulp bias each run and fails if the check misses it.
DISTILL_GRAD_SEEDS = (10, 11, 12)
DISTILL_GRAD_RTOL = {False: (0.1, 1.2e-2), True: (0.2, 3e-2)}
# Model calls a distillation step launches: progressive, the teacher twice
# and the student; consistency distillation, the teacher twice, the target
# and the student.
CALLS_PER_STEP = {"progressive": 3, "consistency": 4}


def _betas(steps=SERVE_STEPS):
    from smd_tpu_torch.diffusion import schedules
    return schedules.noise_schedule(1e-6, 0.01, steps, "linear")


def _check_launches(what, counts, expected, check_tc=True):
    tc, transposes = _side_counts()
    if counts != expected:
        fail(f"{what} launched (attention, film, w8a8, flash) {counts}, "
             f"expected {expected}")
    if (check_tc and tc != counts[0]) or transposes:
        fail(f"{what} made {tc} of {counts[0]} attention launches on the "
             f"tensor-core kernel and {transposes} transposes of w_q, "
             "expected all and 0")


def _fewstep(model, model_fn, smi, layout, sampling, kw, calls, batch,
             seq_len):
    """One few-step chain through ``generate.sample`` twice (the first call
    captures its one graph, the second replays it, timed; launches
    counted), then the same chain from the second's generator through the
    plain versions, eagerly; returns the second call's launch counts."""
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.utils import graphs
    kw = _sample_kw(kw)

    def run(fn, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out, _, _ = generate.sample(fn, _betas(), gen, (seq_len, CHANNELS),
                                    num_samples=batch, sampling=sampling,
                                    collect_steps=0, collect_metrics=False,
                                    device="cuda", **kw)
        return out

    with torch.no_grad():
        ours, seconds, first, counts = _serve_twice(
            f"the {sampling} sample ({layout})",
            lambda first: run(model_fn, 6 if first else 7), calls,
            per_call_launches(layout, seq_len),
            check_tc=layout == "fused")
        if ours.shape != (batch, seq_len, CHANNELS):
            fail(f"{sampling} samples have shape {tuple(ours.shape)}")
        call_rels = []

        def plain_and_kernels(x, c):
            plain = model_fn_plain(model, model_fn, x, c)
            call_rels.append(float((model_fn(x, c) - plain).norm() /
                                   plain.norm()))
            return plain

        with graphs.eager():   # each call's gap is read back
            ref = run(plain_and_kernels, 7)
    if not torch.isfinite(ours).all():
        fail(f"{sampling} {layout} chain: non-finite output")
    call_rel = max(call_rels)
    if call_rel > CALL_RTOL:
        fail(f"a model call of the {sampling} {layout} chain through the "
             f"kernels differs from the plain versions' by {call_rel:.3e} of "
             f"its norm, more than {CALL_RTOL}")
    rel = float((ours - ref).norm() / ref.norm())
    if rel > CHAIN_RTOL:
        fail(f"{sampling} {layout} chain differs from the plain versions' by "
             f"{rel:.3e} of its norm, more than {CHAIN_RTOL}")
    say(f"{sampling} {layout} ({calls} model calls): {batch} requests of "
        f"{seq_len}x{CHANNELS} in {seconds:.3f} s = {batch / seconds:.1f} "
        f"seqs/s on {smi} (replayed; the first call, capture included, "
        f"{first:.3f} s); launches (attention, film, w8a8, flash) "
        f"{counts}; kernels vs plain, |err| / |plain|: worst model call "
        f"{call_rel:.3e} (tolerance {CALL_RTOL}), chain from the same "
        f"generator {rel:.3e} (tolerance {CHAIN_RTOL}), max|err| "
        f"{float((ours - ref).abs().max()):.3e}")
    return counts


def phase_fewstep(smi):
    """DDIM-50, DPM++-8, distilled-2 and consistency-1 through the fused
    flagship; then ``generate.interpolate`` on a 20-step schedule."""
    from smd_tpu_torch.sampling import generate
    model, model_fn = _flagship()
    counts = []
    for sampling, kw, calls in FEWSTEP:
        counts.append(_fewstep(model, model_fn, smi, "fused", sampling, kw,
                               calls, FEWSTEP_BATCH, SEQ_LEN))
    gen = torch.Generator(device="cuda").manual_seed(8)
    real = torch.rand(SERVE_BATCH, SEQ_LEN, CHANNELS, generator=gen,
                      device="cuda") * 2 - 1
    with torch.no_grad():   # 9 chains, one graph
        out, seconds, first, c = _serve_twice(
            "interpolate", lambda first: generate.interpolate(
                model_fn, _betas(20), gen, real.cpu().numpy(),
                device="cuda")[0], 9 * 20, per_call_launches("fused"))
    counts.append(c)
    if out.shape != (9, SERVE_BATCH, SEQ_LEN, CHANNELS) or \
            not torch.isfinite(out).all():
        fail(f"interpolants {tuple(out.shape)} are not finite or of the "
             "expected shape")
    say(f"interpolate fused: 9 interpolants x {SERVE_BATCH} pairs, 20 DDPM "
        f"steps each, in {seconds:.3f} s on {smi} (9 chains replaying one "
        f"graph; the first call, capture included, {first:.3f} s); launches "
        f"{counts[-1]}")
    return counts


def _sample_kw(kw):
    """A FEWSTEP entry's ``generate.sample`` keywords: ``grid_steps`` N
    becomes ``distill_grid(betas, N)``."""
    from smd_tpu_torch.training import distill
    kw = dict(kw)
    if "grid_steps" in kw:
        kw["distill_grid"] = distill.distill_grid(_betas(),
                                                  kw.pop("grid_steps"))
    return kw


def _fewstep_warmup(model_fn, sampling, kw, batch):
    """The chain's first call at the shape to be served: it captures the
    step's CUDA graph (its warm-up launches counted nowhere)."""
    from smd_tpu_torch.sampling import generate
    generate.sample(model_fn, _betas(), None, (SEQ_LEN, CHANNELS),
                    num_samples=batch, sampling=sampling, collect_steps=0,
                    collect_metrics=False, device="cuda", **_sample_kw(kw))


def phase_fewstep_int8_flash(smi):
    """DDIM-50 through the int8 flagship (1000 requests); DPM++-8 through
    the standard flagship at S=512 (16 requests, the flash kernel)."""
    model, model_fn = _int8_flagship()
    with torch.no_grad():
        model_fn(torch.zeros(8, SEQ_LEN, CHANNELS, device="cuda"),
                 torch.full((8, 1, 1), 0.5, device="cuda"))
    counts = [_fewstep(model, model_fn, smi, "int8", "ddim",
                       dict(ddim_steps=50), 50, FEWSTEP_BATCH, SEQ_LEN)]
    del model, model_fn
    model, model_fn = _standard_flagship()
    counts.append(_fewstep(model, model_fn, smi, "standard", "dpmpp",
                           dict(ddim_steps=8), 8, LONG_BATCH, LONG_SEQ_LEN))
    del model, model_fn
    torch.cuda.empty_cache()
    return counts


def _endless(batches):
    while True:
        yield from batches


def phase_distill(state, smi):
    """Progressive distillation 8 -> 4 -> 2 and consistency distillation
    through the fused kernels (bf16), from the trained params; their
    students' samples; one distillation-loss gradient through the kernels
    against the plain versions."""
    from smd_tpu_torch import cli
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.training import consistency, distill
    from smd_tpu_torch.utils import graphs
    model = _fused_from(state)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_ds, _ = cli.dataset_from_flags()
    batches = [torch.from_numpy(b).cuda() for b in train_ds]
    betas = _betas()
    counts = []

    def serve(stage_params, grid, sampling, steps):
        student = distill.frozen_copy(model, stage_params).eval()
        gen = torch.Generator(device="cuda").manual_seed(9)
        with torch.no_grad():
            out, _, _ = generate.sample(
                lambda x, c: student(x.to(torch.bfloat16),
                                     c.to(torch.bfloat16)).float(),
                betas, gen, (SEQ_LEN, CHANNELS), num_samples=SERVE_BATCH,
                sampling=sampling, ddim_steps=steps, distill_grid=grid,
                device="cuda")
        if out.shape != (SERVE_BATCH, SEQ_LEN, CHANNELS) or \
                not torch.isfinite(out).all():
            fail(f"the {sampling} student's samples are not finite")
        return out

    # At their default scan_chunk (50), each stage's steps are one chunk:
    # the step captured once a stage (after graphs.WARMUP_STEPS eager
    # steps, whose launches count) and replayed.
    for name, run, steps, graphs_made in (
            ("progressive", lambda log: distill.progressive_distill(
                model, params, betas, _endless(batches), start_steps=8,
                end_steps=2, steps_per_stage=DISTILL_STAGE_STEPS,
                log_fn=log),
             3 * DISTILL_STAGE_STEPS, 3),
            ("consistency", lambda log: consistency.consistency_distill(
                model, params, betas, _endless(batches), num_segments=32,
                steps=CD_STEPS, log_fn=log),
             CD_STEPS, 1)):
        losses = []
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = run(lambda n, step, loss: losses.append(loss))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        counts.append(_counts())
        launched = steps + graphs.WARMUP_STEPS * graphs_made
        _check_launches(f"{steps} {name} distillation steps ({graphs_made} "
                        f"captured, {launched} steps launched)", counts[-1],
                        tuple(launched * CALLS_PER_STEP[name] * n
                              for n in per_call_launches("fused")))
        if not np.isfinite(losses).all():
            fail(f"non-finite {name} distillation loss: {losses}")
        if name == "progressive":
            if sorted(out) != [2, 4, 8]:
                fail(f"progressive stages {sorted(out)}")
            sample = serve(out[2]["params"], out[2]["grid"], "distilled", 2)
        else:
            sample = serve(out["params"], out["grid"], "consistency", 1)
        say(f"{name} distillation, fused bf16, batch {batches[0].shape[0]}: "
            f"{steps} steps at {ms:.3f} ms/step (wall, stages, copies and "
            f"{graphs_made} captures included; batches on the card), "
            f"losses logged at each chunk's end "
            f"{[round(x, 4) for x in losses]}, "
            f"launches {counts[-1]} on {smi}; its "
            f"{'2-step' if name == 'progressive' else '1-step'} sample of "
            f"{SERVE_BATCH} in [{float(sample.min()):.3f}, "
            f"{float(sample.max()):.3f}]")

    # The distillation gradient, kernels against the plain versions, for
    # each draw seed, with and without the x0 clip; then the same check
    # with a one-ulp fault planted in the film kernel, which must fail it.
    grid, mids = distill.halve_grid(distill.distill_grid(betas, 16))
    teacher = distill.frozen_copy(model, params)
    batch = batches[0]
    names = list(params)

    def grads(plain, clip_x0, draws):
        for m in (model, teacher):
            m.use_plain_ops(plain)
        try:
            loss = distill.progressive_distillation_loss(
                batch, model, teacher, grid, mids, clip_x0=clip_x0,
                draws=draws)
            return loss, torch.autograd.grad(loss, list(
                model.parameters()))
        finally:
            for m in (model, teacher):
                m.use_plain_ops(False)

    def gap(seed, clip_x0, fault=contextlib.nullcontext()):
        """(losses, per-parameter |g_k - g_p| / |g_p| sorted, with names)
        at draw ``seed``."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        draws = (torch.randint(0, 8, (batch.shape[0],), generator=gen,
                               device="cuda"),
                 torch.randn(batch.shape, generator=gen, device="cuda"))
        _reset_counts()
        with fault:
            loss_k, g_k = grads(False, clip_x0, draws)
        torch.cuda.synchronize()
        _check_launches("a progressive distillation gradient", _counts(),
                        tuple(3 * n for n in per_call_launches("fused")))
        loss_p, g_p = grads(True, clip_x0, draws)
        rels = []
        for name, a, b in zip(names, g_k, g_p):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                fail(f"{name}: non-finite distillation gradient")
            rels.append((float((a.float() - b.float()).norm() /
                               b.float().norm().clamp_min(1e-30)), name))
        return (loss_k, loss_p), sorted(rels)

    for clip_x0 in (False, True):
        worst_rtol, median_rtol = DISTILL_GRAD_RTOL[clip_x0]
        what = f"{'with' if clip_x0 else 'without'} the x0 clip"
        for seed in DISTILL_GRAD_SEEDS:
            (loss_k, loss_p), rels = gap(seed, clip_x0)
            (worst, worst_name), median = rels[-1], rels[len(rels) // 2][0]
            if worst > worst_rtol or median > median_rtol:
                fail(f"distillation gradient ({what}, seed {seed}) differs "
                     f"from the plain versions' by {worst:.3e} of "
                     f"{worst_name}'s norm (tolerance {worst_rtol}), "
                     f"{median:.3e} at the median parameter (tolerance "
                     f"{median_rtol})")
            say(f"progressive distillation loss gradient ({what}, seed "
                f"{seed}), batch {batch.shape[0]}: loss {loss_k.item():.5f} "
                f"through the kernels, {loss_p.item():.5f} plain; "
                f"|g_kernel - g_plain| / |g_plain| worst parameter "
                f"{worst:.3e} ({worst_name}; tolerance {worst_rtol}), "
                f"median {median:.3e} (tolerance {median_rtol})")
        _, rels = gap(DISTILL_GRAD_SEEDS[0], clip_x0, _film_one_ulp_up())
        median = rels[len(rels) // 2][0]
        if median <= median_rtol:
            fail(f"a one-ulp fault planted in the film kernel moved the "
                 f"distillation gradient ({what}) by {median:.3e} at the "
                 f"median parameter, within the tolerance {median_rtol}: "
                 "the check cannot see it")
        say(f"planted fault, every film output one bf16 ulp up ({what}, "
            f"seed {DISTILL_GRAD_SEEDS[0]}): median {median:.3e}, above the "
            f"tolerance {median_rtol}, as it must be")
    return counts


@contextlib.contextmanager
def _film_one_ulp_up():
    """A planted fault: each film kernel launch returns its output moved one
    bf16 ulp towards +inf."""
    from smd_tpu_torch.ops import fused_film_resblock as ffr
    launch = ffr._launch

    def faulty(*args):
        out = launch(*args)
        return torch.nextafter(out, torch.full_like(out, float("inf")))

    ffr._launch = faulty
    try:
        yield
    finally:
        ffr._launch = launch


def phase_fewstep_clis(tmp, smi):
    """``train_ncsn --distill`` in its three modes, then ``sample_ncsn`` on
    the checkpoint and the bundles, on phase 10's run."""
    from smd_tpu_torch import sample_ncsn, train_ncsn
    data = f"{tmp}/data"
    base = [f"--flagfile={FLAGFILE}", f"--dataset={data}",
            f"--slice_ckpt={data}/slice.pkl", f"--model_dir={tmp}/fp32"]
    for mode, extra, bundles in (
            ("progressive", ["--distill_start_steps=8",
                             "--distill_end_steps=2",
                             f"--distill_stage_steps={DISTILL_STAGE_STEPS}"],
             ("8.pkl", "4.pkl", "2.pkl")),
            ("consistency", ["--distill_stage_steps=10"],
             ("consistency.pkl",)),
            ("ct", ["--distill_stage_steps=8"], ("consistency.pkl",))):
        _reset_counts()
        t0 = time.perf_counter()
        train_ncsn.main(["train_ncsn", *base, "--distill",
                         f"--distill_mode={mode}", *extra])
        torch.cuda.synchronize()
        missing = [b for b in bundles if not os.path.exists(
            f"{tmp}/fp32/distilled/{b}")]
        if missing:
            fail(f"train_ncsn --distill_mode={mode} wrote no {missing}")
        _check_launches(f"train_ncsn --distill_mode={mode}", _counts(),
                        per_call_launches("standard"))
        say(f"train_ncsn --distill --distill_mode={mode} {' '.join(extra)}: "
            f"{time.perf_counter() - t0:.1f} s (data input included), "
            f"bundles {list(bundles)} on {smi}")
    samples = [f"--sampling_dir={tmp}/samples", "--sample_size=64"]
    for extra in (["--sampling=ddim", "--ddim_steps=50"],
                  ["--sampling=dpmpp", "--ddim_steps=8", "--infill"],
                  ["--sampling=distilled", "--ddim_steps=2"],
                  ["--sampling=consistency",
                   "--consistency_sampling_steps=1"]):
        path = f"{tmp}/samples/ncsn/generated.pkl"
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        gen, _ = sample_ncsn.main(["sample_ncsn", *base, *samples, *extra])
        seconds = time.perf_counter() - t0
        with open(path, "rb") as f:
            flushed = pickle.load(f)
        if flushed.shape != (64, *LATENT_SHAPE) or \
                not np.isfinite(flushed).all() or \
                gen.shape != (64, SEQ_LEN, CHANNELS):
            fail(f"sample_ncsn {extra}: generated {flushed.shape} "
                 f"(flushed), {gen.shape}, or not finite")
        if "--infill" in extra:
            from smd_tpu_torch import cli
            _, eval_ds = cli.dataset_from_flags(include_cardinality=False)
            real = eval_ds.take_examples(64)
            if not (np.array_equal(gen[:, :8], real[:, :8]) and
                    np.array_equal(gen[:, -8:], real[:, -8:])):
                fail("sample_ncsn --infill changed the 8 edge latents")
        say(f"sample_ncsn {' '.join(extra)}: 64 requests in {seconds:.2f} s "
            f"(flags, data and model load included) on {smi}; "
            f"ncsn/generated.pkl {flushed.shape}, finite")


# The dense networks and the NCSN family (phases 18-20), at the shipped
# flagfiles' widths: none sets --num_layers or --mlp_dims, so the flag
# defaults make every one 6 x 2048: DenseDDPM and DenseNCSN on 512-d
# latents, ToyNCSN and ToyDDPM on the 2-D toy mixture.
DENSE_FLAGFILE = "configs/ddpm-mel-1seq-512.cfg"
NCSN_FLAGFILE = "configs/ncsn-mel-1seq-512.cfg"
TOY_FLAGFILES = ("configs/mixture/mixture-single-2.cfg",
                 "configs/mixture/mixture-single-ddpm-2.cfg")
FLAT_WIDTH, FLAT_TRAIN, FLAT_EVAL = 512, 2560, 1024
FLAT_SERVE = 1000           # requests served in phases 18-19
DENSE_STEPS, NCSN_STEPS, SSM_STEPS, TOY_STEPS = 40, 40, 5, 20
# ALD at the flagfile's 500 levels with --ld_steps cut from 100 to 10:
# 5,000 model calls in place of 50,000.
ALD_STEPS = 10
# The NCSN flagfile's shipped --snapshot_sampling samples --eval_samples
# (3000) with ALD at --ld_steps (100) at each snapshot, 50,000 model calls;
# phase 19 cuts it to 256 samples and 2 steps a level (1,000 calls).
NCSN_SNAPSHOT_SAMPLES = 256
NCSN_SNAPSHOT = (f"--eval_samples={NCSN_SNAPSHOT_SAMPLES}", "--ld_steps=2")
# A float32 model on the card against the same model on the CPU (TF32 off):
# |out_card - out_cpu| <= RTOL * |out_cpu| in norm, and each parameter's
# gradient likewise. Float32 sums in other orders, and the x5000 noise
# encoding's one-ulp sin/exp differences between the two devices' math
# libraries (tests/test_torch_blocks.py), carried through 6 FiLM blocks.
# Read on the card (NVIDIA H100 80GB HBM3, 700 W): DenseDDPM 4.9e-6,
# ConvNCSN 2.5e-6 and its worst gradient 4.7e-6.
CPU_RTOL = 1e-4


def _write_flat_latents(root):
    """Seeded 512-d latents as the ``flatten`` script writes them: a
    16-dimensional structure mapped to 512 dims, plus noise."""
    from smd_tpu_torch.data import records
    rng = np.random.default_rng(1)
    mix = rng.normal(size=(16, FLAT_WIDTH)) / 4
    for split, n in (("train", FLAT_TRAIN), ("eval", FLAT_EVAL)):
        z = rng.normal(size=(n, 16)) @ mix + \
            0.1 * rng.normal(size=(n, FLAT_WIDTH))
        records.write_tfrecord(f"{root}/{split}-0.tfrecord",
                               z.astype(np.float32))


def _falls(what, losses, last=10):
    first, tail = float(losses[0]), float(losses[-last:].mean())
    if not tail < first:
        fail(f"{what}: the last {last} steps' mean loss {tail:.4f} is not "
             f"below the first step's {first:.4f}")
    return first, tail


def _vs_cpu(what, model, args, grads=False):
    """``model`` (float32, on the card) against a copy on the CPU on the
    same inputs: the output's and, with ``grads``, each parameter's
    gradient of mean(out^2), each within CPU_RTOL of its norm. Returns
    (output's relative error, max |err|, worst gradient's, its name)."""
    import copy
    cpu = copy.deepcopy(model).cpu()

    def run(m, inputs):
        with torch.set_grad_enabled(grads):
            out = m(*inputs)
            g = torch.autograd.grad(out.square().mean(),
                                    list(m.parameters())) if grads else ()
        return out.detach(), g

    out, g_card = run(model, args)
    ref, g_cpu = run(cpu, [a.cpu() for a in args])
    out = out.cpu()
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite output on the card")
    rel = float((out - ref).norm() / ref.norm())
    worst, worst_name = 0.0, None
    for (name, _), a, b in zip(model.named_parameters(), g_card, g_cpu):
        r = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
        if r > worst:
            worst, worst_name = r, name
    if rel > CPU_RTOL or worst > CPU_RTOL:
        fail(f"{what} on the card differs from the CPU's by {rel:.3e} of "
             f"the output's norm, {worst:.3e} of {worst_name}'s gradient "
             f"(tolerance {CPU_RTOL})")
    return rel, float((out - ref).abs().max()), worst, worst_name


@contextlib.contextmanager
def _timed(module, name, seconds):
    """Replace ``module.name`` with a wrapper that calls it twice, as a
    second request of the same shape would come, the generator (its first
    argument that is one) put back between: the first call captures the
    chain's CUDA graph, the second replays it. Appends (the second call's
    seconds, the first's), each between two synchronizes, to ``seconds``;
    returns the second call's output, which equals a single call's."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        gens = [a for a in args if isinstance(a, torch.Generator)]
        state = gens[0].get_state() if gens else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        if gens:
            gens[0].set_state(state)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append((time.perf_counter() - t0, first))
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _serve_cli(argv, what, smi, shape, calls):
    """``sample_ncsn.main`` on ``argv`` (no flush), timed whole and in its
    ``generate.sample`` call alone (between two synchronizes, the second of
    two calls: ``_timed``); fails unless the samples are finite, of
    ``shape``, and no kernel launched."""
    from smd_tpu_torch import sample_ncsn
    from smd_tpu_torch.sampling import generate
    chain = []
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with _timed(generate, "sample", chain):
        gen, _ = sample_ncsn.main(["sample_ncsn", *argv, "--noflush"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if _counts() != per_call_launches("standard"):
        fail(f"sample_ncsn {what} launched {_counts()}, expected none")
    if gen.shape != shape or not np.isfinite(gen).all():
        fail(f"sample_ncsn {what}: samples {gen.shape}, expected {shape} "
             "and finite")
    say(f"sample_ncsn {what}: {shape[0]} requests of {shape[1:]}, the "
        f"chain {chain[0][0]:.3f} s = {shape[0] / chain[0][0]:.1f} seqs/s, "
        f"{1e3 * chain[0][0] / calls:.3f} ms per model call ({calls} calls; "
        f"metrics and snapshots collected, as the CLI does; the step "
        f"captured in a CUDA graph and replayed; the first call, capture "
        f"included, {chain[0][1]:.3f} s), {seconds:.3f} s with flags, data, "
        f"model load and both calls, on {smi}; samples in "
        f"[{float(gen.min()):.3f}, {float(gen.max()):.3f}]")
    return chain[0][0]


def phase_dense_ddpm(tmp, smi):
    """DenseDDPM from ``configs/ddpm-mel-1seq-512.cfg``: trained, held
    against the CPU, its checkpoint served through ``sample_ncsn``."""
    from smd_tpu_torch import cli
    data = f"{tmp}/flat"
    _write_flat_latents(data)
    base = [f"--dataset={data}", f"--model_dir={tmp}/dense",
            f"--max_steps={DENSE_STEPS}", f"--snapshot_freq={DENSE_STEPS}",
            "--logging_freq=10"]
    state, steps, losses = _train(base, window=(10, DENSE_STEPS),
                                  flagfile=DENSE_FLAGFILE)
    first, tail = _falls("DenseDDPM", losses)
    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"trained float32 {cli.FLAGS.architecture} ({cli.FLAGS.num_layers} "
        f"x {cli.FLAGS.mlp_dims}, {n_params / 1e6:.2f} M params, batch "
        f"{cli.FLAGS.batch_size}, T={cli.FLAGS.num_sigmas}): "
        f"{DENSE_STEPS} steps, loss first {first:.4f}, mean of the last 10 "
        f"{tail:.4f}; {steps.ms_per_step():.3f} ms/step (wall, steps "
        f"10-{DENSE_STEPS}, data input included) on {smi}")
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(64, FLAT_WIDTH, generator=gen, device="cuda")
    t = torch.rand(64, 1, generator=gen, device="cuda") * 0.95 + 0.05
    rel, err, _, _ = _vs_cpu("DenseDDPM", state.model.eval(), (x, t))
    say(f"DenseDDPM float32 forward on 64x{FLAT_WIDTH}, card vs CPU: "
        f"{rel:.3e} of the norm, max|err| {err:.3e} (tolerance {CPU_RTOL})")
    _serve_cli([f"--flagfile={DENSE_FLAGFILE}", *base, "--sampling=ddpm",
                f"--sample_size={FLAT_SERVE}"], "DenseDDPM ddpm T=1000",
               smi, (FLAT_SERVE, FLAT_WIDTH), 1000)


def phase_ncsn(tmp, smi):
    """DenseNCSN from ``configs/ncsn-mel-1seq-512.cfg`` (6 x 2048): DSM
    training, a few SSM steps (the double backward), then CAS at the
    flagfile's 500 levels and ALD at 500 levels with ``--ld_steps`` cut to
    10."""
    from smd_tpu_torch import cli
    data = f"{tmp}/flat"
    base = [f"--dataset={data}", f"--snapshot_freq={NCSN_STEPS}",
            "--logging_freq=10"]
    t0 = time.perf_counter()
    state, steps, losses = _train(
        [*base, *NCSN_SNAPSHOT, f"--model_dir={tmp}/ncsn",
         f"--max_steps={NCSN_STEPS}"],
        window=(10, NCSN_STEPS), flagfile=NCSN_FLAGFILE)
    train_s = time.perf_counter() - t0
    snaps = {c: f"{tmp}/ncsn/samples/{c}/{NCSN_STEPS}.pkl"
             for c in ("init", "real", "fake")}
    for category, path in snaps.items():
        if not os.path.exists(path):
            fail(f"--snapshot_sampling wrote no {path}")
        with open(path, "rb") as f:
            snap = pickle.load(f)
        if snap.shape != (NCSN_SNAPSHOT_SAMPLES, FLAT_WIDTH) or \
                not np.isfinite(snap).all():
            fail(f"snapshot {category}: {snap.shape} or not finite")
    say(f"--snapshot_sampling as shipped, at step {NCSN_STEPS}: ALD "
        f"{cli.FLAGS.num_sigmas} levels x {cli.FLAGS.ld_steps} steps on "
        f"{NCSN_SNAPSHOT_SAMPLES} samples (--eval_samples cut from 3000, "
        f"--ld_steps from 100), samples/{{init,real,fake}}/{NCSN_STEPS}.pkl "
        f"written; training and snapshot {train_s:.1f} s")
    first, tail = _falls("DenseNCSN dsm", losses)
    say(f"trained float32 {cli.FLAGS.architecture} ({cli.FLAGS.num_layers} "
        f"x {cli.FLAGS.mlp_dims}, batch {cli.FLAGS.batch_size}, "
        f"{cli.FLAGS.loss}, {cli.FLAGS.num_sigmas} sigmas from "
        f"{cli.FLAGS.sigma_begin}): {NCSN_STEPS} steps, loss first "
        f"{first:.4f}, mean of the last 10 {tail:.4f}; "
        f"{steps.ms_per_step():.3f} ms/step (wall, steps 10-{NCSN_STEPS}, "
        f"data input included) on {smi}")
    _, ssm, losses = _train(
        [*base, *NCSN_SNAPSHOT, f"--model_dir={tmp}/ssm",
         f"--max_steps={SSM_STEPS}", "--loss=ssm"], flagfile=NCSN_FLAGFILE)
    grads = torch.stack(ssm.grads).float().cpu()
    if not torch.isfinite(grads).all():
        fail(f"non-finite SSM gradient norm: {grads.tolist()}")
    say(f"SSM on {cli.FLAGS.architecture} {cli.FLAGS.num_layers} x "
        f"{cli.FLAGS.mlp_dims} (double backward), {SSM_STEPS} steps: "
        f"losses {[round(float(v), 3) for v in losses]}, gradient norms "
        f"{[round(float(v), 3) for v in grads]}")
    serve = [f"--flagfile={NCSN_FLAGFILE}", *base, f"--model_dir={tmp}/ncsn",
             f"--sample_size={FLAT_SERVE}"]
    levels = cli.FLAGS.num_sigmas
    _serve_cli([*serve, "--sampling=cas"], f"DenseNCSN cas, {levels} levels",
               smi, (FLAT_SERVE, FLAT_WIDTH), levels + 1)
    _serve_cli([*serve, "--sampling=ald", f"--ld_steps={ALD_STEPS}"],
               f"DenseNCSN ald, {levels} levels x {ALD_STEPS} steps "
               f"(--ld_steps cut from 100: {levels * ALD_STEPS} model calls "
               f"in place of {levels * 100})", smi, (FLAT_SERVE, FLAT_WIDTH),
               levels * ALD_STEPS + 1)


def phase_conv_toy(tmp, smi):
    """ConvNCSN forward and backward on 64x32x42 against the CPU; the two
    toy flagfiles trained a few steps on the 2-D mixture."""
    from smd_tpu_torch import cli
    from smd_tpu_torch.data import records
    from smd_tpu_torch.data.synthetic import toy_distribution
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.layers import init_parameters
    model = init_parameters(get_model("ConvNCSN", device="cuda",
                                      data_channels=CHANNELS), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(SERVE_BATCH, SEQ_LEN, CHANNELS, generator=gen,
                    device="cuda")
    sig = torch.rand(SERVE_BATCH, 1, 1, generator=gen, device="cuda") + 0.1
    rel, err, worst, name = _vs_cpu("ConvNCSN", model, (x, sig), grads=True)
    say(f"ConvNCSN float32 forward and backward on {SERVE_BATCH}x{SEQ_LEN}x"
        f"{CHANNELS}, card vs CPU: output {rel:.3e} of the norm (max|err| "
        f"{err:.3e}), worst gradient {worst:.3e} ({name}); tolerance "
        f"{CPU_RTOL}")
    toy = f"{tmp}/toy"
    rng = np.random.default_rng(2)
    for split, n in (("train", 2048), ("eval", 512)):
        records.write_tfrecord(f"{toy}/{split}-0.tfrecord",
                               toy_distribution(n, rng))
    for flagfile in TOY_FLAGFILES:
        _, steps, losses = _train(
            [f"--dataset={toy}",
             f"--model_dir={tmp}/{os.path.basename(flagfile)[:-4]}",
             "--nosnapshot_sampling", f"--max_steps={TOY_STEPS}",
             f"--snapshot_freq={TOY_STEPS}", "--logging_freq=10"],
            window=(5, TOY_STEPS), flagfile=flagfile)
        say(f"{flagfile}: {cli.FLAGS.architecture} ({cli.FLAGS.num_layers} x "
            f"{cli.FLAGS.mlp_dims}, {cli.FLAGS.loss}, continuous noise "
            f"{cli.FLAGS.continuous_noise}, batch {cli.FLAGS.batch_size}) "
            f"{TOY_STEPS} steps, losses {float(losses[0]):.4f} .. "
            f"{float(losses[-1]):.4f}, {steps.ms_per_step():.3f} ms/step on "
            f"{smi}")


# The autoregressive MDN (phases 21-22): configs/mdn-mel-32seq-512.cfg.
MDN_FLAGFILE = "configs/mdn-mel-32seq-512.cfg"
MDN_WIDTH = dict(num_layers=6, num_heads=8, num_mlp_layers=2, mlp_dims=2048,
                 mdn_mixtures=100)
MDN_TRAIN, MDN_EVAL = 1280, 1024       # sample_mdn takes 1000 eval examples
MDN_STEPS, MDN_RESUME, MDN_SERVE = 60, 70, 1000
MDN_LONG_BATCH, MDN_OPT_STEPS = 16, 5
# The MDN at S=512 through the flash kernel against its plain version, in
# norm (each output, each parameter's gradient): float32 flash calls are
# within 1e-5 of the plain version, carried through 6 layers and the head,
# as CPU_RTOL holds float32 networks to the CPU; bf16 compute as phase 4's
# flagship check, 5e-2 of the largest output (one bf16 ulp of an attention
# output carried through the layers).
MDN_F32_RTOL, MDN_BF16_RTOL = 1e-4, 5e-2


def _no_launches(what):
    torch.cuda.synchronize()
    if _counts() != (0, 0, 0, 0):
        fail(f"{what} launched (attention, film, w8a8, flash) {_counts()}, "
             "expected none at S=32")


def phase_mdn(tmp, smi):
    """The MDN flagfile trained, checkpointed, resumed and served through
    the two entry points."""
    from smd_tpu_torch import cli, sample_mdn, train_mdn
    from smd_tpu_torch.sampling import mdn_decode
    data = f"{tmp}/mdn_data"
    _write_latents(data, MDN_TRAIN, MDN_EVAL)
    base = [f"--flagfile={MDN_FLAGFILE}", f"--dataset={data}",
            f"--slice_ckpt={data}/slice.pkl", f"--model_dir={tmp}/mdn",
            f"--snapshot_freq={MDN_STEPS // 2}", "--logging_freq=10"]
    steps = StepLog(window=(10, MDN_STEPS))
    _reset_counts()
    state = train_mdn.main(["train_mdn", *base, f"--max_steps={MDN_STEPS}"],
                           step_callback=steps)
    _no_launches("training the MDN")
    losses = torch.stack(steps.losses).float().cpu()
    if not torch.isfinite(losses).all() or len(losses) != MDN_STEPS:
        fail(f"MDN training: {len(losses)} steps, losses {losses.tolist()}")
    first, tail = _falls("TransformerMDN", losses)
    ckpts = sorted(os.listdir(f"{tmp}/mdn/ckpt"))
    if f"{MDN_STEPS}.pt" not in ckpts or state.ema_params is not None:
        fail(f"MDN checkpoints {ckpts}, EMA {state.ema_params is not None}")
    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"trained float32 {cli.FLAGS.architecture} ({cli.FLAGS.num_layers} "
        f"layers, {cli.FLAGS.num_heads} heads, {cli.FLAGS.num_mlp_layers} x "
        f"{cli.FLAGS.mlp_dims} resblocks, {cli.FLAGS.mdn_components} "
        f"mixtures, {n_params / 1e6:.2f} M params, batch "
        f"{cli.FLAGS.batch_size}): {MDN_STEPS} steps, NLL first {first:.4f},"
        f" mean of the last 10 {tail:.4f}; {steps.ms_per_step():.3f} ms/step "
        f"(wall, steps 10-{MDN_STEPS}, data input included) on {smi}; "
        f"checkpoints {ckpts}")
    resumed = StepLog()
    state = train_mdn.main(["train_mdn", *base, f"--max_steps={MDN_RESUME}"],
                           step_callback=resumed)
    if resumed.steps[0] != MDN_STEPS + 1 or state.step != MDN_RESUME:
        fail(f"the resumed MDN run took steps {resumed.steps[0]}.."
             f"{state.step}, expected {MDN_STEPS + 1}..{MDN_RESUME}")
    say(f"resumed the MDN from step {resumed.steps[0] - 1} to {state.step}")
    del state

    serve = ["sample_mdn", *base, f"--sample_size={MDN_SERVE}",
             f"--sampling_dir={tmp}/mdn_samples", "--nll_gate=warn"]
    for name, extra in (("ar_decode_cached", []),
                        ("ar_decode", ["--nocached_decode", "--noflush"])):
        seconds = []
        _reset_counts()
        with _timed(mdn_decode, name, seconds):
            gen, gates = sample_mdn.main([*serve, *extra])
        _no_launches(f"sample_mdn {name}")
        if gen.shape != (MDN_SERVE, SEQ_LEN, CHANNELS) or \
                not np.isfinite(gen).all():
            fail(f"sample_mdn {name}: samples {gen.shape}, expected "
                 f"{(MDN_SERVE, SEQ_LEN, CHANNELS)} and finite")
        say(f"sample_mdn {name}: {MDN_SERVE} requests of {SEQ_LEN}x"
            f"{CHANNELS} decoded in {seconds[0][0]:.3f} s = "
            f"{MDN_SERVE / seconds[0][0]:.1f} seqs/s on {smi} (replayed; "
            f"the first call, capture included, {seconds[0][1]:.3f} s); "
            f"gate: held-out "
            f"NLL {gates['heldout_nll']:.3f} against the Gaussian baseline "
            f"{gates['gaussian_nll']:.3f} (margin "
            f"{cli.FLAGS.nll_gate_margin}), marginal deviation "
            f"{gates['marginal_deviation']:.3f} (limit "
            f"{cli.FLAGS.gate_dev_max}); samples in [{float(gen.min()):.3f},"
            f" {float(gen.max()):.3f}]")
    flushed = sorted(os.listdir(f"{tmp}/mdn_samples/mdn"))
    if flushed != ["generated.pkl", "real.pkl"]:
        fail(f"sample_mdn flushed {flushed}")


def _rel(a, b):
    return float((a.float() - b.float()).norm() /
                 b.float().norm().clamp_min(1e-30))


def _mdn_long_call(model, x, what, rtol, by_max=False):
    """One teacher-forced call through the kernel (6 flash launches)
    against the same call through the plain version. The plain version is
    causal, as each layer is, so a launch that was not would fail here."""
    with torch.no_grad():
        _reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        if _counts() != (0, 0, 0, MDN_WIDTH["num_layers"]):
            fail(f"{what}: launched {_counts()}, expected "
                 f"{MDN_WIDTH['num_layers']} flash")
        ref = model_fn_plain(model, model, x)
    errs = []
    for o, r in zip(out, ref):
        if not torch.isfinite(o).all() or o.dtype != torch.float32:
            fail(f"{what}: output non-finite or {o.dtype}")
        errs.append(float((o - r).abs().max() / r.abs().max()) if by_max
                    else _rel(o, r))
    if max(errs) > rtol:
        fail(f"{what}: kernel vs plain (pi, mu, log_sigma) {errs}, limit "
             f"{rtol}")
    return errs


def _mdn(max_decode_length):
    """The MDN flagfile's TransformerMDN, float32, with weights from a seed
    in the Flax layout carried in by the converter."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerMDN", device="cuda", data_channels=CHANNELS,
                      max_decode_length=max_decode_length, **MDN_WIDTH)
    return load_flax_params(model, random_flax_params(model, seed=0))


def phase_mdn_long(smi):
    """The MDN's width on 512 positions, through the causal flash kernel."""
    import copy

    from smd_tpu_torch.diffusion.losses import mdn_nll
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.sampling import mdn_decode
    from smd_tpu_torch.training import mdn as trainer
    model = _mdn(LONG_SEQ_LEN)
    gen = torch.Generator(device="cuda").manual_seed(13)
    shape = (MDN_LONG_BATCH, LONG_SEQ_LEN, CHANNELS)
    x = torch.randn(shape, generator=gen, device="cuda") * 0.5
    layers = MDN_WIDTH["num_layers"]
    errs = _mdn_long_call(model, x, "MDN float32 at S=512", MDN_F32_RTOL)
    say(f"MDN float32 call on {MDN_LONG_BATCH}x{LONG_SEQ_LEN}x{CHANNELS}: "
        f"{layers} causal flash launches; kernel vs plain (pi, mu, "
        f"log_sigma) {', '.join(f'{e:.2e}' for e in errs)} of the norm "
        f"(limit {MDN_F32_RTOL})")
    bf16 = get_model("TransformerMDN", device="cuda", data_channels=CHANNELS,
                     dtype=torch.bfloat16, max_decode_length=LONG_SEQ_LEN,
                     **MDN_WIDTH)
    bf16.load_state_dict(model.state_dict())
    bf16.to(torch.bfloat16).mdn.float()
    errs = _mdn_long_call(bf16, x, "MDN bf16 at S=512", MDN_BF16_RTOL,
                          by_max=True)
    say(f"MDN bf16 call (bf16 trunk and resblocks, float32 head): {layers} "
        f"causal flash launches; kernel vs plain max|err| / max|ref| "
        f"{', '.join(f'{e:.2e}' for e in errs)} (limit {MDN_BF16_RTOL})")

    params = dict(model.named_parameters())

    def grads(plain):
        model.use_plain_ops(plain)
        try:
            loss = mdn_nll(*model(x), x)
            return loss, torch.autograd.grad(loss, list(params.values()),
                                             allow_unused=True)
        finally:
            model.use_plain_ops(False)

    _reset_counts()
    loss_k, g_k = grads(False)
    torch.cuda.synchronize()
    if _counts() != (0, 0, 0, layers):
        fail(f"an MDN NLL gradient launched {_counts()}, expected {layers} "
             "flash")
    loss_p, g_p = grads(True)
    worst, worst_name = 0.0, None
    for name, a, b in zip(params, g_k, g_p):
        if a is None or b is None or not (torch.isfinite(a).all() and
                                          torch.isfinite(b).all()):
            fail(f"{name}: no finite gradient through the "
                 f"{'kernel' if a is None else 'plain version'}")
        if _rel(a, b) > worst:
            worst, worst_name = _rel(a, b), name
    if worst > MDN_F32_RTOL:
        fail(f"the MDN NLL gradient of {worst_name} differs from the plain "
             f"version's by {worst:.3e} of its norm (limit {MDN_F32_RTOL})")
    say(f"MDN float32 NLL gradient at S=512: NLL {loss_k.item():.4f} through "
        f"the kernel, {loss_p.item():.4f} plain; all {len(params)} "
        f"parameters have a finite gradient; worst {worst:.3e} of the norm "
        f"({worst_name}; limit {MDN_F32_RTOL})")

    state = trainer.create_train_state(copy.deepcopy(model), trainer.TrainConfig(
        learning_rate=3e-4), init=False)
    train_step = trainer.make_train_step()
    train_step(state, x)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses = [train_step(state, x)[1]["loss"] for _ in range(MDN_OPT_STEPS)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / MDN_OPT_STEPS
    trained = _counts()
    losses = torch.stack(losses).cpu()
    if trained != (0, 0, 0, layers * MDN_OPT_STEPS) or \
            not torch.isfinite(losses).all():
        fail(f"{MDN_OPT_STEPS} MDN steps at S=512 launched {trained}, "
             f"losses {losses.tolist()}")
    say(f"MDN float32 train steps at {MDN_LONG_BATCH}x{LONG_SEQ_LEN}: "
        f"{ms:.3f} ms/step (wall, {MDN_OPT_STEPS} steps after 1), NLL "
        f"{float(losses[0]):.4f} .. {float(losses[-1]):.4f}, launches "
        f"{trained}, on {smi}")
    del state

    served = [trained]
    full = lambda t: bf16(t, shift=False)   # noqa: E731 (one key)
    for name in ("ar_decode", "ar_decode_cached"):

        def run(first, name=name):
            g = torch.Generator(device="cuda").manual_seed(13 if first
                                                          else 14)
            if name == "ar_decode":
                return mdn_decode.ar_decode(
                    g, full, MDN_LONG_BATCH, steps=LONG_SEQ_LEN,
                    channels=CHANNELS, log_sigma_cap=0.0, device="cuda")
            return mdn_decode.ar_decode_cached(
                g, bf16, MDN_LONG_BATCH, steps=LONG_SEQ_LEN,
                channels=CHANNELS, log_sigma_cap=0.0)

        # ar_decode: 511 replays of the captured step and the last step, a
        # call of its own: 512 full forwards of 6 flash launches.
        out, seconds, first, counts = _serve_twice(
            f"{name} at S=512", run, LONG_SEQ_LEN,
            (0, 0, 0, layers if name == "ar_decode" else 0))
        if out.shape != shape or not torch.isfinite(out).all():
            fail(f"{name} at S=512: {tuple(out.shape)}, expected {shape} and "
                 "finite")
        say(f"MDN {name} bf16, {MDN_LONG_BATCH} requests of "
            f"{LONG_SEQ_LEN}x{CHANNELS}: {seconds:.3f} s = "
            f"{MDN_LONG_BATCH / seconds:.2f} seqs/s (replayed; the first "
            f"call, capture included, {first:.3f} s), launches {counts}, on "
            f"{smi}")
        served.append(counts)
    return served


# The MusicVAE codec and noise -> MIDI (phase 23). The codecs are the
# shipped architectures at full width with float32 weights from a seed: a
# copy of the repository for the card leaves the trained bundles
# (checkpoints/) out, as for the flagship's slice above.
CODEC_PIECES, CODEC_CHUNKS = 64, 32   # 64 pieces x 32 two-bar chunks
CODEC_CPU = 64                        # chunks held against the CPU
CODEC_HIER = 64                       # latents through each hierarchical
GEN_BATCH, GEN_STEPS = 64, 8          # noise -> MIDI: 64 requests, DPM++-8
MELODIES = 4                          # generate_melodies --n (512 x 42)
SONG_FILES = 16                       # MIDI files for generate_song_data
DATA_RANGE = (-3.0, 3.0)              # the bundles' normalization range
# The float32 codec on the card against the same model on the CPU (TF32
# off): |card - cpu| <= CODEC_RTOL * |cpu| in norm for mu, sigma and the
# teacher-forced logits: float32 sums in other orders through 32 steps of
# 2048-unit LSTMs, as CPU_RTOL holds the dense networks.
CODEC_RTOL = 1e-4
# Free-running tokens at temperature 1e-3 with the same Gumbel draws: equal
# on each row up to the first step where the CPU run's top-two gap of
# logits + temperature * Gumbel is below CODEC_MARGIN (a float32 logit
# moves by ~1e-6 between the devices; a gap below the margin may flip).
CODEC_MARGIN = 1e-3
CODEC_TEMPERATURE = 1e-3
# The bf16 codec (what the codec scripts serve on the card by default)
# against the float32 one on the card, on all the chunks: mu and the
# teacher-forced logits within these fractions of the norm, and the
# free-running tokens from the float32 mu with the same draws equal on each
# row up to its first step whose float32 top-two gap is below
# CODEC_BF16_MARGIN. CODEC_BF16_FAULT is planted each run and must be
# caught. The readings behind the limits (``study_torch_tolerances.py
# --codec``, PERF.md section 5), over weight seeds 23-25 (this phase's is
# 23): clean, mu 2.16e-3-2.38e-3 and logits 3.64e-3-3.71e-3 of the norm,
# tokens equal up to a gap of 1.36e-3 at most; every input product one
# bf16 ulp high (xi+1ulp), mu 3.16e-3-3.56e-3 and logits 4.30e-3-4.50e-3;
# the logits rounded to bf16, logits 3.98e-3-4.06e-3. The encoder's cell
# state rounded to bf16 moves mu by 3% (2.24e-3-2.46e-3), inside bf16's
# own spread: no limit against float32 tells it apart.
CODEC_BF16_MU = 2.8e-3
CODEC_BF16_LOGITS = 4.0e-3
CODEC_BF16_MARGIN = 3e-3
CODEC_BF16_FAULT = "xi+1ulp"


def _codec_tree(cfg, seed):
    """A Flax-layout float32 tree of ``cfg``'s MusicVAE from ``seed``."""
    from smd_tpu_torch.codec.musicvae import MusicVAE
    from smd_tpu_torch.utils.flax_params import random_flax_params
    with torch.device("meta"):
        shapes = MusicVAE(cfg)
    return random_flax_params(shapes, seed)


def _melody_pieces(seed, count, bars):
    """``count`` seeded monophonic pieces of ``bars`` bars at 120 qpm (a
    bar is 2 s), as the port's NoteSequences."""
    from smd_tpu_torch.codec.note_sequence import (NoteSequence, Tempo,
                                                   TimeSignature)
    rng = np.random.default_rng(seed)
    pieces = []
    for _ in range(count):
        ns = NoteSequence(tempos=[Tempo(qpm=120.0)],
                          time_signatures=[TimeSignature()])
        t, end, pitch = 0.0, 2.0 * bars, int(rng.integers(55, 80))
        while t < end:
            dur = float(rng.choice([0.25, 0.5, 0.5, 1.0]))
            if rng.random() < 0.85 or t + dur >= end:
                ns.add_note(pitch, int(rng.integers(60, 110)), t,
                            min(t + 0.9 * dur, end))
            pitch = int(np.clip(pitch + rng.integers(-4, 5), 48, 84))
            t += dur
        pieces.append(ns)
    return pieces


def _rel_norm(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm())


def _synced(fn):
    """(fn(), seconds between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile(fn, steps):
    """(device operations a step, device-busy ms a step, profiled ms a
    step, idle share, host launches a step) of ``fn`` under
    ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    from smd_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    device, busy, span, idle = profiling.trace_summary(prof)
    return (len(device) / steps, busy / 1e3 / steps, span / 1e3 / steps,
            idle, profiling.host_launches(prof) / steps)


def _tokens_until_close(ours, ref, logits, gumbel):
    """Steps compared: each row of ``ours`` equals ``ref`` up to its first
    step whose top-two gap of logits + temperature * Gumbel (``logits``
    and ``gumbel`` of the ``ref`` run) is below CODEC_MARGIN."""
    scores = (logits + CODEC_TEMPERATURE * gumbel).float().cpu()
    top2 = scores.topk(2, dim=-1).values
    close = (top2[..., 0] - top2[..., 1]) < CODEC_MARGIN
    ours, ref = ours.cpu(), ref.cpu()
    compared = 0
    for row in range(ref.shape[0]):
        hits = torch.nonzero(close[row])
        stop = int(hits[0]) if len(hits) else ref.shape[1]
        if not torch.equal(ours[row, :stop], ref[row, :stop]):
            fail(f"codec decode row {row}: card tokens "
                 f"{ours[row, :stop].tolist()} differ from the CPU's "
                 f"{ref[row, :stop].tolist()} before a top-two gap below "
                 f"{CODEC_MARGIN}")
        compared += stop
    return compared


@contextlib.contextmanager
def codec_fault(model, fault):
    """A planted fault in the bf16 codec ``model`` (None: none):

    - ``enc-carry-bf16``: the encoder's cell state rounded to bf16 each step
      (flax keeps it float32);
    - ``xi+1ulp``: every input product one bf16 ulp towards +inf;
    - ``logits-bf16``: the decoder's logits rounded to bf16 (they are
      float32).

    A kept chain's graph does not see a Python-level patch: with a fault
    the codec's chains run their steps eagerly (``graphs.eager()``).
    """
    from smd_tpu_torch.codec import musicvae as mv
    from smd_tpu_torch.utils import graphs
    undo = []
    if fault == "enc-carry-bf16":
        for cell in (model.encoder.OptimizedLSTMCell_0,
                     model.encoder.OptimizedLSTMCell_1):
            def step(carry, xi, w_h, b_h, _step=cell.step):
                c, h = _step(carry, xi, w_h, b_h)
                return c.bfloat16().to(c.dtype), h
            cell.step = step
            undo.append(lambda cell=cell: delattr(cell, "step"))
    elif fault == "xi+1ulp":
        product = mv.input_product

        def faulty(x, w_i):
            out = product(x, w_i)
            return torch.nextafter(out, torch.full_like(out, float("inf")))
        mv.input_product = faulty
        undo.append(lambda: setattr(mv, "input_product", product))
    elif fault == "logits-bf16":
        hook = model.decoder.cell.logits.register_forward_hook(
            lambda m, i, out: out.bfloat16().float())
        undo.append(hook.remove)
    elif fault is not None:
        raise ValueError(f"no codec fault {fault!r}")
    try:
        with (graphs.eager() if fault else contextlib.nullcontext()):
            yield
    finally:
        for f in undo:
            f()


def codec_reference(model, x, gumbel):
    """The float32 codec's (mu, teacher-forced logits, free-running logits,
    tokens) on chunks ``x``, decoding mu with the draws ``gumbel``."""
    mu, _ = model.encoder(x)
    teacher = model(x, noise=torch.zeros_like(mu))[0]
    logits, tokens = model.decode(mu, CODEC_TEMPERATURE, gumbel=gumbel)
    return mu, teacher, logits, tokens


def codec_bf16_readings(ref, bf16, x, gumbel, fault=None):
    """The bf16 codec ``bf16`` against ``codec_reference``'s ``ref``: mu's
    and the teacher-forced logits' |err| / |ref| in norm; ``margin_needed``,
    the least top-two gap of the float32 run at or before a row's first
    differing token, over the rows that differ (the tokens pass below a
    margin above it); the steps compared at CODEC_BF16_MARGIN, and the
    share of equal tokens."""
    mu, teacher, logits, tokens = ref
    with codec_fault(bf16, fault):
        mu16, _ = bf16.encoder(x)
        teacher16 = bf16(x, noise=torch.zeros_like(mu))[0]
        _, tokens16 = bf16.decode(mu, CODEC_TEMPERATURE, gumbel=gumbel)
    top2 = (logits + CODEC_TEMPERATURE * gumbel).topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    length = tokens.shape[1]
    steps = torch.arange(length, device=gap.device)

    def first(mask):
        return torch.where(mask.any(1), mask.int().argmax(1), length)

    differ = tokens16 != tokens
    rows = differ.any(1)
    upto = steps[None] <= first(differ)[:, None]
    needed = torch.where(upto, gap, float("inf")).min(1).values[rows]
    return {"mu": _rel_norm(mu16, mu),
            "logits": _rel_norm(teacher16, teacher),
            "margin_needed": float(needed.max()) if len(needed) else 0.0,
            "compared": int(first(gap < CODEC_BF16_MARGIN).sum()),
            "steps": tokens.numel(),
            "equal": float((~differ).float().mean())}


def codec_bf16_exceeded(r):
    """The limits the readings ``r`` exceed."""
    out = []
    if not r["mu"] <= CODEC_BF16_MU:
        out.append(f"mu {r['mu']:.3e} of the norm > {CODEC_BF16_MU}")
    if not r["logits"] <= CODEC_BF16_LOGITS:
        out.append(f"teacher-forced logits {r['logits']:.3e} of the norm > "
                   f"{CODEC_BF16_LOGITS}")
    if not r["margin_needed"] < CODEC_BF16_MARGIN:
        out.append(f"tokens differ before a float32 top-two gap below "
                   f"{CODEC_BF16_MARGIN} (least gap up to a row's first "
                   f"difference {r['margin_needed']:.3e})")
    return out


def _codec_bf16_check(codec, bf16, x, smi):
    """Hold the bf16 codec to the float32 one on ``x`` by the limits
    above, and catch CODEC_BF16_FAULT planted."""
    cfg = codec.config
    gumbel = card_gumbel((x.shape[0], cfg.max_seq_len, cfg.depth))
    ref = codec_reference(codec, x, gumbel)
    sound = codec_bf16_readings(ref, bf16, x, gumbel)
    exceeded = codec_bf16_exceeded(sound)
    if exceeded:
        fail("the bf16 codec against float32 on the card: "
             + "; ".join(exceeded))
    if sound["compared"] < sound["steps"] // 4:
        fail(f"bf16 codec tokens: only {sound['compared']} of "
             f"{sound['steps']} steps before a near tie; the check holds "
             "too little")
    faulted = codec_bf16_readings(ref, bf16, x, gumbel, CODEC_BF16_FAULT)
    if not codec_bf16_exceeded(faulted):
        fail(f"the bf16 codec check passes a planted {CODEC_BF16_FAULT} "
             f"fault: {faulted}")

    def line(r):
        return (f"mu {r['mu']:.3e}, teacher-forced logits {r['logits']:.3e} "
                f"of the norm, tokens {r['equal']:.4f} equal, least gap up "
                f"to a row's first difference {r['margin_needed']:.3e}")
    say(f"codec bf16 against float32 on the card, {x.shape[0]} chunks: "
        f"{line(sound)} (limits {CODEC_BF16_MU}, {CODEC_BF16_LOGITS}, "
        f"tokens equal on {sound['compared']} of {sound['steps']} steps up "
        f"to each row's first gap below {CODEC_BF16_MARGIN}); planted "
        f"{CODEC_BF16_FAULT}: {line(faulted)}, caught: "
        f"{'; '.join(codec_bf16_exceeded(faulted))}; on {smi}")


def card_gumbel(shape, seed=37):
    """Seeded Gumbel draws on the card."""
    from smd_tpu_torch.codec.musicvae import gumbel_noise
    return gumbel_noise(shape, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")


def codec_chunks():
    """CODEC_PIECES x CODEC_CHUNKS two-bar one-hot chunks (N, 32, 90),
    tokenized by the port's converter from seeded pieces."""
    from smd_tpu_torch.codec.melody import melody_2bar_converter
    chunks, seed = [], 0
    n_chunks = CODEC_PIECES * CODEC_CHUNKS
    while len(chunks) < n_chunks:
        for ns in _melody_pieces(seed, CODEC_PIECES, 2 * CODEC_CHUNKS):
            chunks += melody_2bar_converter.to_tensors(ns).inputs[::2]
        seed += 1
    return torch.from_numpy(np.stack(chunks[:n_chunks]))


def _codec_twice(what, run, graphs_made):
    """``run()`` twice, as a user serves two requests of one shape: the
    first call captures the codec chains' ``graphs_made`` CUDA graphs (each
    after ``graphs.WARMUP_STEPS`` eager warm-up steps), the second replays
    them and captures nothing. Returns (the second call's output, its
    seconds, the first call's seconds)."""
    from smd_tpu_torch.utils import graphs
    before = _warmups()
    _reset_counts()
    _, first = _synced(run)
    made = _warmups() - before
    if made != graphs.WARMUP_STEPS * graphs_made:
        fail(f"{what}: the first call ran {made} warm-up steps, expected "
             f"{graphs.WARMUP_STEPS} for each of {graphs_made} graphs")
    out, seconds = _synced(run)
    if _warmups() != before + made:
        fail(f"{what}: the second call captured again")
    if _counts() != (0, 0, 0, 0):
        fail(f"{what}: the codec launched a port kernel: {_counts()}")
    return out, seconds, first


def _codec_served(what, run, steps, graphs_made, smi):
    """A codec chain's shape served under the profiler: ``run()`` once
    (capturing where no graph of the shape is kept), then a replaying call
    profiled: host launches, wall (the profiled span) and device-busy ms a
    step, and the idle share."""
    _synced(run)
    before = _warmups()
    ops, busy, span, idle, launches = _profile(run, steps)
    if _warmups() != before:
        fail(f"{what}: the profiled call captured again")
    say(f"{what}, replayed under the profiler: {launches:.1f} host "
        f"launches and {ops:.1f} device operations a step, device busy "
        f"{busy:.3f} of {span:.3f} wall ms a step, idle share {idle:.3f} "
        f"({graphs_made} graph(s) a call), on {smi}")
    return busy, span, idle, launches


def phase_codec(tmp, smi):
    """melody-2-big at full width, float32 weights from a seed: 2,048
    tokenized chunks encoded and their mu decoded on the card, float32 and
    bf16, timed; the card against the CPU on 64 chunks; then 64 latents
    decoded through melody-16-big and multi-1-big. Returns the float32
    codec and the path of its bundle (fp16 leaves, as shipped)."""
    from smd_tpu_torch.codec import musicvae as mv
    from smd_tpu_torch.config import MUSIC_VAE_CONFIG
    from smd_tpu_torch.scripts.package_generation_bundle import fp16_tree
    from smd_tpu_torch.utils import io as io_lib

    cfg = MUSIC_VAE_CONFIG["melody-2-big"].model
    t0 = time.perf_counter()
    tree = _codec_tree(cfg, seed=23)
    codec = mv.TrainedMusicVAE(params=tree, config=cfg, device="cuda")
    cpu = mv.TrainedMusicVAE(params=tree, config=cfg, device="cpu")
    bf16 = mv.build_musicvae(cfg, tree, dtype=torch.bfloat16, device="cuda")
    path = os.path.join(tmp, "codec-melody-2-big.pkl")
    io_lib.save({"params": fp16_tree(codec.model.state_dict()),
                 "config": cfg}, path)
    del tree
    n_params = sum(p.numel() for p in codec.model.parameters())
    say(f"melody-2-big codec: {n_params / 1e6:.2f} M parameters from a seed "
        f"(BiLSTM-{cfg.enc_units}, {len(cfg.dec_units)} x "
        f"{cfg.dec_units[0]} decoder, {cfg.latent_dims}-d latent), built in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    x = codec_chunks().cuda()
    n_chunks = x.shape[0]
    say(f"tokenized {n_chunks} two-bar chunks ({x.shape[1]} steps x "
        f"{x.shape[2]}) from seeded pieces in "
        f"{time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(23)
    rates = {}
    with torch.no_grad():
        for name, model in (("float32", codec.model), ("bf16", bf16)):
            (_, mu, sigma), enc_s, enc_first = _codec_twice(
                f"the {name} encode of {n_chunks} chunks",
                lambda: model.encode(x, gen), 1)
            (_, tokens), dec_s, dec_first = _codec_twice(
                f"the {name} decode of {n_chunks} chunks",
                lambda: model.decode(mu, CODEC_TEMPERATURE, generator=gen),
                1)
            if not (torch.isfinite(mu).all() and torch.isfinite(sigma).all()
                    and (sigma > 0).all()) or tokens.shape != x.shape[:2]:
                fail(f"the {name} codec's posterior or tokens are malformed")
            rates[name] = (mu, tokens)
            say(f"codec {name} on {n_chunks} chunks, each the second call "
                f"of its shape (the kept chain's graph replayed): encode "
                f"{enc_s:.3f} s = {n_chunks / enc_s:.1f} chunks/s (first "
                f"call, capturing, {enc_first:.3f} s), decode (temperature "
                f"{CODEC_TEMPERATURE}) {dec_s:.3f} s = "
                f"{n_chunks / dec_s:.1f} chunks/s (first {dec_first:.3f} s), "
                f"on {smi}")
        mu32 = rates["float32"][0]
        _codec_bf16_check(codec.model, bf16, x, smi)
        for batch in (64, n_chunks):
            _codec_served(f"codec float32 decode of {batch} chunks",
                          lambda: codec.model.decode(
                              mu32[:batch], CODEC_TEMPERATURE,
                              generator=gen), cfg.max_seq_len, 1, smi)
        _codec_served(f"codec float32 encode of {n_chunks} chunks",
                      lambda: codec.model.encode(x, gen), cfg.max_seq_len,
                      1, smi)

        # The card against the CPU, float32, on CODEC_CPU chunks.
        xs = x[:CODEC_CPU]
        mu_c, sigma_c = cpu.model.encoder(xs.cpu())
        mu_g, sigma_g = codec.model.encoder(xs)
        noise = torch.zeros_like(mu_c)
        tf_c = cpu.model(xs.cpu(), noise=noise)[0]
        tf_g = codec.model(xs, noise=noise.cuda())[0]
        gumbel = mv.gumbel_noise((CODEC_CPU, cfg.max_seq_len, cfg.depth),
                                 torch.Generator().manual_seed(31))
        logits_c, tokens_c = cpu.model.decode(mu_c, CODEC_TEMPERATURE,
                                              gumbel=gumbel)
        _, tokens_g = codec.model.decode(mu_c.cuda(), CODEC_TEMPERATURE,
                                         gumbel=gumbel.cuda())
    errs = {"mu": _rel_norm(mu_g, mu_c), "sigma": _rel_norm(sigma_g, sigma_c),
            "teacher-forced logits": _rel_norm(tf_g, tf_c)}
    for what, err in errs.items():
        if not err <= CODEC_RTOL:
            fail(f"codec {what} on the card differs from the CPU's by "
                 f"{err:.3e} of the norm (limit {CODEC_RTOL})")
    compared = _tokens_until_close(tokens_g, tokens_c, logits_c, gumbel)
    if compared < tokens_c.numel() // 4:
        fail(f"codec decode: only {compared} of {tokens_c.numel()} steps "
             "before a near tie; the check holds too little")
    say(f"codec float32 card vs CPU on {CODEC_CPU} chunks: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" of the norm (limit {CODEC_RTOL}); free-running tokens equal on "
        f"{compared} of {tokens_c.numel()} steps (each row up to its first "
        f"top-two gap below {CODEC_MARGIN}), "
        f"{int((tokens_g.cpu() == tokens_c).sum())} equal in all")
    del bf16, cpu, rates
    torch.cuda.empty_cache()

    for entry in ("melody-16-big", "multi-1-big"):
        e = MUSIC_VAE_CONFIG[entry]
        vae = mv.TrainedMusicVAE(params=_codec_tree(e.model, seed=24),
                                 config=e.model,
                                 converter=e.data_converter, device="cuda")
        z = np.random.default_rng(24).standard_normal(
            (CODEC_HIER, e.model.latent_dims)).astype(np.float32)
        S = e.model.hier_segments
        # The conductor's chain and the decoder's: two graphs.
        tokens, seconds, first = _codec_twice(
            f"the {entry} decode", lambda: vae.decode_to_tensors(z), 2)
        _codec_served(f"{entry} decode of {CODEC_HIER} latents",
                      lambda: vae.decode_to_tensors(z),
                      e.model.max_seq_len // S, 2, smi)
        seqs = vae.converter.from_tensors(tokens)
        if tokens.shape != (CODEC_HIER, e.model.max_seq_len) or \
                tokens.min() < 0 or tokens.max() >= e.model.depth or \
                len(seqs) != CODEC_HIER:
            fail(f"{entry} decoded tokens {tokens.shape} in "
                 f"[{tokens.min()}, {tokens.max()}]")
        n_params = sum(p.numel() for p in vae.model.parameters())
        say(f"{entry} decode ({S} segments x {e.model.max_seq_len // S} "
            f"steps, {n_params / 1e6:.1f} M parameters from a seed): "
            f"{CODEC_HIER} latents in "
            f"{seconds:.3f} s = {CODEC_HIER / seconds:.1f} chunks/s (the "
            f"second call; the first, capturing, {first:.3f} s), "
            f"{sum(len(s.notes) for s in seqs)} notes, on {smi}")
        del vae
        torch.cuda.empty_cache()
    return codec, path


@contextlib.contextmanager
def _decoded_tokens():
    """The tokens every TrainedMusicVAE decodes inside the block, in order
    (its ``decode_to_tensors`` wrapped for the block)."""
    from smd_tpu_torch.codec.musicvae import TrainedMusicVAE
    decode, tokens = TrainedMusicVAE.decode_to_tensors, []

    def record(self, z, temperature=1e-3, gumbel=None):
        tokens.append(decode(self, z, temperature, gumbel))
        return tokens[-1]
    TrainedMusicVAE.decode_to_tensors = record
    try:
        yield tokens
    finally:
        TrainedMusicVAE.decode_to_tensors = decode


def _check_midi(path, tokens):
    """The MIDI file at ``path`` reads back with one note per note-on token
    of ``tokens`` (chunks, steps), in order."""
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec.melody import MIN_PITCH
    pitches = [n.pitch for n in midi_io.read_midi_file(path).notes]
    expected = [int(t) - 2 + MIN_PITCH for t in np.asarray(tokens).ravel()
                if t >= 2]
    if pitches != expected:
        fail(f"{path} reads back {len(pitches)} notes, its tokens say "
             f"{len(expected)}")
    return len(pitches)


def _slice_idx(seed):
    return np.sort(np.random.default_rng(seed).choice(512, CHANNELS,
                                                      replace=False))


def phase_noise_to_midi(tmp, smi, codec):
    """The fused flagship (seeded weights, bf16) samples 64 requests of
    32x42 with DPM++-8 through the film and attention kernels; the latents
    are inverse-transformed to 512 dims and decoded by ``codec`` into 64
    MIDI files, each read back with the notes its tokens say. Returns the
    sample's launch counts."""
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.codec import song as song_lib
    from smd_tpu_torch.data import transforms
    from smd_tpu_torch.sampling import generate

    model, model_fn = _flagship()
    kw = dict(num_samples=GEN_BATCH, sampling="dpmpp", ddim_steps=GEN_STEPS,
              collect_steps=0, collect_metrics=False, device="cuda")
    with torch.no_grad():
        _fewstep_warmup(model_fn, "dpmpp", dict(ddim_steps=GEN_STEPS),
                        GEN_BATCH)
        gen = torch.Generator(device="cuda").manual_seed(23)
        _reset_counts()
        (samples, _, _), seconds = _synced(lambda: generate.sample(
            model_fn, _betas(), gen, (SEQ_LEN, CHANNELS), **kw))
    counts = _counts()
    _check_launches(f"the DPM++-{GEN_STEPS} sample", counts,
                    tuple(GEN_STEPS * n for n in per_call_launches("fused")))
    if samples.shape != (GEN_BATCH, SEQ_LEN, CHANNELS) or \
            not torch.isfinite(samples).all():
        fail(f"the DPM++ samples: {tuple(samples.shape)}, not all finite")
    del model, model_fn
    latents = transforms.inverse_data_transform(
        samples.cpu().numpy(), True, None, *DATA_RANGE, _slice_idx(23),
        out_channels=512, rng=np.random.default_rng(23))
    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "noise-to-midi")
    os.makedirs(out_dir)
    notes = 0
    with _decoded_tokens() as tokens:
        for i in range(GEN_BATCH):
            song = song_lib.embeddings_to_song(latents[i].astype(np.float64),
                                               codec, codec.converter)
            path = os.path.join(out_dir, f"melody_{i:03d}.mid")
            midi_io.write_midi_file(song.note_sequence, path)
            notes += _check_midi(path, tokens[-1])
    seconds_midi = time.perf_counter() - t0
    say(f"noise -> MIDI: DPM++-{GEN_STEPS} on {GEN_BATCH} requests of "
        f"{SEQ_LEN}x{CHANNELS} through the fused flagship in {seconds:.3f} s "
        f"(launches (attention, film, w8a8, flash) {counts}, all attention "
        f"on the tensor-core kernel); inverse transform to "
        f"{latents.shape[-1]} dims; {GEN_BATCH} x {SEQ_LEN} = "
        f"{GEN_BATCH * SEQ_LEN} chunks decoded and {GEN_BATCH} MIDI files "
        f"written and read back ({notes} notes, each as its tokens say) in "
        f"{seconds_midi:.3f} s, on {smi}")
    return counts


def phase_codec_clis(tmp, smi, codec_path):
    """``generate_melodies`` on a bundle of the port's writer (the
    standard flagship from a seed, 512x42: flash attention) and the codec
    of phase 23a; then ``generate_song_data`` on 16 seeded MIDI files and
    ``decode_dataset`` on its records. Returns generate_melodies' launch
    counts."""
    from smd_tpu_torch.codec import midi_io
    from smd_tpu_torch.data import tfrecord_native
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.scripts import (decode_dataset, generate_melodies,
                                       generate_song_data,
                                       package_generation_bundle)
    from smd_tpu_torch.utils import io as io_lib
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)

    std = get_model("TransformerDDPM", device="cpu", data_channels=CHANNELS,
                    **FLAGSHIP)
    load_flax_params(std, random_flax_params(std, seed=0))
    arch = {k: v for k, v in FLAGSHIP.items() if k != "embed_channels"}
    bundle = package_generation_bundle.generation_bundle(
        dict(std.named_parameters()),
        arch={"architecture": "TransformerDDPM", **arch},
        schedule={"sigma_begin": 1e-6, "sigma_end": 0.01,
                  "num_sigmas": SERVE_STEPS, "kind": "linear"},
        sample_shape=(LONG_SEQ_LEN, CHANNELS), out_channels=512,
        slice_idx=_slice_idx(24), normalize=True, data_min=DATA_RANGE[0],
        data_max=DATA_RANGE[1], provenance="chip_smoke phase 23c")
    del std
    bundle_path = os.path.join(tmp, "bundle-512.pkl")
    io_lib.save(bundle, bundle_path)

    out_dir = os.path.join(tmp, "melodies")
    with _decoded_tokens() as decoded:
        _reset_counts()
        paths, seconds = _synced(lambda: generate_melodies.main([
            "generate_melodies", f"--bundle={bundle_path}",
            f"--vae_params={codec_path}", f"--output_dir={out_dir}",
            "--sampler=dpmpp", f"--steps={GEN_STEPS}", f"--n={MELODIES}"]))
    counts = _counts()
    # One call: the DPM++ step captured after its warm-up steps.
    from smd_tpu_torch.utils import graphs
    expected = tuple((GEN_STEPS + graphs.WARMUP_STEPS) * n
                     for n in per_call_launches("standard", LONG_SEQ_LEN))
    if counts != expected:
        fail(f"generate_melodies at S={LONG_SEQ_LEN} launched (attention, "
             f"film, w8a8, flash) {counts}, expected {expected}")
    chunks = sum(len(t) for t in decoded)
    if len(paths) != MELODIES or chunks != MELODIES * LONG_SEQ_LEN:
        fail(f"generate_melodies wrote {len(paths)} files from {chunks} "
             f"chunks, expected {MELODIES} from {MELODIES * LONG_SEQ_LEN}")
    notes = sum(_check_midi(p, t) for p, t in zip(paths, decoded))
    say(f"generate_melodies --sampler=dpmpp --steps={GEN_STEPS} "
        f"--n={MELODIES} on a {LONG_SEQ_LEN}x{CHANNELS} standard-layout "
        f"bundle: {seconds:.3f} s, launches (attention, film, w8a8, flash) "
        f"{counts}; {chunks} chunks decoded into {len(paths)} MIDI files "
        f"({notes} notes, each as its tokens say), on {smi}")

    midi_dir = os.path.join(tmp, "midi")
    os.makedirs(midi_dir)
    for i, ns in enumerate(_melody_pieces(25, SONG_FILES, bars=16)):
        midi_io.write_midi_file(ns, os.path.join(midi_dir, f"{i:02d}.mid"))
    encoded, dec_dir = os.path.join(tmp, "encoded"), os.path.join(tmp, "dec")
    (count, skipped), enc_s = _synced(lambda: generate_song_data.main([
        "generate_song_data", f"--input={midi_dir}/*.mid",
        f"--output={encoded}", f"--vae_params={codec_path}",
        "--workers=2"]))
    if count != SONG_FILES or skipped:
        fail(f"generate_song_data encoded {count} songs, skipped {skipped}")
    songs = [pickle.loads(r) for name in ("eval", "training")
             for r in tfrecord_native.iter_records(
                 os.path.join(encoded, f"{name}_seqs.tfrecord-00000"))]
    for song in songs:
        if song.ndim != 3 or song.shape[0] != 3 or song.shape[2] != 512 or \
                not np.isfinite(song).all():
            fail(f"an encoded song record is {song.shape}, or not finite")
    n_chunks = sum(s.shape[1] for s in songs)
    split, dec_s = _synced(lambda: decode_dataset.main([
        "decode_dataset", f"--encoded_data={encoded}", f"--output={dec_dir}",
        f"--vae_params={codec_path}"]))
    tokens = [pickle.loads(r) for name in ("eval", "train")
              for r in tfrecord_native.iter_records(
                  os.path.join(dec_dir, f"decoded-{name}.tfrecord-00000"))]
    if len(tokens) != len(songs) or any(
            t.dtype != np.bool_ or t.shape != (s.shape[1] * 32, 90) or
            not (t.sum(-1) == 1).all() for t, s in zip(tokens, songs)):
        fail("decode_dataset's records are not one one-hot row per step of "
             "each song")
    say(f"generate_song_data on {SONG_FILES} MIDI files: {len(songs)} songs, "
        f"{n_chunks} chunks in {enc_s:.3f} s (bf16 codec, 2 parser "
        f"processes); decode_dataset {split} in {dec_s:.3f} s; every record "
        f"finite and of its shape, on {smi}")
    return counts



# Codec training and the quality path (phase 24): the codec trainer at the
# shipped melody-2-big width (cat-mel_2bar_big) on a seeded synthetic
# corpus, its artifact evaluated and rendered to audio, and the metric sweep
# of sample_ncsn --compute_metrics on the fused flagship's samples.
CODEC_SONGS = 64
CODEC_STEPS = 200
CODEC_TRAIN_FLAGS = ("--enc_units=2048", "--dec_units=2048",
                     "--dec_layers=3", "--latent_dims=512",
                     "--batch_size=64", f"--steps={CODEC_STEPS}",
                     "--scheduled_sampling=0.2", "--log_every=50",
                     "--parse_workers=1", "--seed=24")
# One train step of a narrow codec on the card against the same step on
# the CPU (TF32 off), the encoder noise and the scheduled-sampling draws
# replayed: |p_card - p_cpu| <= CODEC_STEP_RTOL * |p_cpu| for every
# parameter. Float32 sums in other orders through 32 LSTM steps forward
# and back; Adam's first step moves each element by about lr, so the
# learning rate is kept small (1e-4): a gradient element at rounding level
# whose sign differs moves that element by 2e-4.
CODEC_STEP_RTOL = 1e-4
METRIC_REQUESTS = 1000
# 16 latents as 4 pieces of 4 two-bar chunks: a briefly trained codec may
# decode a chunk to a rest (one-chunk pieces: 5 of 32 silent on the H100),
# a piece of four rarely.
AUDIO_PIECES, AUDIO_CHUNKS = 4, 4
# sample_audio's prior baseline draws from numpy's global generator, as the
# JAX script does; 24d seeds it so that every run decodes the same prior
# pieces: the briefly trained codec decodes some draws of the prior to no
# notes at all, which render as a silent WAV.
AUDIO_PRIOR_SEED = 24


class ScalarLog:
    """A ``SummaryWriter`` that keeps the scalars (``evaluate`` writes each
    model's metrics there and returns the last model's)."""

    def __init__(self):
        self.scalars = {}

    def scalar(self, tag, value, step):
        self.scalars[tag] = float(value)

    def image(self, tag, png, step):
        pass

    def flush(self):
        pass


def _codec_step_vs_cpu():
    """One train step of a narrow codec (latent 64, 128-unit encoder, 2 x
    128 decoder, scheduled sampling 0.5) on the card and on the CPU from
    the same tree, batch and draws; returns the worst parameter's
    relative difference."""
    from smd_tpu_torch.codec import musicvae as mv
    from smd_tpu_torch.training import musicvae as mvtrain
    cfg = mv.MusicVAEConfig(latent_dims=64, enc_units=128,
                            dec_units=(128, 128), free_bits=0.0)
    tree = _codec_tree(cfg, seed=24)
    gen = torch.Generator().manual_seed(24)
    B, T = 16, cfg.max_seq_len
    batch = torch.randint(0, cfg.depth, (B, T), generator=gen,
                          dtype=torch.uint8)
    draws = dict(noise=torch.randn(B, cfg.latent_dims, generator=gen),
                 gumbel=mv.gumbel_noise((B, T, cfg.depth), gen),
                 ss_mix=torch.rand(B, T, 1, generator=gen))
    params = {}
    for device in ("cpu", "cuda"):
        model = mv.build_musicvae(cfg, tree, device=device).train()
        model.requires_grad_(True)
        opt = mvtrain.make_optimizer(1e-4, 0, CODEC_STEPS)
        state = opt.init(dict(model.named_parameters()))
        mvtrain.train_step(model, opt, state, batch.to(device), 0.5,
                           **{k: v.to(device) for k, v in draws.items()})
        params[device] = {n: p.detach().cpu()
                          for n, p in model.named_parameters()}
    return max(float((params["cuda"][n] - p).norm() / p.norm())
               for n, p in params["cpu"].items())


def phase_codec_training(tmp, smi):
    """24a: ``train_musicvae.main`` at melody-2-big's width on a seeded
    corpus, 200 steps on the card, float32, scheduled sampling 0.2; the
    ELBO finite and falling; the float16 artifact loaded on the card; one
    narrow train step against the CPU. Returns the artifact's path."""
    from smd_tpu_torch.codec import musicvae as mv
    from smd_tpu_torch.scripts import make_melody_corpus, train_musicvae
    from smd_tpu_torch.scripts.train_musicvae import load_tensors
    from smd_tpu_torch.utils import io as io_lib
    corpus = f"{tmp}/corpus"
    make_melody_corpus.main(["make_melody_corpus", f"--output_dir={corpus}",
                             f"--n_songs={CODEC_SONGS}", "--seed=24"])
    path = f"{tmp}/musicvae-trained.pkl"
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = train_musicvae.main(["train_musicvae", f"--input={corpus}/*.mid",
                               *CODEC_TRAIN_FLAGS, f"--output={path}",
                               "--device=cuda"])
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_launches("codec training", _counts(), (0, 0, 0, 0))
    losses = out["losses"]
    if losses.shape != (CODEC_STEPS,) or not np.isfinite(losses).all():
        fail(f"codec training: ELBO not finite or not {CODEC_STEPS} steps")
    tail = float(losses[-20:].mean())
    if not tail < float(losses[0]):
        fail(f"codec training: the last 20 steps' ELBO {tail:.3f} is not "
             f"below the first step's {float(losses[0]):.3f}")
    cfg, metrics = out["config"], out["metrics"]
    codec = mv.TrainedMusicVAE(params=io_lib.load(path), device="cuda")
    n_params = sum(p.numel() for p in codec.model.parameters())
    ids = load_tensors(sorted(glob.glob(f"{corpus}/*.mid")), 1)[:64]
    z, mu, sigma = codec.encode_tensors(
        [np.eye(cfg.depth, dtype=np.float32)[row] for row in ids])
    tokens = codec.decode_to_tensors(mu)
    if not (np.isfinite(mu).all() and np.isfinite(sigma).all()) or \
            tokens.shape != (64, cfg.max_seq_len):
        fail("the trained codec's float16 artifact does not encode and "
             "decode on the card")
    step_ms = 1e3 * out["step_seconds"] / CODEC_STEPS
    say(f"train_musicvae melody-2-big ({n_params / 1e6:.1f} M parameters, "
        f"batch 64, float32, scheduled sampling 0.2 ramped): "
        f"{metrics['train_chunks']} train / {metrics['eval_chunks']} eval "
        f"chunks of {CODEC_SONGS} songs; {CODEC_STEPS} steps in "
        f"{seconds:.1f} s wall (parse, build, evaluations and the artifact "
        f"included); {step_ms:.2f} ms a step (optimizer steps alone, the "
        f"card synchronized every 25); peak memory {peak_gb:.2f} GB; ELBO "
        f"first {float(losses[0]):.2f}, mean of the last 20 {tail:.2f}; "
        f"held-out round trip {metrics['eval_roundtrip_acc']:.4f}, teacher "
        f"forced {metrics['eval_teacher_forced_acc']:.4f}; float16 artifact "
        f"loaded on the card, 64 chunks encoded and decoded; on {smi}")
    ops, busy, span, idle, products = _codec_step_profile(path)
    say(f"melody-2-big train step at batch 64 under the profiler (3 steps): "
        f"{ops:.0f} device operations a step, device busy {busy:.2f} of "
        f"{span:.2f} ms a step (idle {idle:.3f}), of which the products "
        f"(cuBLAS GEMM kernels) {products:.2f} ms")
    rel = _codec_step_vs_cpu()
    if rel > CODEC_STEP_RTOL:
        fail(f"a codec train step on the card differs from the CPU's by "
             f"{rel:.3e} of a parameter's norm, more than {CODEC_STEP_RTOL}")
    say(f"codec train step (latent 64, 128 units, scheduled sampling 0.5), "
        f"card vs CPU, same draws: worst parameter {rel:.3e} of its norm "
        f"(tolerance {CODEC_STEP_RTOL})")
    return path, corpus


def _codec_step_profile(path, steps=3):
    """A melody-2-big train step at batch 64 under the profiler, from the
    trained artifact: (device operations a step, device-busy ms a step,
    profiled ms a step, idle share, products' device ms a step)."""
    from smd_tpu_torch.codec import musicvae as mv
    from smd_tpu_torch.training import musicvae as mvtrain
    from smd_tpu_torch.utils import io as io_lib
    from smd_tpu_torch.utils import profiling
    bundle = io_lib.load(path)
    cfg = mv.normalize_config(bundle["config"])
    model = mv.build_musicvae(cfg, bundle["params"], device="cuda").train()
    model.requires_grad_(True)
    opt = mvtrain.make_optimizer(1e-3, 200, CODEC_STEPS)
    state = opt.init(dict(model.named_parameters()))
    gen = torch.Generator(device="cuda").manual_seed(24)
    batch = torch.randint(0, cfg.depth, (64, cfg.max_seq_len),
                          generator=gen, device="cuda")

    def run(n):
        for _ in range(n):
            mvtrain.train_step(model, opt, state, batch, 0.2, gen)

    run(1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run(steps)
        torch.cuda.synchronize()
    device, busy, span, idle = profiling.trace_summary(prof)
    products = profiling.busy_us([(e.time_range.start, e.time_range.end)
                                  for e in device
                                  if "gemm" in e.name.lower()])
    return (len(device) / steps, busy / 1e3 / steps, span / 1e3 / steps,
            idle, products / 1e3 / steps)


def phase_eval_codec(smi, path, corpus):
    """24b: ``eval_codec.main`` on 24a's artifact over 64 chunks."""
    from smd_tpu_torch.scripts import eval_codec
    t0 = time.perf_counter()
    scores = eval_codec.main(["eval_codec", f"--input={corpus}/*.mid",
                              f"--vae_params={path}", "--max_chunks=64",
                              "--device=cuda"])
    seconds = time.perf_counter() - t0
    if list(scores) != list(eval_codec.NAMES) or not all(
            np.isfinite(v) and 0 <= v <= 1 for v in scores.values()):
        fail(f"eval_codec scores {scores}")
    say(f"eval_codec on the trained artifact, 64 chunks: "
        + ", ".join(f"{k} {v:.4f}" for k, v in scores.items())
        + f" in {seconds:.2f} s (artifact load included) on {smi}")


def phase_sampling_metrics(tmp, smi):
    """24c: DPM++-8 on 1000 requests of 32x42 through the fused flagship
    at bf16 (phase 4's weights), and through the same weights in float32
    on the plain versions; ``sample_ncsn.evaluate`` on the bf16 samples
    against seeded real latents; then ``sample_ncsn --compute_metrics
    --compute_final_only`` on phase 10's checkpoint and records. Returns
    the launch counts."""
    from smd_tpu_torch import cli, sample_ncsn
    from smd_tpu_torch.eval import metrics
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model, model_fn = _flagship()
    f32 = get_model("TransformerDDPM", device="cuda", data_channels=CHANNELS,
                    fused_attention=True, fused_head=True, **FLAGSHIP)
    load_flax_params(f32, random_flax_params(f32, seed=0))
    f32.eval().use_plain_ops(True)

    def sample(fn):
        gen = torch.Generator(device="cuda").manual_seed(24)
        with torch.no_grad():
            out, _, _ = generate.sample(
                fn, _betas(), gen, (SEQ_LEN, CHANNELS),
                num_samples=METRIC_REQUESTS, sampling="dpmpp", ddim_steps=8,
                collect_steps=0, collect_metrics=False, device="cuda")
        return out.cpu().numpy().astype(np.float64)

    with torch.no_grad():
        _fewstep_warmup(model_fn, "dpmpp", {"ddim_steps": 8},
                        METRIC_REQUESTS)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    samples = sample(model_fn)
    sample_s = time.perf_counter() - t0
    counts = _counts()
    _check_launches("the metric sweep's DPM++-8 samples", counts,
                    tuple(8 * n for n in per_call_launches("fused")))
    samples_f32 = sample(lambda x, c: f32(x, c))
    del model, f32
    real = np.random.default_rng(24).normal(
        size=(METRIC_REQUESTS, SEQ_LEN, CHANNELS))
    cli.FLAGS(["sample_ncsn", "--compute_final_only"])
    log = ScalarLog()
    t0 = time.perf_counter()
    stats = sample_ncsn.evaluate(log, real, samples[None], None, real,
                                 has_init=False)
    sweep_s = time.perf_counter() - t0
    fd_samples = log.scalars["ncsn/frechet_distance"]
    if not all(np.isfinite(v) for v in [*stats.values(),
                                        *log.scalars.values()]):
        fail(f"non-finite metric: {stats} {log.scalars}")
    if not stats["frechet_dist"] < fd_samples:
        fail(f"FD(real, real) {stats['frechet_dist']:.4f} is not below "
             f"FD(real, samples) {fd_samples:.4f}")
    t0 = time.perf_counter()
    fd_f32 = metrics.frechet_distance(real, samples_f32)
    fd_between = metrics.frechet_distance(samples_f32, samples)
    fd_s = (time.perf_counter() - t0) / 2
    say(f"DPM++-8 fused bf16, {METRIC_REQUESTS} requests of "
        f"{SEQ_LEN}x{CHANNELS} in {sample_s:.3f} s (launches {counts}); "
        f"evaluate (compute_final_only: ncsn, random and real against "
        f"{METRIC_REQUESTS} seeded real latents, 1344-d) in {sweep_s:.1f} s "
        f"on the host; ncsn: FD {fd_samples:.4f}, precision "
        f"{log.scalars['ncsn/precision']:.4f}, recall "
        f"{log.scalars['ncsn/recall']:.4f}, improved P/R "
        f"{log.scalars['ncsn/improved_precision']:.4f}/"
        f"{log.scalars['ncsn/improved_recall']:.4f}, NDB "
        f"{log.scalars['ncsn/ndb']:.4f}, MMD rbf "
        f"{log.scalars['ncsn/mmd_rbf']:.3e}; returned (the real baseline's, "
        f"as the reference): FD {stats['frechet_dist']:.4e}; on {smi}")
    say(f"FD cost of bf16 serving (random weights, same seeds, DPM++-8): "
        f"FD(real, bf16 fused) {fd_samples:.4f}, FD(real, float32 plain) "
        f"{fd_f32:.4f}, FD(float32, bf16) {fd_between:.4f} "
        f"({fd_s:.2f} s an FD)")
    return counts


def phase_metrics_cli(tmp, smi):
    """24c: ``sample_ncsn --compute_metrics --compute_final_only`` on
    phase 10's checkpoint and records (DPM++-8, 128 requests)."""
    import json as json_lib

    from smd_tpu_torch import sample_ncsn
    data, out = f"{tmp}/data", f"{tmp}/metrics"
    t0 = time.perf_counter()
    _reset_counts()
    sample_ncsn.main(["sample_ncsn", f"--flagfile={FLAGFILE}",
                      f"--dataset={data}", f"--slice_ckpt={data}/slice.pkl",
                      f"--model_dir={tmp}/fp32", "--sampling=dpmpp",
                      "--ddim_steps=8", f"--sample_size={EVAL_EXAMPLES}",
                      f"--sampling_dir={out}", "--compute_metrics",
                      "--compute_final_only"])
    seconds = time.perf_counter() - t0
    _check_launches("sample_ncsn --compute_metrics", _counts(),
                    per_call_launches("standard"))
    with open(f"{out}/metrics.json") as f:
        stats = json_lib.load(f)
    if not stats or not all(np.isfinite(v) for v in stats.values()):
        fail(f"sample_ncsn --compute_metrics wrote {stats}")
    say(f"sample_ncsn --compute_metrics --compute_final_only on phase 10's "
        f"checkpoint, {EVAL_EXAMPLES} requests DPM++-8: {seconds:.1f} s "
        f"(load, sampling and the sweep); metrics.json finite "
        f"({len(stats)} stats) on {smi}")


def phase_audio(tmp, smi, path):
    """24d: ``sample_audio`` on 24a's artifact and 16 latents (4 pieces of
    4 chunks): WAVs written and not silent."""
    from scipy.io import wavfile

    from smd_tpu_torch.eval import plots
    from smd_tpu_torch.scripts import sample_audio
    from smd_tpu_torch.utils import io as io_lib
    latents = np.random.default_rng(24).normal(
        size=(AUDIO_PIECES, AUDIO_CHUNKS, 512))
    io_lib.save(latents.astype(np.float32), f"{tmp}/audio-in/generated.pkl")
    out = f"{tmp}/audio"
    plot_flag = "--include_plots" if plots.available() \
        else "--noinclude_plots"
    np.random.seed(AUDIO_PRIOR_SEED)
    t0 = time.perf_counter()
    rendered = sample_audio.main([
        "sample_audio", f"--input={tmp}/audio-in", f"--output={out}",
        f"--vae_params={path}", f"--n_synth={AUDIO_PIECES}", plot_flag,
        "--device=cuda"])
    seconds = time.perf_counter() - t0
    if len(rendered) != 2 * AUDIO_PIECES:
        fail(f"sample_audio rendered {len(rendered)} files")
    peaks = []
    for base in rendered:
        _, pcm = wavfile.read(f"{base}.wav")
        peaks.append(int(np.abs(pcm).max()))
    if min(peaks) < 100:
        fail(f"sample_audio wrote a silent WAV (peaks {peaks})")
    say(f"sample_audio: {AUDIO_PIECES} pieces of {AUDIO_CHUNKS} latents "
        f"and the prior baseline decoded on the card and rendered "
        f"({len(rendered)} WAVs, 44.1 "
        f"kHz, peaks {min(peaks)}-{max(peaks)} of 32767; {plot_flag}, "
        f"matplotlib {'imports' if plots.available() else 'absent'}) in "
        f"{seconds:.1f} s on {smi}")


# Distributed training (phase 25). 25b-25d run their ranks as processes on
# this card (gloo over CUDA tensors) or, with a card a rank, on NCCL.
DDP_STEPS = 20              # 25a: train_ncsn under RANK=0 WORLD_SIZE=1
DDP_SCAN_CHUNK = 4          # 25a's chunk in the group; 25b's on 2 ranks
DDP_BATCH, DDP_RANKS, DDP_TRAIN_STEPS = 64, 2, 3
# 25b: the two ranks against one rank on the 64 rows with the same draws,
# its gradient taken as the ranks take it (two halves of 32 averaged in
# float32): each parameter within DDP_RTOL of its norm (the same
# arithmetic: bit-equal on the card). Against one rank's gradient of the
# 64 rows in one batch: rank 0's first averaged gradient within
# DDP_GRAD_RTOL of each leaf's norm, every rank's losses within
# DDP_LOSS_RTOL, and the params after the steps within DDP_ONE_BATCH_RTOL.
# These differ only by bf16 rounding: a bf16 ulp is 2^-8 (3.9e-3) of an
# element, and the 32- and 64-row reductions round apart. Read on the card
# (NVIDIA H100 80GB HBM3, 700 W): params 1.317e-3, losses 8.5e-4, first
# gradient 3.8e-3 (a LayerNorm scale, whose gradient sums every row's
# product), the control 0.49. The gradient and the losses carry the scale
# that Adam and clipping take out of the params: a sum in place of the
# mean doubles both. The control: one half's gradient alone (a rank whose
# all-reduce did nothing) must lie beyond DDP_GRAD_RTOL.
DDP_RTOL = 1e-4
DDP_GRAD_RTOL = 1e-2
DDP_LOSS_RTOL = 1e-2
DDP_ONE_BATCH_RTOL = 5e-3
# 25c: the float32 standard flagship split over the model axis against the
# unsplit one: the forward within TP_FORWARD_RTOL of its norm, the first
# gradient and the params after the steps within TP_RTOL of each leaf's
# norm. Read on the card (NVIDIA H100 80GB HBM3, 700 W): forward 7.9e-7,
# gradient 7.5e-7, params 1.3e-6 (the key bias, whose true gradient is 0:
# Adam steps on its float noise; tests/test_torch_parallel.py reads 3e-4
# there on the CPU against JAX).
TP_FORWARD_RTOL, TP_RTOL = 1e-5, 1e-4


def _worst(ours, ref):
    """(worst |a - b| / |b| over the leaves, its name)."""
    worst = max((_rel(ours[n], ref[n]), n) for n in ref)
    return worst


def _ddp_batch():
    gen = torch.Generator(device="cuda").manual_seed(25)
    return torch.rand(DDP_BATCH, SEQ_LEN, CHANNELS, generator=gen,
                      device="cuda") * 2 - 1


def _fused_bf16(seed=0, remat=False):
    """The fused flagship with bf16 params and compute (phase 13's
    training layout), weights from a seed; ``remat`` checkpoints its
    transformer layers."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device="cuda",
                      data_channels=CHANNELS, fused_attention=True,
                      fused_head=True, dtype=torch.bfloat16, remat=remat,
                      **FLAGSHIP)
    load_flax_params(model, random_flax_params(model, seed=seed))
    return model.to(torch.bfloat16)


def _standard_f32(seed=0):
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device="cuda",
                      data_channels=CHANNELS, **FLAGSHIP)
    return load_flax_params(model, random_flax_params(model, seed=seed))


def _ddp_config():
    from smd_tpu_torch.training import diffusion as trainer
    return trainer.TrainConfig(learning_rate=1e-3, ema=True)


def _tp_steps(state, loss_fn, batch, steps):
    """(the first gradient, whole, before any step; the params after
    ``steps`` train steps, whole); the split leaves gathered."""
    from smd_tpu_torch.parallel import mesh as mesh_lib
    grads, _ = state.gradients(loss_fn(state.model, batch, state.generator))
    grads = {n: (mesh_lib.gather_leaf(g, state.specs[n], state.mesh)
                 if n in state.specs else g).detach()
             for n, g in grads.items()}
    for _ in range(steps):
        state.descend(loss_fn(state.model, batch, state.generator))
    return grads, state.state_dict()["params"]


def _replicated(state):
    """The state's tensors that every rank holds whole (params, moments,
    EMA): under a model axis the split leaves' blocks differ by rank."""
    whole = [n for n in state.params if n not in state.specs]
    trees = (state.params, state.opt_state["mu"], state.opt_state["nu"],
             state.ema_params or {})
    return [tree[n].detach() for tree in trees for n in whole if n in tree]


def _tp_chunk(make, mesh, betas, batch):
    """25c's chunk on the model axis for the model ``make()`` builds:
    DDP_TRAIN_STEPS single steps from a seeded start, then the same steps
    as one chunk from the same start, capturing and then replaying, each
    held to the single steps bit for bit (params, Adam moments, EMA,
    losses, generator) with the replicated leaves checked equal across the
    group by checksum; then the kept chunk replayed with one recorded
    all-gather made a no-op (on every rank alike), which must differ.
    Returns this rank's readings."""
    import torch.distributed as dist

    from smd_tpu_torch.diffusion import losses
    from smd_tpu_torch.parallel import mesh as mesh_lib
    from smd_tpu_torch.training import diffusion as trainer
    from smd_tpu_torch.utils import graphs
    state = trainer.create_train_state(make(), _ddp_config(), seed=0,
                                       init=False, mesh=mesh)
    start = [t.clone() for t in state.tensors()]
    gen_start = state.generator.get_state()

    def restore():
        with torch.no_grad():
            torch._foreach_copy_(state.tensors(), start)
        state.generator.set_state(gen_start)
        state.step = state.opt_state["count"] = 0

    step = trainer.make_train_step(losses.diffusion_loss, betas, True, mesh)
    step(state, batch)   # warm-up: kernels loaded
    restore()
    out = {}
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    ref_loss = torch.stack([step(state, batch)[1]["loss"]
                            for _ in range(DDP_TRAIN_STEPS)])
    torch.cuda.synchronize()
    out["steps_ms"] = 1e3 * (time.perf_counter() - t0) / DDP_TRAIN_STEPS
    out["steps_counts"] = _counts()
    ref = [t.clone() for t in state.tensors()]
    ref_gen = state.generator.get_state()

    def same(metrics):
        return (all(torch.equal(a, b) for a, b in zip(state.tensors(), ref))
                and torch.equal(metrics["loss"], ref_loss)
                and torch.equal(state.generator.get_state(), ref_gen))

    chunk = trainer.make_train_chunk(losses.diffusion_loss, betas, True,
                                     mesh)
    stack = batch.expand(DDP_TRAIN_STEPS, *batch.shape)
    for how in ("capture", "replay"):
        restore()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        _, metrics = chunk(state, stack)
        torch.cuda.synchronize()
        out[f"{how}_ms"] = 1e3 * (time.perf_counter() - t0) / \
            DDP_TRAIN_STEPS
        out[f"{how}_counts"] = _counts()
        out[f"{how}_tc"] = _side_counts()[0]
        out[f"{how}_equal"] = same(metrics)
        mesh_lib.check_replicas_equal(_replicated(state),
                                      f"replicated leaves after the {how}")
    pieces, points, _ = chunk._chunk._last.graphs[None]
    kinds = [getattr(p.fn, "func", None) for p in points]
    owners = {n.rsplit(".", 1)[0] for n in state.specs}
    out.update(pieces=len(pieces), collectives=len(points),
               gathers=kinds.count(dist.all_gather),
               reduces=kinds.count(dist.all_reduce),
               split_dense=len(owners),
               layer_dense=sum("TransformerLayer_" in o for o in owners),
               remat=state.model.TransformerEncoder_0.remat)
    j = kinds.index(dist.all_gather)
    kept = points[j]
    points[j] = graphs.Point(lambda: None, kept.buffers)
    restore()
    try:
        _, metrics = chunk(state, stack)
        out["fault_caught"] = not same(metrics)
    finally:
        points[j] = kept
    chunk.close()
    return out


def _ddp_rank(rank, n, backend, port, out_dir):
    """One rank of 25b and 25c: the fused flagship on the data axis, then
    the float32 standard flagship on the model axis, then the chunk on the
    model axis (``_tp_chunk``). Each rank writes its launch counts,
    losses, times and memory to ``out_dir/ranks-{rank}.pt``; rank 0 adds
    its gradients, params and forward."""
    import torch.distributed as dist

    from smd_tpu_torch.diffusion import losses, schedules
    from smd_tpu_torch.ops import _build
    from smd_tpu_torch.parallel import mesh as mesh_lib
    from smd_tpu_torch.training import diffusion as trainer
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()   # built by phase 2
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    out = {}
    try:
        betas = schedules.noise_schedule(1e-6, 0.01, 1000, "linear")
        batch = _ddp_batch()
        # 25b: data axis.
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=n, model=1))
        state = trainer.create_train_state(_fused_bf16(), _ddp_config(),
                                           seed=0, init=False, mesh=mesh)
        step = trainer.make_train_step(losses.diffusion_loss, betas, True,
                                       mesh)
        rows = mesh_lib.shard_batch(batch, mesh)
        fresh = trainer.create_train_state(
            _fused_bf16(), _ddp_config(), seed=0, init=False).state_dict()
        step(state, rows)   # warm-up: kernels loaded, group connected
        state.load_state_dict(fresh)
        # The first step's gradient, averaged over the ranks; then back to
        # the start (params, moments and generator).
        grads, _ = state.gradients(trainer.make_loss_fn(
            losses.diffusion_loss, betas, True, mesh)(state.model, rows,
                                                      state.generator))
        out["dp_grads"] = {k: v.float().cpu() for k, v in grads.items()}
        del grads
        state.load_state_dict(fresh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = [step(state, rows)[1] for _ in range(DDP_TRAIN_STEPS)]
        torch.cuda.synchronize()
        out["dp_ms"] = 1e3 * (time.perf_counter() - t0) / DDP_TRAIN_STEPS
        out["dp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["dp_counts"] = _counts()
        out["dp_tc"] = _side_counts()[0]
        out["dp_losses"] = [float(m["loss"]) for m in metrics]
        # Raises on the rank whose params differ from rank 0's.
        mesh_lib.check_replicas_equal(state.params.values())
        out["dp_params"] = {k: v.float().cpu() for k, v in
                            state.state_dict()["params"].items()}
        steps = [t.clone() for t in state.tensors()]
        # The same steps as one chunk from the same start: each step's
        # all-reduce between its two captured segments.
        state.load_state_dict(fresh)
        del fresh
        chunk = trainer.make_train_chunk(losses.diffusion_loss, betas, True,
                                         mesh)
        stack = rows.expand(DDP_TRAIN_STEPS, *rows.shape)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        _, chunk_metrics = chunk(state, stack)      # captures, then replays
        torch.cuda.synchronize()
        out["chunk_first_ms"] = 1e3 * (time.perf_counter() - t0) / \
            DDP_TRAIN_STEPS
        out["chunk_counts"] = _counts()
        out["chunk_tc"] = _side_counts()[0]
        out["chunk_equal"] = all(torch.equal(a, b) for a, b in
                                 zip(state.tensors(), steps)) and \
            torch.equal(chunk_metrics["loss"].cpu(),
                        torch.tensor(out["dp_losses"]))
        mesh_lib.check_replicas_equal(state.tensors(), "chunked state")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(state, stack)                         # replays the graphs
        torch.cuda.synchronize()
        out["chunk_ms"] = 1e3 * (time.perf_counter() - t0) / DDP_TRAIN_STEPS
        chunk.close()
        del state, steps, chunk
        torch.cuda.empty_cache()
        # 25c: model axis, float32.
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1, model=n))
        torch.cuda.reset_peak_memory_stats()
        state = trainer.create_train_state(_standard_f32(), _ddp_config(),
                                           seed=0, init=False, mesh=mesh)
        with torch.no_grad():
            gen = torch.Generator(device="cuda").manual_seed(26)
            x = torch.randn(DDP_BATCH, SEQ_LEN, CHANNELS, generator=gen,
                            device="cuda")
            cond = torch.rand(DDP_BATCH, 1, 1, generator=gen,
                              device="cuda")
            out["tp_forward"] = state.model(x, cond).cpu()
        loss_fn = trainer.make_loss_fn(losses.diffusion_loss, betas, True,
                                       mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, params = _tp_steps(state, loss_fn, batch, DDP_TRAIN_STEPS)
        torch.cuda.synchronize()
        out["tp_seconds"] = time.perf_counter() - t0
        out["tp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["tp_split"] = len(state.specs)
        out["tp_grads"] = {k: v.cpu() for k, v in grads.items()}
        out["tp_params"] = {k: v.cpu() for k, v in params.items()}
        del state, grads, params
        torch.cuda.empty_cache()
        # 25c: the chunk on the model axis, float32 and fused bf16, and
        # fused bf16 with its layers checkpointed.
        for name, make in (("f32", _standard_f32), ("bf16", _fused_bf16),
                           ("bf16_remat",
                            functools.partial(_fused_bf16, remat=True))):
            out[f"tpc_{name}"] = _tp_chunk(make, mesh, betas, batch)
            torch.cuda.empty_cache()
        if rank:
            out = {k: v for k, v in out.items() if not k.startswith(
                ("dp_grads", "dp_params", "tp_forward", "tp_grads",
                 "tp_params"))}
        torch.save(out, os.path.join(out_dir, f"ranks-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_ddp_single(tmp, smi):
    """25a: ``dryrun.entry()``; ``train_ncsn --scan_chunk`` under RANK=0
    WORLD_SIZE=1 (an NCCL group of one) against the same steps by single
    steps without the variables, bit for bit."""
    import torch.distributed as dist

    from smd_tpu_torch import dryrun
    fn, args = dryrun.entry()
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    if out.shape != (8, SEQ_LEN, CHANNELS) or not torch.isfinite(out).all():
        fail(f"dryrun.entry() gave {tuple(out.shape)}, not finite")
    del fn, args
    data = f"{tmp}/data"
    runs = {}
    for name, env in (("group", True), ("plain", False)):
        argv = [f"--dataset={data}", f"--slice_ckpt={data}/slice.pkl",
                f"--model_dir={tmp}/ddp-{name}", f"--max_steps={DDP_STEPS}",
                f"--snapshot_freq={DDP_STEPS}", "--logging_freq=10"]
        if env:   # the chunk in the group, single steps without one
            argv.append(f"--scan_chunk={DDP_SCAN_CHUNK}")
        keys = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
        if env:
            os.environ.update(RANK="0", WORLD_SIZE="1",
                              MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(dryrun.free_port()))
        try:
            t0 = time.perf_counter()
            state, _, losses = _train(argv)
            seconds = time.perf_counter() - t0
            backend = dist.get_backend() if dist.is_initialized() else None
        finally:
            for k in keys:
                os.environ.pop(k, None)
            if dist.is_initialized():
                dist.destroy_process_group()
        if env and backend != "nccl":
            fail(f"train_ncsn under RANK=0 WORLD_SIZE=1 started {backend}, "
                 "not an NCCL group")
        runs[name] = ({n: p.detach().clone() for n, p in
                       state.params.items()}, float(losses[-1]), seconds)
        del state
    differ = [n for n, p in runs["group"][0].items()
              if not torch.equal(p, runs["plain"][0][n])]
    if differ:
        fail(f"train_ncsn --scan_chunk={DDP_SCAN_CHUNK} in an NCCL group of "
             f"one differs from its per-step run without one in "
             f"{len(differ)} parameters, e.g. {differ[:3]}")
    say(f"dryrun.entry(): the flagship's forward on 8x32x42 on the card; "
        f"train_ncsn {FLAGFILE} at full width, {DDP_STEPS} steps in "
        f"chunks of {DDP_SCAN_CHUNK} (captured) in an NCCL group of one "
        f"({runs['group'][2]:.1f} s) and by single steps without one "
        f"({runs['plain'][2]:.1f} s): all {len(runs['plain'][0])} parameters "
        f"bit-equal, last loss {runs['plain'][1]:.5f}; on {smi}")


def _one_rank_ddp(betas, batch):
    """25b's references on one rank: (its gradient as the ranks take it,
    two halves of 32 averaged in float32; the gradient of the 64 rows in
    one batch), each DDP_TRAIN_STEPS steps from the same params and draws.
    Returns the params of each, the one-batch run's first gradient, ms a
    step, peak GB and losses, and the first half's first gradient alone
    (the control)."""
    from smd_tpu_torch.diffusion import losses
    from smd_tpu_torch.training import diffusion as trainer
    loss_fn = trainer.make_loss_fn(losses.diffusion_loss, betas, True)
    out = {}
    for how in ("halves", "batch"):
        state = trainer.create_train_state(_fused_bf16(), _ddp_config(),
                                           seed=0, init=False)
        half = DDP_BATCH // DDP_RANKS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_losses = []
        for _ in range(DDP_TRAIN_STEPS):
            draws = losses.draws_for(losses.diffusion_loss, batch.shape,
                                     betas, state.generator, True, "cuda")
            if how == "batch":
                grads, loss = state.gradients(loss_fn(state.model, batch,
                                                      None, draws))
                run_losses.append(float(loss))
            else:
                parts = [state.gradients(loss_fn(
                    state.model, batch[i * half:(i + 1) * half], None,
                    tuple(d[i * half:(i + 1) * half] for d in draws)))[0]
                    for i in range(DDP_RANKS)]
                grads = {n: (sum(p[n].float() for p in parts) / DDP_RANKS)
                         .to(parts[0][n].dtype) for n in parts[0]}
            if f"{how}_grads" not in out:
                first = parts[0] if how == "halves" else grads
                out[f"{how}_grads"] = {n: g.detach().clone()
                                       for n, g in first.items()}
            state.apply_gradients(grads, state.global_norm(grads))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / DDP_TRAIN_STEPS
        out[how] = {k: v.float().cpu()
                    for k, v in state.state_dict()["params"].items()}
        out[f"{how}_grads"] = {k: v.float().cpu()
                               for k, v in out[f"{how}_grads"].items()}
        if how == "batch":
            out["ms"], out["losses"] = ms, run_losses
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del state
    return out


def phase_ddp_ranks(smi):
    """25b-25c: two ranks on the data axis (the fused flagship at bf16)
    and on the model axis (the float32 standard flagship; the chunk of it
    and of the fused flagship at bf16, with and without remat). Returns
    the ranks' launch counts."""
    from smd_tpu_torch import dryrun
    from smd_tpu_torch.diffusion import losses, schedules
    from smd_tpu_torch.training import diffusion as trainer
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DDP_RANKS else "gloo"
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(
            _ddp_rank, args=(DDP_RANKS, backend, dryrun.free_port(),
                             out_dir), nprocs=DDP_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"ranks-{r}.pt"))
                 for r in range(DDP_RANKS)]
    out = ranks[0]
    betas = schedules.noise_schedule(1e-6, 0.01, 1000, "linear")
    batch = _ddp_batch()
    where = (f"{DDP_RANKS} ranks on {cards} card(s), {backend}" +
             (" over CUDA tensors (the ranks share the card)"
              if cards < DDP_RANKS else ""))
    # 25b
    per_rank = tuple(DDP_TRAIN_STEPS * k for k in per_call_launches("fused"))
    for r, got in enumerate(ranks):
        if got["dp_counts"] != per_rank or got["dp_tc"] != per_rank[0]:
            fail(f"data-axis rank {r} launched (attention, film, w8a8, "
                 f"flash) {got['dp_counts']} ({got['dp_tc']} tensor-core) "
                 f"in {DDP_TRAIN_STEPS} steps, expected {per_rank}, all "
                 "tensor-core")
    from smd_tpu_torch.utils import graphs
    per_chunk = tuple((DDP_TRAIN_STEPS + graphs.WARMUP_STEPS) * k
                      for k in per_call_launches("fused"))
    for r, got in enumerate(ranks):
        if not got["chunk_equal"]:
            fail(f"data-axis rank {r}: the chunk of {DDP_TRAIN_STEPS} "
                 "steps differs from its single steps (params, moments, EMA "
                 "or losses)")
        if got["chunk_counts"] != per_chunk or \
                got["chunk_tc"] != per_chunk[0]:
            fail(f"data-axis rank {r}: the chunk launched (attention, film, "
                 f"w8a8, flash) {got['chunk_counts']} ({got['chunk_tc']} "
                 f"tensor-core), expected {per_chunk} ({DDP_TRAIN_STEPS} "
                 f"replays and {graphs.WARMUP_STEPS} warm-up steps), all "
                 "tensor-core")
    ref = _one_rank_ddp(betas, batch)
    halves, halves_name = _worst(out["dp_params"], ref["halves"])
    one, one_name = _worst(out["dp_params"], ref["batch"])
    grad, grad_name = _worst(out["dp_grads"], ref["batch_grads"])
    control, control_name = _worst(ref["halves_grads"], ref["batch_grads"])
    loss = max(abs(a - b) / abs(b) for got in ranks
               for a, b in zip(got["dp_losses"], ref["losses"]))
    if halves > DDP_RTOL:
        fail(f"2 ranks differ from one rank's halves by {halves:.3e} of "
             f"{halves_name}'s norm, more than {DDP_RTOL}")
    if grad > DDP_GRAD_RTOL or control <= DDP_GRAD_RTOL:
        fail(f"rank 0's first averaged gradient differs from one rank's "
             f"64-row gradient by {grad:.3e} of {grad_name}'s norm (limit "
             f"{DDP_GRAD_RTOL}); one half's alone by {control:.3e} "
             "(must exceed it)")
    if loss > DDP_LOSS_RTOL:
        fail(f"a rank's losses {[got['dp_losses'] for got in ranks]} "
             f"differ from one rank's {ref['losses']} by {loss:.3e}, more "
             f"than {DDP_LOSS_RTOL}")
    if one > DDP_ONE_BATCH_RTOL:
        fail(f"2 ranks differ from one rank's 64-row batch by {one:.3e} of "
             f"{one_name}'s norm, more than {DDP_ONE_BATCH_RTOL}")
    say(f"25b data axis, fused flagship bf16, global batch {DDP_BATCH} = "
        f"{DDP_RANKS} x {DDP_BATCH // DDP_RANKS}, {DDP_TRAIN_STEPS} steps "
        f"({where}): the ranks launched (attention, film, w8a8, flash) "
        f"{[got['dp_counts'] for got in ranks]}, all attention "
        f"tensor-core; replicas equal (checksums); "
        f"against one rank, same draws: halves worst {halves:.3e} "
        f"({halves_name}; limit {DDP_RTOL}); against its batch of 64: first "
        f"gradient worst {grad:.3e} ({grad_name}; limit {DDP_GRAD_RTOL}; "
        f"one half's alone {control:.3e}, {control_name}), losses "
        f"{loss:.3e} (limit {DDP_LOSS_RTOL}), params after "
        f"{DDP_TRAIN_STEPS} steps {one:.3e} ({one_name}; limit "
        f"{DDP_ONE_BATCH_RTOL}); losses "
        f"{[round(x, 5) for x in out['dp_losses']]} against one rank's "
        f"{[round(x, 5) for x in ref['losses']]}")
    say(f"25b the chunk on the data axis ({where}): {DDP_TRAIN_STEPS} steps "
        f"as one chunk from the same start, each step's gradient "
        f"all-reduce eager between its two captured segments: params, Adam "
        f"moments, EMA and losses bit-equal to the ranks' single steps, "
        f"replicas equal (checksums); launches a rank "
        f"{[got['chunk_counts'] for got in ranks]} ({DDP_TRAIN_STEPS} "
        f"replays and {graphs.WARMUP_STEPS} warm-up steps); wall ms/step "
        f"{[round(got['chunk_ms'], 2) for got in ranks]} replayed "
        f"(the capturing chunk "
        f"{[round(got['chunk_first_ms'], 2) for got in ranks]}) against "
        f"{[round(got['dp_ms'], 2) for got in ranks]} by single steps")
    say(f"25b wall ms/step: 1 rank (batch 64) {ref['ms']:.2f}, {DDP_RANKS} "
        f"ranks (32 each) {[round(got['dp_ms'], 2) for got in ranks]}; "
        f"peak memory a rank "
        f"{[round(got['dp_peak_gb'], 2) for got in ranks]} GB against one "
        f"rank's {ref['peak_gb']:.2f} GB; on {smi}")
    # 25c
    model = _standard_f32()
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(26)
        x = torch.randn(DDP_BATCH, SEQ_LEN, CHANNELS, generator=gen,
                        device="cuda")
        cond = torch.rand(DDP_BATCH, 1, 1, generator=gen, device="cuda")
        whole = model(x, cond).cpu()
    forward = _rel(out["tp_forward"], whole)
    if forward > TP_FORWARD_RTOL:
        fail(f"the model-axis forward differs by {forward:.3e} of its norm")
    torch.cuda.reset_peak_memory_stats()
    state = trainer.create_train_state(model, _ddp_config(), seed=0,
                                       init=False)
    loss_fn = trainer.make_loss_fn(losses.diffusion_loss, betas, True)
    t0 = time.perf_counter()
    grads, params = _tp_steps(state, loss_fn, batch, DDP_TRAIN_STEPS)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    grad, grad_name = _worst(out["tp_grads"],
                             {k: v.cpu() for k, v in grads.items()})
    param, param_name = _worst(out["tp_params"],
                               {k: v.cpu() for k, v in params.items()})
    if grad > TP_RTOL or param > TP_RTOL:
        fail(f"the model axis differs from one rank: gradient {grad:.3e} "
             f"({grad_name}), params {param:.3e} ({param_name})")
    say(f"25c model axis, standard flagship float32 ({where}; "
        f"{out['tp_split']} parameters split a rank): forward on "
        f"{DDP_BATCH}x{SEQ_LEN}x{CHANNELS} {forward:.3e} of its norm (limit "
        f"{TP_FORWARD_RTOL}); first gradient worst {grad:.3e} ({grad_name}; "
        f"limit {TP_RTOL}); params after {DDP_TRAIN_STEPS} steps worst "
        f"{param:.3e} ({param_name}; limit {TP_RTOL}); gradient and "
        f"{DDP_TRAIN_STEPS} steps {out['tp_seconds']:.2f} s on {DDP_RANKS} "
        f"ranks, {one_s:.2f} s on one; peak memory a rank "
        f"{[round(got['tp_peak_gb'], 2) for got in ranks]} GB against one "
        f"rank's {peak:.2f} GB; "
        f"ranks spawned and run in {spawn_s:.1f} s; on {smi}")
    del state, model
    torch.cuda.empty_cache()
    for name, what, layout in (("f32", "standard flagship float32",
                                "standard"),
                               ("bf16", "fused flagship bf16", "fused"),
                               ("bf16_remat", "fused flagship bf16 with remat",
                                "fused")):
        got = [r[f"tpc_{name}"] for r in ranks]
        per_step = per_call_launches(layout)
        # Under remat the backward recomputes each transformer layer up to
        # the last tensor it saved: its attention launch again, and the
        # all-gather of every split Dense of the layer but the MLP's output
        # Dense, whose gathered output only the residual sum reads.
        recomputed = 0
        if got[0]["remat"]:
            per_step = (2 * per_step[0], *per_step[1:])
            recomputed = got[0]["layer_dense"] - FLAGSHIP["num_layers"]
        expected = {
            "steps": tuple(DDP_TRAIN_STEPS * k for k in per_step),
            "capture": tuple((DDP_TRAIN_STEPS + graphs.WARMUP_STEPS) * k
                             for k in per_step),
            "replay": tuple(DDP_TRAIN_STEPS * k for k in per_step)}
        for r, g in enumerate(got):
            for how in ("capture", "replay"):
                if not g[f"{how}_equal"]:
                    fail(f"model-axis rank {r}, {what}: the {how} chunk of "
                         f"{DDP_TRAIN_STEPS} steps differs from its single "
                         "steps (params, moments, EMA, losses or generator)")
                if g[f"{how}_counts"] != expected[how] or \
                        g[f"{how}_tc"] != expected[how][0]:
                    fail(f"model-axis rank {r}, {what}: the {how} chunk "
                         f"launched (attention, film, w8a8, flash) "
                         f"{g[f'{how}_counts']} ({g[f'{how}_tc']} "
                         f"tensor-core), expected {expected[how]}")
            if g["steps_counts"] != expected["steps"]:
                fail(f"model-axis rank {r}, {what}: the single steps "
                     f"launched {g['steps_counts']}, expected "
                     f"{expected['steps']}")
            if not g["fault_caught"]:
                fail(f"model-axis rank {r}, {what}: a replay with one "
                     "all-gather skipped was not caught: the chunk does not "
                     "read the collectives run between its pieces")
            if g["collectives"] != g["gathers"] + g["reduces"] or \
                    g["gathers"] != g["split_dense"] + recomputed or \
                    g["pieces"] != g["collectives"] + 1:
                fail(f"model-axis rank {r}, {what}: {g['pieces']} pieces, "
                     f"{g['collectives']} collectives ({g['gathers']} "
                     f"all-gathers, {g['reduces']} all-reduces) for "
                     f"{g['split_dense']} split Dense layers and "
                     f"{recomputed} recomputed")
        g = got[0]
        say(f"25c the chunk on the model axis, {what} ({where}; "
            f"{g['split_dense']} split Dense layers): {DDP_TRAIN_STEPS} "
            f"steps as one chunk from the same start, {g['pieces']} "
            f"captured pieces and {g['collectives']} collectives a step "
            f"({g['gathers']} all-gathers, {recomputed} of them the "
            f"backward's recompute, {g['reduces']} all-reduces, the "
            "norm's among them) eager between them: params, Adam moments, "
            "EMA, losses and generator bit-equal to the single steps, "
            "capturing and replaying, replicated leaves equal (checksums); "
            f"launches a rank (attention, film, w8a8, flash) "
            f"{[x['replay_counts'] for x in got]} replayed, "
            f"{[x['capture_counts'] for x in got]} capturing "
            f"({graphs.WARMUP_STEPS} warm-up steps); one all-gather "
            f"skipped at replay caught; wall ms/step "
            f"{[round(x['replay_ms'], 2) for x in got]} replayed, "
            f"{[round(x['capture_ms'], 2) for x in got]} the capturing "
            f"chunk, {[round(x['steps_ms'], 2) for x in got]} by single "
            f"steps; on {smi}")
    return tuple(sum(c) for c in zip(
        *(got[k] for got in ranks for k in ("dp_counts", "chunk_counts")),
        *(got[f"tpc_{name}"][k] for got in ranks
          for name in ("bf16", "bf16_remat")
          for k in ("steps_counts", "capture_counts", "replay_counts"))))


def phase_dryrun_multichip(smi):
    """25d: ``dryrun_multichip(4)``: 4 ranks, a 2 x 2 grid, 2 steps and a
    chunk of 2 from the same start bit-equal to them on every rank."""
    from smd_tpu_torch import dryrun
    t0 = time.perf_counter()
    result = dryrun.dryrun_multichip(4)
    if (result["data"], result["model"]) != (2, 2) or \
            not np.isfinite(result["loss"]):
        fail(f"dryrun_multichip(4): {result}")
    say(f"25d dryrun_multichip(4) in {time.perf_counter() - t0:.1f} s: "
        f"{result}; on {smi}")


# Captured training chunks (phase 26): each trainer's step captured in a
# CUDA graph (smd_tpu_torch/utils/graphs.py) and replayed CHUNK_STEPS
# times, against as many eager steps from the same state and generator
# state, at full width: the fused flagship at bf16 and the standard one in
# float32 on 64 x 32x42, the MDN on 128 x 32x42, a progressive-distillation
# stage (8 -> 4) of the fused flagship, and the codec at melody-2-big width
# on batch 64; then the fused, float32 and MDN trainers again with each
# transformer layer checkpointed (``_remat``: recomputed inside the
# captured backward), each after its plain mode, whose captured peak
# memory it must stay below. profile_torch_train.py builds the same
# trainers.
CHUNK_STEPS = 8
CHUNK_PROFILE_STEPS = 2     # steps under the profiler, eager and captured
CHUNK_MODES = ("fused", "fp32", "mdn", "distill", "codec", "fused_remat",
               "fp32_remat", "mdn_remat")
TRAIN_BATCH = {"fp32": 64, "mixed": 64, "fused": 64, "distill": 64,
               "mdn": 128, "codec": 64}
# The codec's chunk draws its scheduled-sampling tokens at every step (the
# probability a tensor, as JAX's scan takes it); the eager step draws them
# where the probability is above 0, so both run at a constant 0.2.
CHUNK_SS = 0.2
# A captured chunk against the eager steps: bit-equal where two eager runs
# from the same state are; else within CHUNK_SPREAD_FACTOR times their
# spread (worst leaf's |a - b| / |b|, and the losses' largest difference).
CHUNK_SPREAD_FACTOR = 4.0
# melody-2-big (cat-mel_2bar_big), as phase 24 trains it.
CODEC_BIG = dict(latent_dims=512, enc_units=2048, dec_units=(2048,) * 3,
                 free_bits=48.0)


class Trainer:
    """One trainer at full width on the card: its step eager
    (``step(batch) -> loss``) and its chunk (``chunk(batches) -> (K,)
    losses``, a captured step replayed), the tensors both write, and
    ``snapshot``/``restore`` of the whole state (tensors, counts,
    generator). Modes: ``fp32``, ``mixed``, ``fused``, ``distill``,
    ``mdn`` and ``codec``, and each but the codec with ``_remat`` (the
    model's transformer layers checkpointed); ``batch`` defaults to
    TRAIN_BATCH's."""

    def __init__(self, mode, batch=None, seed=0):
        self.mode = mode.removesuffix("_remat")
        self.remat = mode.endswith("_remat")
        self.batch = batch or TRAIN_BATCH[self.mode]
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        if mode == "codec":
            self._codec(seed, gen)
        else:
            self.batches = torch.rand(
                (CHUNK_STEPS, self.batch, SEQ_LEN, CHANNELS), generator=gen,
                device="cuda") * 2 - 1
            self._diffusion(seed)
            self.gen = self.state.generator
        self.kept = []
        self.chunk_fn = self._measured(self._chunk())

    def _measured(self, chunk):
        """``chunk`` with its loss function (a ``TrainChunk``'s) recording
        into ``kept`` the bytes allocated at the end of the forward above
        its start: the activations the step keeps for its backward. A
        replay runs no Python, so the last entry is the capture's (its
        allocations come from the graph's pool)."""
        fn = getattr(chunk, "loss_fn", None)
        if fn is None:
            return chunk

        def loss_fn(*args):
            before = torch.cuda.memory_allocated()
            loss = fn(*args)
            self.kept.append(torch.cuda.memory_allocated() - before)
            return loss

        chunk.loss_fn = loss_fn
        return chunk

    def _diffusion(self, seed):
        from smd_tpu_torch.diffusion import losses, schedules
        from smd_tpu_torch.models import get_model
        from smd_tpu_torch.models.layers import init_parameters
        from smd_tpu_torch.training import diffusion as trainer
        betas = schedules.noise_schedule(1e-6, 0.01, 1000, "linear")
        if self.mode == "mdn":
            from smd_tpu_torch.training import mdn
            model = init_parameters(get_model(
                "TransformerMDN", device="cuda", data_channels=CHANNELS,
                remat=self.remat, **MDN_WIDTH), seed)
            self.state = mdn.create_train_state(
                model, trainer.TrainConfig(learning_rate=3e-4), seed,
                init=False)
            self._step, self._chunk = mdn.make_train_step(), \
                mdn.make_train_chunk
            return
        fused = self.mode in ("fused", "distill")
        model = get_model("TransformerDDPM", device="cuda",
                          data_channels=CHANNELS,
                          dtype=torch.float32 if self.mode == "fp32" else
                          torch.bfloat16, fused_attention=fused,
                          fused_head=fused, remat=self.remat, **FLAGSHIP)
        init_parameters(model, seed)
        if fused:
            model = model.to(torch.bfloat16)
        self.state = trainer.create_train_state(
            model, trainer.TrainConfig(learning_rate=1e-3,
                                       ema=self.mode != "distill"), seed,
            init=False)
        if self.mode == "distill":
            from smd_tpu_torch.training import distill
            grid, mids = distill.halve_grid(distill.distill_grid(betas, 16))
            teacher = {n: p.detach().clone()
                       for n, p in model.named_parameters()}
            self._step = distill.make_distill_step(model, teacher, grid,
                                                   mids)
            self._chunk = lambda: distill.make_distill_step(
                model, teacher, grid, mids, chunk=True)
        else:
            self._step = trainer.make_train_step(losses.diffusion_loss,
                                                 betas, True)
            self._chunk = lambda: trainer.make_train_chunk(
                losses.diffusion_loss, betas, True)

    def _codec(self, seed, gen):
        from smd_tpu_torch.codec import musicvae as mv
        from smd_tpu_torch.training import musicvae as mvtrain
        cfg = mv.MusicVAEConfig(**CODEC_BIG)
        model = mv.build_musicvae(cfg, seed=seed, device="cuda")
        model.train().requires_grad_(True)
        opt = mvtrain.make_optimizer(1e-3, 200, 2000)
        opt_state = opt.init(dict(model.named_parameters()))
        self.batches = torch.randint(
            0, cfg.depth, (CHUNK_STEPS, self.batch, cfg.max_seq_len),
            generator=gen, device="cuda")
        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        self.codec = (model, opt, opt_state)
        self._chunk = lambda: mvtrain.make_train_chunk(
            model, opt, opt_state, self.gen, scheduled_sampling=True)

    def tensors(self):
        if self.mode != "codec":
            return self.state.tensors()
        model, opt, opt_state = self.codec
        return opt.tensors(dict(model.named_parameters()), opt_state)

    def step(self, batch):
        """One eager step; its loss."""
        if self.mode == "codec":
            from smd_tpu_torch.training import musicvae as mvtrain
            model, opt, opt_state = self.codec
            return mvtrain.train_step(model, opt, opt_state, batch, CHUNK_SS,
                                      self.gen)[0]
        return self._step(self.state, batch)[1]["loss"]

    def chunk(self, batches):
        """One chunk of ``len(batches)`` steps; its (K,) losses."""
        if self.mode == "codec":
            return self.chunk_fn(batches, [CHUNK_SS] * len(batches))["loss"]
        return self.chunk_fn(self.state, batches)[1]["loss"]

    def new_chunk(self):
        """A chunk that captures anew (its first call)."""
        self.chunk_fn.close()
        self.chunk_fn = self._chunk()

    def snapshot(self):
        if self.mode == "codec":
            counts = (self.codec[2]["count"], None)
        else:
            counts = (self.state.opt_state["count"], self.state.step)
        return ([t.clone() for t in self.tensors()], counts,
                self.gen.get_state())

    def restore(self, snap):
        tensors, (count, step), gen_state = snap
        with torch.no_grad():
            torch._foreach_copy_(self.tensors(), tensors)
        if self.mode == "codec":
            self.codec[2]["count"] = count
        else:
            self.state.opt_state["count"], self.state.step = count, step
        self.gen.set_state(gen_state)

    def close(self):
        self.chunk_fn.close()


def _leaf_gap(ours, ref):
    """(worst leaf |ours - ref| / |ref| in norm, leaves not bit-equal)."""
    worst, unequal = 0.0, 0
    for a, b in zip(ours, ref):
        if not torch.equal(a, b):
            unequal += 1
            worst = max(worst, float((a.float() - b.float()).norm() /
                                     b.float().norm().clamp_min(1e-30)))
    return worst, unequal


def _chunk_run(trainer, snap, captured):
    """From ``snap``: the K steps eager or as one chunk; (tensors after,
    losses, generator state after, wall s, launch counts)."""
    trainer.restore(snap)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    if captured:
        losses = trainer.chunk(trainer.batches)
    else:
        losses = torch.stack([trainer.step(b) for b in trainer.batches])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ([t.clone() for t in trainer.tensors()], losses.float(),
            trainer.gen.get_state(), seconds,
            (*_counts(), _side_counts()[0]))


def _chunk_profile(trainer, snap, captured):
    """(device operations, device-busy ms, profiled ms, idle share, host
    launches) a step of CHUNK_PROFILE_STEPS steps under
    ``torch.profiler``, eager or as a chunk (the graph captured already)."""
    trainer.restore(snap)
    batches = trainer.batches[:CHUNK_PROFILE_STEPS]

    def run():
        if captured:
            trainer.chunk(batches)
        else:
            for b in batches:
                trainer.step(b)

    return _profile(run, CHUNK_PROFILE_STEPS)


@contextlib.contextmanager
def _stale_slot():
    """A planted fault: every replay of a chunk reads slot 0's batch."""
    from smd_tpu_torch.utils import graphs
    run = graphs._Slots.run

    def stale(self, step, variant=None):
        return run(self, lambda slot: step(
            {**slot, "batch": self.inputs["batch"][0]}), variant)

    graphs._Slots.run = stale
    try:
        yield
    finally:
        graphs._Slots.run = run


def _peak_above(base):
    """GB allocated at the peak since the last reset, above ``base``."""
    return (torch.cuda.max_memory_allocated() - base) / 1e9


@contextlib.contextmanager
def _peak_split_at_capture(marks):
    """Append to ``marks`` the peak allocated before a chunk's first
    capture begins (its warm-up steps, the state's saved copy alive) and
    reset the peak there, so that the peak read after the run is the
    capture's and the replays'."""
    from smd_tpu_torch.utils import graphs
    begin = graphs._Capture.begin

    def split(self):
        if not marks:
            marks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        begin(self)

    graphs._Capture.begin = split
    try:
        yield
    finally:
        graphs._Capture.begin = begin


def phase_chunks(smi, modes=CHUNK_MODES):
    """26: each trainer's captured chunk against its eager steps; a
    ``_remat`` mode's activations kept by the captured forward
    (``Trainer.kept``) below its plain mode's, which must have run before
    it. Each mode's peak above what was allocated before the run (the
    state, its snapshot, the batches) is printed, eager and captured: at
    the flagfiles' batches the optimizer's temporaries, after the
    backward, set it, so remat need not lower it."""
    from smd_tpu_torch.utils import graphs
    counts = []
    peaks = {}
    for mode in modes:
        t0 = time.perf_counter()
        trainer = Trainer(mode)
        plain_mode = trainer.mode
        if trainer.remat and plain_mode not in peaks:
            fail(f"{mode} runs after {plain_mode}, whose peak it is held to")
        snap = trainer.snapshot()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eager = _chunk_run(trainer, snap, False)
        eager_peak = torch.cuda.max_memory_allocated() / 1e9
        eager_step = _peak_above(base)
        again = _chunk_run(trainer, snap, False)
        spread = _leaf_gap(again[0], eager[0])[0]
        loss_spread = float((again[1] - eager[1]).abs().max())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = []
        with _peak_split_at_capture(marks):
            first = _chunk_run(trainer, snap, True)     # warm-up and capture
        capture_step = _peak_above(base)
        warmup_step = (marks[0] - base) / 1e9
        chunk_step = max(warmup_step, capture_step)
        chunk_peak = chunk_step + base / 1e9
        kept = trainer.kept[-1] / 1e9 if trainer.kept else float("nan")
        peaks[mode] = (eager_step, chunk_step, kept)
        captured = _chunk_run(trainer, snap, True)
        limit = CHUNK_SPREAD_FACTOR * spread
        loss_limit = CHUNK_SPREAD_FACTOR * loss_spread
        for what, run in (("the capturing chunk", first),
                          ("a replayed chunk", captured)):
            gap, unequal = _leaf_gap(run[0], eager[0])
            loss_gap = float((run[1] - eager[1]).abs().max())
            if gap > limit or loss_gap > loss_limit:
                fail(f"{mode}: {what} of {CHUNK_STEPS} steps differs from "
                     f"as many eager steps: worst leaf {gap:.3e} "
                     f"({unequal} leaves not bit-equal; limit {limit:.3e}), "
                     f"losses {loss_gap:.3e} (limit {loss_limit:.3e})")
            if not torch.equal(run[2], eager[2]):
                fail(f"{mode}: {what} left the generator elsewhere than "
                     "the eager steps")
        if captured[4] != eager[4]:
            fail(f"{mode}: a chunk of {CHUNK_STEPS} launched (attention, "
                 f"film, w8a8, flash, tensor-core attention) {captured[4]}, "
                 f"the eager steps {eager[4]}")
        per_step = {"fused": per_call_launches("fused"),
                    "distill": tuple(3 * n for n in
                                     per_call_launches("fused"))}.get(
                                         plain_mode, (0, 0, 0, 0))
        if trainer.remat:   # each layer's attention again in the backward
            per_step = (2 * per_step[0], *per_step[1:])
        expected = tuple(CHUNK_STEPS * n for n in per_step)
        if tuple(eager[4][:4]) != expected or eager[4][4] != eager[4][0]:
            fail(f"{mode}: {CHUNK_STEPS} eager steps launched "
                 f"{eager[4]}, expected {expected}, attention all on the "
                 "tensor-core kernel")
        counts.append(tuple(captured[4][:4]))
        prof_eager = _chunk_profile(trainer, snap, False)
        prof_chunk = _chunk_profile(trainer, snap, True)
        # The planted fault: each replay reads slot 0's batch.
        trainer.new_chunk()
        with _stale_slot():
            faulty = _chunk_run(trainer, snap, True)
        trainer.close()
        gap, unequal = _leaf_gap(faulty[0], eager[0])
        if not gap > limit:
            fail(f"{mode}: a chunk replaying slot 0's batch at every step "
                 f"reads {gap:.3e} against the eager steps, within the "
                 f"limit {limit:.3e}: the check cannot see it")
        rows = []
        for what, run, prof, peak in (("eager", again, prof_eager,
                                       eager_peak),
                                      ("captured", captured, prof_chunk,
                                       chunk_peak)):
            events, busy, _, idle, launches = prof
            rows.append(
                f"{what}: {1e3 * run[3] / CHUNK_STEPS:.3f} wall ms a step, "
                f"{launches:.1f} host launches a step, {events:.0f} device "
                f"operations, {busy:.3f} device-busy ms a step, idle "
                f"{idle:.3f} ({CHUNK_PROFILE_STEPS} steps profiled), peak "
                f"memory {peak:.2f} GB")
        rows.append(f"peak above the state before the run: eager "
                    f"{eager_step:.3f} GB, captured {chunk_step:.3f} GB "
                    f"(its warm-up {warmup_step:.3f}, the state's copy "
                    f"alive; the capture and replays {capture_step:.3f}); "
                    f"activations kept by the captured forward "
                    f"{kept:.4f} GB")
        if trainer.remat:
            plain_eager, plain_chunk, plain_kept = peaks[plain_mode]
            if not kept < plain_kept:
                fail(f"{mode}: the captured forward keeps {kept:.4f} GB "
                     f"for its backward, not below {plain_mode}'s "
                     f"{plain_kept:.4f} GB: remat kept the activations")
            if chunk_step > plain_chunk:
                fail(f"{mode}: the captured chunk's peak above the state "
                     f"{chunk_step:.3f} GB exceeds {plain_mode}'s "
                     f"{plain_chunk:.3f} GB")
            rows.append(f"without remat ({plain_mode}): peak eager "
                        f"{plain_eager:.3f} GB, captured {plain_chunk:.3f} "
                        f"GB (captured {plain_chunk - chunk_step:.3f} GB "
                        f"lower with remat), kept {plain_kept:.4f} GB "
                        f"({plain_kept - kept:.4f} GB lower with remat)")
        say(f"26 {mode}, batch {trainer.batch}: {CHUNK_STEPS} captured "
            f"steps against {CHUNK_STEPS} eager ones from the same state: "
            f"worst leaf {_leaf_gap(captured[0], eager[0])[0]:.3e}, losses "
            f"{float((captured[1] - eager[1]).abs().max()):.3e} (two eager "
            f"runs' spread {spread:.3e} and {loss_spread:.3e}; limits "
            f"{limit:.3e}, {loss_limit:.3e}); the generator where the eager "
            f"steps leave it; launches (attention, film, w8a8, flash, "
            f"tensor-core) {captured[4]} as eager; the stale-slot fault "
            f"reads {gap:.3e} ({unequal} leaves), caught; capture with "
            f"{graphs.WARMUP_STEPS} warm-up steps and {CHUNK_STEPS} "
            f"replays {first[3]:.2f} s; " + "; ".join(rows) +
            f"; phase {time.perf_counter() - t0:.1f} s; on {smi}")
        del trainer, snap, eager, again, first, captured, faulty
        torch.cuda.empty_cache()
    return counts


# Remat through the CLIs (phase 26b): the flagfiles at full width with
# --remat, each run in chunks (the step captured, each transformer layer
# recomputed in its backward) and by single steps from the same seed;
# then progressive distillation of the chunked run's checkpoint.
REMAT_CLI_STEPS, REMAT_CLI_CHUNK = 8, 4
REMAT_CLI_TRAIN, REMAT_CLI_EVAL = 512, 256


@contextlib.contextmanager
def _counted_checkpoints(calls):
    """Count the model's layer checkpoints (``torch.utils.checkpoint``
    calls of ``TransformerEncoder``) into ``calls[0]``; a captured step
    makes them at its warm-up and capture only."""
    from smd_tpu_torch.models import ddpm
    real = ddpm.checkpoint

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    ddpm.checkpoint = counted
    try:
        yield
    finally:
        ddpm.checkpoint = real


def phase_remat_clis(smi):
    """26b: ``train_ncsn --remat`` and ``train_mdn --remat`` in chunks of
    REMAT_CLI_CHUNK against the same runs by single steps, every parameter
    bit-equal; ``train_ncsn --distill --remat`` on the chunked run's
    checkpoint, its chunk captured. Each run checkpoints layers and the
    chunked ones capture (warm-up steps counted)."""
    from smd_tpu_torch import cli, train_mdn, train_ncsn
    from smd_tpu_torch.utils import graphs
    cli.define_sampling_flags()   # --distill restores for sampling
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        _write_latents(data, REMAT_CLI_TRAIN, REMAT_CLI_EVAL)
        common = [f"--dataset={data}", f"--slice_ckpt={data}/slice.pkl",
                  "--remat", f"--max_steps={REMAT_CLI_STEPS}",
                  f"--snapshot_freq={REMAT_CLI_STEPS}",
                  f"--logging_freq={REMAT_CLI_CHUNK}"]
        for name, main, flagfile in (("train_ncsn", train_ncsn.main,
                                      FLAGFILE),
                                     ("train_mdn", train_mdn.main,
                                      MDN_FLAGFILE)):
            runs = {}
            for chunk in (REMAT_CLI_CHUNK, 1):
                calls, warm = [0], graphs.warmup_steps
                _reset_counts()
                t0 = time.perf_counter()
                with _counted_checkpoints(calls):
                    state = main([name, f"--flagfile={flagfile}",
                                  f"--model_dir={tmp}/{name}-{chunk}",
                                  f"--scan_chunk={chunk}", *common])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                _no_launches(f"{name} --remat")
                captured = graphs.warmup_steps > warm
                if state.step != REMAT_CLI_STEPS or not calls[0] or \
                        captured != (chunk > 1):
                    fail(f"{name} --remat --scan_chunk={chunk}: step "
                         f"{state.step}, {calls[0]} layer checkpoints, "
                         f"captured {captured}")
                runs[chunk] = ({n: p.detach().clone()
                                for n, p in state.params.items()},
                               seconds, calls[0])
                del state
            differ = [n for n, p in runs[REMAT_CLI_CHUNK][0].items()
                      if not torch.equal(p, runs[1][0][n])]
            if differ:
                fail(f"{name} --remat --scan_chunk={REMAT_CLI_CHUNK} differs "
                     f"from its run by single steps in {len(differ)} "
                     f"parameters, e.g. {differ[:3]}")
            say(f"26b {name} --remat on {flagfile} at full width, "
                f"{REMAT_CLI_STEPS} steps in chunks of {REMAT_CLI_CHUNK} "
                f"(captured; {runs[REMAT_CLI_CHUNK][2]} layer checkpoints "
                f"at warm-up and capture, {runs[REMAT_CLI_CHUNK][1]:.1f} s) "
                f"and by single steps ({runs[1][2]} checkpoints, "
                f"{runs[1][1]:.1f} s): all {len(runs[1][0])} parameters "
                f"bit-equal; on {smi}")
        calls, warm = [0], graphs.warmup_steps
        t0 = time.perf_counter()
        with _counted_checkpoints(calls):
            train_ncsn.main([
                "train_ncsn", f"--flagfile={FLAGFILE}",
                f"--model_dir={tmp}/train_ncsn-{REMAT_CLI_CHUNK}", *common,
                "--distill", "--distill_mode=progressive",
                "--distill_start_steps=4", "--distill_end_steps=2",
                f"--distill_stage_steps={REMAT_CLI_STEPS}"])
        torch.cuda.synchronize()
        bundles = sorted(os.listdir(
            f"{tmp}/train_ncsn-{REMAT_CLI_CHUNK}/distilled"))
        if "2.pkl" not in bundles or not calls[0] or \
                graphs.warmup_steps == warm:
            fail(f"train_ncsn --distill --remat: bundles {bundles}, "
                 f"{calls[0]} layer checkpoints, warm-up steps "
                 f"{graphs.warmup_steps - warm}")
        say(f"26b train_ncsn --distill --remat (progressive 4 -> 2, "
            f"{REMAT_CLI_STEPS} steps, the stage's chunk captured; "
            f"{calls[0]} layer checkpoints at warm-up and capture) on the "
            f"chunked run's checkpoint: {time.perf_counter() - t0:.1f} s, "
            f"bundles {bundles}; on {smi}")


# Captured sampler chains (phase 27): each sampler's step captured in a CUDA
# graph (smd_tpu_torch/utils/graphs.py) and replayed once a step, against
# the same chain run eagerly (``graphs.eager()``) from a generator seeded
# alike, at full width. Bit-equal (limit 0, ``torch.equal``): state,
# collection, metrics and the generator's state after the chain; launches
# those of the eager chain plus the warm-up steps of the first call. The
# planted fault: a second call through the kept graph with another
# schedule of the same length (the MDN decodes: another seed) must equal a
# fresh eager chain on it and differ from the first call's result, which a
# constant baked into the graph or a stale table would not.
CHAIN_BATCH = 64            # requests a chain at S=32 (phase 5's)
CHAIN_LONG_STEPS = 200      # DDPM steps at 16 x 512x42, cut from 1000
CHAIN_NCSN_BATCH = 256      # DenseNCSN requests (phase 19 serves 1000)
CHAIN_ALD_STEPS = 2         # ALD steps a level, as phase 19's snapshots
CHAIN_PROFILE = 8           # steps of the short chain under the profiler
# (batch, positions) of the MDN's cached decode and of its full-forward
# decode (4 requests at 512: 512 device-bound forwards of 4.4 ms).
MDN_CHAIN = (((128, SEQ_LEN), (128, SEQ_LEN)),
             ((LONG_BATCH, LONG_SEQ_LEN), (4, LONG_SEQ_LEN)))


def _dense_ncsn():
    """``configs/ncsn-mel-1seq-512.cfg``'s DenseNCSN (6 x 2048) with
    weights from a seed, cast to bf16 as ``sample_ncsn`` serves it."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("DenseNCSN", device="cuda", data_channels=FLAT_WIDTH,
                      num_layers=6, mlp_dims=2048)
    load_flax_params(model, random_flax_params(model, seed=0))
    model = model.to(torch.bfloat16).eval()

    def model_fn(x, sigma):
        return model(x.to(torch.bfloat16), sigma.to(torch.bfloat16)).float()
    return model, model_fn


def _outs(out):
    """A chain's tensors (state, collection, metrics), the Nones left
    out."""
    return tuple(t for t in (out if isinstance(out, tuple) else (out,))
                 if t is not None)


def _chain_cases():
    """The cases: ``call(fn, gen, which)`` runs the chain, ``which`` "main",
    "alt" (another schedule of the same length) or "short" (CHAIN_PROFILE
    steps or levels, replaying the same graphs; the MDN decodes' whole
    chain)."""
    from smd_tpu_torch.diffusion import schedules
    from smd_tpu_torch.sampling import generate, mdn_decode
    from smd_tpu_torch.training import distill

    def betas(which, steps=SERVE_STEPS):
        if which == "short":
            steps = CHAIN_PROFILE
        end = 0.02 if which == "alt" else 0.01
        return schedules.noise_schedule(1e-6, end, steps, "linear")

    def sampler(sampling, seq_len=SEQ_LEN, batch=CHAIN_BATCH, steps=None,
                **kw):
        def call(fn, gen, which):
            b = betas(which, steps or SERVE_STEPS)
            extra = dict(kw)
            if sampling in ("ddim", "dpmpp") and which == "short":
                extra["ddim_steps"] = min(extra["ddim_steps"], CHAIN_PROFILE)
            if "grid_steps" in extra:
                extra["distill_grid"] = distill.distill_grid(
                    betas(which if which == "alt" else "main"),
                    extra.pop("grid_steps"))
            if "infill" in extra:
                extra.pop("infill")
                real = torch.rand(batch, seq_len, CHANNELS,
                                  generator=torch.Generator().manual_seed(3))
                samples, masks = generate.infill_edge_mask(
                    real.numpy() * 2 - 1)
                extra.update(infill_samples=samples, infill_masks=masks)
            extra.setdefault("collect_steps", 0)
            extra.setdefault("collect_metrics", False)
            return generate.sample(fn, b, gen, (seq_len, CHANNELS),
                                   num_samples=batch, sampling=sampling,
                                   device="cuda", **extra)
        return call

    def langevin(sampling):
        def call(fn, gen, which):
            levels = CHAIN_PROFILE if which == "short" else 500
            sig = schedules.noise_schedule(
                15.0, 0.02 if which == "alt" else 0.01, 500, "geometric")
            # CHAIN_PROFILE snapshots: the short chain's collection has
            # the main chain's shape, so it replays the same graphs.
            return generate.sample(
                fn, sig[:levels], gen, (FLAT_WIDTH,),
                num_samples=CHAIN_NCSN_BATCH, sampling=sampling,
                epsilon=9.64e-7, steps=CHAIN_ALD_STEPS,
                collect_steps=CHAIN_PROFILE, device="cuda")
        return call

    def mdn(name, batch, steps):
        def call(model, gen, which):
            if which == "alt":   # the decodes' data: the seed
                gen.manual_seed(gen.initial_seed() + 1000)
            if name == "ar_decode_cached":
                return mdn_decode.ar_decode_cached(
                    gen, model, batch, steps=steps, channels=CHANNELS,
                    log_sigma_cap=0.0)
            return mdn_decode.ar_decode(
                gen, model.full, batch, steps=steps, channels=CHANNELS,
                log_sigma_cap=0.0, device="cuda")
        return call

    fused, int8 = per_call_launches("fused"), per_call_launches("int8")
    std = per_call_launches("standard", LONG_SEQ_LEN)
    none = (0, 0, 0, 0)
    short = CHAIN_PROFILE
    # (name, model, call, model calls, launches a call, graphs, model calls
    # of the short chain); grouped by model, each built once.
    cases = [
        ("DDPM-1000 fused", "fused", sampler("ddpm"), SERVE_STEPS, fused, 1,
         short),
        ("DDIM-50 eta 0", "fused", sampler("ddim", ddim_steps=50), 50,
         fused, 1, short),
        # The last step draws neither noise: a second graph.
        ("DDIM-50 eta 1 infill", "fused",
         sampler("ddim", ddim_steps=50, ddim_eta=1.0, infill=True), 50,
         fused, 2, short),
        ("DPM++-8 collection and metrics", "fused",
         sampler("dpmpp", ddim_steps=8, collect_steps=8,
                 collect_metrics=True), 8, fused, 1, short),
        ("distilled-2", "fused", sampler("distilled", grid_steps=2), 2,
         fused, 1, 2),
        # Step 0 does not re-noise: a second graph.
        ("consistency-2", "fused",
         sampler("consistency", grid_steps=32, ddim_steps=2), 2, fused, 2,
         2),
        ("DDPM-1000 int8", "int8", sampler("ddpm"), SERVE_STEPS, int8, 1,
         short),
        (f"DDPM-{CHAIN_LONG_STEPS} standard at {LONG_BATCH} x "
         f"{LONG_SEQ_LEN}", "standard",
         sampler("ddpm", LONG_SEQ_LEN, LONG_BATCH, CHAIN_LONG_STEPS),
         CHAIN_LONG_STEPS, std, 1, short),
        # + the final denoise, a call of its own.
        (f"ALD 500 x {CHAIN_ALD_STEPS}", "ncsn", langevin("ald"),
         500 * CHAIN_ALD_STEPS + 1, none, 1, short * CHAIN_ALD_STEPS + 1),
        # The last level draws no noise: a second graph.
        ("CAS 500", "ncsn", langevin("cas"), 501, none, 2, short + 1)]
    for (batch, steps), (full_batch, _) in MDN_CHAIN:
        flash = MDN_WIDTH["num_layers"] if steps >= LONG_SEQ_LEN else 0
        cases.append((f"ar_decode_cached {batch} x {steps}", f"mdn{steps}",
                      mdn("ar_decode_cached", batch, steps), steps, none, 1,
                      steps))
        # 511 replays and the last step, a call of its own.
        cases.append((f"ar_decode {full_batch} x {steps}", f"mdn{steps}",
                      mdn("ar_decode", full_batch, steps), steps,
                      (0, 0, 0, flash), 1, steps))
    return cases


def _chain_model(kind):
    """(model, what a case calls) for a case's model kind."""
    if kind == "fused":
        return _flagship()
    if kind == "int8":
        model, fn = _int8_flagship()
        with torch.no_grad():   # the K-major weights, made once
            fn(torch.zeros(8, SEQ_LEN, CHANNELS, device="cuda"),
               torch.full((8, 1, 1), 0.5, device="cuda"))
        return model, fn
    if kind == "standard":
        return _standard_flagship()
    if kind == "ncsn":
        return _dense_ncsn()
    model = _mdn(int(kind[3:])).eval()
    model.full = lambda t: model(t, shift=False)
    return model, model


def _chain_run(fn, call, seed, which, eager):
    """(outputs, generator state after, seconds, launches, peak GB) of one
    chain from a generator seeded with ``seed``."""
    from smd_tpu_torch.utils import graphs
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), (graphs.eager() if eager
                           else contextlib.nullcontext()):
        out = _outs(call(fn, gen, which))
    torch.cuda.synchronize()
    return (out, gen.get_state(), time.perf_counter() - t0, _counts(),
            torch.cuda.max_memory_allocated() / 1e9)


def _bit_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_chains(smi):
    """27: every sampler chain and both MDN decodes, captured against
    eager."""
    from smd_tpu_torch.utils import graphs
    served, rows = [], []
    models = {}
    for (name, kind, call, calls, per_call, graphs_made,
         short_calls) in _chain_cases():
        if kind not in models:
            graphs.release()
            models.clear()
            torch.cuda.empty_cache()
            models[kind] = _chain_model(kind)
        fn = models[kind][1]
        t_case = time.perf_counter()
        eager = _chain_run(fn, call, 27, "main", True)
        expected = tuple(calls * n for n in per_call)
        if eager[3] != expected:
            fail(f"27 {name}: the eager chain launched {eager[3]}, "
                 f"expected {expected}")
        before = _warmups()
        first = _chain_run(fn, call, 27, "main", False)
        made = _warmups() - before
        # The planted fault: another schedule through the kept graph (a
        # replaying call), against a fresh eager chain on it.
        alt = _chain_run(fn, call, 27, "alt", False)
        alt_eager = _chain_run(fn, call, 27, "alt", True)
        if made != graphs.WARMUP_STEPS * graphs_made or \
                _warmups() != before + made:
            fail(f"27 {name}: {made} warm-up steps at the first call and "
                 f"{_warmups() - before - made} after, expected "
                 f"{graphs.WARMUP_STEPS} for each of {graphs_made} graphs "
                 "and none")
        warm = tuple((calls + made) * n for n in per_call)
        for what, run, ref, launches in (
                ("the capturing call", first, eager, warm),
                ("a replaying call on another schedule", alt, alt_eager,
                 expected)):
            if not _bit_equal(run[0], ref[0]):
                gaps = [float((x.float() - y.float()).abs().max())
                        for x, y in zip(run[0], ref[0])]
                fail(f"27 {name}: {what} differs from its eager chain (max "
                     f"|diff| of state, collection, metrics {gaps}): a "
                     "baked or stale value where the schedule changed")
            if not torch.equal(run[1], ref[1]):
                fail(f"27 {name}: {what} left the generator elsewhere than "
                     "its eager chain")
            if run[3] != launches or ref[3] != expected:
                fail(f"27 {name}: {what} launched {run[3]}, its eager "
                     f"chain {ref[3]}, expected {launches} and {expected} "
                     f"({made} warm-up steps' at the first call)")
        if torch.equal(alt[0][0], first[0][0]):
            fail(f"27 {name}: another schedule gave the first schedule's "
                 "state: the planted fault cannot show")
        # The captured short chain under the profiler (the MDN decodes their
        # whole chain, at 32 positions only); the eager step's launches are
        # profile_torch_sampler.py --eager's.
        short = "main" if kind.startswith("mdn") else "short"
        prof = _profile(lambda: _chain_run(fn, call, 27, short, False),
                        short_calls) if short_calls <= SEQ_LEN else \
            (0.0,) * 5
        served.append(alt[3])
        rows.append(name)
        say(f"27 {name}: captured bit-equal to eager (state, collection, "
            f"metrics, generator) at the capturing call and at a replaying "
            f"call on another schedule (the planted fault: unlike the "
            f"first); launches {alt[3]} ({first[3]} at the first call, "
            f"{made} warm-up steps, {graphs_made} graphs); wall s eager "
            f"{eager[2]:.3f}, captured {alt[2]:.3f}, first call "
            f"{first[2]:.3f}; captured, profiled ({short_calls} model "
            f"calls; 0 where not profiled): host launches a model call "
            f"{prof[4]:.1f}, device-busy ms a call {prof[1]:.3f}, idle "
            f"{prof[3]:.3f}; peak memory eager "
            f"{eager[4]:.2f} GB, captured {first[4]:.2f} GB; case "
            f"{time.perf_counter() - t_case:.1f} s; on {smi}")
    graphs.release()
    models.clear()
    torch.cuda.empty_cache()
    say(f"27: {len(rows)} chains captured bit-equal to eager, each planted "
        "stale-schedule fault caught")
    return served


# The codec's recurrences as captured chains (phase 28): each chain's step
# captured in a CUDA graph and replayed (smd_tpu_torch/codec/musicvae.py
# over utils/graphs.py), against the same call with its steps run eagerly
# (``graphs.eager()``) from a generator seeded alike: every output and the
# generator's state bit-equal (torch.equal), at the capturing call and at
# a replaying one.
CODEC_CHAIN_BATCHES = (64, 2048)      # melody-2-big chunks, as phase 23a
CODEC_CHAIN_HIER = 64                 # latents through each hierarchical
# The planted stale-temperature fault: a second decode at the second
# temperature through the kept graph, its staged temperature left at the
# first's (what a graph that baked a Python float would do).
CODEC_CHAIN_TEMPS = (CODEC_TEMPERATURE, 1.0)


@contextlib.contextmanager
def _stale_temperature():
    """Chains whose graphs are captured keep the temperature they were
    staged with: the fault phase 28 must catch."""
    from smd_tpu_torch.utils import graphs
    stage = graphs._Slots.stage

    def stale(self, k, inputs, tables, statics):
        if self.graphs:
            statics = {n: v for n, v in statics.items() if n != "temp"}
        return stage(self, k, inputs, tables, statics)
    graphs._Slots.stage = stale
    try:
        yield
    finally:
        graphs._Slots.stage = stage


def _codec_call(call, seed, eager):
    """(outputs, generator state after, seconds) of ``call(gen)``, its
    chains captured (or replayed) or with their steps run eagerly."""
    from smd_tpu_torch.utils import graphs
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), (graphs.eager() if eager
                           else contextlib.nullcontext()):
        out = call(gen)
    torch.cuda.synchronize()
    return (_outs(out), gen.get_state(), time.perf_counter() - t0)


def _one_hot_chunks(n, cfg, seed):
    tokens = torch.randint(0, cfg.depth, (n, cfg.max_seq_len),
                           generator=torch.Generator().manual_seed(seed))
    return torch.nn.functional.one_hot(tokens, cfg.depth).float().cuda()


def phase_codec_chains(smi):
    """28: every codec chain captured against its eager steps, and the
    planted stale-temperature fault."""
    from smd_tpu_torch.codec import musicvae as mv
    from smd_tpu_torch.config import MUSIC_VAE_CONFIG
    from smd_tpu_torch.utils import graphs

    cases = []
    cfg = MUSIC_VAE_CONFIG["melody-2-big"].model
    tree = _codec_tree(cfg, seed=28)
    x = _one_hot_chunks(max(CODEC_CHAIN_BATCHES), cfg, 28)
    mu = torch.randn(max(CODEC_CHAIN_BATCHES), cfg.latent_dims,
                     generator=torch.Generator().manual_seed(29)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        model = mv.build_musicvae(cfg, tree, dtype=dtype, device="cuda")
        name = f"melody-2-big {str(dtype).split('.')[-1]}"
        for batch in CODEC_CHAIN_BATCHES:
            cases.append((f"{name} encode of {batch}", 1,
                          lambda gen, m=model, b=batch: m.encode(x[:b], gen)))
            cases.append((f"{name} decode of {batch}", 1,
                          lambda gen, m=model, b=batch: m.decode(
                              mu[:b], CODEC_TEMPERATURE, generator=gen)))
        # The encoder's graph at 64 is kept from the encode above.
        cases.append((f"{name} teacher-forced forward of 64", 1,
                      lambda gen, m=model: m(x[:64], gen)))
        if dtype == torch.float32:
            float32 = model
    del tree
    for entry in ("melody-16-big", "multi-1-big"):
        e = MUSIC_VAE_CONFIG[entry].model
        model = mv.build_musicvae(e, _codec_tree(e, seed=28), device="cuda")
        z = torch.randn(CODEC_CHAIN_HIER, e.latent_dims,
                        generator=torch.Generator().manual_seed(30)).cuda()
        cases.append((f"{entry} decode of {CODEC_CHAIN_HIER} latents "
                      f"(conductor embeddings, logits, tokens)", 2,
                      lambda gen, m=model, z=z: (m.conductor(z), *m.decode(
                          z, CODEC_TEMPERATURE, generator=gen))))
    rows = []
    _reset_counts()
    for what, graphs_made, call in cases:
        eager = _codec_call(call, 28, True)
        before = _warmups()
        first = _codec_call(call, 28, False)
        made = _warmups() - before
        second = _codec_call(call, 28, False)
        if made != graphs.WARMUP_STEPS * graphs_made or \
                _warmups() != before + made:
            fail(f"28 {what}: the first call ran {made} warm-up steps, "
                 f"expected {graphs.WARMUP_STEPS} for each of {graphs_made} "
                 "graphs, and the second none")
        for which, run in (("capturing", first), ("replaying", second)):
            if not (_bit_equal(run[0], eager[0]) and
                    torch.equal(run[1], eager[1])):
                fail(f"28 {what}: the {which} call differs from the eager "
                     "steps (outputs or the generator's state)")
        rows.append(f"{what}: eager {eager[2]:.3f} s, captured "
                    f"{second[2]:.3f} s (first {first[2]:.3f} s)")
    if _counts() != (0, 0, 0, 0):
        fail(f"28: the codec launched a port kernel: {_counts()}")

    # The stale-temperature fault, on the float32 melody-2-big decoder:
    # the fault's call right after the first, whose temperature the kept
    # graph's buffer still holds; then the sound second call, and the
    # fresh eager decode.
    gumbel = card_gumbel((64, cfg.max_seq_len, cfg.depth), seed=31)

    def decode(temperature):
        return lambda gen: float32.decode(mu[:64], temperature,
                                          gumbel=gumbel)

    t1, t2 = CODEC_CHAIN_TEMPS
    kept = _codec_call(decode(t1), 0, False)[0]
    with _stale_temperature():
        stale = _codec_call(decode(t2), 0, False)[0]
    again = _codec_call(decode(t2), 0, False)[0]
    fresh = _codec_call(decode(t2), 0, True)[0]
    if not _bit_equal(again, fresh) or _bit_equal(again, kept):
        fail("28: the kept decoder graph at another temperature does not "
             "equal a fresh eager decode there, or equals the first")
    if _bit_equal(stale, fresh):
        fail("28: a kept graph whose temperature stayed at the first call's "
             "passes the check")
    flips = int((stale[1] != fresh[1]).sum())
    say("28 codec chains bit-equal to their eager steps (outputs and the "
        "generator's state, capturing and replaying calls): "
        + "; ".join(rows) + f"; the kept decoder graph at temperature {t2} "
        f"after {t1} equals a fresh eager decode at {t2}; the planted "
        f"stale temperature caught ({flips} of {stale[1].numel()} tokens "
        f"differ); on {smi}")


def main():
    with Phase("1 device"):
        smi = phase_device()
    with Phase("2 build"):
        phase_build()
    with Phase("3 kernels"):
        records = phase_kernels()
    served = []
    with Phase("4 model"):
        model, model_fn = _flagship()
        phase_model(model, model_fn, "fused")
    with Phase("5 serve"):
        served.append(phase_serve(model, model_fn, smi, "fused"))
    del model, model_fn
    with Phase("6 int8 model"):
        model, model_fn = _int8_flagship()
        phase_model(model, model_fn, "int8")
    with Phase("7 int8 serve"):
        served.append(phase_serve(model, model_fn, smi, "int8"))
    del model, model_fn
    with Phase("8 standard model"):
        model, model_fn = _standard_flagship()
        phase_model(model, model_fn, "standard", LONG_BATCH, LONG_SEQ_LEN)
        phase_model(model, model_fn, "standard")
    with Phase("9 standard serve"):
        served.append(phase_serve(model, model_fn, smi, "standard",
                                  LONG_BATCH, LONG_SEQ_LEN))
    del model, model_fn
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("10 train"):
            state = phase_train(tmp, smi)
        with Phase("11 serve the checkpoint"):
            phase_train_serve(smi)
        with Phase("12 mixed precision"):
            phase_mixed(tmp, smi)
        with Phase("13 fused training"):
            served.append(phase_fused_train(state, smi))
        with Phase("14 few-step serve"):
            served.extend(phase_fewstep(smi))
        with Phase("15 few-step int8 and flash"):
            served.extend(phase_fewstep_int8_flash(smi))
        with Phase("16 distillation"):
            served.extend(phase_distill(state, smi))
        with Phase("17 the CLIs"):
            phase_fewstep_clis(tmp, smi)
        with Phase("18 dense DDPM"):
            phase_dense_ddpm(tmp, smi)
        with Phase("19 NCSN"):
            phase_ncsn(tmp, smi)
        with Phase("20 ConvNCSN and the toy networks"):
            phase_conv_toy(tmp, smi)
        with Phase("21 MDN"):
            phase_mdn(tmp, smi)
        with Phase("22 MDN at 512 positions"):
            served.extend(phase_mdn_long(smi))
        t23 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp23:
            with Phase("23a the codec"):
                codec, codec_path = phase_codec(tmp23, smi)
            with Phase("23b noise to MIDI"):
                served.append(phase_noise_to_midi(tmp23, smi, codec))
            del codec
            torch.cuda.empty_cache()
            with Phase("23c the codec CLIs"):
                served.append(phase_codec_clis(tmp23, smi, codec_path))
        say(f"phase 23 (codec and generation) took "
            f"{time.perf_counter() - t23:.1f} s")
        torch.cuda.empty_cache()
        t24 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp24:
            with Phase("24a codec training"):
                trained, corpus = phase_codec_training(tmp24, smi)
            with Phase("24b eval_codec"):
                phase_eval_codec(smi, trained, corpus)
            with Phase("24c sampling metrics"):
                served.append(phase_sampling_metrics(tmp24, smi))
                phase_metrics_cli(tmp, smi)
            with Phase("24d audio"):
                phase_audio(tmp24, smi, trained)
        say(f"phase 24 (codec training, metrics, audio) took "
            f"{time.perf_counter() - t24:.1f} s")
        torch.cuda.empty_cache()
        t25 = time.perf_counter()
        with Phase("25a one rank in a group"):
            phase_ddp_single(tmp, smi)
        with Phase("25b-c data and model axes"):
            served.append(phase_ddp_ranks(smi))
        with Phase("25d dryrun_multichip"):
            phase_dryrun_multichip(smi)
        say(f"phase 25 (distributed training) took "
            f"{time.perf_counter() - t25:.1f} s")
    with Phase("26 captured training chunks"):
        served.extend(phase_chunks(smi))
    with Phase("26b remat through the CLIs"):
        phase_remat_clis(smi)
    with Phase("27 captured sampler chains"):
        served.extend(phase_chains(smi))
    with Phase("28 captured codec chains"):
        phase_codec_chains(smi)
    # Each kernel's launches in the runs of the paths that run it.
    for i, name in enumerate(KERNELS):
        records[name]["launches"] = sum(c[i] for c in served)
    kernels = [dict(name=name, route="cuda", **records[name])
               for name in KERNELS]
    say(f"total {time.perf_counter() - T_START:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
