#!/usr/bin/env python3
"""Where the time of a training step goes on the card (smd_tpu_torch).

    python3 profile_torch_train.py [--mode fp32|mixed|fused|distill|mdn]
                                   [--batch 64] [--steps 20]

Trains the flagship TransformerDDPM of ``chip_smoke.py`` (6 layers, 8
heads, embed 128, MLP 2048, 2 FiLM resblocks) on 32x42 latents with
``training.diffusion.make_train_step`` (the DDPM loss, gradient, global-norm
clip, Adam; T=1000 linear betas, LR 1e-3, no EMA, as
``configs/ddpm-mel-32seq-512.cfg``), params drawn from seed 0, on random
batches in [-1, 1] that lie on the card. The modes: ``fp32`` (the standard
layout in float32), ``mixed`` (``--mixed_precision``: bf16 compute, float32
params) and ``fused`` (the fused layout, params and compute bf16: the
attention and film kernels forward, their plain versions' gradients
backward), and ``distill`` (a progressive-distillation step of the fused
layout at bf16, ``training.distill.make_distill_step`` on the 8-to-4 stage
of an 8-step start: the teacher, a frozen copy, twice without a gradient,
the student once with its gradient, clip and Adam), and ``mdn`` (the
TransformerMDN of ``configs/mdn-mel-32seq-512.cfg``, float32, on its
teacher-forced NLL with ``training.mdn.make_train_step``; the flagfile's
batch is 128). After 5 warm-up steps
it times ``--steps`` steps (host clock
around a synchronised run), then traces as many under ``torch.profiler``,
and prints wall and device-busy ms per step, the idle share, the device
time by kind and the kernels by device time (``profile_torch_sampler.
report``, with the op profile of the trace written to ``--trace_dir``);
the last line is one JSON object with those numbers. Needs a CUDA device.
"""
import argparse
import time

import torch

import chip_smoke
from profile_torch_sampler import report
from smd_tpu_torch.utils import profiling

MODES = ("fp32", "mixed", "fused", "distill", "mdn")


def _state(mode):
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.layers import init_parameters
    from smd_tpu_torch.training import diffusion as trainer
    if mode == "mdn":
        model = get_model("TransformerMDN", device="cuda",
                          data_channels=chip_smoke.CHANNELS,
                          **chip_smoke.MDN_WIDTH)
        return trainer.create_train_state(
            init_parameters(model, 0),
            trainer.TrainConfig(learning_rate=3e-4, ema=False), init=False)
    fused = mode in ("fused", "distill")
    model = get_model("TransformerDDPM", device="cuda",
                      data_channels=chip_smoke.CHANNELS,
                      dtype=torch.float32 if mode == "fp32" else
                      torch.bfloat16, fused_attention=fused,
                      fused_head=fused, **chip_smoke.FLAGSHIP)
    init_parameters(model, 0)
    if fused:
        model = model.to(torch.bfloat16)
    config = trainer.TrainConfig(learning_rate=1e-3, ema=False)
    return trainer.create_train_state(model, config, init=False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES, default="fp32")
    ap.add_argument("--batch", type=int, default=chip_smoke.SERVE_BATCH)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace_dir", default="chiprun_out/profile-train",
                    help="where the Chrome trace of the profiled steps goes")
    args = ap.parse_args()
    smi = chip_smoke.phase_device()
    from smd_tpu_torch.diffusion import losses, schedules
    from smd_tpu_torch.training import diffusion as trainer
    state = _state(args.mode)
    betas = schedules.noise_schedule(1e-6, 0.01, 1000, "linear")
    if args.mode == "distill":
        from smd_tpu_torch.training import distill
        grid, mids = distill.halve_grid(distill.distill_grid(betas, 16))
        step = distill.make_distill_step(state.model, state.params, grid,
                                         mids)
    elif args.mode == "mdn":
        from smd_tpu_torch.training import mdn
        step = mdn.make_train_step()
    else:
        step = trainer.make_train_step(losses.diffusion_loss, betas, True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [torch.rand(args.batch, chip_smoke.SEQ_LEN, chip_smoke.CHANNELS,
                          generator=gen, device="cuda") * 2 - 1
               for _ in range(args.steps)]

    def run():
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()

    for b in batches[:5]:
        step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) / args.steps
    with profiling.trace(args.trace_dir, "cuda") as prof:
        run()
    report(prof, args.steps, wall, smi,
           f"train {args.mode}, batch {args.batch}, 32x42",
           trace_dir=args.trace_dir, mode=args.mode, batch=args.batch)


if __name__ == "__main__":
    main()
