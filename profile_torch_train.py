#!/usr/bin/env python3
"""Where the time of a training step goes on the card (smd_tpu_torch).

    python3 profile_torch_train.py [--mode fp32|mixed|fused|distill|mdn|codec]
                                   [--batch 64] [--steps 24] [--scan_chunk K]

Trains one of ``chip_smoke.Trainer``'s trainers at full width, params from
seed 0, on seeded batches that lie on the card: the flagship
TransformerDDPM of ``chip_smoke.py`` (6 layers, 8 heads, embed 128, MLP
2048, 2 FiLM resblocks) on 32x42 with the DDPM loss, gradient, global-norm
clip, Adam and the EMA (T=1000 linear betas, LR 1e-3), in ``fp32`` (the
standard layout in float32), ``mixed`` (bf16 compute, float32 params) or
``fused`` (the fused layout, params and compute bf16: the attention and
film kernels forward, their plain versions' gradients backward);
``distill`` (a progressive-distillation step of the fused layout on the
8-to-4 stage: the teacher, a frozen copy, twice without a gradient, the
student once); ``mdn`` (the TransformerMDN of
``configs/mdn-mel-32seq-512.cfg``, float32, its teacher-forced NLL; batch
128); ``codec`` (the MusicVAE ``melody-2-big`` at batch 64, the ELBO with
scheduled sampling 0.2). After 5 warm-up steps it times ``--steps`` eager
steps (host clock around a synchronised run), then traces as many under
``torch.profiler``; with ``--scan_chunk`` K > 1 it does the same with the
steps taken K at a time through the trainer's chunk (one step captured in
a CUDA graph, ``training/graphs.py``, replayed K times; the capturing
chunk is not timed). For each it prints wall and device-busy ms per step,
the idle share, the host's launches a step, the device time by kind and
the kernels by device time (``profile_torch_sampler.report``, with the op
profile of each trace written under ``--trace_dir``); the last line is one
JSON object with both records. Needs a CUDA device.
"""
import argparse
import json
import time

import torch

import chip_smoke
from profile_torch_sampler import report
from smd_tpu_torch.utils import profiling

MODES = ("fp32", "mixed", "fused", "distill", "mdn", "codec")


def _batches(trainer, count):
    """``count`` batches, the trainer's own (CHUNK_STEPS of them) in
    turn."""
    idx = torch.arange(count, device="cuda") % trainer.batches.shape[0]
    return trainer.batches[idx]


def _measure(run, steps, trace_dir):
    """(wall seconds a step of ``run()``, its ``torch.profiler`` run)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profiling.trace(trace_dir, "cuda") as prof:
        run()
    return wall, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES, default="fp32")
    ap.add_argument("--batch", type=int, default=None,
                    help="the trainer's batch (chip_smoke.TRAIN_BATCH)")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--scan_chunk", type=int, default=1,
                    help="also take the steps this many at a time through "
                         "the captured chunk")
    ap.add_argument("--trace_dir", default="chiprun_out/profile-train",
                    help="where the Chrome traces of the profiled steps go")
    args = ap.parse_args()
    smi = chip_smoke.phase_device()
    trainer = chip_smoke.Trainer(args.mode, args.batch)
    what = f"train {args.mode}, batch {trainer.batch}"
    batches = _batches(trainer, args.steps)

    def eager():
        for b in batches:
            trainer.step(b)

    for b in batches[:5]:
        trainer.step(b)
    wall, prof = _measure(eager, args.steps, f"{args.trace_dir}/eager")
    records = {"eager": report(prof, args.steps, wall, smi,
                               f"{what}, eager steps",
                               trace_dir=f"{args.trace_dir}/eager",
                               mode=args.mode, batch=trainer.batch)}
    k = args.scan_chunk
    if k > 1:
        chunks = max(1, args.steps // k)
        stacks = [_batches(trainer, k) for _ in range(chunks)]

        def captured():
            for stack in stacks:
                trainer.chunk(stack)

        trainer.chunk(stacks[0])   # warm-up and capture
        wall, prof = _measure(captured, chunks * k,
                              f"{args.trace_dir}/captured")
        records["captured"] = report(
            prof, chunks * k, wall, smi,
            f"{what}, chunks of {k} captured steps",
            trace_dir=f"{args.trace_dir}/captured", mode=args.mode,
            batch=trainer.batch, scan_chunk=k)
    trainer.close()
    print(json.dumps(records), flush=True)


if __name__ == "__main__":
    main()
