#!/usr/bin/env python3
"""Where the time of a DDPM sampler step goes on the card (smd_tpu_torch).

    python3 profile_torch_sampler.py [--layout fused|int8|standard|dense|mdn]
                                     [--batch 64] [--seq_len 32] [--steps 20]
                                     [--eager]

Serves a bf16 flagship TransformerDDPM of ``chip_smoke.py`` on
``--seq_len``x42 latents with ``generate.sample(sampling="ddpm")`` for
``--steps`` steps, first without and then under ``torch.profiler``. The
layouts: ``fused`` (the fused attention and film kernels), ``int8`` (the
standard einsum trunk and the w8a8 kernel, quantized and calibrated as
there) and ``standard`` (the einsum trunk, or the flash-attention kernel at
``--seq_len`` >= 512, and the float head); ``dense`` serves
``configs/ddpm-mel-1seq-512.cfg``'s DenseDDPM (6 x 2048, bf16 params as
``sample_ncsn`` serves them; resblocks in float32) on 512-d latents
(``--seq_len`` unused); ``mdn`` decodes ``--steps`` positions with
``mdn_decode.ar_decode_cached`` through ``configs/mdn-mel-32seq-512.cfg``'s
TransformerMDN (float32, as ``sample_mdn`` serves it; a step is one
position over the KV cache). The chain serves as a user's does: its step
captured in a CUDA graph and replayed once a step (a first call of the same
shape captures it, outside the timings); ``--eager`` runs the step eagerly
instead (``utils.graphs.eager``), the loop the capture replaced. It prints:
wall seconds per step
(host clock around a synchronised run), the device's busy time per step
(union of the kernels' intervals in the trace) and its idle share, the
device time by kind (the port's kernels, the library's matmuls, PyTorch's
multi-tensor and other kernels) and the kernels by device time. The last
line is one JSON object with those numbers; the Chrome trace of the
profiled steps goes to ``--trace_dir``, whose op profile
(``smd_tpu_torch.utils.profiling``) is printed too. Needs a CUDA device.
"""
import argparse
import contextlib
import json
import time
from collections import defaultdict

import torch

import chip_smoke
from smd_tpu_torch.utils import profiling


def _serve(model_fn, steps, batch, shape, seed):
    from smd_tpu_torch.diffusion import schedules
    from smd_tpu_torch.sampling import generate
    betas = schedules.noise_schedule(1e-6, 0.01, steps, "linear")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return generate.sample(model_fn, betas, gen, shape,
                           num_samples=batch, sampling="ddpm",
                           collect_steps=0, collect_metrics=False,
                           device="cuda")[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=chip_smoke.SERVE_BATCH)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq_len", type=int, default=chip_smoke.SEQ_LEN)
    ap.add_argument("--layout", choices=(*chip_smoke.LAYOUTS, "dense",
                                         "mdn"),
                    default="fused",
                    help="fused kernels, the int8 head through w8a8, the "
                         "standard layout (flash attention at S >= 512), "
                         "the single-latent DenseDDPM, or the MDN's cached "
                         "decode")
    ap.add_argument("--trace_dir", default="chiprun_out/profile-sampler",
                    help="where the Chrome trace of the profiled steps goes")
    ap.add_argument("--eager", action="store_true",
                    help="run each step eagerly, not as a replay of its "
                         "captured CUDA graph")
    args = ap.parse_args()
    smi = chip_smoke.phase_device()
    if args.layout == "mdn":
        from smd_tpu_torch.sampling import mdn_decode
        model = chip_smoke._mdn(max(128, args.steps))

        def serve(steps, seed):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return mdn_decode.ar_decode_cached(
                gen, model, args.batch, steps=steps,
                channels=chip_smoke.CHANNELS, log_sigma_cap=0.0)
    else:
        _, model_fn = {"fused": chip_smoke._flagship,
                       "int8": chip_smoke._int8_flagship,
                       "standard": chip_smoke._standard_flagship,
                       "dense": chip_smoke._dense_ddpm}[args.layout]()
        shape = (chip_smoke.FLAT_WIDTH,) if args.layout == "dense" else \
            (args.seq_len, chip_smoke.CHANNELS)

        def serve(steps, seed):
            return _serve(model_fn, steps, args.batch, shape, seed)
    from smd_tpu_torch.utils import graphs
    with torch.no_grad(), (graphs.eager() if args.eager
                           else contextlib.nullcontext()):
        serve(args.steps, 0)    # the capture, outside the timings
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(args.steps, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps

        with profiling.trace(args.trace_dir, "cuda") as prof:
            serve(args.steps, 1)

    how = "eager" if args.eager else "captured"
    report(prof, args.steps, wall, smi,
           f"{args.layout} ({how}), batch {args.batch}, seq_len "
           f"{args.seq_len}", trace_dir=args.trace_dir, layout=args.layout,
           batch=args.batch, seq_len=args.seq_len, chain=how)


# The port's CUDA kernels (smd_tpu_torch/csrc/), by name.
PORT_KERNELS = ("film_gemm_kernel", "film_f32_kernel", "row_stats_kernel",
                "ln_attention_kernel", "ln_attention_tc_kernel",
                "flash_bf16_kernel", "flash_kernel", "w8a8_gemm_kernel",
                "quantize_kernel", "transpose_kernel")


def kind(name):
    """A device kernel's kind: the port's kernels, the library's matmuls,
    PyTorch's multi-tensor (foreach) kernels, or other PyTorch kernels."""
    if any(f"::{k}<" in name or f"::{k}(" in name for k in PORT_KERNELS):
        return "port kernels"
    if "multi_tensor_apply" in name:
        return "multi-tensor kernels"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "library matmuls"
    return "other kernels"


def report(prof, steps, wall, smi, what, trace_dir=None, **meta):
    """Print wall and device-busy ms per step, the idle share, the device
    time by kind and the kernels by device time from a ``torch.profiler``
    trace of ``steps`` steps, the host's launches a step (kernels, graph
    replays, copies), and the trace's op profile (``utils.profiling``)
    where ``trace_dir`` holds it; the last line one JSON object with them
    and ``meta``, which it returns."""
    device, busy, span, idle = profiling.trace_summary(prof)
    launches = profiling.host_launches(prof) / steps
    per_kernel = defaultdict(lambda: [0, 0.0])
    for evt in device:
        per_kernel[evt.name][0] += 1
        per_kernel[evt.name][1] += evt.time_range.end - evt.time_range.start
    busy, span = busy / 1e6 / steps, span / 1e6 / steps
    print(f"{smi}; {what}, {steps} steps", flush=True)
    print(f"wall {wall * 1e3:.3f} ms/step unprofiled; profiled span "
          f"{span * 1e3:.3f} ms/step, device busy {busy * 1e3:.3f} ms/step, "
          f"idle share {idle:.3f}, {launches:.1f} host launches a step, "
          f"{len(device) / steps:.1f} device operations a step")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    by_kind = defaultdict(lambda: [0.0, 0.0])
    for name, (calls, us) in rows:
        by_kind[kind(name)][0] += us / 1e3 / steps
        by_kind[kind(name)][1] += calls / steps
    print("by kind: " + ", ".join(
        f"{k} {ms:.3f} ms/step ({calls:.0f} calls)"
        for k, (ms, calls) in sorted(by_kind.items(), key=lambda kv:
                                      -kv[1][0])))
    print(f"{'device ms/step':>14} {'calls/step':>10}  kernel")
    for name, (calls, us) in rows[:25]:
        print(f"{us / 1e3 / steps:14.4f} {calls / steps:10.1f}  "
              f"{name[:110]}")
    if trace_dir is not None:
        print("op profile (device time by launching operation):")
        print(profiling.format_op_profile(*profiling.op_profile(trace_dir),
                                          steps=steps))
    record = {
        "card": smi, **meta, "steps": steps,
        "wall_ms_per_step": wall * 1e3,
        "profiled_span_ms_per_step": span * 1e3,
        "device_busy_ms_per_step": busy * 1e3,
        "idle_share": idle, "host_launches_per_step": launches,
        "device_operations_per_step": len(device) / steps,
        "by_kind": {k: {"device_ms_per_step": ms, "calls_per_step": c}
                    for k, (ms, c) in by_kind.items()},
        "kernels": [{"name": n, "calls_per_step": c / steps,
                     "device_ms_per_step": us / 1e3 / steps}
                    for n, (c, us) in rows[:25]]}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
