#!/usr/bin/env python3
"""What ``chip_smoke.py``'s few-step checks read clean and with planted
faults, on the card (smd_tpu_torch).

    python3 study_torch_tolerances.py [--grad_seeds 10]

Sets the limits of phases 14-16 (``CALL_RTOL``, ``CHAIN_RTOL``,
``DISTILL_GRAD_RTOL``) beside the readings they must pass and the faults
they should catch. On the fused flagship of ``chip_smoke.py`` (random bf16
weights from seed 0) it runs the four few-step chains of phase 14 on 1000
requests, each through the kernels and through the plain versions from one
generator, and reads the chain's |err| / |plain| and the worst model call's
(every call of the plain chain also run through the kernels). Then it
trains the flagship as phase 10 does and reads the progressive-distillation
gradient through the kernels against the plain versions, with and without
the x0 clip, at ``--grad_seeds`` draw seeds from 10: the worst parameter's
|err| / |plain|, the median parameter's and the whole gradient's. Each
reading is repeated with a fault planted in a kernel's output:

- ``film+1ulp`` / ``attn+1ulp``: every film / fused-attention output one
  bf16 ulp towards +inf;
- ``film*1.01`` / ``attn*1.01``: every such output 1% too large;

the faulted gradients at the first three seeds.

    python3 study_torch_tolerances.py --codec

instead sets phase 23's limits on the bf16 codec (``CODEC_BF16_*``): the
``melody-2-big`` codec from weight seeds 23-25 (phase 23a's is 23), float32
and bf16, on phase 23a's 2,048 chunks, read by ``codec_bf16_readings``
clean at draw seeds 37-39 and with each fault of ``chip_smoke.codec_fault``
at seed 37.

Prints one ``reading`` JSON line each, then the card's name and power
limit. Needs a CUDA device.
"""
import argparse
import contextlib
import json
import tempfile

import numpy as np
import torch

import chip_smoke as cs

FAULTS = ("film+1ulp", "attn+1ulp", "film*1.01", "attn*1.01")


@contextlib.contextmanager
def planted(fault):
    """Each launch of the faulted kernel returns a wrong output."""
    from smd_tpu_torch.ops import fused_attention as fat
    from smd_tpu_torch.ops import fused_film_resblock as ffr
    if fault is None:
        yield
        return
    module = ffr if fault.startswith("film") else fat
    launch = module._launch

    def faulty(*args):
        out = launch(*args)
        if fault.endswith("+1ulp"):
            return torch.nextafter(out, torch.full_like(out, float("inf")))
        return (out.float() * 1.01).to(out.dtype)

    module._launch = faulty
    try:
        yield
    finally:
        module._launch = launch


def reading(**kw):
    print("reading", json.dumps(kw), flush=True)


def chains():
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.utils import graphs
    model, model_fn = cs._flagship()

    def run(fn, sampling, kw):
        gen = torch.Generator(device="cuda").manual_seed(7)
        out, _, _ = generate.sample(
            fn, cs._betas(), gen, (cs.SEQ_LEN, cs.CHANNELS),
            num_samples=cs.FEWSTEP_BATCH, sampling=sampling, collect_steps=0,
            collect_metrics=False, device="cuda", **cs._sample_kw(kw))
        return out

    # Eager chains: a kept CUDA graph would replay the kernels as captured,
    # without the fault planted in the wrapper, and the plain chain reads
    # each call's gap back to the host.
    with torch.no_grad(), graphs.eager():
        for sampling, kw, _ in cs.FEWSTEP:
            for fault in (None, *FAULTS):
                call_rels = []

                def plain_and_kernels(x, c):
                    plain = cs.model_fn_plain(model, model_fn, x, c)
                    call_rels.append(float((model_fn(x, c) - plain).norm() /
                                           plain.norm()))
                    return plain

                with planted(fault):
                    ours = run(model_fn, sampling, kw)
                    ref = run(plain_and_kernels, sampling, kw)
                reading(check="chain", sampling=sampling, fault=fault,
                        chain=float((ours - ref).norm() / ref.norm()),
                        worst_call=max(call_rels), calls=len(call_rels))


def gradients(state, seeds):
    from smd_tpu_torch import cli
    from smd_tpu_torch.training import distill
    model = cs._fused_from(state)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_ds, _ = cli.dataset_from_flags()
    batch = torch.from_numpy(next(iter(train_ds))).cuda()
    grid, mids = distill.halve_grid(distill.distill_grid(cs._betas(), 16))
    teacher = distill.frozen_copy(model, params)
    names = list(params)

    def grads(plain, clip_x0, draws):
        for m in (model, teacher):
            m.use_plain_ops(plain)
        try:
            loss = distill.progressive_distillation_loss(
                batch, model, teacher, grid, mids, clip_x0=clip_x0,
                draws=draws)
            return torch.autograd.grad(loss, list(model.parameters()))
        finally:
            for m in (model, teacher):
                m.use_plain_ops(False)

    def study(seed, clip_x0, fault):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        draws = (torch.randint(0, 8, (batch.shape[0],), generator=gen,
                               device="cuda"),
                 torch.randn(batch.shape, generator=gen, device="cuda"))
        with planted(fault):
            g_k = grads(False, clip_x0, draws)
        g_p = grads(True, clip_x0, draws)
        d = [float((a.float() - b.float()).norm()) for a, b in zip(g_k, g_p)]
        n = [float(b.float().norm()) for b in g_p]
        rels = [x / max(y, 1e-30) for x, y in zip(d, n)]
        reading(check="distill_grad", seed=seed, clip_x0=clip_x0,
                fault=fault, worst=max(rels),
                worst_name=names[int(np.argmax(rels))],
                median=float(np.median(rels)),
                whole=float(np.linalg.norm(d) / np.linalg.norm(n)))

    for clip_x0 in (False, True):
        for seed in seeds:
            study(seed, clip_x0, None)
        for fault in FAULTS:
            for seed in seeds[:3]:
                study(seed, clip_x0, fault)


CODEC_FAULTS = ("enc-carry-bf16", "xi+1ulp", "logits-bf16")


def codec():
    from smd_tpu_torch.codec import musicvae as mv
    from smd_tpu_torch.config import MUSIC_VAE_CONFIG
    cfg = MUSIC_VAE_CONFIG["melody-2-big"].model
    x = cs.codec_chunks().cuda()
    with torch.no_grad():
        for seed in (23, 24, 25):
            tree = cs._codec_tree(cfg, seed)
            f32 = mv.build_musicvae(cfg, tree, device="cuda")
            bf16 = mv.build_musicvae(cfg, tree, dtype=torch.bfloat16,
                                     device="cuda")
            del tree
            for draws in (37, 38, 39):
                gumbel = cs.card_gumbel(
                    (x.shape[0], cfg.max_seq_len, cfg.depth), draws)
                ref = cs.codec_reference(f32, x, gumbel)
                for fault in (None, *CODEC_FAULTS) if draws == 37 \
                        else (None,):
                    r = cs.codec_bf16_readings(ref, bf16, x, gumbel, fault)
                    reading(check="codec_bf16", seed=seed, draws=draws,
                            fault=fault, **r,
                            exceeded=cs.codec_bf16_exceeded(r))
            del f32, bf16
            torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--grad_seeds", type=int, default=10)
    parser.add_argument("--codec", action="store_true",
                        help="read phase 23's bf16 codec check instead")
    args = parser.parse_args()
    smi = cs.phase_device()
    if args.codec:
        codec()
        print(f"on {smi}", flush=True)
        return
    cs.phase_build()
    chains()
    with tempfile.TemporaryDirectory() as tmp:
        state = cs.phase_train(tmp, smi)
        gradients(state, list(range(10, 10 + args.grad_seeds)))
    print(f"on {smi}", flush=True)


if __name__ == "__main__":
    main()
