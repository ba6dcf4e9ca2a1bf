"""The port's fused_ln_attention against the Pallas kernel.

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in Pallas interpret mode, as ``tests/test_fused_attention.py`` runs it. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.ops import fused_attention as jfat
from smd_tpu_torch.ops import fused_attention as fat


def _inputs(B=4, S=16, E=32, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, E)) + 0.2).astype(np.float32)
    wqkv = (rng.normal(size=(E, 3 * E)) / np.sqrt(E)).astype(np.float32)
    bqkv = (rng.normal(size=(3 * E,)) * 0.1).astype(np.float32)
    wout = (rng.normal(size=(E, E)) / np.sqrt(E)).astype(np.float32)
    bout = (rng.normal(size=(E,)) * 0.1).astype(np.float32)
    lns = (1 + 0.1 * rng.normal(size=(E,))).astype(np.float32)
    lnb = (0.1 * rng.normal(size=(E,))).astype(np.float32)
    return x, wqkv, bqkv, wout, bout, lns, lnb


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret(causal):
    args = _inputs()
    ref = jfat.fused_ln_attention(*map(jnp.asarray, args), 4, causal,
                                  interpret=True)
    ours = fat.fused_ln_attention(*map(torch.from_numpy, args), 4, causal)
    assert ours.dtype == torch.float32 and ours.shape == (4, 16, 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)  # float32, as the Pallas tests


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_reference(causal):
    args = _inputs(B=2, S=8, E=64, seed=1)
    ref = jfat._reference(*map(jnp.asarray, args), num_heads=8, causal=causal)
    ours = fat._reference(*map(torch.from_numpy, args), 8, causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)  # float32


def test_bf16_input_is_computed_in_float32_and_stored_in_bf16():
    args = _inputs(seed=2)
    x = torch.from_numpy(args[0]).bfloat16()
    ours = fat.fused_ln_attention(x, *map(torch.from_numpy, args[1:]), 4)
    assert ours.dtype == torch.bfloat16
    ref = jfat._reference(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          *map(jnp.asarray, args[1:]), num_heads=4,
                          causal=False)
    # float32 inside; the outputs may land either side of a bf16 rounding
    # boundary: one bf16 ulp of |y| <= 4.
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=1.6e-2)


def test_cpu_wrapper_counts_no_launch():
    before = fat.fused_ln_attention.launches
    fat.fused_ln_attention(*map(torch.from_numpy, _inputs()), 4)
    assert fat.fused_ln_attention.launches == before


# -- the CUDA kernel's bf16 arithmetic, emulated ------------------------------
# ``fused_attention._tc_emulation`` rounds the LN rows, q, k, v, p and o to
# bf16 where the tensor-core kernel does; chip_smoke.py holds the kernel to
# it on the card by ``tc_ulp_stats``.

_emulate_bf16_kernel = fat._tc_emulation


def _bf16_inputs(B, S, E, seed):
    """chip_smoke's attention inputs: x ~ N(0.2, 1), weights ~ N(0, 1/E),
    small biases and LN affine, all bf16."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, S, E)) + 0.2,
              rng.normal(size=(E, 3 * E)) / np.sqrt(E),
              rng.normal(size=(3 * E,)) * 0.1,
              rng.normal(size=(E, E)) / np.sqrt(E),
              rng.normal(size=(E,)) * 0.1,
              1 + 0.1 * rng.normal(size=(E,)),
              0.1 * rng.normal(size=(E,))]
    return [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in arrays]


@pytest.mark.parametrize("B,S,E,H,causal", [
    (8, 32, 128, 8, False),     # the bench shape (Dh=16), fewer items
    (8, 32, 128, 8, True),
    (4, 32, 64, 8, False),      # Dh=8
    (4, 33, 64, 2, True),       # Dh=32, ragged S
    (4, 16, 128, 2, False),     # Dh=64
    (5, 20, 64, 8, True),       # Dh=8, ragged S
])
def test_bf16_kernel_arithmetic_within_tolerance(B, S, E, H, causal):
    """bf16 LN rows, q, k, v, one bf16 rounding of p and of o keep the
    kernel within chip_smoke's rule (|err| <= 2e-2 + 1e-2 |ref|) and the
    card tests' (3e-2, 3e-2) of the JAX reference."""
    args = _bf16_inputs(B, S, E, seed=S + E + H)
    ours = _emulate_bf16_kernel(*args, H, causal).float().numpy()
    ref = np.asarray(jfat._reference(
        jnp.asarray(args[0].float().numpy(), jnp.bfloat16),
        *(jnp.asarray(a.float().numpy()) for a in args[1:]),
        num_heads=H, causal=causal), np.float32)
    np.testing.assert_allclose(ours, ref, atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(ours, ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("x_dtype,w_dtype,S,E,tc", [
    (torch.bfloat16, torch.bfloat16, 32, 128, True),    # the bench shape
    (torch.bfloat16, torch.bfloat16, 64, 64, True),
    (torch.bfloat16, torch.bfloat16, 65, 128, False),   # S past 64
    (torch.bfloat16, torch.bfloat16, 32, 256, False),   # E past 128
    (torch.bfloat16, torch.bfloat16, 32, 40, False),    # E % 16
    (torch.float32, torch.float32, 32, 128, False),
    (torch.bfloat16, torch.float32, 32, 128, False),
    (torch.float32, torch.bfloat16, 32, 128, False),
])
def test_tensor_core_route(x_dtype, w_dtype, S, E, tc):
    """Which of the two CUDA kernels a call takes (decided before any
    launch, so it is checked here)."""
    assert fat.tensor_core_route(x_dtype, w_dtype, S, E) is tc


def _chip_smoke():
    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_one_ulp_fault_fails_the_emulation_statistics():
    """chip_smoke.py holds the card kernel to ``_tc_emulation`` by
    ``tc_ulp_stats`` at its limits: the emulation itself reads (0, 0), a
    fault of one bf16 ulp in every output (1, +-1), beyond them; so does a
    one-ulp fault in one output of ten, by its share."""
    cs = _chip_smoke()

    def within(stats):
        return stats[0] <= cs.ATTN_EMU_MAX_SHARE and \
            abs(stats[1]) <= cs.ATTN_EMU_MAX_MEAN_ULP

    args = _bf16_inputs(8, 32, 128, seed=3)
    emu = fat._tc_emulation(*args, 8, False)
    assert emu.dtype == torch.bfloat16
    assert fat.tc_ulp_stats(emu, emu) == (0.0, 0.0)
    for direction, sign in ((float("inf"), 1.0), (-float("inf"), -1.0)):
        moved = torch.nextafter(emu, torch.full_like(emu, direction))
        assert fat.tc_ulp_stats(moved, emu) == (1.0, sign)
        assert not within(fat.tc_ulp_stats(moved, emu))
    some = emu.clone().flatten()
    some[::10] = torch.nextafter(some[::10],
                                 torch.full_like(some[::10], float("inf")))
    share, mean = fat.tc_ulp_stats(some.reshape(emu.shape), emu)
    assert abs(share - 0.1) < 1e-3 and not within((share, mean))
