"""The port's fused_ln_attention against the Pallas kernel.

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in Pallas interpret mode, as ``tests/test_fused_attention.py`` runs it. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
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
