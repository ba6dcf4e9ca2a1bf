"""The port's fused_ln_film_swish_dense against the Pallas kernel.

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in Pallas interpret mode, as ``tests/test_fused_film_resblock.py`` runs it.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smd_tpu.ops import fused_film_resblock as jffr
from smd_tpu_torch.ops import fused_film_resblock as ffr


def _inputs(B=3, S=8, K=32, N=32, residual=False, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, K)) * 0.5 + 0.3).astype(np.float32)
    scale = (rng.normal(size=(B, 1, K)) * 0.2 + 1.0).astype(np.float32)
    shift = (rng.normal(size=(B, 1, K)) * 0.2).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    b = (rng.normal(size=(N,)) * 0.1).astype(np.float32)
    res = rng.normal(size=(B, S, N)).astype(np.float32) if residual else None
    return x, scale, shift, w, b, res


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("residual", [False, True])
def test_plain_matches_pallas_interpret(residual):
    args = _inputs(residual=residual)
    ref = jffr.fused_ln_film_swish_dense(
        *[None if a is None else jnp.asarray(a) for a in args], interpret=True)
    ours = ffr.fused_ln_film_swish_dense(*_torch(args))
    assert ours.dtype == torch.float32 and ours.shape == (3, 8, 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)  # float32, as the Pallas tests


@pytest.mark.parametrize("residual", [False, True])
def test_plain_matches_jax_reference(residual):
    args = _inputs(B=2, S=16, K=64, N=48, residual=residual, seed=1)
    ref = jffr._reference(*[None if a is None else jnp.asarray(a)
                            for a in args])
    ours = ffr._reference(*_torch(args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)  # float32


def test_bf16_weights_round_h_before_the_product():
    """bf16 W: h is rounded to bf16, the sum stays float32, the result is
    stored in x.dtype; against the JAX reference on the same bf16 values."""
    x, scale, shift, w, b, _ = _inputs(K=64, N=64, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    bb = torch.from_numpy(b).bfloat16()
    ours = ffr.fused_ln_film_swish_dense(xb, torch.from_numpy(scale),
                                         torch.from_numpy(shift), wb, bb)
    assert ours.dtype == torch.bfloat16
    ref = jffr._reference(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                          jnp.asarray(scale), jnp.asarray(shift),
                          jnp.asarray(wb.float().numpy(), jnp.bfloat16),
                          jnp.asarray(bb.float().numpy(), jnp.bfloat16))
    # Same roundings; the float32 sums differ in order, which can move a
    # result across a bf16 rounding boundary: one bf16 ulp of |y| <= 4.
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=1.6e-2)


def test_cpu_wrapper_counts_no_launch():
    before = ffr.fused_ln_film_swish_dense.launches
    ffr.fused_ln_film_swish_dense(*_torch(_inputs()))
    assert ffr.fused_ln_film_swish_dense.launches == before
