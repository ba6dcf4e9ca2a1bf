"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports nothing of JAX, so it runs where the port runs:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""
import pytest
import torch

from smd_tpu_torch.ops import fused_attention as fat
from smd_tpu_torch.ops import fused_film_resblock as ffr

pytestmark = pytest.mark.gpu

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    # float32: sums in another order; bf16 out: one rounding of |y| <= 4.
    return 1e-4 if dtype == F32 else 3e-2


def _film(dev, B, S, K, N, x_dtype, w_dtype, b_dtype, residual, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, K, generator=g, device=dev) * 0.5 + 0.3
    scale = torch.randn(B, 1, K, generator=g, device=dev) * 0.2 + 1.0
    shift = torch.randn(B, 1, K, generator=g, device=dev) * 0.2
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    b = torch.randn(N, generator=g, device=dev) * 0.1
    res = torch.randn(B, S, N, generator=g, device=dev) if residual else None
    return (x.to(x_dtype), scale, shift, w.to(w_dtype), b.to(b_dtype),
            None if res is None else res.to(x_dtype))


@pytest.mark.parametrize("x_dtype,w_dtype,b_dtype", [
    (F32, F32, F32), (BF16, BF16, BF16), (BF16, BF16, F32), (F32, BF16, F32),
    (BF16, F32, BF16)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(4, 32, 256, 256), (3, 13, 72, 200)])
def test_film_kernel_matches_plain(cuda, x_dtype, w_dtype, b_dtype, residual,
                                   shape):
    args = _film(cuda, *shape, x_dtype, w_dtype, b_dtype, residual)
    before = ffr.fused_ln_film_swish_dense.launches
    out = ffr.fused_ln_film_swish_dense(*args)
    ref = ffr._reference(*args)
    torch.cuda.synchronize()
    assert ffr.fused_ln_film_swish_dense.launches == before + 1
    assert out.dtype == x_dtype and out.shape == ref.shape
    tol = _tol(BF16 if BF16 in (x_dtype, w_dtype) else F32)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_film_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, scale, shift, w, b, _ = _film(cuda, 2, 8, 64, 64, BF16, BF16, BF16,
                                     False)
    with pytest.raises(ValueError, match="contiguous"):
        ffr.fused_ln_film_swish_dense(x.transpose(0, 1).contiguous()
                                      .transpose(0, 1), scale, shift, w, b)
    with pytest.raises(ValueError, match="dtype"):
        ffr.fused_ln_film_swish_dense(x, scale.bfloat16(), shift, w, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        ffr.fused_ln_film_swish_dense(x[..., :60].contiguous(),
                                      scale[..., :60].contiguous(),
                                      shift[..., :60].contiguous(),
                                      w[:60].contiguous(), b)


def _attn(dev, B, S, E, x_dtype, w_dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, E, generator=g, device=dev) + 0.2
    ws = [torch.randn(E, 3 * E, generator=g, device=dev) / E ** 0.5,
          torch.randn(3 * E, generator=g, device=dev) * 0.1,
          torch.randn(E, E, generator=g, device=dev) / E ** 0.5,
          torch.randn(E, generator=g, device=dev) * 0.1,
          1 + 0.1 * torch.randn(E, generator=g, device=dev),
          0.1 * torch.randn(E, generator=g, device=dev)]
    return x.to(x_dtype), [w.to(w_dtype) for w in ws]


@pytest.mark.parametrize("x_dtype,w_dtype", [(F32, F32), (BF16, BF16),
                                             (BF16, F32), (F32, BF16)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,E,H", [(8, 32, 128, 8), (5, 20, 64, 8),
                                     (3, 33, 64, 2), (2, 16, 128, 2)])
def test_attention_kernel_matches_plain(cuda, x_dtype, w_dtype, causal, B, S,
                                        E, H):
    x, ws = _attn(cuda, B, S, E, x_dtype, w_dtype)
    before = fat.fused_ln_attention.launches
    out = fat.fused_ln_attention(x, *ws, H, causal)
    ref = fat._reference(x, *ws, H, causal)
    torch.cuda.synchronize()
    assert fat.fused_ln_attention.launches == before + 1
    assert out.dtype == x_dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(x_dtype),
                               rtol=_tol(x_dtype))


def test_attention_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, ws = _attn(cuda, 2, 8, 96, BF16, BF16)
    with pytest.raises(ValueError, match="head widths"):
        fat.fused_ln_attention(x, *ws, 8)          # Dh = 12
    with pytest.raises(ValueError, match="dtype"):
        fat.fused_ln_attention(x, ws[0], ws[1].float(), *ws[2:], 4)
    x, ws = _attn(cuda, 1, 240, 64, BF16, BF16)
    with pytest.raises(ValueError, match="shared memory"):
        fat.fused_ln_attention(x, *ws, 4)


def test_fused_model_kernels_match_plain(cuda):
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device=cuda, data_channels=42,
                      num_layers=2, num_heads=8, num_mlp_layers=2,
                      mlp_dims=256, embed_channels=128, fused_attention=True,
                      fused_head=True)
    load_flax_params(model, random_flax_params(model, seed=0))
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 32, 42, generator=g, device=cuda)
    t = torch.rand(4, 1, 1, generator=g, device=cuda)
    with torch.no_grad():
        out = model(x, t)
        ref = model.use_plain_ops(True)(x, t)
    model.use_plain_ops(False)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)  # float32
