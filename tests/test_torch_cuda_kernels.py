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
from smd_tpu_torch.ops import quant_matmul as qmm
from smd_tpu_torch.ops.quant import int8_matmul, quantize_weight

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
@pytest.mark.parametrize("shape", [
    (4, 32, 256, 256),
    (3, 13, 72, 200),      # K and N multiples of no tile
    (3, 100, 2048, 2048),  # 300 rows: a partial 128-row tile; S=100 rows
                           # per item, so a tile spans several items' FiLM
    (2, 40, 136, 2056),    # K=136: a ragged K step; N = 2048 + 8: one
                           # column chunk past 8 tiles
])
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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,E,H", [
    (1000, 32, 128, 8),   # the bench shape: more tiles than the grid has SMs
    (5, 32, 128, 8),      # NB=2 items a tile: B not a multiple of it
    (7, 20, 64, 8),       # Dh=8, ragged S, NB=4
    (3, 33, 64, 2),       # Dh=32, S past 32: 48 rows an item
    (9, 16, 128, 2),      # Dh=64, NB=5
    (4, 64, 128, 4),      # Dh=32, the longest S the kernel takes
    (3, 64, 128, 8),      # Dh=16 at S=64: one 16-row query block at a time
    (2, 50, 64, 8),       # Dh=8, ragged S rounded up to 64
])
def test_attention_tensor_core_kernel(cuda, causal, B, S, E, H):
    """bf16 x and weights at S <= 64, E <= 128 take the tensor-core
    kernel, several items a block."""
    x, ws = _attn(cuda, B, S, E, BF16, BF16)
    assert fat.tensor_core_route(x.dtype, ws[0].dtype, S, E)
    before = (fat.fused_ln_attention.launches,
              fat.fused_ln_attention.tc_launches)
    out = fat.fused_ln_attention(x, *ws, H, causal)
    ref = fat._reference(x, *ws, H, causal)
    torch.cuda.synchronize()
    assert (fat.fused_ln_attention.launches,
            fat.fused_ln_attention.tc_launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert out.dtype == BF16 and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(BF16),
                               rtol=_tol(BF16))


@pytest.mark.parametrize("x_dtype,w_dtype,S,E,H", [
    (F32, F32, 32, 128, 8), (BF16, F32, 32, 128, 8), (F32, BF16, 32, 128, 8),
    (BF16, BF16, 65, 64, 8),    # S past 64
    (BF16, BF16, 32, 256, 4),   # E past 128
])
def test_attention_routes_the_rest_to_the_first_version(cuda, x_dtype,
                                                        w_dtype, S, E, H):
    x, ws = _attn(cuda, 3, S, E, x_dtype, w_dtype)
    assert not fat.tensor_core_route(x.dtype, ws[0].dtype, S, E)
    before = (fat.fused_ln_attention.launches,
              fat.fused_ln_attention.tc_launches)
    out = fat.fused_ln_attention(x, *ws, H)
    ref = fat._reference(x, *ws, H)
    torch.cuda.synchronize()
    assert (fat.fused_ln_attention.launches,
            fat.fused_ln_attention.tc_launches) == (before[0] + 1, before[1])
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


def _grads_close(grads, ref_grads, dtype):
    """Each gradient within a share of its plain counterpart's norm: the
    backward differentiates the plain version at the same inputs, so the
    two differ only through the loss's dependence on the forward output
    (float32 sums in another order; bf16: one rounding of the output)."""
    tol = 1e-4 if dtype == F32 else 2e-2
    for a, b in zip(grads, ref_grads):
        assert a is not None and a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        err = (a.float() - b.float()).norm() / b.float().norm()
        assert err <= tol, f"relative gradient error {float(err):.3e}"


def _half_square(out):
    return 0.5 * out.float().square().sum()


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("S", [32, 64])
def test_film_gradients_through_the_kernel(cuda, dtype, residual, S):
    """A loss through the kernel gives every input its gradient (the
    backward differentiates the plain version), and the forward is one
    launch."""
    args = [None if a is None else a.requires_grad_()
            for a in _film(cuda, 4, S, 256, 256, dtype, dtype, dtype,
                           residual)]
    leaves = [a for a in args if a is not None]
    before = ffr.fused_ln_film_swish_dense.launches
    out = ffr.fused_ln_film_swish_dense(*args)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(_half_square(out), leaves)
    torch.cuda.synchronize()
    assert ffr.fused_ln_film_swish_dense.launches == before + 1
    ref = torch.autograd.grad(_half_square(ffr._reference(*args)), leaves)
    _grads_close(grads, ref, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [32, 64])
def test_attention_gradients_through_the_kernel(cuda, dtype, causal, S):
    x, ws = _attn(cuda, 6, S, 128, dtype, dtype)
    leaves = [t.requires_grad_() for t in (x, *ws)]
    before = (fat.fused_ln_attention.launches,
              fat.fused_ln_attention.tc_launches)
    out = fat.fused_ln_attention(*leaves, 8, causal)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(_half_square(out), leaves)
    torch.cuda.synchronize()
    # bf16 at S <= 64, E = 128 takes the tensor-core kernel.
    assert (fat.fused_ln_attention.launches,
            fat.fused_ln_attention.tc_launches) == (
                before[0] + 1, before[1] + int(dtype == BF16))
    ref = torch.autograd.grad(
        _half_square(fat._reference(*leaves, 8, causal)), leaves)
    _grads_close(grads, ref, dtype)


def test_serving_call_takes_no_autograd_node(cuda):
    """Without a gradient to record, the wrappers return a plain tensor, as
    they did before the autograd nodes."""
    x, ws = _attn(cuda, 2, 32, 128, BF16, BF16)
    ws = [w.requires_grad_() for w in ws]
    with torch.no_grad():
        assert fat.fused_ln_attention(x, *ws, 8).grad_fn is None
    args = _film(cuda, 2, 32, 256, 256, BF16, BF16, BF16, True)
    assert ffr.fused_ln_film_swish_dense(*args).grad_fn is None


def test_fused_model_gradients_through_the_kernels(cuda):
    """Every parameter of the fused model gets a gradient through the
    kernels, within the bf16 tolerance of the plain versions'."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device=cuda, data_channels=42,
                      num_layers=2, num_heads=8, num_mlp_layers=2,
                      mlp_dims=256, embed_channels=128, fused_attention=True,
                      fused_head=True, dtype=BF16)
    load_flax_params(model, random_flax_params(model, seed=0))
    model = model.to(BF16)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(8, 32, 42, generator=g, device=cuda)
    t = torch.rand(8, 1, 1, generator=g, device=cuda)
    params = list(model.parameters())
    before = (fat.fused_ln_attention.launches,
              ffr.fused_ln_film_swish_dense.launches)
    grads = torch.autograd.grad(_half_square(model(x, t)), params)
    assert (fat.fused_ln_attention.launches,
            ffr.fused_ln_film_swish_dense.launches) == (before[0] + 2,
                                                        before[1] + 4)
    ref = torch.autograd.grad(
        _half_square(model.use_plain_ops(True)(x, t)), params)
    model.use_plain_ops(False)
    # bf16 through 2 layers and the head: a looser share of the norm.
    for a, b in zip(grads, ref):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).norm() <= 5e-2 * b.float().norm()


def _w8a8(dev, M, K, N, x_dtype, leaf_dtype, bias=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    xf = torch.randn(M, K, generator=g, device=dev) * 0.8 + 0.3
    x = (xf * torch.sigmoid(xf)).to(x_dtype)
    w_q, w_s = quantize_weight(torch.randn(K, N, generator=g, device=dev) /
                               K ** 0.5)
    b = torch.randn(N, generator=g, device=dev) * 0.1 if bias else None
    a_s = x.float().abs().amax() / 127
    return (x, w_q, w_s.to(leaf_dtype),
            None if b is None else b.to(leaf_dtype), a_s.to(leaf_dtype))


def _w8a8_tol(dtype):
    # Exact int32 sums and the same float32 epilogue: float32 agrees to an
    # ulp; a bf16 y to one bf16 rounding.
    return (1e-6, 1e-6) if dtype == F32 else (1e-6, 2 ** -7)


@pytest.mark.parametrize("x_dtype,leaf_dtype", [(F32, F32), (BF16, BF16),
                                                (BF16, F32), (F32, BF16)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M,K,N", [(256, 256, 128), (1000, 2048, 2048),
                                   (37, 48, 72), (130, 512, 264)])
def test_w8a8_kernel_matches_plain(cuda, x_dtype, leaf_dtype, bias, M, K,
                                   N):
    args = _w8a8(cuda, M, K, N, x_dtype, leaf_dtype, bias)
    before = qmm.w8a8_dense.launches
    out = qmm.w8a8_dense(*args)
    ref = qmm._reference(*args)
    torch.cuda.synchronize()
    assert qmm.w8a8_dense.launches == before + 1
    assert out.dtype == x_dtype and out.shape == (M, N)
    atol, rtol = _w8a8_tol(x_dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def test_w8a8_kernel_at_the_bench_shape(cuda):
    args = _w8a8(cuda, 1000 * 32, 2048, 2048, BF16, BF16)
    out = qmm.w8a8_dense(*args)
    ref = qmm._reference(*args)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=_w8a8_tol(BF16)[0],
                               rtol=_w8a8_tol(BF16)[1])


@pytest.mark.parametrize("K", [256, 2048])
def test_w8a8_kernel_int32_sums_are_exact(cuda, K):
    """Integer x at a scale of 1 is its own codes; with |x| <= 64 every
    sum stays below 2**24, so y is the int32 sum itself."""
    g = torch.Generator(device=cuda).manual_seed(3)
    xi = torch.randint(-64, 65, (200, K), generator=g, device=cuda)
    w_q = torch.randint(-127, 128, (K, 136), generator=g, device=cuda,
                        dtype=torch.int8)
    y = qmm.w8a8_dense(xi.float(), w_q, torch.ones(136, device=cuda), None,
                       1.0)
    assert torch.equal(y, int8_matmul(xi.to(torch.int8), w_q))


def test_w8a8_kernel_leading_dims(cuda):
    x, w_q, w_s, b, a_s = _w8a8(cuda, 4 * 40, 256, 128, BF16, BF16)
    flat = qmm.w8a8_dense(x, w_q, w_s, b, a_s)
    out = qmm.w8a8_dense(x.reshape(4, 40, 256), w_q, w_s, b, a_s)
    assert out.shape == (4, 40, 128)
    assert torch.equal(out.reshape(160, 128), flat)


def test_w8a8_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, w_q, w_s, b, a_s = _w8a8(cuda, 64, 256, 128, BF16, BF16)
    with pytest.raises(ValueError, match="static activation scale"):
        qmm.w8a8_dense(x, w_q, w_s, b)
    with pytest.raises(ValueError, match="multiple of 16"):
        qmm.w8a8_dense(x[:, :40].contiguous(), w_q[:40].contiguous(), w_s,
                       b, a_s)
    with pytest.raises(ValueError, match="multiple of 8"):
        qmm.w8a8_dense(x, w_q[:, :60].contiguous(), w_s[:60].contiguous(),
                       b[:60].contiguous(), a_s)
    with pytest.raises(ValueError, match="contiguous"):
        qmm.w8a8_dense(x.t().contiguous().t(), w_q, w_s, b, a_s)
    with pytest.raises(ValueError, match="dtype"):
        qmm.w8a8_dense(x.half(), w_q, w_s, b, a_s)
    with pytest.raises(ValueError, match="dtype"):
        qmm.w8a8_dense(x, w_q.float(), w_s, b, a_s)
    with pytest.raises(ValueError, match="cpu"):
        qmm.w8a8_dense(x, w_q.cpu(), w_s, b, a_s)


@pytest.mark.parametrize("M,K,N", [(1000, 2048, 2048), (300, 144, 264),
                                   (37, 48, 72)])
def test_w8a8_kernel_with_and_without_the_kmajor_copy(cuda, M, K, N):
    """A caller's K-major copy spares the transpose launch; without it the
    wrapper makes one; both give the same y."""
    args = _w8a8(cuda, M, K, N, BF16, BF16)
    w_t = qmm.transpose_weight(args[1])
    assert torch.equal(w_t, args[1].t())
    t0, l0 = qmm.transpose_weight.launches, qmm.w8a8_dense.launches
    with_copy = qmm.w8a8_dense(*args, w_t=w_t)
    torch.cuda.synchronize()
    assert (qmm.transpose_weight.launches, qmm.w8a8_dense.launches) == \
        (t0, l0 + 1)
    without = qmm.w8a8_dense(*args)
    torch.cuda.synchronize()
    assert (qmm.transpose_weight.launches, qmm.w8a8_dense.launches) == \
        (t0 + 1, l0 + 2)
    assert torch.equal(with_copy, without)
    atol, rtol = _w8a8_tol(BF16)
    torch.testing.assert_close(with_copy.float(), qmm._reference(*args)
                               .float(), atol=atol, rtol=rtol)
    with pytest.raises(ValueError, match="w_t has shape"):
        qmm.w8a8_dense(*args, w_t=w_t[:8])


def test_quant_block_refreshes_its_kmajor_copy(cuda):
    """The block's K-major copy follows w1_q through an in-place load and a
    replacement, and is made once otherwise."""
    from smd_tpu_torch.models.blocks import QuantDenseResBlock
    block = QuantDenseResBlock(256, use_kernel=True).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(4)

    def codes():
        return torch.randint(-127, 128, (256, 256), generator=g, device=cuda,
                             dtype=torch.int8)
    with torch.no_grad():
        block.w1_q.copy_(codes())
    first = block.kmajor_weight(1)
    assert torch.equal(first, block.w1_q.t())
    t0 = qmm.transpose_weight.launches
    assert block.kmajor_weight(1) is first
    assert qmm.transpose_weight.launches == t0
    with torch.no_grad():
        block.w1_q.copy_(codes())          # as load_flax_params loads
    assert torch.equal(block.kmajor_weight(1), block.w1_q.t())
    block.w1_q = codes()                   # replaced
    assert torch.equal(block.kmajor_weight(1), block.w1_q.t())
    assert qmm.transpose_weight.launches == t0 + 2


def test_int8_model_kernels_match_plain(cuda):
    """The quantized TransformerDDPM through the w8a8 kernel against the
    same model through its plain version: the same codes and sums, so the
    same float32 outputs up to an ulp."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.fuse import (calibrate_head_act_scales,
                                           quantize_head_params)
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    kw = dict(data_channels=42, num_layers=2, num_heads=8, num_mlp_layers=2,
              mlp_dims=256, embed_channels=128)
    std = get_model("TransformerDDPM", device="cpu", **kw)
    tree = quantize_head_params(random_flax_params(std, seed=0))
    model = get_model("TransformerDDPM", device=cuda, quantized_head=True,
                      quantized_head_kernel=True, **kw)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 32, 42, generator=g, device=cuda)
    t = torch.rand(4, 1, 1, generator=g, device=cuda)
    tree = calibrate_head_act_scales(model, tree, [(x, t)])
    load_flax_params(model, tree)
    before = qmm.w8a8_dense.launches
    with torch.no_grad():
        out = model(x, t)
        torch.cuda.synchronize()
        assert qmm.w8a8_dense.launches == before + 4
        ref = model.use_plain_ops(True)(x, t)
    model.use_plain_ops(False)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_served_int8_model_makes_no_transpose_launch(cuda):
    """After the first call has made each head weight's K-major copy, a
    call of the quantized model launches w8a8 four times and no
    transpose."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.fuse import quantize_head_params
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    kw = dict(data_channels=42, num_layers=1, num_heads=8, num_mlp_layers=2,
              mlp_dims=256, embed_channels=128)
    std = get_model("TransformerDDPM", device="cpu", **kw)
    tree = quantize_head_params(random_flax_params(std, seed=0))
    model = get_model("TransformerDDPM", device=cuda, quantized_head=True,
                      quantized_head_kernel=True, **kw)
    load_flax_params(model, tree)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 32, 42, generator=g, device=cuda)
    t = torch.rand(4, 1, 1, generator=g, device=cuda)
    with torch.no_grad():
        t0 = qmm.transpose_weight.launches
        first = model(x, t)
        assert qmm.transpose_weight.launches == t0 + 4
        before = (qmm.transpose_weight.launches, qmm.w8a8_dense.launches)
        again = model(x, t)
        torch.cuda.synchronize()
    assert (qmm.transpose_weight.launches, qmm.w8a8_dense.launches) == \
        (before[0], before[1] + 4)
    assert torch.equal(first, again)


# -- flash_attention ----------------------------------------------------------

def _qkv(dev, B, S, H, Dh, dtype, seed=0, strided=False):
    """Unit-normal q, k, v; ``strided``: views of one (B, S, 3, H, Dh)
    projection, as ``unbind`` gives them to the attention layer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        qkv = torch.randn(B, S, 3, H, Dh, generator=g, device=dev)
        return qkv.to(dtype).unbind(dim=2)
    return tuple(torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
                 for _ in range(3))


# float32: the JAX tests' tolerance for unit-normal q, k, v. At Dh=64 the
# scores reach |s|~40, and two orders of a 64-term float32 dot product set
# them a few 1e-6 apart.
FLASH_F32_ATOL = 2e-5


def _assert_flash_close(out, ref):
    """float32 within FLASH_F32_ATOL; bf16 is the float32 result rounded
    once, so within one bf16 ulp of |ref| plus FLASH_F32_ATOL, the most the
    float32 results may differ before the rounding."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs()
    if out.dtype == F32:
        assert float(err.max()) <= FLASH_F32_ATOL, float(err.max())
        return
    _, e = torch.frexp(ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(err), e - 8)
    excess = err - ulp
    i = int(excess.argmax())
    assert float(excess.max()) <= FLASH_F32_ATOL, (
        f"max |err| {float(err.max()):.3e}; worst beyond one ulp: |err| "
        f"{float(err.flatten()[i]):.3e} at |ref| "
        f"{float(ref.float().abs().flatten()[i]):.3e}")


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,S,H,Dh,causal,block_diag", [
    (2, 512, 8, 16, False, 0),      # the served shape, fewer items
    (2, 512, 8, 16, True, 0),       # the MDN's causal shape, fewer items
    (2, 384, 2, 16, True, 0),       # a 128-row q tile over two k tiles
    (1, 200, 2, 32, True, 0),       # ragged: S a multiple of no tile
    (2, 384, 2, 16, False, 96),     # groups that leave whole k tiles out
    (1, 384, 2, 64, True, 96),      # causal and groups together
    (3, 256, 4, 8, False, 32),      # many groups per q tile
    (1, 1024, 2, 64, False, 0),
    (4, 64, 2, 16, True, 0),        # one partial q tile
    (2, 600, 2, 16, False, 0),      # ragged last q and k tiles
    (3, 130, 2, 16, True, 0),       # ragged, causal: 2 keys in the last tile
    (2, 130, 3, 8, False, 0),       # Dh=8: the depth padded to 16
    (1, 600, 2, 64, True, 96),      # ragged, causal and groups at Dh=64
])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, Dh, causal,
                                    block_diag):
    from smd_tpu_torch.ops import flash_attention as fa
    q, k, v = _qkv(cuda, B, S, H, Dh, dtype)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal, block_diag)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _assert_flash_close(out, fa._reference_attention(q, k, v, causal,
                                                     block_diag))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Dh", [16, 64])
def test_flash_kernel_reads_strided_views(cuda, dtype, causal, Dh):
    from smd_tpu_torch.ops import flash_attention as fa
    q, k, v = _qkv(cuda, 3, 512, 8, Dh, dtype, strided=True)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, causal)
    ref = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal)
    assert torch.equal(out, ref)
    _assert_flash_close(out, fa._reference_attention(q, k, v, causal))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_packed_shape(cuda, dtype, causal):
    """B=1000, S=32 packs G=8 items: a (125, 256, 8, 16) call with
    block_diag=32, the same function as attention over each item."""
    from smd_tpu_torch.ops import flash_attention as fa
    q, k, v = _qkv(cuda, 1000, 32, 8, 16, dtype, strided=True)
    before = fa.flash_attention.launches
    out = fa.packed_short_seq_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _assert_flash_close(out, fa._reference_attention(q, k, v, causal))
    assert fa.packed_short_seq_attention(q[:7], k[:7], v[:7]) is None


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from smd_tpu_torch.ops import flash_attention as fa
    q, k, v = _qkv(cuda, 1, 128, 2, 12, BF16)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="head widths"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 128, 2, 16, BF16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, k[:, :64], v)
    with pytest.raises(ValueError, match="contiguous along Dh"):
        fa.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v)
    wide = torch.zeros(1, 128, 2, 20, dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, wide[..., :16], v)
    with pytest.raises(ValueError, match="cpu"):
        fa.flash_attention(q, k.cpu(), v)
    assert fa.flash_attention.launches == before


def test_standard_model_flash_route_matches_plain(cuda):
    """The standard-layout TransformerDDPM at S=512 through the kernel
    against the same model through its plain version (float32), one launch
    per layer; at S=32 the layers take the einsum and launch nothing."""
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.ops import flash_attention as fa
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device=cuda, data_channels=42,
                      num_layers=2, num_heads=8, num_mlp_layers=1,
                      mlp_dims=256, embed_channels=128)
    load_flax_params(model, random_flax_params(model, seed=0))
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 512, 42, generator=g, device=cuda)
    t = torch.rand(2, 1, 1, generator=g, device=cuda)
    with torch.no_grad():
        before = fa.flash_attention.launches
        out = model(x, t)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 2
        ref = model.use_plain_ops(True)(x, t)
        model.use_plain_ops(False)
        assert fa.flash_attention.launches == before + 2
        model(x[:, :32], t)
        assert fa.flash_attention.launches == before + 2
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)  # float32


# -- few-step chains and distillation through the kernels ---------------------

_CHAIN_KW = dict(data_channels=42, num_layers=2, num_heads=8,
                 num_mlp_layers=2, mlp_dims=256, embed_channels=128)
# (seq_len, batch, wrapper, launches per model call, tolerance). The fused
# layout at bf16 is held in norm, |kernel - plain| <= 0.1 |plain|: x0 =
# (x - sigma·eps)/alpha carries the model's bf16 rounding times 1/alpha
# into single elements (chip_smoke.py's CHAIN_RTOL); the int8 head and the
# standard layout at S=512 in float32 elementwise to 1e-3 (the w8a8
# kernel's sums are exact; flash within 1e-5 a call, times 1/alpha <= 12).
_LAYOUTS = {
    "fused": (32, 4, lambda: (fat.fused_ln_attention,
                              ffr.fused_ln_film_swish_dense), (2, 4), 0.1),
    "int8": (32, 4, lambda: (qmm.w8a8_dense,), (4,), 1e-3),
    "standard": (512, 2, lambda: (_flash_wrapper(),), (2,), 1e-3),
}


def _flash_wrapper():
    from smd_tpu_torch.ops import flash_attention as fa
    return fa.flash_attention


def _layout_model(dev, layout):
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.models.fuse import (calibrate_head_act_scales,
                                           quantize_head_params)
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    if layout == "fused":
        model = get_model("TransformerDDPM", device=dev, fused_attention=True,
                          fused_head=True, dtype=BF16, **_CHAIN_KW)
        load_flax_params(model, random_flax_params(model, seed=0))
        return model.to(BF16)
    if layout == "int8":
        std = get_model("TransformerDDPM", device="cpu", **_CHAIN_KW)
        tree = quantize_head_params(random_flax_params(std, seed=0))
        model = get_model("TransformerDDPM", device=dev, quantized_head=True,
                          quantized_head_kernel=True, **_CHAIN_KW)
        g = torch.Generator(device=dev).manual_seed(3)
        cal = [(torch.randn(4, 32, 42, generator=g, device=dev),
                torch.rand(4, 1, 1, generator=g, device=dev))]
        return load_flax_params(model, calibrate_head_act_scales(
            model, tree, cal))
    model = get_model("TransformerDDPM", device=dev, **_CHAIN_KW)
    return load_flax_params(model, random_flax_params(model, seed=0))


@pytest.mark.parametrize("layout", ["fused", "int8", "standard"])
@pytest.mark.parametrize("sampling,steps", [("ddim", 5), ("dpmpp", 4),
                                            ("distilled", 2)])
def test_fewstep_chain_through_the_kernels_matches_plain(cuda, layout,
                                                         sampling, steps):
    """A short few-step chain of ``generate.sample`` through each layout's
    kernels against the same chain, same generator, through the plain
    versions; each model call launches its layout's kernels."""
    from smd_tpu_torch.diffusion import schedules
    from smd_tpu_torch.sampling import generate
    from smd_tpu_torch.training import distill
    seq_len, batch, wrappers, per_call, tol = _LAYOUTS[layout]
    model = _layout_model(cuda, layout).eval()
    dtype = next(model.parameters()).dtype
    betas = schedules.noise_schedule(1e-6, 0.01, 100, "linear")

    def model_fn(x, c):
        return model(x.to(dtype), c.to(dtype)).float()

    def run():
        g = torch.Generator(device=cuda).manual_seed(4)
        out, _, _ = generate.sample(
            model_fn, betas, g, (seq_len, 42), num_samples=batch,
            sampling=sampling, ddim_steps=steps, collect_steps=0,
            collect_metrics=False,
            distill_grid=distill.distill_grid(betas, steps), device=cuda)
        return out

    with torch.no_grad():
        model_fn(torch.zeros(batch, seq_len, 42, device=cuda),
                 torch.full((batch, 1, 1), 0.5, device=cuda))
        before = [w.launches for w in wrappers()]
        out = run()
        torch.cuda.synchronize()
        assert [w.launches - b for w, b in zip(wrappers(), before)] == \
            [steps * n for n in per_call]
        model.use_plain_ops(True)
        ref = run()
        model.use_plain_ops(False)
    assert torch.isfinite(out).all()
    if layout == "fused":
        assert (out - ref).norm() <= tol * ref.norm()
    else:
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


def test_distillation_gradient_through_the_kernels(cuda):
    """A progressive-distillation loss gradient through the fused kernels
    (the teacher twice without a gradient, the student once) against the
    plain versions', in float32 and without the x0 clip: every parameter
    within 1e-3 of its norm (the kernels within 1e-4 a call). The clip
    makes the gradient jump where an x0 element crosses +-1, so a
    last-bit difference could move it by far more (chip_smoke.py, phase
    16)."""
    from smd_tpu_torch.diffusion import schedules
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.training import distill
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerDDPM", device=cuda, fused_attention=True,
                      fused_head=True, **_CHAIN_KW)
    load_flax_params(model, random_flax_params(model, seed=0))
    teacher = distill.frozen_copy(model, dict(model.named_parameters()))
    grid, mids = distill.halve_grid(distill.distill_grid(
        schedules.noise_schedule(1e-6, 0.01, 1000, "linear"), 8))
    g = torch.Generator(device=cuda).manual_seed(5)
    batch = torch.rand(16, 32, 42, generator=g, device=cuda) * 2 - 1
    draws = (torch.randint(0, 4, (16,), generator=g, device=cuda),
             torch.randn(batch.shape, generator=g, device=cuda))
    params = list(model.parameters())

    def grads():
        loss = distill.progressive_distillation_loss(
            batch, model, teacher, grid, mids, clip_x0=False, draws=draws)
        return torch.autograd.grad(loss, params)

    before = (fat.fused_ln_attention.launches,
              ffr.fused_ln_film_swish_dense.launches)
    ours = grads()
    assert (fat.fused_ln_attention.launches,
            ffr.fused_ln_film_swish_dense.launches) == (before[0] + 3 * 2,
                                                        before[1] + 3 * 4)
    for m in (model, teacher):
        m.use_plain_ops(True)
    ref = grads()
    for m in (model, teacher):
        m.use_plain_ops(False)
    for a, b in zip(ours, ref):
        assert torch.isfinite(a).all()
        assert (a - b).norm() <= 1e-3 * b.norm()


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_mdn_flash_route_matches_plain(cuda, dtype):
    """The TransformerMDN at S=512 through the causal kernel against the
    same model through its plain version: the forward (one launch a layer)
    and every parameter's NLL gradient; the cached decode launches nothing.
    float32 within 1e-4 (sums in another order); bf16 compute on bf16
    trunk params (the head stays float32) within 5e-2 of the largest
    output and each gradient within 5e-2 of its norm, chip_smoke's fused
    limits: one bf16 ulp of the attention output carried through the
    layers."""
    from smd_tpu_torch.diffusion.losses import mdn_nll
    from smd_tpu_torch.models import get_model
    from smd_tpu_torch.ops import flash_attention as fa
    from smd_tpu_torch.utils.flax_params import (load_flax_params,
                                                 random_flax_params)
    model = get_model("TransformerMDN", device=cuda, data_channels=42,
                      num_layers=2, num_heads=8, num_mlp_layers=1,
                      mlp_dims=256, mdn_mixtures=4, dtype=dtype)
    load_flax_params(model, random_flax_params(model, seed=0))
    model.TransformerEncoder_0.to(dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 512, 42, generator=g, device=cuda)

    def run():
        out = model(x)
        grads = torch.autograd.grad(mdn_nll(*out, x),
                                    list(model.parameters()))
        return [o.detach() for o in out], grads

    before = fa.flash_attention.launches
    out, grads = run()
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    model.use_plain_ops(True)
    ref, ref_grads = run()
    model.use_plain_ops(False)
    assert fa.flash_attention.launches == before + 2
    for o, r in zip(out, ref):
        assert o.dtype == F32
        if dtype == F32:
            torch.testing.assert_close(o, r, atol=1e-4, rtol=1e-4)
        else:
            assert float((o - r).abs().max()) <= 5e-2 * float(r.abs().max())
    for a, b in zip(grads, ref_grads):
        rel = float((a.float() - b.float()).norm() /
                    b.float().norm().clamp_min(1e-30))
        assert rel <= (1e-4 if dtype == F32 else 5e-2), rel
    with torch.no_grad():
        cache = model.init_cache(2)
        model.decode(x[:, :1], cache)
    assert fa.flash_attention.launches == before + 2
