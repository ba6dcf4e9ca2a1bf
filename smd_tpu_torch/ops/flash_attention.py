"""Blockwise (flash) softmax attention over (B, S, H, Dh), q pre-scaled.

Port of ``smd_tpu/ops/flash_attention.py`` (``flash_attention``, Pallas
kernel ``_attn_kernel``, and ``packed_short_seq_attention``): softmax
attention with an online softmax, float32 running max, sum and accumulator,
an optional causal mask and an optional block-diagonal group mask of size
``block_diag``, stored in ``q.dtype``. The caller scales q by 1/sqrt(Dh).
``supported`` and ``_pick_block`` are the JAX predicates that route the
attention layer to the kernel; the Pallas blocks they pick are a TPU
tiling device, and the CUDA kernel chooses its own tiles.

On a CUDA tensor the wrapper launches the kernel of
``csrc/flash_attention.cu`` or raises; on a CPU tensor it takes
``_reference_attention``, the plain PyTorch version. The backward pass
differentiates the plain version, as the JAX ``custom_vjp`` does.
"""
from __future__ import annotations

import torch

from smd_tpu_torch.ops import _build

__all__ = ["flash_attention", "supported", "pack_group",
           "packed_short_seq_attention"]

_NEG_INF = -1e30
# Head widths the kernel is instantiated for (its per-thread registers).
HEAD_DIMS = (8, 16, 32, 64)
_INT_MAX = 2 ** 31 - 1


def supported(seq_len: int, head_dim: int, dtype) -> bool:
    """Whether the attention layer routes this shape to the kernel: the JAX
    predicate (float32 or bf16, S >= 128, S a multiple of its block)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    return seq_len >= 128 and seq_len % _pick_block(seq_len) == 0


def _pick_block(seq_len: int) -> int:
    for cand in (512, 256, 128):
        if seq_len % cand == 0:
            return cand
    return seq_len


def _reference_attention(q, k, v, causal: bool, block_diag: int = 0):
    """Plain PyTorch transcription of the JAX ``_reference_attention``."""
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    keep = None
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if block_diag:
        idx = torch.arange(S, device=q.device) // block_diag
        same = idx[:, None] == idx[None, :]
        keep = same if keep is None else keep & same
    if keep is not None:
        scores = scores.masked_fill(~keep[None, None], _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)


def _launch(q, k, v, causal: bool, block_diag: int):
    """Check what the CUDA kernel takes, launch it and count the launch.

    The checks read each tensor's shape and strides once: a served step
    makes this call once a layer, and its host time adds to the step's."""
    if q.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {q.device}")
    shape = q.shape
    B, S, H, Dh = shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head widths {HEAD_DIMS}, "
                         f"got Dh={Dh}")
    size = q.element_size()
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, S, H, Dh)}")
        if t.dtype != q.dtype or t.dtype not in _build.FLOATS:
            raise ValueError(f"{name} has dtype {t.dtype}; q, k and v share "
                             f"one of {_build.FLOATS}")
        # The kernel reads rows of Dh by 16-byte vectors, at any row, batch
        # and head stride that keeps them 16-byte aligned.
        sb, ss, sh, sd = t.stride()
        if sd != 1:
            raise ValueError(f"{name} must be contiguous along Dh")
        if t.data_ptr() % 16 or (sb * size) % 16 or (ss * size) % 16 or \
                (sh * size) % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
        if max(sb, ss, sh) > _INT_MAX:
            raise ValueError(f"{name}: strides must fit in 32 bits")
        strides += (sb, ss, sh)
    if block_diag < 0:
        raise ValueError(f"block_diag must be >= 0, got {block_diag}")
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch("smd_flash_attention", q, k, v, out, B, S, H, Dh,
                      *strides, int(causal), int(block_diag),
                      _build.dtype_code(q))
    flash_attention.launches += 1
    return out


def _forward(q, k, v, causal: bool, block_diag: int):
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal, block_diag)
    return _launch(q, k, v, causal, block_diag)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_diag):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.block_diag = causal, block_diag
        return _forward(q, k, v, causal, block_diag)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _reference_attention(q, k, v, ctx.causal, ctx.block_diag)
        return (*torch.autograd.grad(out, (q, k, v), g), None, None)


def flash_attention(q, k, v, causal: bool = False, block_diag: int = 0):
    """Softmax attention over (B, S, H, Dh) tensors; q pre-scaled by caller.

    q, k and v may be strided views (the unbound qkv projection); the
    output is a new contiguous (B, S, H, Dh) tensor in q's dtype. Where no
    gradient is needed (serving), the call skips the autograd node.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, block_diag)
    return _forward(q, k, v, causal, block_diag)


flash_attention.launches = 0


def pack_group(batch: int, seq_len: int, max_packed: int = 256) -> int:
    """Largest G dividing ``batch`` whose packed length G*seq_len is a
    multiple of 128 and at most ``max_packed`` (1 if there is none)."""
    best = 1
    for g in range(2, max_packed // seq_len + 1):
        packed = g * seq_len
        if batch % g == 0 and packed % 128 == 0:
            best = g
    return best


def packed_short_seq_attention(q, k, v, causal: bool = False,
                               plain: bool = False):
    """Attention for short sequences via batch packing.

    G batch items become one G*S sequence with a block-diagonal mask of
    size S: the same function, since a block-diagonal softmax row never
    mixes groups and causal order within a block is the global order.
    Returns None when G=1 (the caller takes its einsum). ``plain=True``
    runs the plain version wherever the tensors lie: the yardstick.
    """
    B, S, H, Dh = q.shape
    g = pack_group(B, S)
    if g == 1:
        return None
    qp = q.reshape(B // g, g * S, H, Dh)
    kp = k.reshape(B // g, g * S, H, Dh)
    vp = v.reshape(B // g, g * S, H, Dh)
    op = _reference_attention if plain else flash_attention
    return op(qp, kp, vp, causal, S).reshape(B, S, H, Dh)
