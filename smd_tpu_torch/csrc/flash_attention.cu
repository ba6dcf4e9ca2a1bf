// Flash attention on Hopper: for each batch item and head,
//
//     o = softmax(q k^T [causal] [block_diag]) v           (S, Dh) per head
//
// over q, k, v of shape (B, S, H, Dh) with q already scaled by 1/sqrt(Dh).
// The causal mask keeps key j <= query i; the block_diag mask (size G > 0)
// keeps keys of the query's group, j / G == i / G. Float32 running max, sum
// and accumulator per query row (online softmax); o is stored in q's type
// into a contiguous (B, S, H, Dh) tensor. No S x S matrix touches memory.
//
// Replaces the TPU kernel smd_tpu/ops/flash_attention.py, flash_attention
// (Pallas kernel _attn_kernel), which also serves packed_short_seq_attention
// (block_diag = the short sequence's length).
//
// What bounds it on an H100 (served shapes B=64, S=512, H=8, Dh=16, bf16):
// one exponential per kept (query, key) pair, 134M of them, 0.034 ms at the
// special-function units' 3.9e12/s (132 SMs x 16 a clock); against that,
// 2*Dh operations for q.k and 2*Dh for p.v per pair on the bf16 tensor
// cores take 0.009 ms at 989 TFLOP/s, and moving q, k, v and o 0.010 ms.
// This design adds its own work: a second p.v product (p in two bf16
// terms, 0.004 ms) and ~3 float32 operations per pair to split p (0.006
// ms). The same products as float32 FMAs on the CUDA cores would take
// 0.130 ms (8.7 GFLOP at 67 TFLOP/s).
//
// What the bf16 design does about it, FlashAttention-2 style on
// mma.sync.m16n8k16 (bf16 in, float32 sums):
//  - A block of 4 warps owns 128 query rows of one batch*head, 32 rows a
//    warp as two m16 blocks that share every K and V fragment (two
//    independent chains of products and exponentials a warp; at Dh=64,
//    for registers, one m16 block and 64 rows a block); the q
//    fragments are loaded once into registers from the strided
//    (B, S, H, Dh) view (the unbound qkv projection needs no copy). Dh=8 is
//    padded to the mma's depth of 16 with zeros.
//  - K and V tiles of 64 keys are double-buffered in shared memory by
//    cp.async, in bf16 (rows padded by 16 bytes so that ldmatrix reads are
//    free of bank conflicts). S = q k^T comes from ldmatrix on K: bf16 x
//    bf16 products are exact in float32, so the scores are the function's
//    float32 q.k up to the order of the sum.
//  - The online softmax runs on the accumulator fragments: the row max by
//    quad shuffles, then in base 2 with one rounding of the running max
//    shared by every p and alpha: one FMA and one ex2 per score. Masked keys
//    get p = 0 exactly, and a block visits only the key tiles its rows can
//    see (through the diagonal of its last row under the causal mask, the
//    groups of its rows under block_diag); a warp skips a tile none of its
//    rows sees, and masks per score only in a tile its rows see in part.
//  - P.V on the tensor cores: two adjacent n8 accumulator tiles are the A
//    fragment of m16n8k16, so p needs no shuffle; V comes by ldmatrix.trans.
//    p is split into hi, its top 16 bits (a bf16 by truncation, taken on
//    the integer pipe), and lo = bf16(p - hi), rounded (relative error of
//    hi + lo <= 2^-16): two products, so that the bf16 output stays within
//    one bf16 ulp of the float32 function, at one conversion per two
//    scores beside the exponential. l sums the float32 p.
//  - mma.sync, not wgmma: at Dh=16 the exponentials set the pace, not the
//    tensor cores, and a warp's 32 rows keep the softmax in registers.
//    Still to do: wgmma for Dh >= 64, where the products weigh more.
// A float32 q, k, v takes the float32 kernel below (one thread per query
// row, float32 FMAs on the CUDA cores), used to check the kernel in float32.
#include <math_constants.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 128;  // float32 kernel: query rows per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // float32 kernel: keys per online-softmax update
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of one tensor's batch, sequence and head axes.
struct Strides {
  long long b, s, h;
};

using smd::cp_async16;
using smd::ex2;
using smd::ldmatrix_x2_trans;
using smd::ldmatrix_x4;
using smd::mma16816;
using smd::pack_bf16;
using smd::store8;

// ---- float32: one thread per query row on the CUDA cores -------------------
template <typename T, int DH>
__global__ void __launch_bounds__(kBlockQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             Strides qs, Strides kst, Strides vst, int causal,
             int block_diag) {
  __shared__ __align__(16) float k_tile[kBlockK * DH];
  __shared__ __align__(16) float v_tile[kBlockK * DH];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBlockQ;
  const int row = q0 + threadIdx.x;
  const int r = min(row, S - 1);  // rows past S compute row S-1, store none
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * kst.b + h * kst.h;
  const T* vb = v + b * vst.b + h * vst.h;

  // The keys this row sees, [lo, hi), and the keys any row of the block
  // sees, [klo, khi): through the last row's diagonal and group.
  int lo = 0, hi = S, klo = 0, khi = S;
  const int last = min(q0 + kBlockQ, S) - 1;
  if (block_diag > 0) {
    lo = r / block_diag * block_diag;
    hi = min(S, lo + block_diag);
    klo = q0 / block_diag * block_diag;
    khi = min(S, (last / block_diag + 1) * block_diag);
  }
  if (causal) {
    hi = min(hi, r + 1);
    khi = min(khi, last + 1);
  }

  float qv[DH];
#pragma unroll
  for (int d = 0; d < DH; d += 8) {
    float t[8];
    smd::load8(qb + r * qs.s + d, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[d + i] = t[i];
  }
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  // The running max in base 2, m2 = max * log2e, and the running sum.
  float m2 = -CUDART_INF_F, l = 0.f;

  for (int t0 = klo / kBlockK * kBlockK; t0 < khi; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockK * DH / 8; i += kBlockQ) {
      const int jj = i / (DH / 8), d = i % (DH / 8) * 8, j = t0 + jj;
      float kv[8], vv[8];
      if (j < S) {
        smd::load8(kb + j * kst.s + d, kv);
        smd::load8(vb + j * vst.s + d, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
      store8(k_tile + jj * DH + d, kv);
      store8(v_tile + jj * DH + d, vv);
    }
    __syncthreads();

    for (int c0 = 0; c0 < kBlockK; c0 += kChunk) {
      const int j0 = t0 + c0;
      if (j0 >= hi || j0 + kChunk <= lo) continue;  // no key of this row
      float s[kChunk];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4* kr =
            reinterpret_cast<const float4*>(k_tile + (c0 + c) * DH);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qv[4 * d4], kk.x, dot);
          dot = fmaf(qv[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qv[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qv[4 * d4 + 3], kk.w, dot);
        }
        const int j = j0 + c;
        s[c] = (j >= lo && j < hi) ? dot : -CUDART_INF_F;
        cmax = fmaxf(cmax, s[c]);
      }
      // The chunk holds a key of [lo, hi), so m2_new is finite; exp2(-inf)
      // is 0 for the masked keys and for the first chunk's alpha. Every p
      // and alpha uses the same rounded m2, so the roundings of m2 cancel in
      // acc / l.
      const float m2_new = fmaxf(m2, cmax * kLog2e);
      const float alpha = exp2f(m2 - m2_new);
      // sum += p_c, a += p_c v_c over the chunk's keys.
      auto take_chunk = [&](float(&a)[DH], float& sum) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float p = exp2f(fmaf(s[c], kLog2e, -m2_new));
          sum += p;
          const float4* vr =
              reinterpret_cast<const float4*>(v_tile + (c0 + c) * DH);
#pragma unroll
          for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 vv = vr[d4];
            a[4 * d4] = fmaf(p, vv.x, a[4 * d4]);
            a[4 * d4 + 1] = fmaf(p, vv.y, a[4 * d4 + 1]);
            a[4 * d4 + 2] = fmaf(p, vv.z, a[4 * d4 + 2]);
            a[4 * d4 + 3] = fmaf(p, vv.w, a[4 * d4 + 3]);
          }
        }
      };
      if constexpr (DH <= 32) {
        // The chunk's sums enter acc and l once: a two-level sum over the
        // row's keys, about half the rounding of one running sum.
        float cl = 0.f, cacc[DH];
#pragma unroll
        for (int d = 0; d < DH; ++d) cacc[d] = 0.f;
        take_chunk(cacc, cl);
        l = fmaf(l, alpha, cl);
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(acc[d], alpha, cacc[d]);
      } else {  // registers: the row's q and acc already hold 128 floats
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= alpha;
        take_chunk(acc, l);
      }
      m2 = m2_new;
    }
  }

  if (row < S) {
    T* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 8) {
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = acc[d + i] / l;
      store8(dst + d, o);
    }
  }
}

// ---- bf16: mma.sync on the tensor cores ------------------------------------
constexpr int kWarpsQ = 4;
constexpr int kTileK = 64;  // keys per shared-memory tile
// m16 row blocks per warp: two, but one at Dh=64, whose q fragments and
// accumulators would not fit two in 255 registers.
template <int DH>
constexpr int kMR = DH < 64 ? 2 : 1;
template <int DH>
constexpr int kRowsQ = 16 * kMR<DH> * kWarpsQ;  // query rows per block

template <int DH>
__global__ void __launch_bounds__(32 * kWarpsQ)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                  int H, Strides qs, Strides kst, Strides vst, int causal,
                  int block_diag) {
  constexpr int DP = DH < 16 ? 16 : DH;  // depth padded to the mma's 16
  constexpr int LD = DP + 8;             // shared row stride in elements
  constexpr int KC = DP / 16;            // 16-deep chunks of q.k
  constexpr int NT = DH / 8;             // 8-wide column tiles of o
  constexpr int NJ = kTileK / 8;         // 8-key column tiles of s
  constexpr int MR = kMR<DH>, kWarpRows = 16 * MR, kRows = kRowsQ<DH>;
  __shared__ __align__(16) bf16 k_tile[2][kTileK * LD];
  __shared__ __align__(16) bf16 v_tile[2][kTileK * LD];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + kWarpRows * warp;  // the warp's first row
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * kst.b + h * kst.h;
  const bf16* vb = v + b * vst.b + h * vst.h;

  // The keys any row of the block sees, [klo, khi), as the float32 kernel.
  const int last = min(q0 + kRows, S) - 1;
  int klo = 0, khi = S;
  if (block_diag > 0) {
    klo = q0 / block_diag * block_diag;
    khi = min(S, (last / block_diag + 1) * block_diag);
  }
  if (causal) khi = min(khi, last + 1);
  // This thread's rows: g + 8*i of the warp's m16 block mr (rows past S
  // compute row S-1 and store nothing), the keys each sees, [lo, hi), and
  // the keys any row of the warp sees, [wlo, whi).
  const int w0 = min(wq0, S - 1), wl = min(wq0 + kWarpRows - 1, S - 1);
  const bool warp_live = wq0 < S;
  int r[MR][2], lo[MR][2], hi[MR][2];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[mr][i] = min(wq0 + 16 * mr + g + 8 * i, S - 1);
      lo[mr][i] = 0;
      hi[mr][i] = S;
      if (block_diag > 0) {
        lo[mr][i] = r[mr][i] / block_diag * block_diag;
        hi[mr][i] = min(S, lo[mr][i] + block_diag);
      }
      if (causal) hi[mr][i] = min(hi[mr][i], r[mr][i] + 1);
    }
  }
  int wlo = 0, whi = S;
  if (block_diag > 0) {
    wlo = w0 / block_diag * block_diag;
    whi = min(S, (wl / block_diag + 1) * block_diag);
  }
  if (causal) whi = min(whi, wl + 1);

  // q as the A fragment of each 16-deep chunk: a[0], a[2] row g, a[1],
  // a[3] row g+8; columns 2t (a[0], a[1]) and 2t+8 (a[2], a[3]); 0 past Dh.
  uint32_t qa[MR][KC][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr)
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 16 * c + 2 * t + 8 * (i / 2);
        qa[mr][c][i] = d < DH ? *reinterpret_cast<const uint32_t*>(
                                    qb + r[mr][i % 2] * qs.s + d)
                              : 0u;
      }
  if (DH < DP) {  // the padded depth stays 0: it meets q's zeros
    for (int i = threadIdx.x; i < 2 * kTileK; i += 32 * kWarpsQ) {
      *reinterpret_cast<uint4*>(&k_tile[i / kTileK][(i % kTileK) * LD + DH]) =
          make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&v_tile[i / kTileK][(i % kTileK) * LD + DH]) =
          make_uint4(0, 0, 0, 0);
    }
  }

  // K and V rows of keys [t0, t0+64) into buffer buf; keys past S read 0.
  auto load_tile = [&](int t0, int buf) {
    for (int i = threadIdx.x; i < kTileK * DH / 8; i += 32 * kWarpsQ) {
      const int jj = i / (DH / 8), d = i % (DH / 8) * 8, j = t0 + jj;
      const bool in = j < S;
      cp_async16(&k_tile[buf][jj * LD + d], in ? kb + j * kst.s + d : kb,
                 in ? 16 : 0);
      cp_async16(&v_tile[buf][jj * LD + d], in ? vb + j * vst.s + d : vb,
                 in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float o[MR][NT][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mr][n][i] = 0.f;
  // Per row: the running max in base 2, m2 = max * log2e, and the sum.
  float m2[MR][2], l[MR][2];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m2[mr][i] = -CUDART_INF_F;
      l[mr][i] = 0.f;
    }

  const int tfirst = klo / kTileK * kTileK;
  if (tfirst < khi) load_tile(tfirst, 0);
  for (int t0 = tfirst, it = 0; t0 < khi; t0 += kTileK, ++it) {
    const int buf = it & 1;
    if (t0 + kTileK < khi) {
      load_tile(t0 + kTileK, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (warp_live && t0 < whi && t0 + kTileK > wlo) {
      // S = q k^T for the tile's 64 keys: s[mr][j] holds keys 8j + 2t, +1
      // of rows g (s[mr][j][0..1]) and g+8 (s[mr][j][2..3]). Each K
      // fragment serves both m16 blocks.
      float s[MR][NJ][4];
#pragma unroll
      for (int mr = 0; mr < MR; ++mr)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mr][j][i] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          uint32_t kf[4];
          const int key = 8 * j + (lane / 16) * 8 + lane % 8;
          ldmatrix_x4(kf, &k_tile[buf][key * LD + 16 * c + (lane / 8) % 2 * 8],
                      false);
#pragma unroll
          for (int mr = 0; mr < MR; ++mr) {
            mma16816(s[mr][j], qa[mr][c], kf[0], kf[1]);
            mma16816(s[mr][j + 1], qa[mr][c], kf[2], kf[3]);
          }
        }
      }
      // Mask per score only where a row of the warp sees part of the tile.
      const bool partial =
          t0 < wlo || t0 + kTileK > whi ||
          (block_diag > 0 && w0 / block_diag != wl / block_diag) ||
          (causal && t0 + kTileK - 1 > w0);
      if (partial) {
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int key = t0 + 8 * j + 2 * t + i % 2;
              if (key < lo[mr][i / 2] || key >= hi[mr][i / 2])
                s[mr][j][i] = -CUDART_INF_F;
            }
      }
      // The running max and the rescale of o, per row.
      float mneg[MR][2], alpha[MR][2], sum[MR][2];
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mx = fmaxf(mx, fmaxf(s[mr][j][2 * i], s[mr][j][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m2_new = fmaxf(m2[mr][i], mx * kLog2e);
          // -m2_new, or 0 while the row has seen no key, so that every p of
          // a masked key (and alpha of a row with no key before) is
          // exp2(-inf) = 0. Every p and alpha uses the same rounded m2, so
          // its rounding cancels in o / l.
          mneg[mr][i] = m2_new == -CUDART_INF_F ? 0.f : -m2_new;
          alpha[mr][i] = ex2(m2[mr][i] + mneg[mr][i]);
          m2[mr][i] = m2_new;
          sum[mr][i] = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[mr][n][2 * i] *= alpha[mr][i];
            o[mr][n][2 * i + 1] *= alpha[mr][i];
          }
        }
      }
      // Per 16 keys: p = exp2(s * log2e - m2), then o += p v with p as
      // hi + lo in bf16, so that the exponentials of one chunk overlap the
      // products of the last; each V fragment serves both m16 blocks.
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        uint32_t ph[MR][4], pl[MR][4];
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // i: (row g, keys 2t..), (row g+8, ..), (row g, keys 8+2t..),
            // ... hi: p's top 16 bits (a truncation, on the integer pipe);
            // lo: the exact rest p - hi, rounded to bf16.
            float* pp = &s[mr][2 * kk + i / 2][2 * (i % 2)];
            const int row = i % 2;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pp[e] = ex2(fmaf(pp[e], kLog2e, mneg[mr][row]));
              sum[mr][row] += pp[e];
            }
            const uint32_t a = __float_as_uint(pp[0]);
            const uint32_t c = __float_as_uint(pp[1]);
            ph[mr][i] = __byte_perm(a, c, 0x7632);
            pl[mr][i] = pack_bf16(pp[0] - __uint_as_float(a & 0xffff0000u),
                                  pp[1] - __uint_as_float(c & 0xffff0000u));
          }
        const int key = 16 * kk + lane % 8 + (lane / 8) % 2 * 8;
        if constexpr (NT == 1) {
          uint32_t vf[2];
          ldmatrix_x2_trans(vf, &v_tile[buf][key * LD]);
#pragma unroll
          for (int mr = 0; mr < MR; ++mr) {
            mma16816(o[mr][0], ph[mr], vf[0], vf[1]);
            mma16816(o[mr][0], pl[mr], vf[0], vf[1]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t vf[4];
            ldmatrix_x4(vf, &v_tile[buf][key * LD + 8 * n + (lane / 16) * 8],
                        true);
#pragma unroll
            for (int mr = 0; mr < MR; ++mr) {
              mma16816(o[mr][n], ph[mr], vf[0], vf[1]);
              mma16816(o[mr][n + 1], ph[mr], vf[2], vf[3]);
              mma16816(o[mr][n], pl[mr], vf[0], vf[1]);
              mma16816(o[mr][n + 1], pl[mr], vf[2], vf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int mr = 0; mr < MR; ++mr)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          l[mr][i] = fmaf(l[mr][i], alpha[mr][i], sum[mr][i]);
    }
    __syncthreads();  // the tile is consumed before it is loaded again
  }

#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mr][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = wq0 + 16 * mr + g + 8 * i;
      if (row >= S) continue;
      bf16* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * DH;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * t) =
            pack_bf16(o[mr][n][2 * i] / li, o[mr][n][2 * i + 1] / li);
    }
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, Strides qs,
                        Strides ks, Strides vs, int causal, int block_diag,
                        cudaStream_t stream) {
  const dim3 grid(B * H, (S + kRowsQ<DH> - 1) / kRowsQ<DH>);
  flash_bf16_kernel<DH><<<grid, 32 * kWarpsQ, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, qs, ks, vs,
      causal, block_diag);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, Strides qs, Strides ks, Strides vs,
                   int causal, int block_diag, int dtype,
                   cudaStream_t stream) {
  if (dtype == smd::kBF16)
    return launch_bf16<DH>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                           block_diag, stream);
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  flash_kernel<float, DH><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, qs, ks,
      vs, causal, block_diag);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, S, H, Dh) in one type, each at its own element strides of the
// batch, sequence and head axes (Dh contiguous; rows 16-byte aligned);
// out (B, S, H, Dh) contiguous in the same type. Dh is one of 8, 16, 32,
// 64; block_diag 0 means no group mask. Returns cudaGetLastError() after
// the launch.
extern "C" int smd_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int Dh, int q_sb, int q_ss,
                                   int q_sh, int k_sb, int k_ss, int k_sh,
                                   int v_sb, int v_ss, int v_sh, int causal,
                                   int block_diag, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (B < 0 || S < 0 || H < 0 || block_diag < 0 ||
      (S + kRowsQ<64> - 1) / kRowsQ<64> > 65535 ||  // the shortest q tile
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 8:
      return launch<8>(q, k, v, out, B, S, H, qs, ks, vs, causal, block_diag,
                       dtype, st);
    case 16:
      return launch<16>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                        block_diag, dtype, st);
    case 32:
      return launch<32>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                        block_diag, dtype, st);
    case 64:
      return launch<64>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                        block_diag, dtype, st);
    default:
      return cudaErrorInvalidValue;
  }
}
