// Fused short-sequence attention block on Hopper:
//
//     ln  = LN(x) * ln_scale + ln_bias                    (eps 1e-6)
//     qkv = ln @ wqkv + bqkv                              (S,E)@(E,3E)
//     o_h = softmax(q_h k_h^T / sqrt(Dh) [causal]) v_h    per head
//     y   = o @ wout + bout                               (S,E)@(E,E)
//
// Replaces the TPU kernel smd_tpu/ops/fused_attention.py, fused_ln_attention
// (Pallas kernel _kernel). y is stored in x's type.
//
// What bounds it on an H100: at the sampler's shapes (B=1000, S=32, E=128,
// H=8, Dh=16, bf16) one call is ~4.7 GFLOP of products, 0.0048 ms on the
// bf16 tensor cores at 989 TFLOP/s, against 0.0050 ms to move x and y
// (16.4 MB) at 3.35 TB/s, and 8.2M exponentials, 0.0021 ms at 3.9e12/s.
// The same products as float32 FMAs on the CUDA cores take ~0.07 ms.
//
// Two kernels, one function; the wrapper (ops/fused_attention.py) routes:
//
// ln_attention_tc_kernel, bf16 x and bf16 weights, E a multiple of 16 up to
// 128, S up to 64 (the sampler's shapes), instantiated per head width and
// per S rounded up to 16 (S16): a persistent grid of one block of 16 warps
// per SM. Each block stages Wqkv and Wout once in shared memory as bf16
// (rows padded by 16 bytes, so that ldmatrix is free of bank conflicts;
// 132 KB at E=128; each block starts at its own row, so that 132 blocks
// reading the same weights spread over the L2) and the LN affine and
// biases in float32, then loops over tiles of NB items (NB * S16 rows, as
// many as shared memory holds: NB=2 at S=32, E=128). The Pallas kernel
// packs NB items into one block-diagonal tile for the TPU's matrix unit and
// wastes (NB-1)/NB of its score products; here items stay apart, each at a
// 16-row boundary. The next tile's x comes by cp.async while a tile
// computes; the first tile waits for x, Wqkv and Wout only where it needs
// each. Per tile, between block barriers:
//  1. LN, a warp per row, four rows reduced together, in float32 (two
//     passes), the affine applied and the row rounded to bf16 into shared
//     memory: the A operand.
//  2. qkv = ln @ wqkv + bqkv on mma.sync.m16n8k16 (bf16 in, float32 sums),
//     a warp per 32 rows x 48 columns (two 16-row blocks share every W
//     fragment: ldmatrix's shared-memory reads, not the tensor cores, set
//     the pace), A by ldmatrix, W by ldmatrix.trans; bias added in
//     float32; q, k and v stored in bf16.
//  3. Attention, a warp per (item, head), every key of the item in the
//     warp's registers: s = q k^T on mma.sync (Dh=8 on m16n8k8), two
//     16-row query blocks at a time sharing every K and V fragment where
//     registers allow, masked on the fragments (keys past S, causal), the
//     softmax on the fragments in float32 with log2(e)/sqrt(Dh) folded into
//     the exponent, p = exp2(s * c - m2) on the special-function unit; p
//     rounded once to bf16 for p.v on mma.sync (V by ldmatrix.trans) while
//     l sums the float32 p (a CPU emulation of this arithmetic holds it
//     within the tolerances: tests/test_torch_fused_attention.py); o / l
//     stored in bf16 over the LN rows.
//  4. y = o @ wout + bout as 2. (32 x 32 tasks), staged in bf16 over the
//     qkv rows, then stored as 16-byte vectors.
// Rows past S in an item's 16-row block come from LN rows left at zero, so
// every key a warp reads is finite and a masked one adds exactly 0.
// Still to do for speed: the phases run in lockstep between barriers, so
// the tensor cores idle during LN and the softmax; two groups of warps on
// alternate tiles (named barriers, 32-row tiles) would overlap them.
//
// ln_attention_kernel, every other case (float32 x, which is held to 1e-4
// against float32 sums; float32 weights; E past 128; S past 64): the first
// version, kept as flash kept its float32 kernel. All arithmetic is float32
// with the weights cast up. One block of 256 threads per batch item keeps
// the LN rows and the qkv rows in shared memory as float32 (66 KB at the
// flagship shapes); the projections give each thread one output column for
// 8 rows, attention one thread per (head, query) with two passes over the
// keys. Row strides are padded by one float against bank conflicts.
#include <math_constants.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using smd::from_f32;
using smd::to_f32;
using smd::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;

// out[r][n] = sum_k in[r][k] * w[k][n] + b[n] for r < S, n < N; each task is
// one column n for RT consecutive rows.
template <typename TW, typename Store>
__device__ __forceinline__ void project(const float* in, int ldi,
                                        const TW* __restrict__ w,
                                        const TW* __restrict__ b, int K, int N,
                                        int S, Store store) {
  constexpr int RT = 8;
  const int groups = (S + RT - 1) / RT;
  for (int task = threadIdx.x; task < N * groups; task += kThreads) {
    const int n = task % N, r0 = (task / N) * RT;
    int rows[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) rows[i] = min(r0 + i, S - 1) * ldi;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wv = to_f32(w[static_cast<size_t>(k) * N + n]);
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = fmaf(in[rows[i] + k], wv, acc[i]);
    }
    const float bv = to_f32(b[n]);
#pragma unroll
    for (int i = 0; i < RT; ++i)
      if (r0 + i < S) store(r0 + i, n, acc[i] + bv);
  }
}

template <typename TX, typename TW, int DH>
__global__ void __launch_bounds__(kThreads)
ln_attention_kernel(const TX* __restrict__ x, const TW* __restrict__ wqkv,
                    const TW* __restrict__ bqkv, const TW* __restrict__ wout,
                    const TW* __restrict__ bout,
                    const TW* __restrict__ ln_scale,
                    const TW* __restrict__ ln_bias, TX* __restrict__ out,
                    int S, int E, int H, int causal) {
  extern __shared__ float smem[];
  const int ldx = E + 1, ldq = 3 * E + 1;
  float* xs = smem;            // S x ldx: LN rows, later the heads' outputs
  float* qkv = smem + S * ldx;  // S x ldq
  const size_t base = static_cast<size_t>(blockIdx.x) * S * E;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1. LayerNorm with learned affine, a warp per row.
  for (int r = warp; r < S; r += kWarps) {
    float* xr = xs + r * ldx;
    const TX* src = x + base + static_cast<size_t>(r) * E;
    float sum = 0.f;
    for (int k = lane; k < E; k += 32) {
      const float v = to_f32(src[k]);
      xr[k] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / E;
    float sq = 0.f;
    for (int k = lane; k < E; k += 32) {
      const float d = xr[k] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / E + 1e-6f);
    for (int k = lane; k < E; k += 32)
      xr[k] = (xr[k] - mean) * rstd * to_f32(ln_scale[k]) + to_f32(ln_bias[k]);
  }
  __syncthreads();

  // 2. qkv = ln @ wqkv + bqkv.
  project(xs, ldx, wqkv, bqkv, E, 3 * E, S,
          [&](int r, int n, float v) { qkv[r * ldq + n] = v; });
  __syncthreads();

  // 3. Per (head, query): softmax(q k^T / sqrt(Dh)) v into xs.
  const float sqrt_dh = sqrtf(static_cast<float>(DH));
  for (int task = threadIdx.x; task < H * S; task += kThreads) {
    const int h = task / S, q = task % S;
    float qv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qv[d] = qkv[q * ldq + h * DH + d] / sqrt_dh;
    const float* kp = qkv + E + h * DH;
    const float* vp = qkv + 2 * E + h * DH;
    const int kend = causal ? q + 1 : S;
    float m = -CUDART_INF_F;
    for (int j = 0; j < kend; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qv[d], kp[j * ldq + d], s);
      m = fmaxf(m, s);
    }
    float l = 0.f, acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = 0; j < kend; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qv[d], kp[j * ldq + d], s);
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vp[j * ldq + d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) xs[q * ldx + h * DH + d] = acc[d] / l;
  }
  __syncthreads();

  // 4. y = o @ wout + bout, stored in x's type.
  TX* dst = out + base;
  project(xs, ldx, wout, bout, E, E, S, [&](int r, int n, float v) {
    dst[static_cast<size_t>(r) * E + n] = from_f32<TX>(v);
  });
}

template <typename TX, typename TW, int DH>
cudaError_t launch(const void* x, const void* wqkv, const void* bqkv,
                   const void* wout, const void* bout, const void* ln_scale,
                   const void* ln_bias, void* out, int B, int S, int E, int H,
                   int causal, cudaStream_t stream) {
  auto kernel = ln_attention_kernel<TX, TW, DH>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (configured != cudaSuccess) return configured;
  const size_t smem = sizeof(float) * S * ((E + 1) + (3 * E + 1));
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(wqkv),
      static_cast<const TW*>(bqkv), static_cast<const TW*>(wout),
      static_cast<const TW*>(bout), static_cast<const TW*>(ln_scale),
      static_cast<const TW*>(ln_bias), static_cast<TX*>(out), S, E, H, causal);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t dispatch_dh(const void* x, const void* wqkv, const void* bqkv,
                        const void* wout, const void* bout,
                        const void* ln_scale, const void* ln_bias, void* out,
                        int B, int S, int E, int H, int causal,
                        cudaStream_t st) {
  switch (E / H) {
    case 8:
      return launch<TX, TW, 8>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                               out, B, S, E, H, causal, st);
    case 16:
      return launch<TX, TW, 16>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                                out, B, S, E, H, causal, st);
    case 32:
      return launch<TX, TW, 32>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                                out, B, S, E, H, causal, st);
    case 64:
      return launch<TX, TW, 64>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                                out, B, S, E, H, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- bf16: several items a block on the tensor cores -----------------------
constexpr int kTcWarps = 16;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxS = 64;     // an item's keys live in a warp's registers
constexpr int kTcMaxE = 128;    // both weights fit in shared memory
constexpr int kTcMaxRows = 128;  // rows of a tile
constexpr int kLnRows = 4;      // LN rows a warp reduces together

using smd::cp_async16;
using smd::ex2;
using smd::ldmatrix_x2_trans;
using smd::ldmatrix_x4;
using smd::mma16816;
using smd::pack_bf16;

// d += a (16x8, row) * b (8x8, col), bf16 in, float32 sums: q.k at Dh=8.
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The block's shared-memory layout, in bf16 elements from the base: Wqkv
// (E x ld3), Wout (E x ld1), then float32 lns, lnb (E each), bqkv (3E),
// bout (E), then per tile row: x (E, prefetched), the LN row (ld1, later
// o) and the qkv row (ld3, later y at stride ld1). The tile's rows are
// rounded up to 32, the projections' row step. Every region starts 16-byte
// aligned.
struct TcSmem {
  int E, ld1, ld3;
  __host__ __device__ TcSmem(int e) : E(e), ld1(e + 8), ld3(3 * e + 8) {}
  __host__ __device__ size_t fixed_bytes() const {
    return 2 * static_cast<size_t>(E) * (ld3 + ld1) + 4 * 6 * E;
  }
  __host__ __device__ size_t row_bytes() const {
    return 2 * (E + ld1 + ld3);
  }
  __host__ __device__ static int rows(int NB, int S16) {
    return (NB * S16 + 31) / 32 * 32;
  }
};

// out[m0+r][n..n+1] = a @ w + bias over tasks of 32 rows x 8*NW columns
// (two 16-row blocks sharing every W fragment, which halves the
// shared-memory reads of W, the limit here): a (rows x K, row stride lda)
// and w (K x N, row stride ldw) bf16 in shared memory, bias float32, K a
// multiple of 16, N of 16, rows ceil(mblocks / 2) * 32. store(row, col,
// v0, v1) takes two adjacent columns.
template <int NW, typename Store>
__device__ __forceinline__ void tc_project(const bf16* a, int lda,
                                           const bf16* w, int ldw,
                                           const float* bias, int K, int N,
                                           int mblocks, Store store) {
  constexpr int NP = NW / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nchunks = (N + 8 * NW - 1) / (8 * NW);
  const int mpairs = (mblocks + 1) / 2;
  for (int task = warp; task < mpairs * nchunks; task += kTcWarps) {
    const int m0 = task / nchunks * 32, n0 = task % nchunks * (8 * NW);
    // A: rows 0-7 / 8-15 of a block x columns 0-7 / 8-15; W by
    // ldmatrix.trans: k rows 0-7 / 8-15 x two 8-column tiles.
    const bf16* ap =
        a + (m0 + lane % 8 + 8 * ((lane / 8) % 2)) * lda + 8 * (lane / 16);
    const bf16* wp =
        w + (lane % 8 + (lane / 8) % 2 * 8) * ldw + n0 + (lane / 16) * 8;
    float acc[2][NW][4];
#pragma unroll
    for (int mr = 0; mr < 2; ++mr)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mr][n][i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[2][4], bf[NP][4];
      ldmatrix_x4(af[0], ap + k0, false);
      ldmatrix_x4(af[1], ap + 16 * lda + k0, false);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (n0 + 16 * p < N)  // N is a multiple of 16: both tiles or none
          ldmatrix_x4(bf[p], wp + k0 * ldw + 16 * p, true);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (n0 + 16 * p >= N) continue;
#pragma unroll
        for (int mr = 0; mr < 2; ++mr) {
          mma16816(acc[mr][2 * p], af[mr], bf[p][0], bf[p][1]);
          mma16816(acc[mr][2 * p + 1], af[mr], bf[p][2], bf[p][3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int col = n0 + 8 * n + 2 * t;
      if (n0 + 8 * n >= N) continue;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int mr = 0; mr < 2; ++mr) {
        const int row = m0 + 16 * mr + g;
        store(row, col, acc[mr][n][0] + b0, acc[mr][n][1] + b1);
        store(row + 8, col, acc[mr][n][2] + b0, acc[mr][n][3] + b1);
      }
    }
  }
}

// One (item, head): q, k, v rows of the item at row stride ld (bf16, the
// head's columns), o rows at row stride ldo; S16 = S rounded up to 16. MR
// 16-row blocks of queries at a time share every K and V fragment.
template <int DH, int S16>
__device__ __forceinline__ void tc_attend(const bf16* qb, const bf16* kb,
                                          const bf16* vb, int ld, bf16* ob,
                                          int ldo, int S, int causal,
                                          float c) {
  constexpr int KC = DH < 16 ? 1 : DH / 16;  // 16-deep chunks of q.k
  constexpr int NT = DH / 8;                 // 8-wide column tiles of o
  constexpr int NJ = S16 / 8;                // 8-key column tiles of s
  constexpr int MB = S16 / 16;               // 16-row blocks of queries
  constexpr int MR = (MB == 2 && DH <= 32) ? 2 : 1;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool mask = causal || S < S16;
  for (int m0 = 0; m0 < S16; m0 += 16 * MR) {
    // q as the A fragments of each 16-deep chunk (of the 8-deep one).
    uint32_t qa[MR][KC][4];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr) {
      const int r = m0 + 16 * mr;
      if constexpr (DH >= 16) {
#pragma unroll
        for (int cc = 0; cc < KC; ++cc)
          ldmatrix_x4(qa[mr][cc],
                      qb + (r + lane % 8 + 8 * ((lane / 8) % 2)) * ld +
                          16 * cc + 8 * (lane / 16),
                      false);
      } else {
        qa[mr][0][0] =
            *reinterpret_cast<const uint32_t*>(qb + (r + g) * ld + 2 * t);
        qa[mr][0][1] =
            *reinterpret_cast<const uint32_t*>(qb + (r + g + 8) * ld + 2 * t);
      }
    }
    // s[mr][j] holds keys 8j + 2t, +1 of rows g (s[..][0..1]) and g+8.
    float s[MR][NJ][4];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mr][j][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if constexpr (DH >= 16) {
        const int key = 8 * j + (lane / 16) * 8 + lane % 8;
#pragma unroll
        for (int cc = 0; cc < KC; ++cc) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kb + key * ld + 16 * cc + (lane / 8) % 2 * 8,
                      false);
#pragma unroll
          for (int mr = 0; mr < MR; ++mr) {
            mma16816(s[mr][j], qa[mr][cc], kf[0], kf[1]);
            mma16816(s[mr][j + 1], qa[mr][cc], kf[2], kf[3]);
          }
        }
      } else {
        const uint32_t k0 = *reinterpret_cast<const uint32_t*>(
            kb + (8 * j + g) * ld + 2 * t);
        const uint32_t k1 = *reinterpret_cast<const uint32_t*>(
            kb + (8 * j + 8 + g) * ld + 2 * t);
#pragma unroll
        for (int mr = 0; mr < MR; ++mr) {
          mma1688(s[mr][j], qa[mr][0][0], qa[mr][0][1], k0);
          mma1688(s[mr][j + 1], qa[mr][0][0], qa[mr][0][1], k1);
        }
      }
    }
    if (mask) {
#pragma unroll
      for (int mr = 0; mr < MR; ++mr)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = 8 * j + 2 * t + i % 2;
            const int row = m0 + 16 * mr + g + 8 * (i / 2);
            if (key >= S || (causal && key > row))
              s[mr][j][i] = -CUDART_INF_F;
          }
    }
    // Softmax per row, in base 2: every row sees key 0, so m2 is finite;
    // masked keys give exp2(-inf) = 0.
    float mneg[MR][2], sum[MR][2];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mx = fmaxf(mx, fmaxf(s[mr][j][2 * i], s[mr][j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mneg[mr][i] = -(mx * c);
        sum[mr][i] = 0.f;
      }
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[mr][j][i] = ex2(fmaf(s[mr][j][i], c, mneg[mr][i / 2]));
          sum[mr][i / 2] += s[mr][j][i];
        }
    // o = p v, p rounded once to bf16: two adjacent key tiles of s are the
    // A fragment of one 16-key step.
    float o[MR][NT][4];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[mr][n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t pa[MR][4];
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        pa[mr][0] = pack_bf16(s[mr][2 * kk][0], s[mr][2 * kk][1]);
        pa[mr][1] = pack_bf16(s[mr][2 * kk][2], s[mr][2 * kk][3]);
        pa[mr][2] = pack_bf16(s[mr][2 * kk + 1][0], s[mr][2 * kk + 1][1]);
        pa[mr][3] = pack_bf16(s[mr][2 * kk + 1][2], s[mr][2 * kk + 1][3]);
      }
      const int key = 16 * kk + lane % 8 + (lane / 8) % 2 * 8;
      if constexpr (NT == 1) {
        uint32_t vf[2];
        ldmatrix_x2_trans(vf, vb + key * ld);
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
          mma16816(o[mr][0], pa[mr], vf[0], vf[1]);
      } else {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t vf[4];
          ldmatrix_x4(vf, vb + key * ld + 8 * n + (lane / 16) * 8, true);
#pragma unroll
          for (int mr = 0; mr < MR; ++mr) {
            mma16816(o[mr][n], pa[mr], vf[0], vf[1]);
            mma16816(o[mr][n + 1], pa[mr], vf[2], vf[3]);
          }
        }
      }
    }
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float li = sum[mr][i];
        li += __shfl_xor_sync(0xffffffffu, li, 1);
        li += __shfl_xor_sync(0xffffffffu, li, 2);
        const int row = m0 + 16 * mr + g + 8 * i;
        if (row >= S) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(ob + row * ldo + 8 * n + 2 * t) =
              pack_bf16(o[mr][n][2 * i] / li, o[mr][n][2 * i + 1] / li);
      }
  }
}

template <int DH, int S16>
__global__ void __launch_bounds__(kTcThreads, 1)
ln_attention_tc_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ wqkv,
                       const bf16* __restrict__ bqkv,
                       const bf16* __restrict__ wout,
                       const bf16* __restrict__ bout,
                       const bf16* __restrict__ ln_scale,
                       const bf16* __restrict__ ln_bias,
                       bf16* __restrict__ out, int B, int S, int E, int H,
                       int causal, int NB, float c) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const TcSmem L(E);
  const int ld1 = L.ld1, ld3 = L.ld3, rows = TcSmem::rows(NB, S16);
  bf16* w3 = reinterpret_cast<bf16*>(smem_raw);
  bf16* w1 = w3 + E * ld3;
  float* lns = reinterpret_cast<float*>(w1 + E * ld1);
  float* lnb = lns + E;
  float* b3 = lnb + E;
  float* b1 = b3 + 3 * E;
  bf16* xs = reinterpret_cast<bf16*>(b1 + E);  // x rows, NB*S of them
  bf16* lnrows = xs + rows * E;                // LN rows, then o
  bf16* qkv = lnrows + rows * ld1;             // q, k, v rows, then y
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (B + NB - 1) / NB;

  // x rows of the tile's items into xs by 16-byte copies (one group).
  auto prefetch = [&](int tile) {
    const int n = min(NB, B - tile * NB) * S * E / 8;
    const bf16* src = x + static_cast<size_t>(tile) * NB * S * E;
    for (int i = threadIdx.x; i < n; i += kTcThreads)
      cp_async16(xs + i * 8, src + i * 8, 16);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // w (K x N, row-major) into shared memory at row stride ld (one group).
  // Each block starts at its own row, so that the blocks, which all read
  // the same weights at once, spread over the L2's slices.
  auto stage = [&](bf16* dst, const bf16* w, int K, int N, int ld) {
    const int cn = N / 8, n = K * cn, rot = blockIdx.x % K * cn;
    for (int i = threadIdx.x; i < n; i += kTcThreads) {
      const int j = (i + rot) % n;
      cp_async16(dst + j / cn * ld + j % cn * 8, w + j * 8, 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // Once per block, in three groups that the first tile waits for in
  // turn (x before LN, Wqkv before the qkv product, Wout before the output
  // product); the float32 leaves; zeros in the row buffers (the rows past S
  // of each item stay 0, so every key a warp reads is finite).
  prefetch(blockIdx.x);
  stage(w3, wqkv, E, 3 * E, ld3);
  stage(w1, wout, E, E, ld1);
  for (int i = threadIdx.x; i < E; i += kTcThreads) {
    lns[i] = to_f32(ln_scale[i]);
    lnb[i] = to_f32(ln_bias[i]);
    b1[i] = to_f32(bout[i]);
  }
  for (int i = threadIdx.x; i < 3 * E; i += kTcThreads)
    b3[i] = to_f32(bqkv[i]);
  {
    uint4* z = reinterpret_cast<uint4*>(lnrows);
    const int zn = rows * (ld1 + ld3) / 8;
    for (int i = threadIdx.x; i < zn; i += kTcThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const int b0 = tile * NB, nb = min(NB, B - b0);
    const int mblocks = nb * S16 / 16;
    // This tile's x is in.
    if (first)
      asm volatile("cp.async.wait_group 2;\n" ::);
    else
      asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // 1. LN, a warp per row, kLnRows rows reduced together; each lane
    // holds the column pairs 2*lane + 64*j.
    constexpr int kPairs = kTcMaxE / 64;
    for (int r0 = warp * kLnRows; r0 < nb * S; r0 += kTcWarps * kLnRows) {
      float v[kLnRows][kPairs][2], mean[kLnRows], rstd[kLnRows];
#pragma unroll
      for (int u = 0; u < kLnRows; ++u) {
        const bf16* src = xs + min(r0 + u, nb * S - 1) * E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int k = 2 * lane + 64 * j;
          float2 f = make_float2(0.f, 0.f);
          if (k < E)
            f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(src + k));
          v[u][j][0] = f.x;
          v[u][j][1] = f.y;
          sum += f.x + f.y;
        }
        mean[u] = sum;
      }
#pragma unroll
      for (int u = 0; u < kLnRows; ++u) mean[u] = warp_sum(mean[u]) / E;
#pragma unroll
      for (int u = 0; u < kLnRows; ++u) {
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          if (2 * lane + 64 * j >= E) continue;
          const float d0 = v[u][j][0] - mean[u], d1 = v[u][j][1] - mean[u];
          sq += d0 * d0 + d1 * d1;
        }
        rstd[u] = sq;
      }
#pragma unroll
      for (int u = 0; u < kLnRows; ++u)
        rstd[u] = rsqrtf(warp_sum(rstd[u]) / E + 1e-6f);
#pragma unroll
      for (int u = 0; u < kLnRows; ++u) {
        const int rr = r0 + u;
        if (rr >= nb * S) continue;
        bf16* dst = lnrows + (rr / S * S16 + rr % S) * ld1;
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int k = 2 * lane + 64 * j;
          if (k >= E) continue;
          *reinterpret_cast<uint32_t*>(dst + k) = pack_bf16(
              (v[u][j][0] - mean[u]) * rstd[u] * lns[k] + lnb[k],
              (v[u][j][1] - mean[u]) * rstd[u] * lns[k + 1] + lnb[k + 1]);
        }
      }
    }
    if (first) asm volatile("cp.async.wait_group 1;\n" ::);  // Wqkv
    __syncthreads();
    // xs is free: the next tile's x comes while this one computes (an
    // empty group on the last tile keeps the count of groups the same).
    if (tile + gridDim.x < tiles)
      prefetch(tile + gridDim.x);
    else
      asm volatile("cp.async.commit_group;\n" ::);

    // 2. q, k, v in bf16.
    tc_project<6>(lnrows, ld1, w3, ld3, b3, E, 3 * E, mblocks,
                  [&](int row, int col, float v0, float v1) {
                    *reinterpret_cast<uint32_t*>(qkv + row * ld3 + col) =
                        pack_bf16(v0, v1);
                  });
    __syncthreads();

    // 3. Attention, a warp per (item, head); o over the LN rows.
    for (int task = warp; task < nb * H; task += kTcWarps) {
      const int i = task / H, h = task % H;
      const bf16* qb = qkv + i * S16 * ld3 + h * DH;
      tc_attend<DH, S16>(qb, qb + E, qb + 2 * E, ld3,
                         lnrows + i * S16 * ld1 + h * DH, ld1, S, causal, c);
    }
    // Wout (committed before the next tile's x).
    if (first) asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // 4. y = o @ wout + bout, staged in bf16 over the qkv rows, then stored
    // by 16-byte vectors (the next tile's LN writes only the LN rows).
    tc_project<4>(lnrows, ld1, w1, ld1, b1, E, E, mblocks,
                  [&](int row, int col, float v0, float v1) {
                    *reinterpret_cast<uint32_t*>(qkv + row * ld1 + col) =
                        pack_bf16(v0, v1);
                  });
    __syncthreads();
    const int chunks = E / 8;
    for (int idx = threadIdx.x; idx < nb * S * chunks; idx += kTcThreads) {
      const int rr = idx / chunks, cc = idx % chunks * 8;
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b0) * S + rr) * E +
                                cc) =
          *reinterpret_cast<const uint4*>(
              qkv + (rr / S * S16 + rr % S) * ld1 + cc);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Streaming multiprocessors of the current device.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int DH, int S16>
cudaError_t launch_tc(const void* x, const void* wqkv, const void* bqkv,
                      const void* wout, const void* bout, const void* ln_scale,
                      const void* ln_bias, void* out, int B, int S, int E,
                      int H, int causal, cudaStream_t stream) {
  const TcSmem L(E);
  // Tile rows: as many items as shared memory holds, in whole 32-row steps.
  const int max_rows = std::min(
      kTcMaxRows,
      static_cast<int>((kMaxSharedBytes - L.fixed_bytes()) / L.row_bytes()) /
          32 * 32);
  const int NB = std::min(B, max_rows / S16);
  const int sms = sm_count();
  if (NB < 1 || sms < 1) return cudaErrorInvalidValue;
  const size_t smem = L.fixed_bytes() + TcSmem::rows(NB, S16) * L.row_bytes();
  auto kernel = ln_attention_tc_kernel<DH, S16>;
  // Per call: the attribute belongs to the current device.
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (e != cudaSuccess) return e;
  const int tiles = (B + NB - 1) / NB;
  const float c =
      static_cast<float>(1.4426950408889634 / std::sqrt(double(DH)));
  kernel<<<std::min(tiles, sms), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wout),
      static_cast<const bf16*>(bout), static_cast<const bf16*>(ln_scale),
      static_cast<const bf16*>(ln_bias), static_cast<bf16*>(out), B, S, E, H,
      causal, NB, c);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_tc_s(const void* x, const void* wqkv, const void* bqkv,
                        const void* wout, const void* bout,
                        const void* ln_scale, const void* ln_bias, void* out,
                        int B, int S, int E, int H, int causal,
                        cudaStream_t st) {
  switch ((S + 15) / 16) {
    case 1:
      return launch_tc<DH, 16>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                               out, B, S, E, H, causal, st);
    case 2:
      return launch_tc<DH, 32>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                               out, B, S, E, H, causal, st);
    case 3:
      return launch_tc<DH, 48>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                               out, B, S, E, H, causal, st);
    case 4:
      return launch_tc<DH, 64>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                               out, B, S, E, H, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_tc(const void* x, const void* wqkv, const void* bqkv,
                        const void* wout, const void* bout,
                        const void* ln_scale, const void* ln_bias, void* out,
                        int B, int S, int E, int H, int causal,
                        cudaStream_t st) {
  if (E % 16 || E > kTcMaxE || S > kTcMaxS) return cudaErrorInvalidValue;
  switch (E / H) {
    case 8:
      return launch_tc_s<8>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                            out, B, S, E, H, causal, st);
    case 16:
      return launch_tc_s<16>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                             out, B, S, E, H, causal, st);
    case 32:
      return launch_tc_s<32>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                             out, B, S, E, H, causal, st);
    case 64:
      return launch_tc_s<64>(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                             out, B, S, E, H, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,S,E), wqkv (E,3E), bqkv (3E), wout (E,E), bout/ln_scale/ln_bias (E),
// out (B,S,E) in x's type; the weights share w_dtype. Head width E/H is one
// of 8, 16, 32, 64. tc selects ln_attention_tc_kernel (bf16 x and weights,
// E a multiple of 16 up to 128, S up to 64), else ln_attention_kernel.
// Returns cudaGetLastError() after the launch.
extern "C" int smd_fused_ln_attention(const void* x, const void* wqkv,
                                      const void* bqkv, const void* wout,
                                      const void* bout, const void* ln_scale,
                                      const void* ln_bias, void* out, int B,
                                      int S, int E, int H, int causal,
                                      int x_dtype, int w_dtype, int tc,
                                      void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (H <= 0 || E % H) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (x_dtype != smd::kBF16 || w_dtype != smd::kBF16)
      return cudaErrorInvalidValue;
    return dispatch_tc(x, wqkv, bqkv, wout, bout, ln_scale, ln_bias, out, B,
                       S, E, H, causal, st);
  }
  if (x_dtype == smd::kBF16) {
    if (w_dtype == smd::kBF16)
      return dispatch_dh<bf16, bf16>(x, wqkv, bqkv, wout, bout, ln_scale,
                                     ln_bias, out, B, S, E, H, causal, st);
    return dispatch_dh<bf16, float>(x, wqkv, bqkv, wout, bout, ln_scale,
                                    ln_bias, out, B, S, E, H, causal, st);
  }
  if (w_dtype == smd::kBF16)
    return dispatch_dh<float, bf16>(x, wqkv, bqkv, wout, bout, ln_scale,
                                    ln_bias, out, B, S, E, H, causal, st);
  return dispatch_dh<float, float>(x, wqkv, bqkv, wout, bout, ln_scale,
                                   ln_bias, out, B, S, E, H, causal, st);
}
