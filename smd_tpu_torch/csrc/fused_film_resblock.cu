// Fused FiLM-resblock half on Hopper:
//
//     y = swish(LN(x) * scale + shift) @ W + b  [+ residual]
//
// Replaces the TPU kernel smd_tpu/ops/fused_film_resblock.py,
// fused_ln_film_swish_dense (Pallas body _ln_film_swish_dense_body). LN has
// no learned affine and eps 1e-6; the prologue is float32; h is rounded to
// W's type before the product, which sums in float32; bias and residual are
// added in float32 and y is stored in x's type.
//
// What bounds it on an H100: at the sampler's shapes (B=1000, S=32,
// K=N=2048, bf16) one call is 2*32000*2048*2048 = 268 GFLOP, 0.27 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against ~0.1 ms to move x, W, the
// residual and y once at 3.35 TB/s: the tensor cores bound it.
//
// What this design does about it: two launches per call. The first takes
// each row's LN statistics once (a warp per row, two passes in float32 as
// the reference does) into a (rows, 2) scratch buffer. The second owns a
// 128x128 tile of y per block and walks K in steps of 32: it normalises,
// applies the FiLM affine of the row's batch item (row / S) and swish in
// float32, rounds to bf16 into shared memory beside the matching W tile,
// and multiplies on the tensor cores with nvcuda::wmma bf16 16x16x16
// fragments summing in float32. The next step's W tile is copied to shared
// memory by cp.async and its x loaded into registers before the current
// step's products; shared memory is double-buffered with one barrier per
// step, so device-memory latency overlaps the tensor cores. The register
// budget is capped for two blocks per SM. The LN -> affine -> swish
// intermediate never reaches device memory, which is the point of the
// fusion. Still to do for speed: wgmma fed by TMA through a deeper ring, and
// the prologue (recomputed for each of the N/128 column tiles) off the
// tensor cores' path. A float32 W takes a plain float32 path on the CUDA
// cores (used to check the kernel in float32).
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
using smd::from_f32;
using smd::load8;
using smd::load_raw;
using smd::Raw8;
using smd::to_f32;
using smd::unpack;
using smd::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// stats[row] = (mean, 1/sqrt(var + 1e-6)) of each row of x (M, K), a warp
// per row, two passes.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const TX* __restrict__ x, int M, int K,
                 float2* __restrict__ stats) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const TX* xr = x + static_cast<size_t>(row) * K;
  float sum = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  const float mean = warp_sum(sum) / K;
  float sq = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / K + 1e-6f);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// 16 bytes global -> shared without registers; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// h = swish((h - mean) * rstd * scale + shift) for 8 consecutive columns.
// FAST selects the SFU's exp and division (for a bf16 h, whose rounding to
// 8 bits hides their last-bit differences); the exponent is clamped at 80 so
// the divisor stays in __fdividef's range (swish(-80) is -1.4e-33 either
// way).
template <bool FAST>
__device__ __forceinline__ void film8(const float* __restrict__ scale,
                                      const float* __restrict__ shift,
                                      size_t s_off, float mean, float rstd,
                                      float (&h)[8]) {
  float sc[8], sh[8];
  load8(scale + s_off, sc);
  load8(shift + s_off, sh);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = (h[i] - mean) * rstd * sc[i] + sh[i];
    h[i] = FAST ? __fdividef(v, 1.f + __expf(-fmaxf(v, -80.f)))
                : v * (1.f / (1.f + expf(-v)));
  }
}

// ---- bf16 W: tensor cores through wmma ------------------------------------
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;  // 80-byte rows keep wmma pointers 32-byte aligned
constexpr int B_LD = BN + 8;
constexpr int A_CHUNKS = BM * BK / 8 / kThreads;  // 8-element chunks a thread
constexpr int B_CHUNKS = BK * BN / 8 / kThreads;

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, 2)
film_bf16_kernel(const TX* __restrict__ x, const float2* __restrict__ stats,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, const bf16* __restrict__ w,
                 const TB* __restrict__ bias, const TX* __restrict__ res,
                 TX* __restrict__ out, int M, int S, int K, int N) {
  __shared__ __align__(32) bf16 As[2][BM * A_LD];
  __shared__ __align__(32) bf16 Bs[2][BK * B_LD];
  __shared__ __align__(32) float Cs[kWarps * 256];
  __shared__ float s_mean[BM], s_rstd[BM];

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 64 rows x 32 columns

  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const float2 st = row0 + r < M ? stats[row0 + r] : make_float2(0.f, 0.f);
    s_mean[r] = st.x;
    s_rstd[r] = st.y;
  }

  Raw8<TX> ra[A_CHUNKS];
  // Start the K step at k0: W's tile goes to shared buffer buf by cp.async,
  // x's into registers (its prologue comes in store_tiles).
  auto load_tiles = [&](int k0, int buf) {
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int row = row0 + idx / (BK / 8), k = k0 + (idx % (BK / 8)) * 8;
      if (row < M && k < K) {
        load_raw(x + static_cast<size_t>(row) * K + k, ra[c]);
      } else {
        ra[c] = Raw8<TX>{};
      }
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int kr = idx / (BN / 8), nc = (idx % (BN / 8)) * 8;
      const int k = k0 + kr, n = col0 + nc;
      const bool in = k < K && n < N;
      cp_async16(&Bs[buf][kr * B_LD + nc],
                 in ? w + static_cast<size_t>(k) * N + n : w, in ? 16 : 0);
    }
  };
  // Apply the prologue to the loaded x, store it in buffer buf, and wait
  // for this thread's cp.async copies.
  auto store_tiles = [&](int k0, int buf) {
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int r = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      const int row = row0 + r, k = k0 + kc;
      float h[8];
      if (row < M && k < K) {
        unpack(ra[c], h);
        film8<true>(scale, shift, static_cast<size_t>(row / S) * K + k,
                    s_mean[r], s_rstd[r], h);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = 0.f;
      }
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(&As[buf][r * A_LD + kc]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = __floats2bfloat162_rn(h[2 * i], h[2 * i + 1]);
    }
    cp_async_wait_all();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  __syncthreads();  // s_mean, s_rstd
  load_tiles(0, 0);
  store_tiles(0, 0);
  __syncthreads();
  const int steps = (K + BK - 1) / BK;
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) load_tiles((step + 1) * BK, cur ^ 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[cur][(wm * 64 + i * 16) * A_LD + kk],
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[cur][kk * B_LD + wn * 32 + j * 16],
                               B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier, so the
    // copies into it could start before this step's products.
    if (more) store_tiles((step + 1) * BK, cur ^ 1);
    __syncthreads();
  }

  // Epilogue: each warp stages one 16x16 fragment at a time in shared memory
  // and adds bias and residual in float32.
  float* cw = Cs + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + wm * 64 + i * 16 + e / 16;
        const int n = col0 + wn * 32 + j * 16 + e % 16;
        if (row < M && n < N) {
          const size_t o = static_cast<size_t>(row) * N + n;
          float v = cw[e] + to_f32(bias[n]);
          if (res != nullptr) v += to_f32(res[o]);
          out[o] = from_f32<TX>(v);
        }
      }
      __syncwarp();
    }
  }
}

// ---- float32 W: plain float32 on the CUDA cores ---------------------------
constexpr int FM = 64, FN = 64, FK = 16;

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
film_f32_kernel(const TX* __restrict__ x, const float2* __restrict__ stats,
                const float* __restrict__ scale,
                const float* __restrict__ shift, const float* __restrict__ w,
                const TB* __restrict__ bias, const TX* __restrict__ res,
                TX* __restrict__ out, int M, int S, int K, int N) {
  __shared__ float As[FK][FM + 4];  // transposed: As[k][row]
  __shared__ float Bs[FK][FN + 4];

  const int row0 = blockIdx.y * FM, col0 = blockIdx.x * FN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4x4 outputs each

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int c = threadIdx.x; c < FM * FK / 8; c += kThreads) {
      const int r = c / (FK / 8), kc = (c % (FK / 8)) * 8;
      const int row = row0 + r, k = k0 + kc;
      float h[8];
      if (row < M && k < K) {
        const float2 st = stats[row];
        load8(x + static_cast<size_t>(row) * K + k, h);
        film8<false>(scale, shift, static_cast<size_t>(row / S) * K + k, st.x,
                     st.y, h);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) As[kc + i][r] = h[i];
    }
    for (int c = threadIdx.x; c < FK * FN / 4; c += kThreads) {
      const int kr = c / (FN / 4), nc = (c % (FN / 4)) * 4;
      const int k = k0 + kr, n = col0 + nc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && n < N)
        v = *reinterpret_cast<const float4*>(w + static_cast<size_t>(k) * N + n);
      Bs[kr][nc] = v.x;
      Bs[kr][nc + 1] = v.y;
      Bs[kr][nc + 2] = v.z;
      Bs[kr][nc + 3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, n = col0 + tx * 4 + j;
      if (row < M && n < N) {
        const size_t o = static_cast<size_t>(row) * N + n;
        float v = acc[i][j] + to_f32(bias[n]);
        if (res != nullptr) v += to_f32(res[o]);
        out[o] = from_f32<TX>(v);
      }
    }
  }
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   const void* w, const void* b, const void* res, void* out,
                   void* stats, int M, int S, int K, int N, int w_dtype,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const TB* bp = static_cast<const TB*>(b);
  const TX* rp = static_cast<const TX*>(res);
  TX* op = static_cast<TX*>(out);
  float2* st = static_cast<float2*>(stats);
  const bool bf16_w = w_dtype == smd::kBF16;
  const dim3 grid(bf16_w ? (N + BN - 1) / BN : (N + FN - 1) / FN,
                  bf16_w ? (M + BM - 1) / BM : (M + FM - 1) / FM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  row_stats_kernel<TX><<<(M + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      xp, M, K, st);
  if (bf16_w) {
    film_bf16_kernel<TX, TB><<<grid, kThreads, 0, stream>>>(
        xp, st, sc, sh, static_cast<const bf16*>(w), bp, rp, op, M, S, K, N);
  } else {
    film_f32_kernel<TX, TB><<<grid, kThreads, 0, stream>>>(
        xp, st, sc, sh, static_cast<const float*>(w), bp, rp, op, M, S, K, N);
  }
  return cudaGetLastError();
}

}  // namespace

// x (B,S,K), scale/shift (B,1,K) float32, w (K,N), b (N,), res (B,S,N) or
// NULL, out (B,S,N), stats a float32 (B*S, 2) scratch buffer; x_dtype,
// w_dtype, b_dtype are smd::DType codes, res and out take x's type. Returns
// cudaGetLastError() after the launches.
extern "C" int smd_fused_ln_film_swish_dense(
    const void* x, const void* scale, const void* shift, const void* w,
    const void* b, const void* res, void* out, void* stats, int B, int S,
    int K, int N, int x_dtype, int w_dtype, int b_dtype, void* stream) {
  const int M = B * S;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == smd::kBF16) {
    if (b_dtype == smd::kBF16)
      return launch<bf16, bf16>(x, scale, shift, w, b, res, out, stats, M, S,
                                K, N, w_dtype, st);
    return launch<bf16, float>(x, scale, shift, w, b, res, out, stats, M, S,
                               K, N, w_dtype, st);
  }
  if (b_dtype == smd::kBF16)
    return launch<float, bf16>(x, scale, shift, w, b, res, out, stats, M, S,
                               K, N, w_dtype, st);
  return launch<float, float>(x, scale, shift, w, b, res, out, stats, M, S, K,
                              N, w_dtype, st);
}
