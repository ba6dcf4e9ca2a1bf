// Fused short-sequence attention block on Hopper:
//
//     ln  = LN(x) * ln_scale + ln_bias                    (eps 1e-6)
//     qkv = ln @ wqkv + bqkv                              (S,E)@(E,3E)
//     o_h = softmax(q_h k_h^T / sqrt(Dh) [causal]) v_h    per head
//     y   = o @ wout + bout                               (S,E)@(E,E)
//
// Replaces the TPU kernel smd_tpu/ops/fused_attention.py, fused_ln_attention
// (Pallas kernel _kernel). All arithmetic is float32 with the weights cast
// up, as there; y is stored in x's type. The Pallas kernel packs NB items
// into one block-diagonal tile to fill the TPU's matrix unit; that is a
// tiling device, not part of the function, so here a block owns one item.
//
// What bounds it on an H100: at the sampler's shapes (B=1000, S=32, E=128,
// H=8, Dh=16) one call is ~4.7 GFLOP of float32 work, ~70 us on the CUDA
// cores at 67 TFLOP/s, against ~5 us to move x and y in bf16 at 3.35 TB/s:
// the float32 operations bound it.
//
// What this simple design does about it: one block of 256 threads per batch
// item keeps the whole block's intermediates in shared memory (the LN rows,
// then the 32x384 qkv rows, 66 KB at the flagship shapes), so only x, the
// weights (through L2) and y touch device memory. The projections give each
// thread one output column for 8 rows, reading the weight row coalesced and
// the activations as shared-memory broadcasts; attention gives each thread
// one (head, query) pair, two passes over the keys (max, then exp-sum and
// P.V) with Dh accumulators in registers. Row strides are padded by one
// float so per-thread rows fall in distinct banks. Still to do for speed:
// several items per block and bf16 tensor-core products.
#include <math_constants.h>

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

}  // namespace

// x (B,S,E), wqkv (E,3E), bqkv (3E), wout (E,E), bout/ln_scale/ln_bias (E),
// out (B,S,E) in x's type; the weights share w_dtype. Head width E/H is one
// of 8, 16, 32, 64. Returns cudaGetLastError() after the launch.
extern "C" int smd_fused_ln_attention(const void* x, const void* wqkv,
                                      const void* bqkv, const void* wout,
                                      const void* bout, const void* ln_scale,
                                      const void* ln_bias, void* out, int B,
                                      int S, int E, int H, int causal,
                                      int x_dtype, int w_dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (H <= 0 || E % H) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
