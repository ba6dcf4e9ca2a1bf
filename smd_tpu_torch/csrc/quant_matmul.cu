// w8a8 dense on Hopper: static-scale quantize, int8 x int8 -> int32, dequant:
//
//     y = (clip(round_half_even(x / a_s), -127, 127) @ w_q) * (a_s * w_s[j])
//         + b[j]
//
// Replaces the TPU kernel smd_tpu/ops/quant_matmul.py, w8a8_dense (Pallas
// kernel _kernel, wrapper _w8a8_2d). x is float32 or bf16, w_q int8 (K, N),
// w_s and b float32 or bf16 (read as float32), a_s a float32 or bf16 scalar
// on the device; the sum is int32, the scale product is taken first as the
// Pallas epilogue takes it, and y is stored in x's type. Every step rounds as
// the plain version (ops/quant_matmul._reference) does: an IEEE division
// (__fdiv_rn) and rintf for the codes, exact int32 sums, and __fmul_rn /
// __fadd_rn in the epilogue so that no multiply-add is contracted.
//
// What bounds it on an H100: at the sampler's shapes (M = 1000*32 rows,
// K = N = 2048) one call is 2*M*K*N = 268 G int8 operations, 0.136 ms at the
// 1,979 TOP/s int8 tensor-core peak, against 0.079 ms to read x (bf16) and
// w_q and write y (bf16) once at 3.35 TB/s: the tensor cores bound it.
//
// What this design does about it: three launches per call.
//  1. quantize_kernel: x -> int8 codes (M, K), elementwise and memory-bound
//     (each element is divided once). The Pallas kernel quantizes each row
//     stripe once into VMEM and reuses it across the column tiles, a carry
//     that relies on the TPU's sequential grid; CUDA blocks run in no order,
//     and quantizing each A tile in shared memory instead would repeat the
//     IEEE division N/128 = 16 times per element.
//  2. transpose_kernel: w_q (K, N) -> (N, K), 4 MB at the flagship's width,
//     so that both operands of the product are K-contiguous and load into
//     mma fragments with ldmatrix (which cannot transpose 8-bit elements).
//  3. gemm_kernel: a 128x128 output tile per block, 8 warps of 64x32, K in
//     steps of 64 through a 4-stage cp.async ring in shared memory (rows of
//     64 bytes, 16-byte chunks XOR-swizzled so that ldmatrix is free of bank
//     conflicts), mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores, and
//     the dequant and bias epilogue on the int32 accumulators in registers.
// Still to do for speed: wgmma fed by TMA (mma.sync reaches only part of
// Hopper's int8 rate), and the quantize pass folded into a producer stage.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using smd::load8;

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          size_t i) {
  return dtype == smd::kBF16
             ? __bfloat162float(static_cast<const bf16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// ---- 1. quantize ------------------------------------------------------------
constexpr int kQThreads = 256;

template <typename TX>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const TX* __restrict__ x, const void* __restrict__ a_scale,
                int a_dtype, int8_t* __restrict__ xq, size_t chunks) {
  const float s = load_f32(a_scale, a_dtype, 0);
  for (size_t c = blockIdx.x * static_cast<size_t>(kQThreads) + threadIdx.x;
       c < chunks; c += static_cast<size_t>(gridDim.x) * kQThreads) {
    float v[8];
    load8(x + c * 8, v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
      const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(
          __float2int_rn(q)));
      packed[i / 4] |= byte << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(xq + c * 8) = make_uint2(packed[0], packed[1]);
  }
}

// ---- 2. transpose -------------------------------------------------------------
constexpr int kT = 32;  // a 32x32 tile of bytes per block of 32x8 threads

__global__ void __launch_bounds__(kT * 8)
transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K,
                 int N) {
  __shared__ int8_t tile[kT][kT + 4];
  const int n0 = blockIdx.x * kT, k0 = blockIdx.y * kT;
  for (int r = threadIdx.y; r < kT; r += 8) {
    const int k = k0 + r, n = n0 + threadIdx.x;
    if (k < K && n < N) tile[r][threadIdx.x] = w[static_cast<size_t>(k) * N + n];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kT; r += 8) {
    const int n = n0 + r, k = k0 + threadIdx.x;
    if (n < N && k < K) wt[static_cast<size_t>(n) * K + k] = tile[threadIdx.x][r];
  }
}

// ---- 3. int8 product with the dequant epilogue ----------------------------------
constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 64, kStages = 4;
constexpr int kTileBytes = BM * BK;  // A and B tiles alike: 128 rows x 64 bytes
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes;  // 64 KB: dynamic

// Byte offset of 16-byte chunk c (0..3) of row r in a tile: chunk c of row r
// sits at position c ^ ((r >> 1) & 3), so the 8 rows an ldmatrix phase reads
// fall in 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// xq (M, K) and wt (N, K) int8, K-contiguous; y (M, N) in TX.
template <typename TX>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
            const void* __restrict__ a_scale, int a_dtype,
            const void* __restrict__ w_scale, int s_dtype,
            const void* __restrict__ bias, int b_dtype, TX* __restrict__ y,
            int M, int K, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t smem0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 64 rows x 32 columns

  // Copy the K step at k0 into ring slot `stage`; rows past M or N and
  // chunks past K are zero-filled (src_bytes 0), which adds nothing.
  auto load_stage = [&](int stage, int k0) {
    const uint32_t a_base = smem0 + stage * kStageBytes;
    const uint32_t b_base = a_base + kTileBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kThreads;  // 512 chunks per tile
      const int r = idx / 4, c = idx % 4, k = k0 + c * 16;
      const bool k_in = k < K;
      const int m = row0 + r, n = col0 + r;
      const bool a_in = k_in && m < M, b_in = k_in && n < N;
      cp_async16(a_base + swz(r, c),
                 a_in ? xq + static_cast<size_t>(m) * K + k : xq,
                 a_in ? 16 : 0);
      cp_async16(b_base + swz(r, c),
                 b_in ? wt + static_cast<size_t>(n) * K + k : wt,
                 b_in ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s * BK);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // this step's tile is in; the slot refilled below is free
    const int next = step + kStages - 1;
    if (next < steps) load_stage(next % kStages, next * BK);
    asm volatile("cp.async.commit_group;\n" ::);

    const uint32_t a_base = smem0 + (step % kStages) * kStageBytes;
    const uint32_t b_base = a_base + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // matrices: rows 0-7 / 8-15 of the m16 tile x bytes 0-15 / 16-31
        const int r = wm * 64 + i * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
        ldmatrix_x4(a[i], a_base + swz(r, ks * 2 + lane / 16));
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        // matrices: columns 0-7 x bytes 0-15 / 16-31, then columns 8-15
        const int n = wn * 32 + jp * 16 + (lane % 8) + 8 * (lane / 16);
        ldmatrix_x4(b[jp], b_base + swz(n, ks * 2 + (lane / 8) % 2));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i], b[j / 2][2 * (j % 2)],
                 b[j / 2][2 * (j % 2) + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // Epilogue: thread holds rows g and g+8, columns 2t and 2t+1 of each
  // 16x8 fragment.
  const float a_s = load_f32(a_scale, a_dtype, 0);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = col0 + wn * 32 + j * 8 + 2 * t;
    if (n >= N) continue;  // N is even, so n + 1 < N too
    const float sc0 = __fmul_rn(a_s, load_f32(w_scale, s_dtype, n));
    const float sc1 = __fmul_rn(a_s, load_f32(w_scale, s_dtype, n + 1));
    const float b0 = bias != nullptr ? load_f32(bias, b_dtype, n) : 0.f;
    const float b1 = bias != nullptr ? load_f32(bias, b_dtype, n + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + wm * 64 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), sc0);
        float v1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sc1);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        store2(y + static_cast<size_t>(m) * N + n, v0, v1);
      }
    }
  }
}

template <typename TX>
cudaError_t launch(const void* x, const void* w_q, const void* w_scale,
                   const void* b, const void* a_scale, void* xq, void* wt,
                   void* y, int M, int K, int N, int s_dtype, int b_dtype,
                   int a_dtype, cudaStream_t stream) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      gemm_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (configured != cudaSuccess) return configured;
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return cudaErrorInvalidConfiguration;

  const size_t chunks = static_cast<size_t>(M) * K / 8;
  const size_t q_blocks = (chunks + kQThreads - 1) / kQThreads;
  quantize_kernel<TX><<<static_cast<unsigned>(q_blocks < 65536 * 8 ? q_blocks
                                                                   : 65536 * 8),
                        kQThreads, 0, stream>>>(
      static_cast<const TX*>(x), a_scale, a_dtype, static_cast<int8_t*>(xq),
      chunks);
  transpose_kernel<<<dim3((N + kT - 1) / kT, (K + kT - 1) / kT), dim3(kT, 8),
                     0, stream>>>(static_cast<const int8_t*>(w_q),
                                  static_cast<int8_t*>(wt), K, N);
  gemm_kernel<TX><<<dim3((N + BN - 1) / BN, m_tiles), kThreads, kSmemBytes,
                    stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wt), a_scale,
      a_dtype, w_scale, s_dtype, b, b_dtype, static_cast<TX*>(y), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) in x_dtype, w_q (K, N) int8, w_scale (N,), b (N,) or NULL, a_scale
// one element; xq (M, K) and wt (N, K) int8 scratch buffers; y (M, N) in
// x_dtype. The *_dtype arguments are smd::DType codes. K is a multiple of 16
// and N of 8 (the wrapper checks). Returns cudaGetLastError() after the
// launches.
extern "C" int smd_w8a8_dense(const void* x, const void* w_q,
                              const void* w_scale, const void* b,
                              const void* a_scale, void* xq, void* wt,
                              void* y, int M, int K, int N, int x_dtype,
                              int s_dtype, int b_dtype, int a_dtype,
                              void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == smd::kBF16)
    return launch<bf16>(x, w_q, w_scale, b, a_scale, xq, wt, y, M, K, N,
                        s_dtype, b_dtype, a_dtype, st);
  return launch<float>(x, w_q, w_scale, b, a_scale, xq, wt, y, M, K, N,
                       s_dtype, b_dtype, a_dtype, st);
}
