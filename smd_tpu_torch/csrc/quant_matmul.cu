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
// What this design does about it: two launches per call.
//  1. quantize_kernel: x -> int8 codes (M, K), elementwise and memory-bound,
//     16 elements a thread (16-byte loads and one 16-byte store), each
//     element divided once. The Pallas kernel quantizes each row stripe once
//     into VMEM and reuses it across the column tiles, a carry that relies
//     on the TPU's sequential grid; CUDA blocks run in no order, and
//     quantizing each A tile in shared memory instead would repeat the IEEE
//     division N/256 = 8 times per element.
//  2. w8a8_gemm_kernel, one 128x256 tile of y per block: a producer warp
//     feeds a 4-stage ring in shared memory by TMA (the codes as 128 rows x
//     128 K-bytes, the K-major weight w_t (N, K) as 256 rows x 128 K-bytes,
//     both under the 128-byte swizzle, with full/empty mbarriers), and two
//     consumer warpgroups of 64 rows each run
//     wgmma.mma_async m64n256k32 s32.s8.s8 on them, int32 accumulators in
//     registers, releasing a stage once wgmma.wait_group shows its products
//     done. TMA zero-fills the ragged edges of M, N and K, which add 0 to
//     the sums. The epilogue stages the int32 sums through shared memory
//     (rows padded so that the writes are free of bank conflicts) and
//     stores 16-byte vectors of y, dequantized and biased in float32.
// wgmma reads both 8-bit operands K-major only, so the product needs w_q
// transposed: transpose_kernel makes that (N, K) copy, once per weight when
// the caller keeps it (models/blocks.QuantDenseResBlock does), else on every
// call. The TMA/mbarrier/wgmma helpers are film's (hopper.cuh).
// Still to do for speed: a persistent grid, so that a tile's epilogue
// overlaps the next tile's loads, and the quantize pass folded into the
// head's LN/FiLM/swish pass that produces x.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using smd::load8;
using smd::mbar_arrive;
using smd::mbar_expect_tx;
using smd::mbar_init;
using smd::mbar_wait;
using smd::smem_u32;
using smd::store8;
using smd::sw128_desc;
using smd::tma_load;
using smd::wgmma_commit;
using smd::wgmma_fence;
using smd::wgmma_wait;

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          size_t i) {
  return dtype == smd::kBF16
             ? __bfloat162float(static_cast<const bf16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// ---- 1. quantize ------------------------------------------------------------
constexpr int kQThreads = 256;

__device__ __forceinline__ uint32_t code4(const float* v, float s) {
  uint32_t packed = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
    packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                  static_cast<int8_t>(__float2int_rn(q))))
              << (8 * i);
  }
  return packed;
}

// chunks of 16 elements; x and xq 16-byte aligned.
template <typename TX>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const TX* __restrict__ x, const void* __restrict__ a_scale,
                int a_dtype, int8_t* __restrict__ xq, size_t chunks) {
  const float s = load_f32(a_scale, a_dtype, 0);
  for (size_t c = blockIdx.x * static_cast<size_t>(kQThreads) + threadIdx.x;
       c < chunks; c += static_cast<size_t>(gridDim.x) * kQThreads) {
    float v[16];
    load8(x + c * 16, *reinterpret_cast<float(*)[8]>(v));
    load8(x + c * 16 + 8, *reinterpret_cast<float(*)[8]>(v + 8));
    *reinterpret_cast<uint4*>(xq + c * 16) =
        make_uint4(code4(v, s), code4(v + 4, s), code4(v + 8, s),
                   code4(v + 12, s));
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

// ---- 3. int8 product on TMA + wgmma, with the dequant epilogue ------------------
constexpr int BM = 128, BN = 256, BK = 128, kStages = 4;  // BK in bytes
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kGemmThreads = 128 * (kConsumers + 1);
constexpr int kATileBytes = BM * BK;           // codes: 128 rows x 128 bytes
constexpr int kBTileBytes = BN * BK;           // w_t: 256 rows x 128 bytes
constexpr int kStageBytes = kATileBytes + kBTileBytes;
constexpr int kCLd = BN + 8;  // int32 per staged row of y: no bank conflicts
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + 1024 alignment
static_assert(kConsumers * 64 * kCLd * 4 <= kStages * kStageBytes,
              "the epilogue's staging fits in the ring");

// d[64x256] += A[64x32] (K-major) * B[32x256] (K-major), s8 in, int32
// accumulators in the m64nNk32 fragment layout (that of m64nNk16 f32).
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// y (M, N) = codes (M, K) @ w_t (N, K)^T, dequantized: both int8 through the
// tensor maps, y in TX. Block: warpgroup 0 produces (one thread issues TMA),
// warpgroups 1..kConsumers consume 64 rows each.
template <typename TX>
__global__ void __launch_bounds__(kGemmThreads, 1)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const void* __restrict__ a_scale, int a_dtype,
                 const void* __restrict__ w_scale, int s_dtype,
                 const void* __restrict__ bias, int b_dtype,
                 TX* __restrict__ y, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  int* stage_i32 = reinterpret_cast<int*>(smem_raw + (ring - raw));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers * 4);  // a lane per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          mbar_wait(smem_u32(&empty[s]), (kt / kStages - 1) & 1);
        const uint32_t a = ring + s * kStageBytes, b = a + kATileBytes;
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, kStageBytes);
        tma_load(a, &tm_x, kt * BK, m0, bar);
        tma_load(b, &tm_w, kt * BK, n0, bar);
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint32_t a = ring + s * kStageBytes + c * (64 * 128);
    const uint32_t b = ring + s * kStageBytes + kATileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // Both K-major: 32 K-bytes along the swizzled 128-byte rows, 8-row
      // groups 1024 bytes apart.
      wgmma_m64n256k32_s8(acc, sw128_desc(a + kk * 32, 16, 1024),
                          sw128_desc(b + kk * 32, 16, 1024), 1);
    }
    wgmma_commit();
    // The products of step kt-1 are done: release their stage.
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % kStages]));
  }
  wgmma_wait<0>();

  // Epilogue. Both consumers are past their last products (named barrier
  // 1), so the ring is free: stage this warpgroup's 64x256 int32 tile at
  // row stride kCLd, then write y by 16-byte vectors.
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  int* cs = stage_i32 + c * 64 * kCLd;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * q, row = 16 * warp + g;
    *reinterpret_cast<int2*>(cs + row * kCLd + col) =
        make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(cs + (row + 8) * kCLd + col) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  // A thread owns one 8-column chunk of 16 rows, 4 rows apart.
  constexpr int kRowStep = 128 / (BN / 8);
  const int cc = t % (BN / 8), n = n0 + 8 * cc, r0 = t / (BN / 8);
  if (n >= N) return;  // N is a multiple of 8: a chunk is all in or all out
  const float a_s = load_f32(a_scale, a_dtype, 0);
  float sc[8], bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sc[i] = __fmul_rn(a_s, load_f32(w_scale, s_dtype, n + i));
    bv[i] = bias != nullptr ? load_f32(bias, b_dtype, n + i) : 0.f;
  }
#pragma unroll 4
  for (int rb = 0; rb < 64 / kRowStep; ++rb) {
    const int r = r0 + rb * kRowStep, m = m0 + c * 64 + r;
    if (m >= M) break;
    const int4* src = reinterpret_cast<const int4*>(cs + r * kCLd + 8 * cc);
    const int4 lo = src[0], hi = src[1];
    const int sums[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = __fmul_rn(__int2float_rn(sums[i]), sc[i]);
      if (bias != nullptr) v[i] = __fadd_rn(v[i], bv[i]);
    }
    store8(y + static_cast<size_t>(m) * N + n, v);
  }
}

template <typename TX>
cudaError_t launch(const void* x, const void* w_t, const void* w_scale,
                   const void* b, const void* a_scale, void* xq, void* y,
                   int M, int K, int N, int s_dtype, int b_dtype, int a_dtype,
                   cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap tm_x, tm_w;
  if (!smd::encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, BK,
                      BM) ||
      !smd::encode_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w_t, N, K, BK,
                      BN))
    return cudaErrorInvalidValue;
  // Per call: the attribute belongs to the current device.
  const cudaError_t e = cudaFuncSetAttribute(
      w8a8_gemm_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemmSmem);
  if (e != cudaSuccess) return e;

  const size_t chunks = static_cast<size_t>(M) * K / 16;
  const size_t q_blocks = (chunks + kQThreads - 1) / kQThreads;
  quantize_kernel<TX><<<static_cast<unsigned>(q_blocks < 65536 * 8 ? q_blocks
                                                                   : 65536 * 8),
                        kQThreads, 0, stream>>>(
      static_cast<const TX*>(x), a_scale, a_dtype, static_cast<int8_t*>(xq),
      chunks);
  w8a8_gemm_kernel<TX><<<dim3((N + BN - 1) / BN, m_tiles), kGemmThreads,
                         kGemmSmem, stream>>>(
      tm_x, tm_w, a_scale, a_dtype, w_scale, s_dtype, b, b_dtype,
      static_cast<TX*>(y), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// w_q (K, N) int8 -> w_t (N, K) int8, the K-major copy the product reads.
// Returns cudaGetLastError() after the launch.
extern "C" int smd_int8_transpose(const void* w_q, void* w_t, int K, int N,
                                  void* stream) {
  if (K == 0 || N == 0) return cudaSuccess;
  if ((K + kT - 1) / kT > 65535) return cudaErrorInvalidConfiguration;
  transpose_kernel<<<dim3((N + kT - 1) / kT, (K + kT - 1) / kT), dim3(kT, 8),
                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w_q), static_cast<int8_t*>(w_t), K, N);
  return cudaGetLastError();
}

// x (M, K) in x_dtype, w_t (N, K) int8 (w_q transposed), w_scale (N,), b
// (N,) or NULL, a_scale one element; xq (M, K) int8 scratch; y (M, N) in
// x_dtype. The *_dtype arguments are smd::DType codes. K is a multiple of
// 16 and N of 8 (the wrapper checks). Returns cudaGetLastError() after the
// launches.
extern "C" int smd_w8a8_dense(const void* x, const void* w_t,
                              const void* w_scale, const void* b,
                              const void* a_scale, void* xq, void* y, int M,
                              int K, int N, int x_dtype, int s_dtype,
                              int b_dtype, int a_dtype, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == smd::kBF16)
    return launch<bf16>(x, w_t, w_scale, b, a_scale, xq, y, M, K, N, s_dtype,
                        b_dtype, a_dtype, st);
  return launch<float>(x, w_t, w_scale, b, a_scale, xq, y, M, K, N, s_dtype,
                       b_dtype, a_dtype, st);
}
