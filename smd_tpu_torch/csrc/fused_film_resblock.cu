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
// What this design does about it (bf16 W), two launches per call:
//  1. row_stats_kernel, a warp per row: the row's LN statistics in float32
//     (two passes, as the reference), then h = swish(LN(x)*scale + shift)
//     rounded to bf16 into an (M, K) scratch buffer. The prologue runs once
//     per element; writing h and reading it back costs 131 MB each way,
//     ~0.08 ms. Applied instead by the two consumer warpgroups to each
//     stage's x tile in place in shared memory, it runs once per 256-column
//     tile (8 times per element at N=2048); built that way, with one
//     special-function operation per element (swish through tanh.approx),
//     a call took ~0.8 ms against this design's ~0.5 on an H100 SXM: with
//     128 accumulator registers a thread, the consumers' prologue is
//     latency-bound and the tensor cores wait on it.
//  2. film_gemm_kernel, one 128x256 tile of y per block: a producer warp
//     feeds a 4-stage ring in shared memory by TMA (h as 128x64 K-major and
//     W as four 64x64 N-major boxes, both under the 128-byte swizzle, with
//     full/empty mbarriers), and two consumer warpgroups of 64 rows each run
//     wgmma.mma_async m64n256k16 on them (W read N-major through the
//     descriptor's transpose bit), float32 accumulators in registers,
//     releasing a stage once wgmma.wait_group shows its products done. TMA
//     zero-fills the ragged edges of M, N and K. The epilogue stages the
//     accumulators through shared memory (rows padded so that the writes are
//     free of bank conflicts) and stores 16-byte vectors of y with bias and
//     residual added in float32.
// Still to do for speed: a persistent grid (one block per SM over the 250x8
// tiles) so that a tile's epilogue overlaps the next tile's loads, TMA
// multicast of W across a cluster, and the prologue in place run by a
// warpgroup of its own that holds no accumulators. A float32 W takes a plain
// float32 path on the CUDA cores (used to check the kernel in float32).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using smd::from_f32;
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
using smd::to_f32;
using smd::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// stats[row] = (mean, 1/sqrt(var + 1e-6)) of each row of x (M, K), a warp
// per row, two passes. With h given (a bf16 W), the row's prologue
// swish(LN(x) * scale + shift) of batch item row / S is also written to h
// (M, K) in bf16.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const TX* __restrict__ x, int M, int K,
                 float2* __restrict__ stats, const float* __restrict__ scale,
                 const float* __restrict__ shift, int S,
                 bf16* __restrict__ h) {
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
  if (h == nullptr) return;
  const size_t s_off = static_cast<size_t>(row / S) * K;
  bf16* hr = h + static_cast<size_t>(row) * K;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
    film8<true>(scale, shift, s_off + k, mean, rstd, v);
    store8(hr + k, v);
  }
}

// ---- bf16 W: TMA + wgmma ---------------------------------------------------
constexpr int BM = 128, BN = 256, BK = 64, kStages = 4;
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kGemmThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64;                       // 64 bf16: one 128-byte row
constexpr int kATileBytes = BM * BK * 2;       // h: 128 rows x 128 bytes
constexpr int kBBoxBytes = BK * kBox * 2;      // W: 64 K-rows x 128 bytes
constexpr int kStageBytes = kATileBytes + (BN / kBox) * kBBoxBytes;
constexpr int kCLd = BN + 8;  // floats per staged row of y: no bank conflicts
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + 1024 alignment
static_assert(kConsumers * 64 * kCLd * 4 <= kStages * kStageBytes,
              "the epilogue's staging fits in the ring");

// d[64x256] += A[64x16] (K-major) * B[16x256] (N-major), bf16 in, float32
// accumulators in the m64nNk16 fragment layout.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
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
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// y (M, N) = h (M, K) @ W (K, N) + bias [+ res], h and W bf16 through the
// tensor maps, y and res in TO. Block: warpgroup 0 produces (one thread
// issues TMA), warpgroups 1..kConsumers consume 64 rows each.
template <typename TO, typename TB>
__global__ void __launch_bounds__(kGemmThreads, 1)
film_gemm_kernel(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_w,
                 const TB* __restrict__ bias, const TO* __restrict__ res,
                 TO* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  float* stage_f32 = reinterpret_cast<float*>(smem_raw + (ring - raw));
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
        tma_load(a, &tm_h, kt * BK, m0, bar);
#pragma unroll
        for (int j = 0; j < BN / kBox; ++j)
          tma_load(b + j * kBBoxBytes, &tm_w, n0 + j * kBox, kt * BK, bar);
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint32_t a = ring + s * kStageBytes + c * (64 * 128);
    const uint32_t b = ring + s * kStageBytes + kATileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 K-columns are 32 bytes along the swizzled row; 8-row groups
      // 1024 bytes apart. B: 16 K-rows are 2048 bytes on; 64-column boxes
      // kBBoxBytes apart (leading), 8-row groups 1024 bytes apart (stride).
      wgmma_m64n256k16(acc, sw128_desc(a + kk * 32, 16, 1024),
                       sw128_desc(b + kk * 2048, kBBoxBytes, 1024), 1);
    }
    wgmma_commit();
    // The products of step kt-1 are done: release their stage.
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % kStages]));
  }
  wgmma_wait<0>();

  // Epilogue. Both consumers are past their last products (named barrier
  // 1), so the ring is free: stage this warpgroup's 64x256 float32 tile at
  // row stride kCLd, then write y by 16-byte vectors.
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  float* cs = stage_f32 + c * 64 * kCLd;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * q, row = 16 * warp + g;
    *reinterpret_cast<float2*>(cs + row * kCLd + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(cs + (row + 8) * kCLd + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  // A thread owns one 8-column chunk of 16 rows, 4 rows apart; the
  // residual of 8 rows is loaded before any of them is stored.
  constexpr int kRowStep = 128 / (BN / 8), kBatch = 8;
  const int cc = t % (BN / 8), n = n0 + 8 * cc, r0 = t / (BN / 8);
  if (n >= N) return;  // N is a multiple of 8: a chunk is all in or all out
  float bv[8];
  load8(bias + n, bv);
#pragma unroll
  for (int rb = 0; rb < 64 / kRowStep; rb += kBatch) {
    float rv[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + c * 64 + r0 + (rb + u) * kRowStep;
      if (res != nullptr && m < M) {
        load8(res + static_cast<size_t>(m) * N + n, rv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) rv[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + (rb + u) * kRowStep, m = m0 + c * 64 + r;
      if (m >= M) continue;
      const float4* src =
          reinterpret_cast<const float4*>(cs + r * kCLd + 8 * cc);
      const float4 lo = src[0], hi = src[1];
      float v[8] = {lo.x + bv[0], lo.y + bv[1], lo.z + bv[2], lo.w + bv[3],
                    hi.x + bv[4], hi.y + bv[5], hi.z + bv[6], hi.w + bv[7]};
      if (res != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += rv[u][i];
      }
      store8(out + static_cast<size_t>(m) * N + n, v);
    }
  }
}

// A row-major bf16 (rows, cols) matrix read by boxes of box_rows x 64
// columns under the 128-byte swizzle; out-of-bounds elements read as 0.
bool encode_bf16(CUtensorMap* map, const void* ptr, int rows, int cols,
                 int box_rows) {
  return smd::encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows,
                        cols, kBox, box_rows);
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
                   void* stats, void* h, int M, int S, int K, int N,
                   int w_dtype, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const TB* bp = static_cast<const TB*>(b);
  const TX* rp = static_cast<const TX*>(res);
  TX* op = static_cast<TX*>(out);
  float2* st = static_cast<float2*>(stats);
  const int stat_blocks = (M + kWarps - 1) / kWarps;
  if (w_dtype != smd::kBF16) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    row_stats_kernel<TX><<<stat_blocks, kThreads, 0, stream>>>(
        xp, M, K, st, sc, sh, S, nullptr);
    film_f32_kernel<TX, TB><<<grid, kThreads, 0, stream>>>(
        xp, st, sc, sh, static_cast<const float*>(w), bp, rp, op, M, S, K, N);
    return cudaGetLastError();
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535 || h == nullptr) return cudaErrorInvalidConfiguration;
  CUtensorMap tm_h, tm_w;
  if (!encode_bf16(&tm_h, h, M, K, BM) || !encode_bf16(&tm_w, w, K, N, BK))
    return cudaErrorInvalidValue;
  // Per call: the attribute belongs to the current device.
  const cudaError_t e = cudaFuncSetAttribute(
      film_gemm_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemmSmem);
  if (e != cudaSuccess) return e;
  row_stats_kernel<TX><<<stat_blocks, kThreads, 0, stream>>>(
      xp, M, K, st, sc, sh, S, static_cast<bf16*>(h));
  film_gemm_kernel<TX, TB><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      tm_h, tm_w, bp, rp, op, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x (B,S,K), scale/shift (B,1,K) float32, w (K,N), b (N,), res (B,S,N) or
// NULL, out (B,S,N); stats a float32 (B*S, 2) scratch buffer; h a bf16
// (B*S, K) scratch buffer for a bf16 w (NULL for a float32 w). x_dtype,
// w_dtype, b_dtype are smd::DType codes, res and out take x's type. Returns
// cudaGetLastError() after the launches.
extern "C" int smd_fused_ln_film_swish_dense(
    const void* x, const void* scale, const void* shift, const void* w,
    const void* b, const void* res, void* out, void* stats, void* h, int B,
    int S, int K, int N, int x_dtype, int w_dtype, int b_dtype,
    void* stream) {
  const int M = B * S;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == smd::kBF16) {
    if (b_dtype == smd::kBF16)
      return launch<bf16, bf16>(x, scale, shift, w, b, res, out, stats, h, M,
                                S, K, N, w_dtype, st);
    return launch<bf16, float>(x, scale, shift, w, b, res, out, stats, h, M,
                               S, K, N, w_dtype, st);
  }
  if (b_dtype == smd::kBF16)
    return launch<float, bf16>(x, scale, shift, w, b, res, out, stats, h, M,
                               S, K, N, w_dtype, st);
  return launch<float, float>(x, scale, shift, w, b, res, out, stats, h, M, S,
                              K, N, w_dtype, st);
}
