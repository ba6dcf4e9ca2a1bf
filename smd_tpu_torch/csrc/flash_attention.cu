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
// What bounds it on an H100: at the served shapes (B=64, S=512, H=8, Dh=16,
// bf16) one call is 4*B*H*S^2*Dh = 8.6 GFLOP of float32 work, 0.128 ms on
// the CUDA cores at 67 TFLOP/s, against 0.010 ms to move q, k, v and o at
// 3.35 TB/s: the float32 operations bound it (the bf16 tensor cores would
// take 0.009 ms, the mark for a later redesign with wgmma).
//
// What this simple design does about it: the Pallas kernel's (B*H, S, Dh)
// transposes and 512/256/128 blocks are TPU tiling devices. Here a block
// owns one (batch*head, 128-row query tile), one thread per query row with
// the row's q and accumulator in registers, and reads q, k and v in their
// native (B, S, H, Dh) layout by strides, so the unbound qkv projection
// needs no copy. Keys and values pass through shared memory in tiles of 64,
// converted to float32 once, and every thread of a warp reads the same key
// row (a broadcast). The online softmax updates once per 16 keys, in base 2
// (exp2 of s*log2e - max*log2e, one FMA and one MUFU.EX2 per score). A block
// visits only the key tiles its rows can see: through the diagonal of its
// last row under the causal mask, and the groups of its rows under
// block_diag; a thread skips a 16-key chunk wholly outside its own row's
// window. Masked keys get p = 0 exactly (not exp of a large negative), so
// a row never takes in a masked key, whatever order its chunks come in.
#include <math_constants.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 128;  // query rows per block, one per thread
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax update
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of one tensor's batch, sequence and head axes.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, Strides qs, Strides ks, Strides vs,
                   int causal, int block_diag, cudaStream_t stream) {
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  flash_kernel<T, DH><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, qs, ks, vs,
      causal, block_diag);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int Dh, Strides qs,
                        Strides ks, Strides vs, int causal, int block_diag,
                        cudaStream_t st) {
  switch (Dh) {
    case 8:
      return launch<T, 8>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                          block_diag, st);
    case 16:
      return launch<T, 16>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                           block_diag, st);
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                           block_diag, st);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, H, qs, ks, vs, causal,
                           block_diag, st);
    default:
      return cudaErrorInvalidValue;
  }
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
      (S + kBlockQ - 1) / kBlockQ > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == smd::kBF16)
    return dispatch_dh<bf16>(q, k, v, out, B, S, H, Dh, qs, ks, vs, causal,
                             block_diag, st);
  return dispatch_dh<float>(q, k, v, out, B, S, H, Dh, qs, ks, vs, causal,
                            block_diag, st);
}
