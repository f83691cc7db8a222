// Split-KV join attention for PreTTR's query-time join, for Hopper (sm_90a):
// the dense entries.  The paged entry is join_attention_paged.cu.
//
// Replaces: src/repro/kernels/join_attention/kernel.py,
// join_attention_pallas (_join_kernel), in its dense float form and its
// raw-int8 doc K/V form (per-token float32 scales, widened while staged).
//
// Computes attention of q [B, Hq, Sq, D] over the union of two K/V
// segments that are never concatenated: the query segment kq/vq
// [B, Hkv, Lq, D] masked by kq_valid, and the doc segment kd/vd
// [B, Hkv, Ld, D] masked by kd_valid, whose tiles past dlen[b] are
// skipped.  Bidirectional, validity masks only.  GQA head h reads KV head
// h / (Hq / Hkv).
//
// Bound on the H100: the join layers run q [32, 12, 512, 64] bf16 against
// 32 + 480 keys: ~4 * D FLOPs per (row, key) over 2 bytes per element
// read once (1 byte for int8 K/V), 100-200 FLOPs per byte, below the
// bf16 tensor-core ridge (~295): memory bytes bound the 16-bit forms on
// the tensor cores.  The CLS row (Sq = 1) reads every K/V byte for 4 * D
// FLOPs per key: ~1 FLOP per byte, bound by memory bytes.
//
// Design: three kernels.
//  * join_tc_kernel (join_attention.cuh, tensor cores): Sq > 1 with a
//    16-bit q, D 64 or 128 -- the join layers of every 16-bit path.
//  * join_tiled_kernel (join_attention.cuh, CUDA cores): float32 q, other
//    head dims, and Sq = 1 with int8 K/V.  The query-segment K/V seeds the
//    online softmax, then the doc tiles follow up to dlen[b].
//  * join_attention_row_kernel (Sq = 1 with float K/V, the CLS-only final
//    layer): one block of 128 threads per (head, batch row), parallel over
//    keys so 12 * B blocks still fill the card.  Threads score strided
//    keys into shared memory, the block reduces the max and the sum, and
//    the P.V product runs with threads split over (D, key group) so V
//    reads are coalesced.  An exact two-pass softmax over the same masked
//    keys.
#include "join_attention.cuh"

namespace {

constexpr int kRowThreads = 128;

// Block-wide max (is_max) or sum of one value per thread; red holds one
// float per warp.
__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = is_max ? rt::warp_max(x) : rt::warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kRowThreads / 32; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads)
join_attention_row_kernel(const T* __restrict__ q, const T* __restrict__ kq,
                          const T* __restrict__ vq, const T* __restrict__ kd,
                          const T* __restrict__ vd, T* __restrict__ o,
                          const int* __restrict__ dlen, const uint8_t* __restrict__ kq_valid,
                          const uint8_t* __restrict__ kd_valid, int Hq, int Hkv, int Lq,
                          int Ld, rt::BHS qs, rt::BHS kqs, rt::BHS vqs, rt::BHS kds,
                          rt::BHS vds, rt::BHS os, float scale) {
  constexpr int G = kRowThreads / D;   // key groups in the P.V product
  extern __shared__ float smem[];
  float* qsh = smem;                    // [D]
  float* part = qsh + D;                // [G * D]
  float* red = part + G * D;            // [kRowThreads / 32]
  float* s = red + kRowThreads / 32;    // [Lq + Ld]

  const int b = blockIdx.y, h = blockIdx.x;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int n = Lq + min(dlen[b], Ld);
  const T* kqp = kq + b * kqs.b + hk * kqs.h;
  const T* kdp = kd + b * kds.b + hk * kds.h;
  const uint8_t* qval = kq_valid + (long long)b * Lq;
  const uint8_t* dval = kd_valid + (long long)b * Ld;

  for (int d = tid; d < D; d += kRowThreads) qsh[d] = rt::to_f32(q[b * qs.b + h * qs.h + d]);
  __syncthreads();

  float m_loc = rt::kNegInf;
  for (int j = tid; j < n; j += kRowThreads) {
    const bool in_q = j < Lq;
    const T* kr = in_q ? kqp + (long long)j * kqs.s : kdp + (long long)(j - Lq) * kds.s;
    const bool ok = in_q ? qval[j] != 0 : dval[j - Lq] != 0;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) dot = fmaf(qsh[d], rt::to_f32(kr[d]), dot);
    const float sj = ok ? dot * scale : rt::kNegInf;
    s[j] = sj;
    m_loc = fmaxf(m_loc, sj);
  }
  const float m = block_reduce(m_loc, red, true);
  float l_loc = 0.f;
  for (int j = tid; j < n; j += kRowThreads) {
    const float p = expf(s[j] - m);
    s[j] = p;
    l_loc += p;
  }
  const float l = block_reduce(l_loc, red, false);   // syncs: s is complete

  const int d = tid % D, g = tid / D;
  const T* vqp = vq + b * vqs.b + hk * vqs.h + d;
  const T* vdp = vd + b * vds.b + hk * vds.h + d;
  float acc = 0.f;
  for (int j = g; j < n; j += G) {
    const float vj = rt::to_f32(j < Lq ? vqp[(long long)j * vqs.s] : vdp[(long long)(j - Lq) * vds.s]);
    acc = fmaf(s[j], vj, acc);
  }
  part[g * D + d] = acc;
  __syncthreads();
  if (tid < D) {
    float out = 0.f;
    for (int gg = 0; gg < G; ++gg) out += part[gg * D + tid];
    o[b * os.b + h * os.h + tid] = rt::from_f32<T>(out / fmaxf(l, 1e-30f));
  }
}

}  // namespace

// Dense entry: float doc K/V of q's type, or raw int8 doc K/V (kd_dtype
// kI8) with per-token scales kd_scale / vd_scale [B, Ld].  *kernel is set
// to 1 when the call went to join_tc_kernel, 0 for join_tiled_kernel.
extern "C" int rt_join_attention(const void* q, const void* kq, const void* vq, const void* kd,
                                 const void* vd, void* o, const void* dlen, const void* kq_valid,
                                 const void* kd_valid, const void* kd_scale,
                                 const void* vd_scale, int dtype, int kd_dtype, int B, int Hq,
                                 int Hkv, int Sq, int Lq, int Ld, int D, long long qsb,
                                 long long qsh, long long qss, long long kqsb, long long kqsh,
                                 long long kqss, long long vqsb, long long vqsh, long long vqss,
                                 long long kdsb, long long kdsh, long long kdss, long long vdsb,
                                 long long vdsh, long long vdss, long long osb, long long osh,
                                 long long oss, float scale, void* stream, int* kernel) {
  rt::JoinArgs a{q, kq, vq, o, (const int*)dlen, (const uint8_t*)kq_valid, B, Hq, Hkv, Sq, Lq,
                 D, {qsb, qsh, qss}, {kqsb, kqsh, kqss}, {vqsb, vqsh, vqss}, {osb, osh, oss},
                 scale};
  a.doc = rt::DocSeg{kd, vd, (const float*)kd_scale, (const float*)vd_scale,
                     (const uint8_t*)kd_valid, nullptr, 0, 0, Ld,
                     {kdsb, kdsh, kdss}, {vdsb, vdsh, vdss}};
  const bool quant = kd_dtype == rt::kI8;
  if (!rt::join_args_ok(a) || (quant && (!kd_scale || !vd_scale)) ||
      (!quant && kd_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case rt::kF32:
      return quant ? rt::launch_join<float, int8_t, false>(a, s, kernel)
                   : rt::launch_join<float, float, false>(a, s, kernel);
    case rt::kBF16:
      return quant ? rt::launch_join<__nv_bfloat16, int8_t, false>(a, s, kernel)
                   : rt::launch_join<__nv_bfloat16, __nv_bfloat16, false>(a, s, kernel);
    case rt::kF16:
      return quant ? rt::launch_join<__half, int8_t, false>(a, s, kernel)
                   : rt::launch_join<__half, __half, false>(a, s, kernel);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rt_join_attention_row(const void* q, const void* kq, const void* vq,
                                     const void* kd, const void* vd, void* o, const void* dlen,
                                     const void* kq_valid, const void* kd_valid, int dtype, int B,
                                     int Hq, int Hkv, int Sq, int Lq, int Ld, int D,
                                     long long qsb, long long qsh, long long qss, long long kqsb,
                                     long long kqsh, long long kqss, long long vqsb,
                                     long long vqsh, long long vqss, long long kdsb,
                                     long long kdsh, long long kdss, long long vdsb,
                                     long long vdsh, long long vdss, long long osb,
                                     long long osh, long long oss, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq != 1 || Lq < 0 || Ld < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hq, B);
  const rt::BHS qs{qsb, qsh, qss}, kqs{kqsb, kqsh, kqss}, vqs{vqsb, vqsh, vqss},
      kds{kdsb, kdsh, kdss}, vds{vdsb, vdsh, vdss}, os{osb, osh, oss};
  const size_t smem = sizeof(float) * (D + kRowThreads + kRowThreads / 32 + Lq + Ld);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, DD)                                                                        \
  do {                                                                                       \
    cudaFuncSetAttribute(join_attention_row_kernel<T, DD>,                                   \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);            \
    join_attention_row_kernel<T, DD><<<grid, kRowThreads, smem, s>>>(                        \
        (const T*)q, (const T*)kq, (const T*)vq, (const T*)kd, (const T*)vd, (T*)o,          \
        (const int*)dlen, (const uint8_t*)kq_valid, (const uint8_t*)kd_valid, Hq, Hkv, Lq,   \
        Ld, qs, kqs, vqs, kds, vds, os, scale);                                              \
  } while (0)
  RT_DISPATCH(dtype, D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
