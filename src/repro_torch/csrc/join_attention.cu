// Split-KV join attention for PreTTR's query-time join, for Hopper (sm_90a):
// the dense entry.  The paged entry is join_attention_paged.cu, the CLS
// row (Sq = 1 with float doc K/V) join_attention_row.cu.
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
// the tensor cores.
//
// Design: two kernels.
//  * join_tc_kernel (join_attention.cuh, tensor cores): Sq > 1 with a
//    16-bit q, D 64 or 128 -- the join layers of every 16-bit path.
//  * join_tiled_kernel (join_attention.cuh, CUDA cores): float32 q, other
//    head dims, and Sq = 1 with int8 K/V.  The query-segment K/V seeds the
//    online softmax, then the doc tiles follow up to dlen[b].
#include "join_attention.cuh"

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
