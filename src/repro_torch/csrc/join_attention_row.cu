// The join's CLS row (Sq = 1, float doc K/V), for Hopper (sm_90a), through
// the split-KV kernel of decode_attention.cuh: PreTTR's CLS-only final
// layer over the query segment and the doc segment, never concatenated.
//
// Replaces: src/repro/kernels/join_attention/kernel.py,
// join_attention_pallas (_join_kernel) at Sq = 1 with float doc K/V.  The
// other forms are join_attention.cu's and join_attention_paged.cu's.  The
// kernel reads kd_valid itself: masked keys are never read, and a warp
// whose keys of a tile are all masked skips the tile's arithmetic.
#include "decode_attention.cuh"

// q, out: [B, Hq, 1, D] with (batch, head) strides; kq, vq: [B, Hkv, Lq, D]
// and kd, vd: [B, Hkv, Ld, D] with (batch, head, seq) strides; kq_valid
// [B, Lq] and kd_valid [B, Ld] bytes, each or null (all valid); partial:
// float32 [B, Hq, n_splits, D + 2] scratch, null when n_splits is 1;
// align, max_splits, block_rows: the planner's copies of the kernel's
// constants (plan_agrees).  *launched is set to the kernels launched: 1,
// or 2 with the merge.
extern "C" int rt_join_attention_row(const void* q, const void* kq, const void* vq,
                                     const void* kd, const void* vd, void* o,
                                     const void* kq_valid, const void* kd_valid, void* partial,
                                     int dtype, int B, int Hq, int Hkv, int Lq, int Ld, int D,
                                     long long qsb, long long qsh, long long kqsb,
                                     long long kqsh, long long kqss, long long vqsb,
                                     long long vqsh, long long vqss, long long kdsb,
                                     long long kdsh, long long kdss, long long vdsb,
                                     long long vdsh, long long vdss, long long osb,
                                     long long osh, int n_splits, int align, int max_splits,
                                     int block_rows, float scale, void* stream, int* launched) {
  *launched = 0;
  if (!rt::sq1::plan_agrees(align, max_splits, block_rows) || B <= 0 || Hq <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0 || Lq < 0 || Ld < 0)
    return (int)cudaErrorInvalidValue;
  const rt::BHS kqs{kqsb, kqsh, kqss}, vqs{vqsb, vqsh, vqss}, kds{kdsb, kdsh, kdss},
      vds{vdsb, vdsh, vdss};
  cudaStream_t s = (cudaStream_t)stream;
#define RT_JOIN_ROW(T)                                                                         \
  do {                                                                                         \
    const int elt = (int)sizeof(T);                                                            \
    const rt::sq1::JoinSeqs<T> keys{(const T*)kq, (const T*)vq, (const T*)kd, (const T*)vd,   \
                                    kqs, vqs, kds, vds, (const uint8_t*)kq_valid,              \
                                    (const uint8_t*)kd_valid, Lq, Ld};                         \
    const bool vec = rt::sq1::rows_aligned(kq, kqs, elt) && rt::sq1::rows_aligned(vq, vqs, elt) && \
                     rt::sq1::rows_aligned(kd, kds, elt) && rt::sq1::rows_aligned(vd, vds, elt);   \
    const rt::sq1::Rows<T> rows{(const T*)q, (T*)o, (float*)partial, qsb, qsh, osb, osh, Hq,   \
                                Hq / Hkv, 1, n_splits, vec, scale};                            \
    return rt::sq1::launch<T>(keys, rows, D, Hkv, B, s, launched);                             \
  } while (0)
  switch (dtype) {
    case rt::kF32: RT_JOIN_ROW(float);
    case rt::kBF16: RT_JOIN_ROW(__nv_bfloat16);
    case rt::kF16: RT_JOIN_ROW(__half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_JOIN_ROW
  return (int)cudaErrorInvalidValue;
}
