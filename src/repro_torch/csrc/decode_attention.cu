// Flash decode: one query row per query head against a K/V sequence, for
// Hopper (sm_90a), through the split-KV kernel of decode_attention.cuh.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// flash_decode_pallas (_decode_kernel), the whole contract: GQA groups,
// lengths, non-prefix validity and the sliding window.  The kernel, its
// bound and its design are described in decode_attention.cuh.
#include "decode_attention.cuh"

// q, out: [B, Hq, 1, D] with (batch, head) strides; k, v: [B, Hkv, S, D]
// with (batch, head, seq) strides; lengths [B] int32 or null (every row
// S); k_valid [B, S] bytes or null (every key in range valid); partial:
// float32 [B, Hq, n_splits, D + 2] scratch, null when n_splits is 1;
// align, max_splits, block_rows: the planner's copies of the kernel's
// constants (plan_agrees).  *launched is set to the kernels launched: 1,
// or 2 with the merge.
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   const void* lengths, const void* k_valid, void* partial,
                                   int dtype, int B, int Hq, int Hkv, int S, int D,
                                   long long qsb, long long qsh, long long ksb, long long ksh,
                                   long long kss, long long vsb, long long vsh, long long vss,
                                   long long osb, long long osh, int window, int n_splits,
                                   int align, int max_splits, int block_rows, float scale,
                                   void* stream, int* launched) {
  *launched = 0;
  if (!rt::sq1::plan_agrees(align, max_splits, block_rows) || B <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  const rt::BHS ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
#define RT_DECODE(T)                                                                          \
  do {                                                                                        \
    const int elt = (int)sizeof(T);                                                           \
    const rt::sq1::OneSeq<T> keys{(const T*)k, (const T*)v, ks, vs, (const int*)lengths,     \
                                  (const uint8_t*)k_valid, S, window};                        \
    const bool vec = rt::sq1::rows_aligned(k, ks, elt) && rt::sq1::rows_aligned(v, vs, elt);  \
    const rt::sq1::Rows<T> rows{(const T*)q, (T*)o, (float*)partial, qsb, qsh, osb, osh, Hq,  \
                                Hq / Hkv, 1, n_splits, vec, scale};                           \
    return rt::sq1::launch<T>(keys, rows, D, Hkv, B, s, launched);                            \
  } while (0)
  switch (dtype) {
    case rt::kF32: RT_DECODE(float);
    case rt::kBF16: RT_DECODE(__nv_bfloat16);
    case rt::kF16: RT_DECODE(__half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_DECODE
  return (int)cudaErrorInvalidValue;
}
