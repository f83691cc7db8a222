// Split-KV join attention with the doc segment read straight out of the
// device doc cache's token-page pools, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/join_attention/kernel.py,
// join_attention_pallas_paged (_paged_shim).
//
// The same attention as the dense entry (join_attention.cu), with doc K/V
// read from [P, page, Hkv, D] pools through a [B, n_pages] page table:
// key pos of row b is row pos % page of pool page page_table[b, pos / page].
// Validity comes from a [P, page] byte pool (page 0 of the cache is all
// zero, so page-table tails mask themselves), and int8 pools carry
// [P, page, 1] float32 scale pools.  The pools may hold int8, float16,
// bfloat16 or float32 whatever q's type: PreTTR's service feeds float16
// cache pools to a bfloat16 join.  No dense per-batch K/V copy is made.
//
// Bound on the H100: as the dense entry's (about 100-200 FLOPs per byte
// of doc K/V read once, below the bf16 tensor-core ridge): memory bytes
// bound the 16-bit forms, which run on join_tc_kernel; float32 q and
// float32 pools under a 16-bit q run on join_tiled_kernel (CUDA cores).
// The page-table indirection costs one integer division and one
// page-table load per key per tile (join_attention.cuh).
//
// The pool-type dispatch of each q type is compiled in a translation unit
// of its own (this file: float32; join_attention_paged_bf16.cu,
// join_attention_paged_f16.cu), so the parallel build compiles the three
// sets of instantiations at once (join_attention_paged.cuh).
#include "join_attention_paged.cuh"

template int rt::dispatch_paged_pool<float>(int, const rt::JoinArgs&, cudaStream_t, int*);

// q, kq, vq, out as the dense entry; k_pool / v_pool [P, page, Hkv, D]
// contiguous; page_table [B, n_pages] int32; dval_pool [P, page] bytes;
// k/v_scale_pool [P, page] float32 (int8 pools only); dlen [B].  *kernel
// is set to 1 when the call went to join_tc_kernel, 0 for
// join_tiled_kernel.
extern "C" int rt_join_attention_paged(const void* q, const void* kq, const void* vq,
                                       const void* k_pool, const void* v_pool, void* o,
                                       const void* dlen, const void* kq_valid,
                                       const void* page_table, const void* dval_pool,
                                       const void* k_scale_pool, const void* v_scale_pool,
                                       int dtype, int kd_dtype, int B, int Hq, int Hkv, int Sq,
                                       int Lq, int n_pages, int page, int D, long long qsb,
                                       long long qsh, long long qss, long long kqsb,
                                       long long kqsh, long long kqss, long long vqsb,
                                       long long vqsh, long long vqss, long long osb,
                                       long long osh, long long oss, float scale,
                                       void* stream, int* kernel) {
  rt::JoinArgs a{q, kq, vq, o, (const int*)dlen, (const uint8_t*)kq_valid, B, Hq, Hkv, Sq, Lq,
                 D, {qsb, qsh, qss}, {kqsb, kqsh, kqss}, {vqsb, vqsh, vqss}, {osb, osh, oss},
                 scale};
  a.doc = rt::DocSeg{k_pool, v_pool, (const float*)k_scale_pool, (const float*)v_scale_pool,
                     (const uint8_t*)dval_pool, (const int*)page_table, page, n_pages,
                     n_pages * page, {0, 0, 0}, {0, 0, 0}};
  const bool quant = kd_dtype == rt::kI8;
  if (!rt::join_args_ok(a) || page <= 0 || n_pages <= 0 ||
      (quant && (!k_scale_pool || !v_scale_pool)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case rt::kF32: return rt::dispatch_paged_pool<float>(kd_dtype, a, s, kernel);
    case rt::kBF16: return rt::dispatch_paged_pool<__nv_bfloat16>(kd_dtype, a, s, kernel);
    case rt::kF16: return rt::dispatch_paged_pool<__half>(kd_dtype, a, s, kernel);
    default: return (int)cudaErrorInvalidValue;
  }
}
