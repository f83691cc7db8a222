// Flash attention with the PreTTR split mask, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/split_attention/kernel.py,
// flash_attention_pallas (_attn_kernel), in its validity + seg_boundary
// form (causal, window and int8 K/V wait for the LM slice).
//
// Computes, per (b, h, query row i): softmax over the keys j with
// j < lengths[b], k_valid[b, j], and (when seg_boundary >= 0) i and j on
// the same side of seg_boundary, of q.k / sqrt(D), times V.  GQA head h
// reads KV head h / (Hq / Hkv).
//
// Bound on the H100: at the main-path shapes (precompute_docs
// [64, 12, 480, 64] bf16, encode_query [1, 12, 32, 64]) the work is
// 4 * D FLOPs per (row, valid key) against 2 bytes per element read once,
// about 90 FLOPs per byte at Skv = 480: below the bf16 tensor-core ridge
// (~295), above the float32 CUDA-core ridge (~20).  This first kernel runs
// float32 FMAs on CUDA cores, so it is bound by float32 operations.
//
// Design: one block of 128 threads per (q-tile, head, batch row); each
// query row is held by D / 16 lanes (attention_common.cuh), 32 rows per
// block at D = 64.  The TPU grid's sequential KV axis becomes a loop inside
// the block over 32-key K/V tiles staged in shared memory as float32 (the
// rows of a warp read the same key, so the reads broadcast).  Tiles past
// lengths[b] end the loop; tiles wholly on the other side of seg_boundary
// from the whole q-tile are skipped.  The kernel masks its own ragged
// edges, so the wrapper pads nothing.  Tensor cores (wgmma), TMA and
// register tiling over several rows per lane are the next steps.
#include "attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads)
split_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ lengths,
                       const uint8_t* __restrict__ k_valid, int Hq, int Hkv,
                       int Sq, int Skv, rt::BHS qs, rt::BHS ks_, rt::BHS vs_,
                       rt::BHS os, int seg_boundary, float scale) {
  constexpr int TPR = rt::Geo<D>::TPR, ROWS = rt::Geo<D>::ROWS;
  __shared__ __align__(16) float ks[rt::kBlockK * D];
  __shared__ __align__(16) float vs[rt::kBlockK * D];
  __shared__ int kside[rt::kBlockK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int t = threadIdx.x % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int qi = q0 + threadIdx.x / TPR;
  const bool active = qi < Sq;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + ROWS, Sq) - 1;
  const int row_side = (seg_boundary >= 0 && qi >= seg_boundary) ? 1 : 0;

  rt::RowState st;
  rt::load_row<T, D>(st, q + b * qs.b + h * qs.h + (long long)qi * qs.s, t, active);

  const T* kp = k + b * ks_.b + hk * ks_.h;
  const T* vp = v + b * vs_.b + hk * vs_.h;
  const uint8_t* valid = k_valid + (long long)b * Skv;
  const int len = min(lengths[b], Skv);
  for (int k0 = 0; k0 < len; k0 += rt::kBlockK) {
    const int n = min(rt::kBlockK, Skv - k0);
    if (seg_boundary >= 0) {           // whole tile on the other side?
      const bool q_lo = q0 >= seg_boundary, q_hi = q_last >= seg_boundary;
      const bool k_lo = k0 >= seg_boundary, k_hi = k0 + n - 1 >= seg_boundary;
      if (q_lo == q_hi && k_lo == k_hi && q_lo != k_lo) continue;
    }
    __syncthreads();                    // previous tile fully consumed
    rt::stage_tile<T, D>(kp, vp, ks_.s, vs_.s, k0, n, valid, len, seg_boundary, ks, vs, kside);
    __syncthreads();
    rt::fold_tile<D>(st, ks, vs, kside, n, row_side, t, scale);
  }
  if (active) rt::store_row<T, D>(st, o + b * os.b + h * os.h + (long long)qi * os.s, t);
}

}  // namespace

extern "C" int rt_split_attention(const void* q, const void* k, const void* v, void* o,
                                  const void* lengths, const void* k_valid, int dtype,
                                  int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                  long long qsb, long long qsh, long long qss,
                                  long long ksb, long long ksh, long long kss,
                                  long long vsb, long long vsh, long long vss,
                                  long long osb, long long osh, long long oss,
                                  int seg_boundary, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const rt::BHS qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, DD)                                                                    \
  do {                                                                                   \
    constexpr int rows = rt::Geo<DD>::ROWS;                                              \
    const dim3 grid((Sq + rows - 1) / rows, Hq, B);                                      \
    split_attention_kernel<T, DD><<<grid, rt::kThreads, 0, s>>>(                         \
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (const int*)lengths,               \
        (const uint8_t*)k_valid, Hq, Hkv, Sq, Skv, qs, ks, vs, os, seg_boundary, scale); \
  } while (0)
  RT_DISPATCH(dtype, D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
