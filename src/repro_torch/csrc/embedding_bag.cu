// EmbeddingBag gather-reduce for Hopper (sm_90a): the embedding lookups of
// the recsys models (DLRM, DeepFM, xDeepFM).
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py, embedding_bag_pallas
// (_bag_kernel).
//
//   out[b, :] = sum_j row(ids[b, j]) * w[b, j]     float32 accumulator
//   mean:       out[b, :] /= max(sum_j w[b, j], 1)
//   then one rounding to the output type.
//
// Pads carry weight 0 and still read row ids[b, j], as the Pallas kernel
// does.  No weights (nullptr) means weight 1 in every slot.  row(i) is
// table[i] converted to the output type and widened to float32 again:
// exact when the output is the table's type; with a float32 table and
// bf16 output (the one other form taken) it is the rounding of the
// models' `table.astype(bf16)` before their gather, so the cast table is
// never written.  A bag
// of one with weight 1 is then bit-equal to the cast followed by the
// gather.  An id outside [0, rows) reads nothing and makes its slot NaN
// (jnp.take's fill), so no id can fault the card.
//
// Bound: bytes.  A bag reads up to nnz rows of dim elements, its ids and
// weights, and writes one row; 2 FLOPs an element read.  Row addresses are
// 64-bit: DLRM-MLPerf's fused table has 1.9e8 rows of 128, 2.4e10
// elements.
//
// Design: one warp per bag.  The warp's lanes form G = 32 / L groups of L
// lanes, L = min(32, next power of two >= dim).  A group reads one row:
// its lane c reads columns c, c + L, ... (K = ceil(dim / L) of them, held
// in registers), so neighbouring lanes read neighbouring addresses.  The
// G groups take the bag's slots j = g, g + G, ..., and their partial sums
// meet through xor shuffles at the end.  At dim 128 one group is the whole
// warp (K = 4); at dim 10 two groups of 16 lanes read two rows at once; at
// dim 1 (DeepFM's first-order weights) 32 one-lane groups read 32 slots at
// once.
#include <limits.h>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 8;    // bags per block
constexpr int kMaxK = 8;     // columns per lane: dim <= 32 * kMaxK

template <typename T, typename OutT>
__device__ __forceinline__ float load_elt(const T* p) {
  const float x = rt::to_f32(*p);
  if constexpr (sizeof(OutT) < sizeof(T)) {
    return rt::to_f32(rt::from_f32<OutT>(x));
  } else {
    return x;
  }
}

template <typename T, typename OutT, typename IdT, int K>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const T* __restrict__ table, const IdT* __restrict__ ids,
                     const float* __restrict__ weights, OutT* __restrict__ out,
                     long long rows, int dim, long long n_bags, int nnz, int L, int mean) {
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int G = 32 / L;
  const int g = lane / L, c0 = lane - g * L;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  float wsum = 0.f;
  const IdT* bag_ids = ids + bag * nnz;
  const float* bag_w = weights != nullptr ? weights + bag * nnz : nullptr;
  for (int j = g; j < nnz; j += G) {
    const long long id = (long long)bag_ids[j];
    const float w = bag_w != nullptr ? bag_w[j] : 1.f;
    wsum += w;
    if (id < 0 || id >= rows) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    const T* row = table + id * (long long)dim;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k * L;
      if (c < dim) acc[k] = fmaf(load_elt<T, OutT>(row + c), w, acc[k]);
    }
  }
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
  }
  if (g != 0) return;
  const float denom = mean ? fmaxf(wsum, 1.f) : 1.f;
  OutT* orow = out + bag * (long long)dim;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + k * L;
    if (c < dim) orow[c] = rt::from_f32<OutT>(mean ? acc[k] / denom : acc[k]);
  }
}

template <typename T, typename OutT, typename IdT>
int launch(const void* table, const void* ids, const void* weights, void* out, long long rows,
           int dim, long long n_bags, int nnz, int mean, cudaStream_t s) {
  int L = 1;
  while (L < dim && L < 32) L <<= 1;
  const int K = (dim + L - 1) / L;
  const dim3 grid((unsigned)((n_bags + kWarps - 1) / kWarps));
#define LAUNCH(KK)                                                                         \
  embedding_bag_kernel<T, OutT, IdT, KK><<<grid, kWarps * 32, 0, s>>>(                     \
      (const T*)table, (const IdT*)ids, (const float*)weights, (OutT*)out, rows, dim, n_bags, \
      nnz, L, mean)
  if (K <= 1) LAUNCH(1);
  else if (K <= 2) LAUNCH(2);
  else if (K <= 4) LAUNCH(4);
  else if (K <= kMaxK) LAUNCH(kMaxK);
  else return (int)cudaErrorInvalidValue;
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <typename T, typename OutT>
int launch_ids(int ids_64, const void* table, const void* ids, const void* weights, void* out,
               long long rows, int dim, long long n_bags, int nnz, int mean, cudaStream_t s) {
  return ids_64 ? launch<T, OutT, long long>(table, ids, weights, out, rows, dim, n_bags, nnz,
                                             mean, s)
                : launch<T, OutT, int>(table, ids, weights, out, rows, dim, n_bags, nnz, mean, s);
}

}  // namespace

// table [rows, dim] (kF32 or kBF16), ids [n_bags, nnz] (int32, or int64 with
// ids_64), weights [n_bags, nnz] float32 or nullptr, out [n_bags, dim] in
// the table's type, or kBF16 from a kF32 table; mean: 0 sums, 1 divides by
// max(sum of weights, 1).
extern "C" int rt_embedding_bag(const void* table, const void* ids, const void* weights,
                                void* out, int table_dtype, int out_dtype, int ids_64,
                                long long rows, int dim, long long n_bags, int nnz, int mean,
                                void* stream) {
  if (rows <= 0 || dim <= 0 || dim > 32 * kMaxK || n_bags <= 0 || nnz < 0 ||
      (n_bags + kWarps - 1) / kWarps > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_dtype == rt::kF32 && out_dtype == rt::kF32)
    return launch_ids<float, float>(ids_64, table, ids, weights, out, rows, dim, n_bags, nnz,
                                    mean, s);
  if (table_dtype == rt::kF32 && out_dtype == rt::kBF16)
    return launch_ids<float, __nv_bfloat16>(ids_64, table, ids, weights, out, rows, dim, n_bags,
                                            nnz, mean, s);
  if (table_dtype == rt::kBF16 && out_dtype == rt::kBF16)
    return launch_ids<__nv_bfloat16, __nv_bfloat16>(ids_64, table, ids, weights, out, rows, dim,
                                                    n_bags, nnz, mean, s);
  return (int)cudaErrorInvalidValue;
}
