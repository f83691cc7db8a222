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
// never written.  A bag of one with weight 1 is then bit-equal to the cast
// followed by the gather.  An id outside [0, rows) reads nothing and makes
// its bag NaN (jnp.take's fill), so no id can fault the card.  Row
// addresses are 64-bit: DLRM-MLPerf's fused table has 1.9e8 rows of 128,
// 2.4e10 elements.
//
// Bound.  A bag reads nnz rows, its ids and weights, and writes one row; 2
// FLOPs an element read, far under any peak.  HBM bytes bound every route:
// each distinct row, the ids, the weights and the output once, over 3.35
// TB/s.  The L2 gives no tighter floor.  Each of those bytes passes it at
// least once (a distinct row as its 32-byte sectors), but nothing forces a
// second pass: a kernel that took all bags of one id on one SM would read
// that row from the L2 once.  So the L2's floor, those bytes over its peak
// rate (tools/gather_rate.cu), stays below the HBM bound.  These kernels
// take bags in order, and every SM that meets a zipf-hot row reads it from
// the L2 again: that, not the floor, is what their time pays.
//
// Three kernels; the C entry routes on the row's bytes and the pointers'
// alignment and reports the one it ran:
// - embedding_bag_wide_kernel: rows of a multiple of 16 bytes from a
//   16-byte aligned table (bf16 or float32 x 128).  G lanes a row (the
//   least power of two with G K >= R, R = row bytes / 16), each lane moving
//   16 bytes a load: lane `sub` of a group holds the row's 16-byte words
//   sub + k G, k < K (K = 2 for float32 rows over 512 bytes, else 1); the
//   warp's 32 / G groups take 32 / G bags at once, U bags each for bags of
//   one.  A bf16 row of 128 is 16 lanes, two bags a warp instruction.
// - embedding_bag_narrow_kernel: rows of at most 64 bytes, a multiple of 8
//   (or of at most 32, a multiple of 4), from a table aligned to that, such
//   as DeepFM's 40-byte float32 rows and its 4-byte first-order weights.
//   A warp's tile of bags is one flat span of row words (8 or 4 bytes):
//   lane l takes words l + 32 i, so neighbouring lanes load neighbouring
//   words of a row and store neighbouring words of the output, and a 5-word
//   row idles no lane (a lane group a row would idle 3 of 8).
// - embedding_bag_kernel: everything else (no slots, odd dims, unaligned
//   tables such as a contiguous view one element into its storage): one
//   warp a bag, the first version of this file, unchanged.
//
// Shared by the two routed kernels:
// - A persistent grid: min(tiles / 8, SMs x resident blocks) blocks of 8
//   warps; each warp walks tiles of contiguous bags, tile += the grid's
//   warps.  Few bags give one tile a warp.
// - Ids ahead of rows: a warp stages its tile's ids and weights in chunks
//   of J slots (a power of two) x the tile's bags, at most kStage entries,
//   into shared memory with cp.async, the next chunk (or the next tile's
//   first) in flight while the current chunk's rows load: no registers
//   hold ids in flight.
// - Rows in flight: a lane loads U bags' (wide) or K words' (narrow) rows
//   of a slot, or S slots of one bag, before its first FMA; U, K and S are
//   set by how many registers the 64 a thread (4 blocks of 256 an SM)
//   leave for rows in flight and accumulators, without spills.
// - Fixed order: every output column is one lane's fmaf chain over its
//   bag's slots j = 0 .. nnz - 1 (no lanes split a bag's slots), so the
//   result does not depend on the grid or the card, repeats bit for bit,
//   and a bag of one is its row.
// - Plain output stores and register loads: the evict-first hint
//   (st.global.cs), an L2 evict-last policy on table loads, and whole wide
//   rows copied by cp.async.bulk (TMA) into a shared-memory ring were
//   tried and not kept: none was faster.
#include <limits.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// embedding_bag_kernel: one warp a bag (odd dims, unaligned tables)
// ---------------------------------------------------------------------------
//
// The warp's lanes form G = 32 / L groups of L lanes, L = min(32, next
// power of two >= dim).  A group reads one row: its lane c reads columns
// c, c + L, ... (K = ceil(dim / L) of them, held in registers), so
// neighbouring lanes read neighbouring addresses.  The G groups take the
// bag's slots j = g, g + G, ..., and their partial sums meet through xor
// shuffles at the end.

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

// ---------------------------------------------------------------------------
// The routed kernels: embedding_bag_wide_kernel, embedding_bag_narrow_kernel
// ---------------------------------------------------------------------------

constexpr int kVecWarps = 8;           // warps a block
constexpr int kMinBlocks = 4;          // blocks an SM the registers must allow (64 a thread)
constexpr int kWideBytes = 16;         // a wide lane's load
constexpr int kNarrowMaxBytes = 64;    // a narrow row with 8-byte loads; 32 with 4-byte ones
constexpr int kStage = 256;            // (bag, slot) entries of a staged chunk, a warp
// a lane's registers: rows in flight (32-bit words; bags of one, longer
// bags) and accumulators (wide, narrow), at most
constexpr int kOneRawWords = 8, kRawWords = 16;
constexpr int kAccFloats = 16, kNarrowAccFloats = 8;
// what the C entry reports through its last argument
constexpr int kRanGeneric = 0, kRanWide = 1, kRanNarrow = 2;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The V bytes at p as 32-bit words, through the read-only path.
template <int V>
__device__ __forceinline__ void load_words(const void* p, unsigned (&w)[V / 4]) {
  if constexpr (V == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (V == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    static_assert(V == 4, "loads are 4, 8 or 16 bytes");
    w[0] = __ldg(static_cast<const unsigned*>(p));
  }
}

// Element e of the loaded words as row() gives it: widened to float32,
// rounded through the output type first when that is the narrower.
template <typename T, typename OutT>
__device__ __forceinline__ float word_elt(const unsigned* w, int e) {
  float x;
  if constexpr (sizeof(T) == 4) {
    x = __uint_as_float(w[e]);
  } else {  // bf16: element 0 in the low half of word 0
    x = __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16));
  }
  if constexpr (sizeof(OutT) < sizeof(T)) x = rt::to_f32(rt::from_f32<OutT>(x));
  return x;
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(rt::from_f32<__nv_bfloat16>(x));
}

// EL float32 values as EL output elements, in one store.
template <typename OutT, int EL>
__device__ __forceinline__ void store_vec(OutT* p, const float (&v)[EL]) {
  if constexpr (sizeof(OutT) == 4) {
    unsigned u[EL];
#pragma unroll
    for (int e = 0; e < EL; ++e) u[e] = __float_as_uint(v[e]);
    if constexpr (EL == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (EL == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<unsigned*>(p) = u[0];
  } else if constexpr (EL == 1) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(v[0]);
  } else {  // bf16, two to a word
    unsigned u[EL / 2];
#pragma unroll
    for (int e = 0; e < EL / 2; ++e) u[e] = bf16_bits(v[2 * e]) | bf16_bits(v[2 * e + 1]) << 16;
    if constexpr (EL == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (EL == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<unsigned*>(p) = u[0];
  }
}

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* global) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(global), "n"(N)
               : "memory");
}

// A warp's two staged chunks in shared memory (the one read, the one in
// flight): ids of 4 or 8 bytes, and weights.
struct Staged {
  long long id[2][kStage];
  float w[2][kStage];
};

// Copy chunk c of the tile whose first bag is bag0 (tb bags) into buffer
// `buf`: entry e is slot c J + e % J of the tile's bag e / J.  One commit
// group a call.
__device__ __forceinline__ void stage_chunk(Staged& st, int buf, const void* ids, int ids_64,
                                            const float* weights, long long bag0, int tb, int c,
                                            int jshift, long long n_bags, int nnz, int lane) {
  const int J = 1 << jshift, n_entries = tb << jshift;
  for (int e = lane; e < n_entries; e += 32) {
    const long long bag = bag0 + (e >> jshift);
    const int j = (c << jshift) + (e & (J - 1));
    if (bag < n_bags && j < nnz) {
      const long long at = bag * nnz + j;
      if (ids_64)
        cp_async<8>(&st.id[buf][e], static_cast<const long long*>(ids) + at);
      else
        cp_async<4>(reinterpret_cast<int*>(st.id[buf]) + e, static_cast<const int*>(ids) + at);
      if (weights != nullptr) cp_async<4>(&st.w[buf][e], weights + at);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Start chunk c + 1 of this tile, or chunk 0 of the warp's next tile
// (next_bag0 < 0: none), then wait for chunk c; the warp's lanes then see
// each other's copies.
__device__ __forceinline__ void next_chunk(Staged& st, int buf, const void* ids, int ids_64,
                                           const float* weights, long long bag0,
                                           long long next_bag0, int tb, int c, int n_chunks,
                                           int jshift, long long n_bags, int nnz, int lane) {
  const bool last = c + 1 == n_chunks;
  if (!last || next_bag0 >= 0) {
    stage_chunk(st, buf ^ 1, ids, ids_64, weights, last ? next_bag0 : bag0, tb,
                last ? 0 : c + 1, jshift, n_bags, nnz, lane);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncwarp();
}

__device__ __forceinline__ long long staged_id(const Staged& st, int buf, int e, int ids_64) {
  return ids_64 ? st.id[buf][e] : (long long)reinterpret_cast<const int*>(st.id[buf])[e];
}

// embedding_bag_wide_kernel's warp: tiles of TB = 32 / G x U contiguous
// bags.  V: bytes a load; K: loads a lane holds of a row (its words sub + k
// G); U: bags a lane group sums at once; S: slots of a bag loaded before
// their FMAs.  gshift = log2 G, jshift = log2 J (slots a staged chunk).
template <typename T, typename OutT, int V, int K, int U, int S>
__device__ __forceinline__ void bag_tiles(const T* __restrict__ table, const void* __restrict__ ids,
                                          int ids_64, const float* __restrict__ weights,
                                          OutT* __restrict__ out, long long rows, int dim,
                                          long long n_bags, int nnz, int gshift, int jshift,
                                          int mean) {
  constexpr int EL = V / (int)sizeof(T);  // elements a load
  constexpr int W = V / 4;                // 32-bit words a load
  __shared__ __align__(16) Staged staged[kVecWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = 1 << gshift, NG = 32 >> gshift;  // lanes a row; bags a warp takes at once
  const int g = lane >> gshift, sub = lane & (G - 1);
  const int R = dim / EL;                         // loads a row
  const int TB = NG * U;                          // bags a tile
  const int J = 1 << jshift;
  const int n_chunks = (nnz + J - 1) >> jshift;
  const long long n_tiles = (n_bags + TB - 1) / TB;
  const long long stride = (long long)gridDim.x * kVecWarps;
  long long tile = (long long)blockIdx.x * kVecWarps + warp;
  if (tile >= n_tiles) return;  // the whole warp leaves together
  Staged& st = staged[warp];
  stage_chunk(st, 0, ids, ids_64, weights, tile * TB, TB, 0, jshift, n_bags, nnz, lane);
  int buf = 0;

  for (;;) {
    float acc[U][K][EL];
    float wsum[U];
    bool bad[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wsum[u] = 0.f;
      bad[u] = false;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[u][k][e] = 0.f;
    }
    const long long next = tile + stride < n_tiles ? (tile + stride) * TB : -1;
    for (int c = 0; c < n_chunks; ++c, buf ^= 1) {
      next_chunk(st, buf, ids, ids_64, weights, tile * TB, next, TB, c, n_chunks, jshift, n_bags,
                 nnz, lane);
      const int ns = min(J, nnz - (c << jshift));
      for (int s0 = 0; s0 < ns; s0 += S) {
        unsigned raw[U][S][K][W];
        float w[U][S];
        int state[U][S];  // 0: no slot, 1: a row, 2: an id outside the table
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int q = 0; q < S; ++q) {
            const int b = u * NG + g, s = s0 + q;
            const int e = (b << jshift) + s;
            state[u][q] = 0;
            w[u][q] = 0.f;
            if (s < ns && tile * TB + b < n_bags) {
              const long long id = staged_id(st, buf, e, ids_64);
              w[u][q] = weights != nullptr ? st.w[buf][e] : 1.f;
              state[u][q] = 2;
              if (id >= 0 && id < rows) {
                state[u][q] = 1;
                const T* row = table + id * (long long)dim;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                  const int cv = sub + k * G;
                  if (cv < R) load_words<V>(row + cv * EL, raw[u][q][k]);
                }
              }
            }
          }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int q = 0; q < S; ++q) {  // slot order
            if (state[u][q] == 0) continue;
            wsum[u] += w[u][q];
            if (state[u][q] == 2) {
              bad[u] = true;
              continue;
            }
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (sub + k * G < R)
#pragma unroll
                for (int e = 0; e < EL; ++e)
                  acc[u][k][e] = fmaf(word_elt<T, OutT>(raw[u][q][k], e), w[u][q], acc[u][k][e]);
          }
      }
      __syncwarp();  // done with this buffer before it is refilled
    }

#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long bag = tile * TB + u * NG + g;
      if (bag >= n_bags) continue;
      const float denom = mean ? fmaxf(wsum[u], 1.f) : 1.f;
      OutT* orow = out + bag * (long long)dim;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int cv = sub + k * G;
        if (cv >= R) continue;
        float v[EL];
#pragma unroll
        for (int e = 0; e < EL; ++e)
          v[e] = bad[u] ? __int_as_float(0x7fc00000) : mean ? acc[u][k][e] / denom : acc[u][k][e];
        store_vec<OutT, EL>(orow + cv * EL, v);
      }
    }
    tile += stride;
    if (tile >= n_tiles) break;
  }
}

// embedding_bag_narrow_kernel's warp: tiles of TB = 32 K / R contiguous
// bags whose rows (R loads of V bytes each) form one flat span of TB R <=
// 32 K words; lane l takes the span's words w = l + 32 i, i < K, which are
// word w % R of the rows of bag w / R.  Neighbouring lanes read neighbouring
// words of a row and write neighbouring words of the output, and no lane
// idles but the span's last few.  A lane sums each of its words over the
// bag's slots in slot order, loading S slots before their FMAs.
template <typename T, typename OutT, int V, int K, int S>
__device__ __forceinline__ void bag_flat(const T* __restrict__ table, const void* __restrict__ ids,
                                         int ids_64, const float* __restrict__ weights,
                                         OutT* __restrict__ out, long long rows, int dim,
                                         long long n_bags, int nnz, int jshift, int mean) {
  constexpr int EL = V / (int)sizeof(T);
  constexpr int W = V / 4;
  __shared__ __align__(16) Staged staged[kVecWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = dim / EL;
  const int TB = 32 * K / R, span = TB * R;
  const int J = 1 << jshift;
  const int n_chunks = (nnz + J - 1) >> jshift;
  const long long n_tiles = (n_bags + TB - 1) / TB;
  const long long stride = (long long)gridDim.x * kVecWarps;
  long long tile = (long long)blockIdx.x * kVecWarps + warp;
  if (tile >= n_tiles) return;
  int word[K];  // the lane's words: bag in the tile << 3 | load in the row (R <= 8)
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int wd = lane + 32 * i;
    word[i] = wd < span ? (wd / R) << 3 | (wd - (wd / R) * R) : TB << 3;  // TB: no word
  }
  Staged& st = staged[warp];
  stage_chunk(st, 0, ids, ids_64, weights, tile * TB, TB, 0, jshift, n_bags, nnz, lane);
  int buf = 0;

  for (;;) {
    const long long bag0 = tile * TB;
    const int live = (int)min((long long)TB, n_bags - bag0);  // bags of this tile
    float acc[K][EL];
    float wsum[K];
    bool bad[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      wsum[i] = 0.f;
      bad[i] = false;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[i][e] = 0.f;
    }
    const long long next = tile + stride < n_tiles ? (tile + stride) * TB : -1;
    for (int c = 0; c < n_chunks; ++c, buf ^= 1) {
      next_chunk(st, buf, ids, ids_64, weights, bag0, next, TB, c, n_chunks, jshift, n_bags, nnz,
                 lane);
      const int ns = min(J, nnz - (c << jshift));
      for (int s0 = 0; s0 < ns; s0 += S) {
        unsigned raw[K][S][W];
        float w[K][S];
        int state[K][S];  // 0: no slot, 1: a row, 2: an id outside the table
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int q = 0; q < S; ++q) {
            state[i][q] = 0;
            w[i][q] = 0.f;
            if ((word[i] >> 3) < live && s0 + q < ns) {
              const int e = ((word[i] >> 3) << jshift) + s0 + q;
              const long long id = staged_id(st, buf, e, ids_64);
              w[i][q] = weights != nullptr ? st.w[buf][e] : 1.f;
              state[i][q] = 2;
              if (id >= 0 && id < rows) {
                state[i][q] = 1;
                load_words<V>(table + id * (long long)dim + (word[i] & 7) * EL, raw[i][q]);
              }
            }
          }
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int q = 0; q < S; ++q) {  // slot order
            if (state[i][q] == 0) continue;
            wsum[i] += w[i][q];
            if (state[i][q] == 2) {
              bad[i] = true;
              continue;
            }
#pragma unroll
            for (int e = 0; e < EL; ++e)
              acc[i][e] = fmaf(word_elt<T, OutT>(raw[i][q], e), w[i][q], acc[i][e]);
          }
      }
      __syncwarp();
    }

    OutT* ospan = out + bag0 * dim;  // the span's words are the output's, in order
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if ((word[i] >> 3) >= live) continue;
      const float denom = mean ? fmaxf(wsum[i], 1.f) : 1.f;
      float v[EL];
#pragma unroll
      for (int e = 0; e < EL; ++e)
        v[e] = bad[i] ? __int_as_float(0x7fc00000) : mean ? acc[i][e] / denom : acc[i][e];
      store_vec<OutT, EL>(ospan + (lane + 32 * i) * EL, v);
    }
    tile += stride;
    if (tile >= n_tiles) break;
  }
}

#define BAG_PARAMS                                                                        \
  const T *__restrict__ table, const void *__restrict__ ids, int ids_64,                  \
      const float *__restrict__ weights, OutT *__restrict__ out, long long rows, int dim, \
      long long n_bags, int nnz, int gshift, int jshift, int mean

template <typename T, typename OutT, int V, int K, int U, int S>
__global__ void __launch_bounds__(kVecWarps * 32, kMinBlocks)
embedding_bag_wide_kernel(BAG_PARAMS) {
  bag_tiles<T, OutT, V, K, U, S>(table, ids, ids_64, weights, out, rows, dim, n_bags, nnz, gshift,
                                 jshift, mean);
}

template <typename T, typename OutT, int V, int K, int U, int S>
__global__ void __launch_bounds__(kVecWarps * 32, kMinBlocks)
embedding_bag_narrow_kernel(BAG_PARAMS) {
  bag_flat<T, OutT, V, K, S>(table, ids, ids_64, weights, out, rows, dim, n_bags, nnz, jshift,
                             mean);
}

// The routed kernel of a configuration (only that one is instantiated).
template <typename T, typename OutT, int V, int K, int U, int S, bool NARROW>
constexpr auto bag_kernel() {
  if constexpr (NARROW) {
    return &embedding_bag_narrow_kernel<T, OutT, V, K, U, S>;
  } else {
    return &embedding_bag_wide_kernel<T, OutT, V, K, U, S>;
  }
}

struct Bag {
  const void* table;
  const void* ids;
  int ids_64;
  const float* weights;
  void* out;
  long long rows;
  int dim;
  long long n_bags;
  int nnz, mean;
};

int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = dev < 64 ? cached[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) cached[dev] = n;
  }
  return n;
}

// The persistent grid: enough blocks for one tile a warp, at most what the
// card holds resident at once.  J: the least power of two >= nnz that keeps
// a chunk (tb bags) within kStage entries.
template <typename T, typename OutT, int V, int K, int U, int S, bool NARROW>
int launch_routed(const Bag& a, int gshift, int tb, cudaStream_t s) {
  const auto kernel = bag_kernel<T, OutT, V, K, U, S, NARROW>();
  static int resident = 0;  // blocks an SM holds, per kernel
  if (resident == 0) {
    int n = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kVecWarps * 32, 0);
    if (e != cudaSuccess) return (int)e;
    resident = n > 0 ? n : 1;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  int jshift = 0;
  while ((1 << jshift) < a.nnz && (tb << (jshift + 1)) <= kStage) ++jshift;
  const long long tiles = (a.n_bags + tb - 1) / tb;
  const long long want = (tiles + kVecWarps - 1) / kVecWarps;
  const int blocks = (int)(want < (long long)sms * resident ? want : (long long)sms * resident);
  kernel<<<blocks, kVecWarps * 32, 0, s>>>((const T*)a.table, a.ids, a.ids_64, a.weights,
                                           (OutT*)a.out, a.rows, a.dim, a.n_bags, a.nnz, gshift,
                                           jshift, a.mean);
  return (int)cudaGetLastError();
}

// Wide rows.  Bags of one: U bags a lane group, as many as kAccFloats
// accumulators and kOneRawWords words in flight allow (2, or 1 for K = 2);
// longer bags: one bag a group, S slots in flight.  A tile (at most 64
// bags) always fits a chunk.
template <typename T, typename OutT, int K>
int launch_wide(const Bag& a, int gshift, cudaStream_t s) {
  constexpr int EL = kWideBytes / (int)sizeof(T), W = kWideBytes / 4;
  constexpr int U = cmin(kAccFloats / (K * EL), kOneRawWords / (K * W));
  constexpr int S = cmin(8, kRawWords / (K * W));
  const int ng = 32 >> gshift;
  if (a.nnz == 1) return launch_routed<T, OutT, kWideBytes, K, U, 1, false>(a, gshift, ng * U, s);
  return launch_routed<T, OutT, kWideBytes, K, 1, S, false>(a, gshift, ng, s);
}

// Narrow rows.  Bags of one: K words a lane, as many as kNarrowAccFloats
// accumulators and kOneRawWords words in flight allow (at most 4), so a tile
// holds 32 K / R bags; longer bags: one word a lane, S slots in flight.
template <typename T, typename OutT, int V>
int launch_narrow(const Bag& a, int r, cudaStream_t s) {
  constexpr int EL = V / (int)sizeof(T), W = V / 4;
  constexpr int K = cmin(4, cmin(kNarrowAccFloats / EL, kOneRawWords / W));
  constexpr int S = cmin(8, kRawWords / W);
  if (a.nnz == 1) return launch_routed<T, OutT, V, K, 1, 1, true>(a, 0, 32 * K / r, s);
  return launch_routed<T, OutT, V, 1, 1, S, true>(a, 0, 32 / r, s);
}

template <typename T, typename OutT>
int route(const Bag& a, cudaStream_t s, int* ran) {
  const int rb = a.dim * (int)sizeof(T);
  const uintptr_t tp = (uintptr_t)a.table;
  if (a.nnz >= 1 && (uintptr_t)a.out % 16 == 0) {
    if (rb % kWideBytes == 0 && tp % kWideBytes == 0) {
      const int r = rb / kWideBytes, k = r > 32 ? 2 : 1;
      int gshift = 0;
      while ((1 << gshift) * k < r) ++gshift;
      *ran = kRanWide;
      if constexpr (sizeof(T) == 4)  // bf16 rows hold at most 32 loads (dim <= 256)
        if (k == 2) return launch_wide<T, OutT, 2>(a, gshift, s);
      return launch_wide<T, OutT, 1>(a, gshift, s);
    }
    if (rb <= kNarrowMaxBytes && rb % 8 == 0 && tp % 8 == 0) {
      *ran = kRanNarrow;
      return launch_narrow<T, OutT, 8>(a, rb / 8, s);
    }
    if (rb <= kNarrowMaxBytes / 2 && rb % 4 == 0 && tp % 4 == 0) {
      *ran = kRanNarrow;
      return launch_narrow<T, OutT, 4>(a, rb / 4, s);
    }
  }
  *ran = kRanGeneric;
  if ((a.n_bags + kWarps - 1) / kWarps > INT_MAX) return (int)cudaErrorInvalidValue;
  return launch_ids<T, OutT>(a.ids_64, a.table, a.ids, a.weights, a.out, a.rows, a.dim, a.n_bags,
                             a.nnz, a.mean, s);
}

}  // namespace

// table [rows, dim] (kF32 or kBF16), ids [n_bags, nnz] (int32, or int64 with
// ids_64), weights [n_bags, nnz] float32 or nullptr, out [n_bags, dim] in
// the table's type, or kBF16 from a kF32 table; mean: 0 sums, 1 divides by
// max(sum of weights, 1).  kernel_ran: 1 embedding_bag_wide_kernel, 2
// embedding_bag_narrow_kernel, 0 embedding_bag_kernel.
extern "C" int rt_embedding_bag(const void* table, const void* ids, const void* weights,
                                void* out, int table_dtype, int out_dtype, int ids_64,
                                long long rows, int dim, long long n_bags, int nnz, int mean,
                                void* stream, int* kernel_ran) {
  if (rows <= 0 || dim <= 0 || dim > 32 * kMaxK || n_bags <= 0 || nnz < 0 ||
      kernel_ran == nullptr)
    return (int)cudaErrorInvalidValue;
  const Bag a{table, ids, ids_64, static_cast<const float*>(weights), out, rows, dim,
              n_bags, nnz, mean};
  cudaStream_t s = (cudaStream_t)stream;
  if (table_dtype == rt::kF32 && out_dtype == rt::kF32)
    return route<float, float>(a, s, kernel_ran);
  if (table_dtype == rt::kF32 && out_dtype == rt::kBF16)
    return route<float, __nv_bfloat16>(a, s, kernel_ran);
  if (table_dtype == rt::kBF16 && out_dtype == rt::kBF16)
    return route<__nv_bfloat16, __nv_bfloat16>(a, s, kernel_ran);
  return (int)cudaErrorInvalidValue;
}
