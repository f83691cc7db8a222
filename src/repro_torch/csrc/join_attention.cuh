// The tiled split-KV join-attention kernel, shared by the dense entry
// (join_attention.cu: float or raw-int8 doc K/V) and the paged entry
// (join_attention_paged.cu: doc K/V in the device doc cache's page pools).
//
// One block of kThreads threads per (q-tile, head, batch row); each query
// row is held by D / 16 lanes (attention_common.cuh).  The query-segment
// K/V is staged first and seeds the online-softmax state (the Pallas
// kernel's first grid step); then the doc tiles of 32 keys follow up to
// dlen[b] -- the TPU's sequential grid axis is a loop in the block.
//
// Dense float doc rows are staged as the query segment is.  For int8 and
// paged doc K/V the addressing is resolved once per tile: the first
// kBlockK threads compute each key's element offset, its validity and
// (int8 K/V) its K and V scales into shared memory, then the whole block
// stages the tile's elements as float32.  Dense rows sit at
// b*s.b + hk*s.h + pos*s.s; paged key `pos` of row b sits in pool page
// page_table[b, pos / page] at
// row pos % page, element ((p * page + r) * Hkv + hk) * D, so a 32-key tile
// may span several pages (or a page several tiles) and any page size
// works.  Raw int8 K/V are widened to float32 and multiplied by their
// token's scale while staged -- the Pallas kernel's "widen before each
// dot"; the scores never see the scales.  Validity of a paged key comes
// from the validity pool alone, so a stale page behind a document's end
// is masked by its own zero validity.
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace rt {

// The doc-segment operand.
struct DocSeg {
  const void* k;          // dense [B, Hkv, Ld, D] (strides ks); paged pool [P, page, Hkv, D]
  const void* v;          // the same for V (strides vs)
  const float* k_scale;   // raw int8 K/V: dense [B, Ld], paged [P * page]; else null
  const float* v_scale;
  const uint8_t* valid;   // dense [B, Ld]; paged [P * page]
  const int* page_table;  // paged: [B, n_pages]; dense: null
  int page;               // paged: tokens per page
  int n_pages;            // paged: page-table width
  int len;                // doc-segment length: dense Ld, paged n_pages * page
  BHS ks, vs;             // dense strides
};

struct JoinArgs {
  const void* q;          // [B, Hq, Sq, D] (strides qs)
  const void* kq;         // [B, Hkv, Lq, D] (strides kqs)
  const void* vq;
  void* o;                // [B, Hq, Sq, D] (strides os)
  const int* dlen;        // [B]: one past each row's last valid doc key
  const uint8_t* kq_valid;  // [B, Lq]
  int B, Hq, Hkv, Sq, Lq, D;
  BHS qs, kqs, vqs, os;
  float scale;
  DocSeg doc;
};

// Stage doc keys [k0, k0 + n) of raw int8 or paged K/V as float32 (see
// the header comment).  Called by every thread of the block; the caller
// synchronises around it.
template <typename KD, bool PAGED, int D>
__device__ __forceinline__ void stage_doc_tile(const JoinArgs& a, int b, int hk, int k0, int n,
                                               int len, float* ks, float* vs, int* kside,
                                               long long* koff, long long* voff, float* ksc,
                                               float* vsc) {
  constexpr bool kQuant = std::is_same<KD, int8_t>::value;
  const DocSeg& doc = a.doc;
  const KD* kd = (const KD*)doc.k;
  const KD* vd = (const KD*)doc.v;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int pos = k0 + j;
    long long row;  // index into the validity and scale operands
    if (PAGED) {
      const int pi = pos / doc.page;
      row = (long long)doc.page_table[(long long)b * doc.n_pages + pi] * doc.page +
            (pos - pi * doc.page);
      koff[j] = voff[j] = (row * a.Hkv + hk) * D;
    } else {
      row = (long long)b * doc.len + pos;
      koff[j] = b * doc.ks.b + hk * doc.ks.h + pos * doc.ks.s;
      voff[j] = b * doc.vs.b + hk * doc.vs.h + pos * doc.vs.s;
    }
    kside[j] = (pos < len && doc.valid[row] != 0) ? 0 : -1;
    if (kQuant) {
      ksc[j] = doc.k_scale[row];
      vsc[j] = doc.v_scale[row];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    float kx = to_f32(kd[koff[j] + d]);
    float vx = to_f32(vd[voff[j] + d]);
    if (kQuant) {
      kx *= ksc[j];
      vx *= vsc[j];
    }
    ks[i] = kx;
    vs[i] = vx;
  }
}

template <typename T, typename KD, bool PAGED, int D>
__global__ void __launch_bounds__(kThreads) join_tiled_kernel(JoinArgs a) {
  constexpr bool kQuant = std::is_same<KD, int8_t>::value;
  constexpr int TPR = Geo<D>::TPR, ROWS = Geo<D>::ROWS;
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];
  __shared__ int kside[kBlockK];
  __shared__ long long koff[kBlockK], voff[kBlockK];
  __shared__ float ksc[kBlockK], vsc[kBlockK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int t = threadIdx.x % TPR;
  const int qi = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool active = qi < a.Sq;
  const int hk = h / (a.Hq / a.Hkv);

  RowState st;
  load_row<T, D>(st, (const T*)a.q + b * a.qs.b + h * a.qs.h + (long long)qi * a.qs.s, t,
                 active);

  // query segment: every tile, masked by kq_valid only
  const T* kp = (const T*)a.kq + b * a.kqs.b + hk * a.kqs.h;
  const T* vp = (const T*)a.vq + b * a.vqs.b + hk * a.vqs.h;
  const uint8_t* qvalid = a.kq_valid + (long long)b * a.Lq;
  for (int k0 = 0; k0 < a.Lq; k0 += kBlockK) {
    const int n = min(kBlockK, a.Lq - k0);
    __syncthreads();
    stage_tile<T, D>(kp, vp, a.kqs.s, a.vqs.s, k0, n, qvalid, a.Lq, -1, ks, vs, kside);
    __syncthreads();
    fold_tile<D>(st, ks, vs, kside, n, 0, t, a.scale);
  }

  // doc segment: tiles up to dlen[b]
  const DocSeg& doc = a.doc;
  const KD* kd = (const KD*)doc.k;
  const KD* vd = (const KD*)doc.v;
  const int len = min(a.dlen[b], doc.len);
  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    const int n = min(kBlockK, doc.len - k0);
    __syncthreads();
    if constexpr (!PAGED && !kQuant) {  // dense float rows: direct staging
      stage_tile<T, D>((const T*)kd + b * doc.ks.b + hk * doc.ks.h,
                       (const T*)vd + b * doc.vs.b + hk * doc.vs.h, doc.ks.s, doc.vs.s, k0, n,
                       doc.valid + (long long)b * doc.len, len, -1, ks, vs, kside);
    } else {
      stage_doc_tile<KD, PAGED, D>(a, b, hk, k0, n, len, ks, vs, kside, koff, voff, ksc, vsc);
    }
    __syncthreads();
    fold_tile<D>(st, ks, vs, kside, n, 0, t, a.scale);
  }
  if (active)
    store_row<T, D>(st, (T*)a.o + b * a.os.b + h * a.os.h + (long long)qi * a.os.s, t);
}

template <typename T, typename KD, bool PAGED, int D>
int launch_join_tiled_d(const JoinArgs& a, cudaStream_t s) {
  constexpr int rows = Geo<D>::ROWS;
  const dim3 grid((a.Sq + rows - 1) / rows, a.Hq, a.B);
  join_tiled_kernel<T, KD, PAGED, D><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KD, bool PAGED>
int launch_join_tiled(const JoinArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 16: return launch_join_tiled_d<T, KD, PAGED, 16>(a, s);
    case 32: return launch_join_tiled_d<T, KD, PAGED, 32>(a, s);
    case 64: return launch_join_tiled_d<T, KD, PAGED, 64>(a, s);
    case 128: return launch_join_tiled_d<T, KD, PAGED, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shape checks shared by the entries.
inline bool join_args_ok(const JoinArgs& a) {
  return a.B > 0 && a.Hq > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.Sq > 0 && a.Lq >= 0 &&
         a.doc.len >= 0;
}

}  // namespace rt
