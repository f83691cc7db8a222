// The split-KV join-attention kernels shared by the dense entry
// (join_attention.cu: float or raw-int8 doc K/V) and the paged entry
// (join_attention_paged.cu: doc K/V in the device doc cache's page pools),
// and the routing rule between them (launch_join).
//
// join_tc_kernel (tensor cores, attention_tc.cuh): bf16 / fp16 q, head
// dim 64 or 128, Sq > 1, doc K/V of q's type, raw int8, or (paged) the
// other 16-bit type, 16-byte aligned operands -- every 16-bit main path.
// A block holds 64 query rows; the query segment's 64-key tiles come
// first, then the doc segment's up to dlen[b], both through one
// two-stage cp.async ring (PreTTR's 32-token query segment fills half a
// tile; its tail is zero-filled and masked).  Dense rows sit at
// b*s.b + hk*s.h + pos*s.s; paged key `pos` of row b sits in pool page
// page_table[b, pos / page] at row pos % page, element
// ((p * page + r) * Hkv + hk) * D, resolved per key as its copy is issued,
// so a tile may span several pages (or a page several tiles) and any page
// size works.  Doc rows of another type than q's (raw int8, fp16 pools
// under a bf16 join) land in a raw ring and are converted into the 16-bit
// tile: int8 exactly, with the K scale applied to S's columns and the V
// scale to P's; fp16 rounded to bf16.
//
// join_tiled_kernel (CUDA cores): float32 q, other head dims, Sq = 1 with
// int8 K/V, float32 pools under a 16-bit q and unaligned operands.  One
// block of kThreads threads per (q-tile, head, batch row); each query row
// is held by D / 16 lanes (attention_common.cuh).  The query-segment K/V
// is staged first and seeds the online-softmax state (the Pallas kernel's
// first grid step); then the doc tiles of 32 keys follow up to dlen[b] --
// the TPU's sequential grid axis is a loop in the block.  Dense float doc
// rows are staged as the query segment is.  For int8 and paged doc K/V
// the addressing is resolved once per tile: the first kBlockK threads
// compute each key's element offset, its validity and (int8 K/V) its K
// and V scales into shared memory, then the whole block stages the tile's
// elements as float32.  Raw int8 K/V are widened to float32 and
// multiplied by their token's scale while staged -- the Pallas kernel's
// "widen before each dot".
//
// In both, validity of a paged key comes from the validity pool alone, so
// a stale page behind a document's end is masked by its own zero
// validity.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "attention_tc.cuh"

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

// The doc segment's row `pos` of batch row b: its index into the validity
// and scale operands, and the element offsets of its K and V rows.
template <bool PAGED>
__device__ __forceinline__ long long doc_row(const DocSeg& doc, int b, int pos) {
  if (PAGED) {
    const int pi = pos / doc.page;
    return (long long)doc.page_table[(long long)b * doc.n_pages + pi] * doc.page +
           (pos - pi * doc.page);
  }
  return (long long)b * doc.len + pos;
}

// Shared-memory plan of join_tc_kernel: the q tile, the two-stage ring of
// 16-bit K and V tiles, a two-stage raw ring for doc rows of another type
// (kConv), two KeyMeta stages.
template <typename T, typename KD, int D>
struct JoinTc {
  static constexpr bool kQuant = std::is_same<KD, int8_t>::value;
  static constexpr bool kConv = !std::is_same<KD, T>::value;
  static constexpr int kThreads = 128, BM = 64;
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;   // as SplitTc
  static constexpr int TE = tc::Tile<D>::kElems;
  static constexpr int kSmem = BM * D * 2 + 2 * 2 * TE * 2 +
                               (kConv ? 2 * 2 * TE * (int)sizeof(KD) : 0) +
                               2 * (int)sizeof(tc::KeyMeta);
};

template <typename T, typename KD, bool PAGED, int D>
__global__ void __launch_bounds__(128, JoinTc<T, KD, D>::kMinBlocks) join_tc_kernel(JoinArgs a) {
  using G = JoinTc<T, KD, D>;
  constexpr int NT = G::kThreads, BM = G::BM, TE = G::TE, BN = tc::kBlockN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * D;                        // [2][TE]
  T* sV = sK + 2 * TE;
  KD* rK = reinterpret_cast<KD*>(sV + 2 * TE);  // kConv: [2][TE]
  KD* rV = rK + (G::kConv ? 2 * TE : 0);
  tc::KeyMeta* meta = reinterpret_cast<tc::KeyMeta*>(rV + (G::kConv ? 2 * TE : 0));

  const int b = blockIdx.y, h = blockIdx.x, q0 = blockIdx.z * BM;
  const int hk = h / (a.Hq / a.Hkv);
  const T* kqp = (const T*)a.kq + b * a.kqs.b + hk * a.kqs.h;
  const T* vqp = (const T*)a.vq + b * a.vqs.b + hk * a.vqs.h;
  const uint8_t* qvalid = a.kq_valid + (long long)b * a.Lq;
  const DocSeg& doc = a.doc;
  const KD* kd = (const KD*)doc.k;
  const KD* vd = (const KD*)doc.v;
  const int len = min(a.dlen[b], doc.len);
  // virtual tiles: the query segment's [0, nq), then the doc segment's
  const int nq = (a.Lq + BN - 1) / BN;
  const int n_tiles = nq + (len + BN - 1) / BN;
  auto koff = [&](int pos) {
    return PAGED ? (doc_row<true>(doc, b, pos) * a.Hkv + hk) * D
                 : b * doc.ks.b + hk * doc.ks.h + (long long)pos * doc.ks.s;
  };
  auto voff = [&](int pos) {
    return PAGED ? (doc_row<true>(doc, b, pos) * a.Hkv + hk) * D
                 : b * doc.vs.b + hk * doc.vs.h + (long long)pos * doc.vs.s;
  };
  auto issue = [&](int vt, int st) {
    if (vt < nq) {
      const int k0 = vt * BN;
      auto ok = [&](int j) { return k0 + j < a.Lq; };
      tc::issue_tile<D, NT, false>(sK + st * TE, kqp,
                                   [&](int j) { return kqp + (long long)(k0 + j) * a.kqs.s; }, ok);
      tc::issue_tile<D, NT, false>(sV + st * TE, vqp,
                                   [&](int j) { return vqp + (long long)(k0 + j) * a.vqs.s; }, ok);
      return;
    }
    const int k0 = (vt - nq) * BN;
    auto ok = [&](int j) { return k0 + j < len; };
    auto krow = [&](int j) { return kd + koff(k0 + j); };
    auto vrow = [&](int j) { return vd + voff(k0 + j); };
    if constexpr (G::kConv) {
      tc::issue_tile<D, NT, true>(rK + st * TE, kd, krow, ok);
      tc::issue_tile<D, NT, true>(rV + st * TE, vd, vrow, ok);
    } else {
      tc::issue_tile<D, NT, false>(sK + st * TE, kd, krow, ok);
      tc::issue_tile<D, NT, false>(sV + st * TE, vd, vrow, ok);
    }
  };
  auto load_key = [&](int vt) {
    tc::KeyReg r{-1, 1.f, 1.f};
    if (threadIdx.x >= BN) return r;
    if (vt < nq) {
      const int pos = vt * BN + (int)threadIdx.x;
      if (pos < a.Lq && qvalid[pos]) r.side = 0;
      return r;
    }
    const int pos = (vt - nq) * BN + (int)threadIdx.x;
    if (pos < len) {
      const long long row = doc_row<PAGED>(doc, b, pos);
      if (doc.valid[row]) r.side = 0;
      if constexpr (G::kQuant) {
        r.ksc = doc.k_scale[row];
        r.vsc = doc.v_scale[row];
      }
    }
    return r;
  };

  const int warp = threadIdx.x >> 5;
  const int wrow0 = 16 * warp;
  tc::RowMask rm;
  rm.qi[0] = rm.qi[1] = 0;
  rm.side[0] = rm.side[1] = 0;
  rm.k0 = 0;
  rm.causal = false;
  rm.window = 0;
  tc::Acc<D> acc;
  acc.init();

  tc::issue_q<D, NT, BM>(sQ, (const T*)a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq);
  tc::run_tiles(
      meta, n_tiles > 0 ? 0 : -1, [&](int vt) { return vt + 1 < n_tiles ? vt + 1 : -1; }, issue,
      load_key,
      [&](int vt, int st) -> bool {
        if constexpr (G::kConv) {
          if (vt >= nq) {                     // doc rows: widen into stage st
            tc::convert_tile<T, D, NT>(sK + st * TE, rK + st * TE);
            tc::convert_tile<T, D, NT>(sV + st * TE, rV + st * TE);
            return true;
          }
        }
        return false;
      },
      [&](int, int st, const tc::KeyMeta& m) {
        if (q0 + wrow0 < a.Sq)
          tc::attend_tile<T, D, G::kQuant>(acc, sQ, wrow0, sK + st * TE, sV + st * TE, m, rm,
                                           a.scale);
      });
  tc::store_rows<T, D>(acc, (T*)a.o + b * a.os.b + h * a.os.h + (long long)q0 * a.os.s, a.os.s,
                       wrow0, a.Sq - q0);
}

template <typename T, typename KD, bool PAGED, int D>
int launch_join_tc_d(const JoinArgs& a, cudaStream_t s) {
  using G = JoinTc<T, KD, D>;
  static std::atomic<unsigned> raised{0};   // a bit a device
  if (int e = tc::allow_smem(join_tc_kernel<T, KD, PAGED, D>, G::kSmem, raised)) return e;
  const dim3 grid(a.Hq, a.B, (a.Sq + G::BM - 1) / G::BM);
  join_tc_kernel<T, KD, PAGED, D><<<grid, G::kThreads, G::kSmem, s>>>(a);
  return (int)cudaGetLastError();
}

// The routing rule: 16-bit q, D in {64, 128}, Sq > 1, doc K/V not
// float32 and 16-byte aligned operands take join_tc_kernel, everything
// else join_tiled_kernel; *kernel says which (1 tensor cores, 0 CUDA
// cores).
template <typename T, typename KD, bool PAGED>
int launch_join(const JoinArgs& a, cudaStream_t s, int* kernel) {
  bool use_tc = false;
  if constexpr (!std::is_same<T, float>::value && !std::is_same<KD, float>::value) {
    const int elt = (int)sizeof(KD);
    const DocSeg& d = a.doc;
    use_tc = (a.D == 64 || a.D == 128) && a.Sq > 1 &&
             tc::aligned16(a.q, 2, a.qs.b, a.qs.h, a.qs.s) &&
             tc::aligned16(a.kq, 2, a.kqs.b, a.kqs.h, a.kqs.s) &&
             tc::aligned16(a.vq, 2, a.vqs.b, a.vqs.h, a.vqs.s) &&
             (PAGED ? tc::aligned16(d.k, elt, 0, 0, 0) && tc::aligned16(d.v, elt, 0, 0, 0)
                    : tc::aligned16(d.k, elt, d.ks.b, d.ks.h, d.ks.s) &&
                          tc::aligned16(d.v, elt, d.vs.b, d.vs.h, d.vs.s)) &&
             ((uintptr_t)a.o & 3) == 0 && a.os.b % 2 == 0 && a.os.h % 2 == 0 &&
             a.os.s % 2 == 0;
    if (kernel) *kernel = use_tc ? 1 : 0;
    if (use_tc)
      return a.D == 64 ? launch_join_tc_d<T, KD, PAGED, 64>(a, s)
                       : launch_join_tc_d<T, KD, PAGED, 128>(a, s);
  }
  if (kernel) *kernel = 0;
  return launch_join_tiled<T, KD, PAGED>(a, s);
}

// Shape checks shared by the entries.
inline bool join_args_ok(const JoinArgs& a) {
  return a.B > 0 && a.Hq > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.Sq > 0 && a.Lq >= 0 &&
         a.doc.len >= 0;
}

}  // namespace rt
