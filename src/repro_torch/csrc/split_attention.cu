// Flash attention with PreTTR split, causal and sliding-window masks and
// optional raw int8 K/V, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/split_attention/kernel.py,
// flash_attention_pallas (_attn_kernel), its whole contract: lengths,
// non-prefix k_valid, seg_boundary, causal, window, raw int8 K/V with
// per-token scales, head dims 16 to 256.
//
// Computes, per (b, h, query row i): softmax over the keys j with
// j < lengths[b], k_valid[b, j], j <= i (causal), i - j < window
// (window > 0) and (seg_boundary >= 0) i and j on the same side of
// seg_boundary, of q.k / sqrt(D), times V.  GQA head h reads KV head
// h / (Hq / Hkv).  Raw int8 K/V carry per-token float32 scales: the
// CUDA-core kernel widens and scales them while staged, as the Pallas
// kernel widens before each dot; the tensor-core kernel keeps them exact
// and scales S and P instead (below).
//
// Bound on the H100: 4 * D FLOPs per (row, visible key) against 2 bytes
// per element read once.  PreTTR's shapes ([64, 12, 480, 64] bf16) come
// to ~90 FLOPs per byte, gemma3's prefill ([4, 8, 2048, 256] causal, GQA
// 8/4) to ~700: at or above the bf16 tensor-core ridge (~295), so the
// tensor cores' rate bounds the 16-bit forms (~0.07 ms a gemma3 layer).
//
// Two kernels, routed by rt_split_attention, which reports the one it ran:
//  * split_attention_tc_kernel (attention_tc.cuh): bf16 / fp16 q, head
//    dim 64, 128 or 256, Sq > 1, 16-byte aligned operands -- every 16-bit
//    main path (PreTTR's index build, query encoder and concat join,
//    gemma3's prefill).  A block holds 64 query rows (128 at D = 256) and
//    walks 64-key K/V tiles through a two-stage cp.async ring in dynamic
//    shared memory; S = Q.K^T and O += P.V run as mma.sync.m16n8k16 with
//    float32 accumulators, the online softmax over the S fragment in
//    registers.  Raw int8 K/V are staged as raw bytes and widened to the
//    MMA type exactly; the per-token K scale multiplies S's columns and
//    the V scale P's.  Causal grids run the longest q tiles first.
//  * split_attention_kernel (attention_common.cuh, CUDA cores): float32
//    q (the float32 paths hold it to 1e-3 on the card and 2e-5 on the
//    CPU, which a bf16 product cannot meet), other head dims, Sq = 1 and
//    unaligned operands.  One block of 128 threads per (q-tile, head,
//    batch row); each query row is held by D / 16 lanes, K/V tiles of 32
//    keys (16 at D = 256) staged in shared memory as float32.  float32
//    FMAs on CUDA cores bound it (67 TFLOP/s at best).
//
// Both loops follow the Pallas skip predicate: they end at lengths[b]
// and, causal, past the q-tile's last row; with a window they start at the
// first tile the q-tile's first row can still see; tiles wholly on the
// other side of seg_boundary from the whole q-tile are skipped.  Inside a
// tile each row masks by its own position.  causal and window are runtime
// arguments, so the forms share one instantiation per (q type, K/V type,
// D).  The kernels mask their own ragged edges, so the wrapper pads
// nothing.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

// Keys per staged K/V tile at head dim D.
template <int D>
struct BlockK {
  static constexpr int value = D >= 256 ? 16 : rt::kBlockK;
};

struct SplitArgs {
  const void* q;          // [B, Hq, Sq, D] (strides qs)
  const void* k;          // [B, Hkv, Skv, D] (strides ks)
  const void* v;          // (strides vs)
  void* o;                // [B, Hq, Sq, D] (strides os)
  const int* lengths;     // [B]
  const uint8_t* k_valid; // [B, Skv]
  const float* k_scales;  // raw int8 K/V: [B, Skv]; else null
  const float* v_scales;
  int B, Hq, Hkv, Sq, Skv;
  rt::BHS qs, ks, vs, os;
  int causal, window, seg_boundary;
  float scale;
};

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(rt::kThreads) split_attention_kernel(SplitArgs a) {
  constexpr int TPR = rt::Geo<D>::TPR, ROWS = rt::Geo<D>::ROWS, BK = BlockK<D>::value;
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];
  __shared__ int kside[BK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int t = threadIdx.x % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int qi = q0 + threadIdx.x / TPR;
  const bool active = qi < a.Sq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_last = min(q0 + ROWS, a.Sq) - 1;
  const int sb = a.seg_boundary;
  const int row_side = (sb >= 0 && qi >= sb) ? 1 : 0;

  rt::RowState st;
  rt::load_row<T, D>(st, (const T*)a.q + b * a.qs.b + h * a.qs.h + (long long)qi * a.qs.s, t,
                     active);

  const KT* kp = (const KT*)a.k + b * a.ks.b + hk * a.ks.h;
  const KT* vp = (const KT*)a.v + b * a.vs.b + hk * a.vs.h;
  const float* ksc = a.k_scales ? a.k_scales + (long long)b * a.Skv : nullptr;
  const float* vsc = a.v_scales ? a.v_scales + (long long)b * a.Skv : nullptr;
  const uint8_t* valid = a.k_valid + (long long)b * a.Skv;
  const int len = min(a.lengths[b], a.Skv);
  // the Pallas skip predicate as loop bounds: no tile past the valid
  // length or (causal) past the q-tile's last row; with a window, none
  // wholly before the first row's window
  const int k_end = a.causal ? min(len, q_last + 1) : len;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int n = min(BK, a.Skv - k0);
    if (sb >= 0) {                      // whole tile on the other side?
      const bool q_lo = q0 >= sb, q_hi = q_last >= sb;
      const bool k_lo = k0 >= sb, k_hi = k0 + n - 1 >= sb;
      if (q_lo == q_hi && k_lo == k_hi && q_lo != k_lo) continue;
    }
    __syncthreads();                    // previous tile fully consumed
    rt::stage_tile<KT, D, BK>(kp, vp, a.ks.s, a.vs.s, k0, n, valid, len, sb, ks, vs, kside, ksc,
                              vsc);
    __syncthreads();
    rt::fold_tile<D, BK>(st, ks, vs, kside, n, row_side, t, a.scale, k0, qi, a.causal != 0,
                         a.window);
  }
  if (active)
    rt::store_row<T, D>(st, (T*)a.o + b * a.os.b + h * a.os.h + (long long)qi * a.os.s, t);
}

// Shared-memory plan of the tensor-core kernel: the q tile, the 16-bit K
// and V tiles (a two-stage ring; one stage for raw int8 K/V, which land
// in a two-stage raw ring and are widened into it), two KeyMeta stages.
template <typename T, typename KT, int D>
struct SplitTc {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int kWarps = D == 256 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  // blocks an SM should hold: at D = 64 three (at most 170 registers a
  // thread: a cap of 128 spilled); wider heads are bound by their shared
  // memory
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
  static constexpr int BM = 16 * kWarps;             // query rows a block
  static constexpr int TE = rt::tc::Tile<D>::kElems;
  static constexpr int kStages16 = kQuant ? 1 : 2;
  static constexpr int kRawStages = kQuant ? 2 : 0;
  static constexpr int kSmem = BM * D * 2 + 2 * kStages16 * TE * 2 + 2 * kRawStages * TE +
                               2 * (int)sizeof(rt::tc::KeyMeta);
};

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(SplitTc<T, KT, D>::kThreads, SplitTc<T, KT, D>::kMinBlocks)
    split_attention_tc_kernel(SplitArgs a) {
  using G = SplitTc<T, KT, D>;
  namespace tc = rt::tc;
  constexpr int NT = G::kThreads, BM = G::BM, TE = G::TE, BN = tc::kBlockN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * D;                        // [kStages16][TE]
  T* sV = sK + G::kStages16 * TE;
  KT* rK = reinterpret_cast<KT*>(sV + G::kStages16 * TE);   // [kRawStages][TE]
  KT* rV = rK + G::kRawStages * TE;
  tc::KeyMeta* meta = reinterpret_cast<tc::KeyMeta*>(rV + G::kRawStages * TE);

  const int b = blockIdx.y, h = blockIdx.x;
  // causal: the longest q tiles (the last rows) are scheduled first
  const int qt = a.causal ? (int)(gridDim.z - 1 - blockIdx.z) : (int)blockIdx.z;
  const int q0 = qt * BM;
  const int q_last = min(q0 + BM, a.Sq) - 1;
  const int hk = h / (a.Hq / a.Hkv);
  const int sb = a.seg_boundary;
  const KT* kp = (const KT*)a.k + b * a.ks.b + hk * a.ks.h;
  const KT* vp = (const KT*)a.v + b * a.vs.b + hk * a.vs.h;
  const uint8_t* valid = a.k_valid + (long long)b * a.Skv;
  const float* ksc = a.k_scales ? a.k_scales + (long long)b * a.Skv : nullptr;
  const float* vsc = a.v_scales ? a.v_scales + (long long)b * a.Skv : nullptr;
  const int len = min(a.lengths[b], a.Skv);
  // the Pallas skip predicate as loop bounds, as in split_attention_kernel
  const int k_end = a.causal ? min(len, q_last + 1) : len;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) / BN * BN : 0;
  auto next = [&](int k0) {           // first tile at or after k0 to visit
    for (; k0 < k_end; k0 += BN) {
      if (sb < 0) return k0;
      const int n = min(BN, a.Skv - k0);
      const bool q_lo = q0 >= sb, q_hi = q_last >= sb;
      const bool k_lo = k0 >= sb, k_hi = k0 + n - 1 >= sb;
      if (!(q_lo == q_hi && k_lo == k_hi && q_lo != k_lo)) return k0;
    }
    return -1;
  };
  auto issue = [&](int k0, int st) {
    auto ok = [&](int j) { return k0 + j < len; };
    auto krow = [&](int j) { return kp + (long long)(k0 + j) * a.ks.s; };
    auto vrow = [&](int j) { return vp + (long long)(k0 + j) * a.vs.s; };
    if constexpr (G::kQuant) {
      tc::issue_tile<D, NT, true>(rK + st * TE, kp, krow, ok);
      tc::issue_tile<D, NT, true>(rV + st * TE, vp, vrow, ok);
    } else {
      tc::issue_tile<D, NT, false>(sK + st * TE, kp, krow, ok);
      tc::issue_tile<D, NT, false>(sV + st * TE, vp, vrow, ok);
    }
  };
  auto load_key = [&](int k0) {
    tc::KeyReg r{-1, 1.f, 1.f};
    const int pos = k0 + (int)threadIdx.x;
    if (threadIdx.x < BN && pos < len) {
      if (valid[pos]) r.side = (sb >= 0 && pos >= sb) ? 1 : 0;
      if constexpr (G::kQuant) {
        r.ksc = ksc[pos];
        r.vsc = vsc[pos];
      }
    }
    return r;
  };

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int wrow0 = 16 * warp;                // the warp's first row in sQ
  const int w_lo = q0 + wrow0, w_hi = w_lo + 15;
  tc::RowMask rm;
  rm.qi[0] = w_lo + g;
  rm.qi[1] = w_lo + g + 8;
  rm.side[0] = (sb >= 0 && rm.qi[0] >= sb) ? 1 : 0;
  rm.side[1] = (sb >= 0 && rm.qi[1] >= sb) ? 1 : 0;
  rm.causal = a.causal != 0;
  rm.window = a.window;
  tc::Acc<D> acc;
  acc.init();

  tc::issue_q<D, NT, BM>(sQ, (const T*)a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq);
  tc::run_tiles(
      meta, next(k_begin), [&](int k0) { return next(k0 + BN); }, issue, load_key,
      [&](int, int st) -> bool {
        if constexpr (G::kQuant) {            // widen into the one 16-bit stage
          tc::convert_tile<T, D, NT>(sK, rK + st * TE);
          tc::convert_tile<T, D, NT>(sV, rV + st * TE);
          return true;
        }
        return false;
      },
      [&](int k0, int st, const tc::KeyMeta& m) {
        // a warp whose 16 rows all lie past Sq, before the tile (causal)
        // or a window past it has nothing to fold
        const bool idle = w_lo >= a.Sq || (rm.causal && k0 > w_hi) ||
                          (a.window > 0 && w_lo - (k0 + BN - 1) >= a.window);
        if (idle) return;
        rm.k0 = k0;
        const int off = G::kQuant ? 0 : st * TE;
        tc::attend_tile<T, D, G::kQuant>(acc, sQ, wrow0, sK + off, sV + off, m, rm, a.scale);
      });
  tc::store_rows<T, D>(acc, (T*)a.o + b * a.os.b + h * a.os.h + (long long)q0 * a.os.s, a.os.s,
                       wrow0, a.Sq - q0);
}

template <typename T, typename KT, int D>
int launch_d(const SplitArgs& a, cudaStream_t s) {
  constexpr int rows = rt::Geo<D>::ROWS;
  const dim3 grid((a.Sq + rows - 1) / rows, a.Hq, a.B);
  split_attention_kernel<T, KT, D><<<grid, rt::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KT, int D>
int launch_tc_d(const SplitArgs& a, cudaStream_t s) {
  using G = SplitTc<T, KT, D>;
  static std::atomic<unsigned> raised{0};   // a bit a device
  if (int e = rt::tc::allow_smem(split_attention_tc_kernel<T, KT, D>, G::kSmem, raised)) return e;
  const dim3 grid(a.Hq, a.B, (a.Sq + G::BM - 1) / G::BM);
  split_attention_tc_kernel<T, KT, D><<<grid, G::kThreads, G::kSmem, s>>>(a);
  return (int)cudaGetLastError();
}

// The split kernel's own head-dim dispatch: D = 256 needs its 16-key
// tiles, which the join kernels' RT_DISPATCH_D does not offer.
template <typename T, typename KT>
int launch(int D, bool tc, const SplitArgs& a, cudaStream_t s) {
  if constexpr (!std::is_same<T, float>::value) {
    if (tc) switch (D) {
        case 64: return launch_tc_d<T, KT, 64>(a, s);
        case 128: return launch_tc_d<T, KT, 128>(a, s);
        case 256: return launch_tc_d<T, KT, 256>(a, s);
        default: return (int)cudaErrorInvalidValue;
      }
  }
  switch (D) {
    case 16: return launch_d<T, KT, 16>(a, s);
    case 32: return launch_d<T, KT, 32>(a, s);
    case 64: return launch_d<T, KT, 64>(a, s);
    case 128: return launch_d<T, KT, 128>(a, s);
    case 256: return launch_d<T, KT, 256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_kv(int kv_dtype, int dtype, int D, bool tc, const SplitArgs& a, cudaStream_t s) {
  if (kv_dtype == rt::kI8) {
    if (!a.k_scales || !a.v_scales) return (int)cudaErrorInvalidValue;
    return launch<T, int8_t>(D, tc, a, s);
  }
  if (kv_dtype != dtype || a.k_scales || a.v_scales) return (int)cudaErrorInvalidValue;
  return launch<T, T>(D, tc, a, s);
}

}  // namespace

// q, out: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] in q's type (dtype) or
// raw int8 (kv_dtype kI8, with [B, Skv] float32 k_scales / v_scales); all
// with (batch, head, seq) strides and a contiguous D axis.  lengths [B]
// int32, k_valid [B, Skv] bytes.  *kernel is set to 1 when the call went
// to split_attention_tc_kernel, 0 for split_attention_kernel.
extern "C" int rt_split_attention(const void* q, const void* k, const void* v, void* o,
                                  const void* lengths, const void* k_valid,
                                  const void* k_scales, const void* v_scales, int dtype,
                                  int kv_dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                  long long qsb, long long qsh, long long qss,
                                  long long ksb, long long ksh, long long kss,
                                  long long vsb, long long vsh, long long vss,
                                  long long osb, long long osh, long long oss, int causal,
                                  int window, int seg_boundary, float scale, void* stream,
                                  int* kernel) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  SplitArgs a{q, k, v, o, (const int*)lengths, (const uint8_t*)k_valid,
              (const float*)k_scales, (const float*)v_scales, B, Hq, Hkv, Sq, Skv,
              rt::BHS{qsb, qsh, qss}, rt::BHS{ksb, ksh, kss}, rt::BHS{vsb, vsh, vss},
              rt::BHS{osb, osh, oss}, causal, window, seg_boundary, scale};
  // the routing rule: 16-bit q, D in {64, 128, 256}, more than one query
  // row and 16-byte aligned operands take the tensor-core kernel
  const int kv_elt = kv_dtype == rt::kI8 ? 1 : 2;
  const bool tc = (dtype == rt::kBF16 || dtype == rt::kF16) &&
                  (D == 64 || D == 128 || D == 256) && Sq > 1 &&
                  rt::tc::aligned16(q, 2, qsb, qsh, qss) &&
                  rt::tc::aligned16(k, kv_elt, ksb, ksh, kss) &&
                  rt::tc::aligned16(v, kv_elt, vsb, vsh, vss) &&
                  ((uintptr_t)o & 3) == 0 && osb % 2 == 0 && osh % 2 == 0 && oss % 2 == 0;
  if (kernel) *kernel = tc ? 1 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case rt::kF32: return launch_kv<float>(kv_dtype, dtype, D, false, a, s);
    case rt::kBF16: return launch_kv<__nv_bfloat16>(kv_dtype, dtype, D, tc, a, s);
    case rt::kF16: return launch_kv<__half>(kv_dtype, dtype, D, tc, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
