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
// h / (Hq / Hkv).  Raw int8 K/V are widened and multiplied by their
// token's float32 scale while staged, as the Pallas kernel widens before
// each dot.
//
// Bound on the H100: 4 * D FLOPs per (row, visible key) against 2 bytes
// per element read once.  PreTTR's shapes ([64, 12, 480, 64] bf16) come
// to ~90 FLOPs per byte, gemma3's prefill ([4, 8, 2048, 256] causal, GQA
// 8/4) to ~700: above the bf16 tensor-core ridge (~295), so the card
// could run it in ~0.07 ms a layer.  This kernel runs float32 FMAs on
// CUDA cores, so float32 operations bound it (67 TFLOP/s at best).
//
// Design: one block of 128 threads per (q-tile, head, batch row); each
// query row is held by D / 16 lanes (attention_common.cuh): 32 rows a
// block at D = 64, 8 at D = 256.  The TPU grid's sequential KV axis
// becomes a loop inside the block over K/V tiles staged in shared memory
// as float32 (the rows of a warp read the same key, so the reads
// broadcast): 32 keys a tile, 16 at D = 256, where 32 float32 K and V rows
// (64 KB) would pass the 48 KB of static shared memory.  The loop follows
// the Pallas skip predicate: it ends at lengths[b] and, causal, past the
// q-tile's last row; with a window it starts at the first tile the
// q-tile's first row can still see; tiles wholly on the other side of
// seg_boundary from the whole q-tile are skipped.  Inside a tile each row
// masks by its own position.  causal and window are runtime arguments, so
// the forms share one instantiation per (q type, K/V type, D).  The kernel
// masks its own ragged edges, so the wrapper pads nothing.  At D = 256 a
// row spreads over 16 lanes, so a dot product costs 4 shuffle rounds and
// a block holds only 8 rows: every staged tile serves 8 rows, and K/V are
// read from L2 once per 8 query rows.  Tensor cores (wgmma), TMA and
// register tiling over several rows per lane are the next steps.
#include "attention_common.cuh"

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

template <typename T, typename KT, int D>
int launch_d(const SplitArgs& a, cudaStream_t s) {
  constexpr int rows = rt::Geo<D>::ROWS;
  const dim3 grid((a.Sq + rows - 1) / rows, a.Hq, a.B);
  split_attention_kernel<T, KT, D><<<grid, rt::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The split kernel's own head-dim dispatch: D = 256 needs its 16-key
// tiles, which the join kernels' RT_DISPATCH_D does not offer.
template <typename T, typename KT>
int launch(int D, const SplitArgs& a, cudaStream_t s) {
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
int launch_kv(int kv_dtype, int dtype, int D, const SplitArgs& a, cudaStream_t s) {
  if (kv_dtype == rt::kI8) {
    if (!a.k_scales || !a.v_scales) return (int)cudaErrorInvalidValue;
    return launch<T, int8_t>(D, a, s);
  }
  if (kv_dtype != dtype || a.k_scales || a.v_scales) return (int)cudaErrorInvalidValue;
  return launch<T, T>(D, a, s);
}

}  // namespace

// q, out: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] in q's type (dtype) or
// raw int8 (kv_dtype kI8, with [B, Skv] float32 k_scales / v_scales); all
// with (batch, head, seq) strides and a contiguous D axis.  lengths [B]
// int32, k_valid [B, Skv] bytes.
extern "C" int rt_split_attention(const void* q, const void* k, const void* v, void* o,
                                  const void* lengths, const void* k_valid,
                                  const void* k_scales, const void* v_scales, int dtype,
                                  int kv_dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                  long long qsb, long long qsh, long long qss,
                                  long long ksb, long long ksh, long long kss,
                                  long long vsb, long long vsh, long long vss,
                                  long long osb, long long osh, long long oss, int causal,
                                  int window, int seg_boundary, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  SplitArgs a{q, k, v, o, (const int*)lengths, (const uint8_t*)k_valid,
              (const float*)k_scales, (const float*)v_scales, B, Hq, Hkv, Sq, Skv,
              rt::BHS{qsb, qsh, qss}, rt::BHS{ksb, ksh, kss}, rt::BHS{vsb, vsh, vss},
              rt::BHS{osb, osh, oss}, causal, window, seg_boundary, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case rt::kF32: return launch_kv<float>(kv_dtype, dtype, D, a, s);
    case rt::kBF16: return launch_kv<__nv_bfloat16>(kv_dtype, dtype, D, a, s);
    case rt::kF16: return launch_kv<__half>(kv_dtype, dtype, D, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
