// The tensor-core flash-attention mainloop shared by split_attention.cu
// (split_attention_tc_kernel) and join_attention.cuh (join_tc_kernel):
// bf16 / fp16 q with head dim 64, 128 or 256 and more than one query row.
// Float32 q, other head dims and single-row calls stay on the CUDA-core
// core of attention_common.cuh; each C entry routes explicitly and reports
// which kernel ran.
//
// Layout.  A block holds BM = 16 * WARPS query rows in shared memory; warp
// w owns rows 16w .. 16w + 15 (one m16 row block).  Keys come in tiles of
// 64 rows of K and V, copied from global memory with cp.async (16 bytes a
// thread, zero-filled past the valid length) into a two-stage ring in
// dynamic shared memory while the previous tile is computed.  Every
// 16-bit tile is stored with its 16-byte chunks XOR-swizzled by row
// (chunk ^ (row & 7)), so the ldmatrix reads of eight rows at one logical
// chunk hit eight distinct bank groups.
//
// Products.  S = Q.K^T and O += P.V run on the tensor cores as
// mma.sync.m16n8k16 with float32 accumulators in registers: the Q and K
// fragments come from ldmatrix, V from ldmatrix.trans (V is the B
// operand in its transposed form), and P is the A operand straight from
// the S accumulators, rounded to the MMA type, without a trip through
// shared memory.  The online softmax runs over the S fragment in
// registers: each thread holds 2 rows x 16 keys of a warp's 16 x 64 scores,
// row max and sum reduce over the four threads of a row with two xor
// shuffles.
//
// Why mma.sync and not wgmma: mma.sync's per-thread fragment layouts are
// fixed, so every rounding point could be emulated and tested against the
// JAX references before the kernel ran (tests/test_torch_tensor_core_
// numerics.py), and one design covers D = 64 to 256, int8 and paged rows.
// It reads each K/V tile from shared memory once per 16 query rows, which
// bounds the D = 256 forms at about half of wgmma's rate.  Hopper's wgmma
// (64-row warpgroups, operands from shared-memory descriptors in the
// canonical 128-byte swizzle) with TMA loads, mbarriers and a producer
// warp is the next step.
//
// Numerics, against the reference (split_attention/kernel.py, which widens
// q, K, V and P to float32 before each dot):
//  * products of two bf16 / fp16 values are exact in float32, so
//    S = Q.K^T is the reference's value up to summation order; the scale
//    1/sqrt(D) multiplies the float32 dot, masked scores are NEG_INF =
//    -1e30, m and l are float32 and the denominator is max(l, 1e-30);
//  * P is rounded to the MMA type (bf16: 8 significant bits) before P.V;
//    l sums the unrounded float32 P;
//  * raw int8 K/V: integers up to 127 are exact in bf16 and fp16, so the
//    raw values are staged as 16-bit, each S column is multiplied by its
//    key's float32 K scale and each P column by its V scale: K is never
//    rounded.  The scaled P is split into two 16-bit parts, hi = P
//    rounded and lo = (P - hi) rounded, and P.V runs over both (two
//    MMAs), so P keeps ~16 significant bits: rounded once to bf16, a P
//    scaled by V scales that span decades lost up to 0.07 on outputs
//    that cancel (a card test with scales from 1e-4 to 1);
//  * a doc segment of the other 16-bit type (fp16 cache pools under a
//    bf16 join) is converted to the MMA type while staged, which rounds
//    fp16's 11 significant bits to bf16's 8 -- what the plain impl's
//    .to(compute_dtype) does to those pools.
#pragma once

#include <atomic>

#include "attention_common.cuh"

namespace rt {
namespace tc {

constexpr int kBlockN = 64;                 // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// 16-bit elements of one K or V tile.
template <int D>
struct Tile {
  static_assert(D == 64 || D == 128 || D == 256, "tensor-core head dims are 64, 128, 256");
  static constexpr int kElems = kBlockN * D;
  static constexpr int kChunks = D / 8;     // 16-byte chunks of a 16-bit row
};

// Element offset of (row, 16-byte chunk) in a swizzled 16-bit tile.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !pred (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), float32 accumulators.
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two floats rounded to the 16-bit type, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// x, y rounded to the 16-bit type (hi) and what that rounding left,
// rounded again (lo): hi + lo keeps ~16 significant bits of each.
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x, y);
  float hx, hy;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
    hx = __low2float(h);
    hy = __high2float(h);
  } else {
    const __half2 h = *reinterpret_cast<const __half2*>(&hi);
    hx = __low2float(h);
    hy = __high2float(h);
  }
  lo = pack2<T>(x - hx, y - hy);
}

// Issue the cp.async copies of one K or V tile of 64 rows: row_ptr(j) is
// row j's first element (D of them), copied when ok(j) and zero-filled
// otherwise (`any` is a readable address handed to the zero-fill copies).
// 16-bit rows of the MMA type land swizzled (RAW false); raw rows (int8,
// or the other 16-bit type) land plain, for convert_tile.  All NT threads
// of the block call it.
template <int D, int NT, bool RAW, typename KR, typename RowPtr, typename RowOk>
__device__ __forceinline__ void issue_tile(KR* dst, const void* any, RowPtr row_ptr, RowOk ok) {
  constexpr int E = 16 / sizeof(KR);        // elements a 16-byte chunk
  constexpr int C = D / E;
  for (int i = threadIdx.x; i < kBlockN * C; i += NT) {
    const int j = i / C, c = i - j * C;
    const bool p = ok(j);
    const void* src = p ? (const void*)(row_ptr(j) + c * E) : any;
    cp_async16(dst + (RAW ? j * D + c * E : swz<D>(j, c)), src, p);
  }
}

// Raw staging tile -> swizzled 16-bit tile of the MMA type, 8 elements a
// step: int8 exactly, the other 16-bit type rounded to nearest.
template <typename T, int D, int NT, typename KR>
__device__ __forceinline__ void convert_tile(T* dst, const KR* src) {
  constexpr int C = Tile<D>::kChunks;
  for (int i = threadIdx.x; i < kBlockN * C; i += NT) {
    const int j = i / C, c = i - j * C;
    const KR* s = src + j * D + c * 8;
    float f[8];
    if constexpr (sizeof(KR) == 1) {
      const uint2 raw = *reinterpret_cast<const uint2*>(s);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (float)b[e];
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(s);
      const KR* h = reinterpret_cast<const KR*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = to_f32(h[e]);
    }
    uint4 out;
    out.x = pack2<T>(f[0], f[1]);
    out.y = pack2<T>(f[2], f[3]);
    out.z = pack2<T>(f[4], f[5]);
    out.w = pack2<T>(f[6], f[7]);
    *reinterpret_cast<uint4*>(dst + swz<D>(j, c)) = out;
  }
}

// Per-key facts of one staged tile: side -1 when masked (invalid, past
// the valid length or the segment end), else the key's segment (0 or 1);
// the raw int8 K and V scales (1 for 16-bit keys).
struct KeyMeta {
  int side[kBlockN];
  float ksc[kBlockN];
  float vsc[kBlockN];
};

// One key's facts, loaded into a thread's registers a tile ahead and
// stored to shared memory after the current tile is computed.
struct KeyReg {
  int side;
  float ksc, vsc;
};

__device__ __forceinline__ void store_meta(KeyMeta& m, const KeyReg& r) {
  if (threadIdx.x < kBlockN) {
    m.side[threadIdx.x] = r.side;
    m.ksc[threadIdx.x] = r.ksc;
    m.vsc[threadIdx.x] = r.vsc;
  }
}

// The two-stage ring both kernels run over their K/V tiles, which the
// caller numbers: `first` is the first tile to visit (-1: none) and
// next(t) the one after t (-1: t is the last).  issue(t, st) starts tile
// t's cp.async copies into stage st; load_key(t) reads its keys' facts
// into registers, stored to meta[st] once stage st's previous tile is
// folded; prepare(t, st) turns raw staged rows into the MMA type and
// returns true when it wrote shared memory (the same on every thread);
// attend(t, st, meta[st]) folds the tile.  The q tile's copies, issued
// before, land with the first tile.
template <typename Next, typename Issue, typename LoadKey, typename Prepare, typename Attend>
__device__ __forceinline__ void run_tiles(KeyMeta* meta, int first, Next next, Issue issue,
                                          LoadKey load_key, Prepare prepare, Attend attend) {
  int t = first, st = 0;
  KeyReg kr{-1, 1.f, 1.f};
  if (t >= 0) {
    issue(t, 0);
    kr = load_key(t);
  }
  cp_async_commit();
  store_meta(meta[0], kr);
  while (t >= 0) {
    const int nt = next(t);
    if (nt >= 0) {                            // prefetch the next tile
      issue(nt, st ^ 1);
      kr = load_key(nt);
    }
    cp_async_commit();
    cp_async_wait<1>();                       // this tile (and q) landed
    __syncthreads();
    if (prepare(t, st)) __syncthreads();
    attend(t, st, meta[st]);
    if (nt >= 0) store_meta(meta[st ^ 1], kr);
    __syncthreads();                          // stage st free for reuse
    t = nt;
    st ^= 1;
  }
  cp_async_wait<0>();
}

// Softmax state and output accumulator of a warp's 16 rows: this thread
// holds rows g = lane / 4 and g + 8, dims 8n + 2t, 8n + 2t + 1 (t = lane % 4).
// Up to D = 128 the warp's Q fragments stay in registers once loaded (at
// D = 256 they would take 64 registers beside O's 128, so they are read
// from shared memory each tile).
template <int D>
struct Acc {
  static constexpr bool kQRegs = D <= 128;
  float o[D / 8][4];
  float m[2], l[2];
  uint32_t q[kQRegs ? D / 16 : 1][4];
  bool q_ready;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    q_ready = false;
  }
};

// Masks of one call: positions of the thread's two rows, their sides,
// and the causal / window rule (key position = k0 + key index).
struct RowMask {
  int qi[2];
  int side[2];
  int k0;
  bool causal;
  int window;
};

// Scale and mask a warp's 16 x 64 scores in place and take each row's
// maximum: POS adds the causal and window rules to the key sides.
template <bool POS, bool QUANT>
__device__ __forceinline__ void mask_tile(float (&s)[8][4], float (&mt)[2], const KeyMeta& meta,
                                          const RowMask& rm, int t, float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = 8 * n + 2 * t + (c & 1), r = c >> 1;
      float x = s[n][c];
      if constexpr (QUANT) x *= meta.ksc[key];
      bool keep = meta.side[key] == rm.side[r];
      if constexpr (POS) {
        const int kpos = rm.k0 + key, qi = rm.qi[r];
        keep = keep && (!rm.causal || kpos <= qi) && (rm.window <= 0 || qi - kpos < rm.window);
      }
      x = keep ? x * scale : kNegInf;
      s[n][c] = x;
      mt[r] = fmaxf(mt[r], x);
    }
}

// Fold one staged 64-key tile into a warp's 16 rows.  sQ: the block's
// swizzled q tile; qrow0: the warp's first row in it; sK, sV: the tile.
template <typename T, int D, bool QUANT>
__device__ __forceinline__ void attend_tile(Acc<D>& acc, const T* sQ, int qrow0, const T* sK,
                                            const T* sV, const KeyMeta& meta, const RowMask& rm,
                                            float scale) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.f;

  auto q_frag = [&](uint32_t(&a)[4], int kk) {
    ldsm_x4(a, sQ + swz<D>(qrow0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4)));
  };
  if constexpr (Acc<D>::kQRegs) {
    if (!acc.q_ready) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) q_frag(acc.q[kk], kk);
      acc.q_ready = true;
    }
  }

  // S = Q.K^T over D / 16 k-steps; each ldmatrix.x4 of K feeds two n-tiles
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (Acc<D>::kQRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = acc.q[kk][i];
    } else {
      q_frag(a, kk);
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t b[4];
      ldsm_x4(b, sK + swz<D>(16 * nn + (lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1)));
      mma<T>(s[2 * nn], a, b[0], b[1]);
      mma<T>(s[2 * nn + 1], a, b[2], b[3]);
    }
  }

  // scale, mask, running max
  float mt[2] = {kNegInf, kNegInf};
  if (rm.causal || rm.window > 0)
    mask_tile<true, QUANT>(s, mt, meta, rm, t, scale);
  else
    mask_tile<false, QUANT>(s, mt, meta, rm, t, scale);
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(acc.m[r], mt[r]);
    corr[r] = exp2f((acc.m[r] - m_new) * kLog2e);
    acc.m[r] = m_new;
    acc.l[r] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc.o[n][0] *= corr[0];
    acc.o[n][1] *= corr[0];
    acc.o[n][2] *= corr[1];
    acc.o[n][3] *= corr[1];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      const float p = exp2f((s[n][c] - acc.m[r]) * kLog2e);
      acc.l[r] += p;
      s[n][c] = QUANT ? p * meta.vsc[8 * n + 2 * t + (c & 1)] : p;
    }

  // O += P.V over 4 k-steps of 16 keys; P from the S accumulators.  With
  // the V scales folded in (QUANT), P.V runs twice, over P's hi and lo
  // 16-bit parts, so that the scaled P keeps ~16 significant bits
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4], lo[4];
    if constexpr (QUANT) {
      split2<T>(s[2 * kk][0], s[2 * kk][1], a[0], lo[0]);
      split2<T>(s[2 * kk][2], s[2 * kk][3], a[1], lo[1]);
      split2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], lo[2]);
      split2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], lo[3]);
    } else {
      a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_t(b, sV + swz<D>(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * dn + (lane >> 4)));
      mma<T>(acc.o[2 * dn], a, b[0], b[1]);
      mma<T>(acc.o[2 * dn + 1], a, b[2], b[3]);
      if constexpr (QUANT) {
        mma<T>(acc.o[2 * dn], lo, b[0], b[1]);
        mma<T>(acc.o[2 * dn + 1], lo, b[2], b[3]);
      }
    }
  }
}

// Normalise and write a warp's rows below n_rows; out points at row 0 of
// the block's q tile, row stride os (elements).
template <typename T, int D>
__device__ __forceinline__ void store_rows(Acc<D>& acc, T* out, long long os, int qrow0,
                                           int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = acc.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = qrow0 + g + 8 * r;
    if (row >= n_rows) continue;
    T* op = out + (long long)row * os + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(op + 8 * n) =
          pack2<T>(acc.o[n][2 * r] * inv, acc.o[n][2 * r + 1] * inv);
  }
}

// Copy the block's q rows [q0, q0 + BM) below Sq into the swizzled sQ.
template <int D, int NT, int BM, typename T>
__device__ __forceinline__ void issue_q(T* sQ, const T* qp, long long qss, int q0, int Sq) {
  constexpr int C = Tile<D>::kChunks;
  for (int i = threadIdx.x; i < BM * C; i += NT) {
    const int r = i / C, c = i - r * C;
    const bool p = q0 + r < Sq;
    cp_async16(sQ + swz<D>(r, c), p ? (const void*)(qp + (long long)(q0 + r) * qss + c * 8)
                                    : (const void*)qp, p);
  }
}

// True when a pointer and every stride (in elements of `elt` bytes) keep
// 16-byte alignment: what the cp.async copies need.
__host__ __forceinline__ bool aligned16(const void* p, int elt, long long s0, long long s1,
                                        long long s2) {
  const long long e = 16 / elt;
  return ((uintptr_t)p & 15) == 0 && s0 % e == 0 && s1 % e == 0 && s2 % e == 0;
}

// Raise a kernel's dynamic shared memory limit once per (kernel, device):
// the attribute belongs to the current device, so every card a process
// launches on needs its own call (one bit a device in `raised`).
template <typename K>
inline int allow_smem(K kernel, int bytes, std::atomic<unsigned>& raised) {
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(raised.load() & bit)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    raised.fetch_or(bit);
  }
  return 0;
}

}  // namespace tc
}  // namespace rt
