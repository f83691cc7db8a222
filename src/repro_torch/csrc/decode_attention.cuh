// One query row per head against a K/V sequence, for Hopper (sm_90a): the
// split-KV ("flash-decoding") kernel behind both Sq = 1 attention entries,
// rt_decode_attention (decode_attention.cu) and rt_join_attention_row
// (join_attention_row.cu).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// flash_decode_pallas (_decode_kernel), every form; and the CLS row (Sq =
// 1, float doc K/V) of src/repro/kernels/join_attention/kernel.py,
// join_attention_pallas.
//
// Computes, per (b, query head h = hk * R + r): softmax over the visible
// keys of q.k / sqrt(D), times V.  The key source says which keys a batch
// row sees: OneSeq (flash decode) the range [lo, hi) of one sequence, hi =
// min(lengths[b], S), lo = lengths[b] - window for window > 0, masked by
// an optional k_valid; JoinSeqs (the join's CLS row) the query segment
// under kq_valid, then the doc segment under kd_valid, never concatenated.
// Numerics as the Pallas kernels: float32 scores and online softmax,
// NEG_INF = -1e30, scale 1/sqrt(D), denominator max(l, 1e-30), head h
// reads KV head h / R.  Masked keys are never read and add nothing, so a
// row without a valid key writes 0.
//
// Bound on the H100: every visible K and V byte is read once for 4 * D
// FLOPs per (query row, key): R FLOPs a byte in bf16 (R = 1 for
// PreTTR-BERT, 2 for gemma3), far below either ridge, so memory bytes
// bound it.  PreTTR's CLS layers run q [32, 12, 1, 64] against 512 keys;
// gemma3's decode step q [4, 8, 1, 256] against K/V [4, 4, 2080, 256].
//
// Design.  The Pallas grid (B, Hkv, nK) walks its key axis in order on the
// TPU, carrying the softmax state in scratch; here that axis becomes
// parallel blocks and a merge.
//  * Grid (Hkv * row groups, B, n_splits): a block takes one GQA group's
//    R rows (at most 8, in RB registers' worth; larger groups split into
//    row groups) and one chunk of the row's keys.  The wrapper picks
//    n_splits from static shapes only (kernels/decode_attention/plan.py);
//    chunk bounds are computed here, relative to each row's lo and capped
//    at its hi, so window layers keep every split busy.  An empty split
//    writes the empty state (m = NEG_INF, l = 0) without reading K/V.
//  * Lanes: a key is owned by LPK = D / 8 neighbouring lanes, each holding
//    8 of its dims; a block's KG = 128 / LPK lane groups take the keys of
//    a BN = 4 * KG key tile, 4 keys each, so a warp reads whole rows, 16
//    bytes a lane, neighbouring lanes on neighbouring addresses.  A key's
//    score is the lanes' partial dots reduced with log2(LPK) xor shuffles;
//    its group's 4 keys then fold into the group's own online-softmax
//    state (m, l, acc[RB][8] in registers) with one max and one rescale a
//    tile, and P.V runs over the same 8 dims a lane.
//  * Bytes in flight: each lane copies exactly the 16-byte pieces it will
//    read into its own shared-memory slots with cp.async, a ring of three
//    16 KB tiles of 16-bit K and V (two 32 KB tiles of float32), so no
//    barrier is needed inside the key loop and a 16-bit block keeps 32 KB
//    in flight.  Masked keys are not copied; their validity bytes are
//    loaded an iteration before the copies that need them.  Rows not
//    16-byte aligned are copied with plain loads into the same slots.
//  * Merges, in a fixed order (no atomics: repeated calls give the same
//    bits): the block's lane groups merge in shared memory; with one split
//    the block writes the output, else float32 partials (m, l, acc[D]) a
//    row, which sq1_merge_kernel combines: M = max m_i, out = sum acc_i
//    e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-30), skipping splits with
//    l = 0.
#pragma once

#include <atomic>

#include "attention_tc.cuh"

namespace rt {
namespace sq1 {
// Internal linkage: both entries' translation units instantiate the merge
// kernel, and each keeps its own copy.
namespace {

constexpr int kThreads = 128;
constexpr int kKeys = 4;         // keys a lane group takes from each tile
constexpr int kSplitAlign = 16;  // split chunks round up to this many keys
constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 4096;  // the merge's weights fit 32 KB of shared memory
constexpr int kBlockRows = 8;     // query rows a block at most: larger groups take row groups

// The host planner (kernels/decode_attention/plan.py) sizes splits and
// blocks with copies of the three constants above; the entries refuse to
// launch when the copies they are passed differ, so the two cannot drift.
inline bool plan_agrees(int align, int max_splits, int block_rows) {
  return align == kSplitAlign && max_splits == kMaxSplits && block_rows == kBlockRows;
}

template <typename T, int D>
struct Geo {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "head dim must be 16, 32, 64, 128 or 256");
  static constexpr int LPK = D / 8;            // lanes a key
  static constexpr int KG = kThreads / LPK;    // lane groups a block
  static constexpr int BN = kKeys * KG;        // keys a tile
  static constexpr int VEC = 16 / sizeof(T);   // elements a 16-byte copy
  static constexpr int NV = 8 / VEC;           // copies a lane's 8 dims
  static constexpr int kStageBytes = kKeys * 2 * NV * kThreads * 16;
  // key tiles in a lane's cp.async ring: three 16 KB tiles of 16-bit K
  // and V, two 32 KB tiles of float32
  static constexpr int kStages = NV == 1 ? 3 : 2;
  static constexpr int kSmem = kStages * kStageBytes;
};

// Keys of one split: the row's [lo, hi) cut into n_splits chunks of a
// multiple of kSplitAlign keys (plan.py's split_bounds).
__host__ __device__ __forceinline__ int split_chunk(int span, int n_splits) {
  const int per = span > 0 ? (span + n_splits - 1) / n_splits : 0;
  return (per + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
}

// Flash decode's keys: one sequence [B, Hkv, S, D].
template <typename T>
struct OneSeq {
  const T* k;
  const T* v;
  BHS ks, vs;
  const int* lengths;     // [B], or null: S
  const uint8_t* valid;   // [B, S], or null: every key in [lo, hi)
  int S, window;

  __device__ __forceinline__ void range(int b, int& lo, int& hi) const {
    const int length = lengths ? lengths[b] : S;
    hi = min(length, S);
    // q_pos - j < window  <=>  j >= q_pos - window + 1, q_pos = length - 1
    lo = window > 0 ? max(0, length - window) : 0;
  }
  __device__ __forceinline__ unsigned valid_byte(int b, int j) const {
    return valid ? valid[(long long)b * S + j] : 1u;
  }
  __device__ __forceinline__ const T* row(int is_v, int b, int hk, int j) const {
    return is_v ? v + b * vs.b + hk * vs.h + j * vs.s : k + b * ks.b + hk * ks.h + j * ks.s;
  }
};

// The join's CLS row: the query segment [B, Hkv, Lq, D] then the doc
// segment [B, Hkv, Ld, D], as key positions [0, Lq) and [Lq, Lq + Ld).
template <typename T>
struct JoinSeqs {
  const T *kq, *vq, *kd, *vd;
  BHS kqs, vqs, kds, vds;
  const uint8_t* kq_valid;  // [B, Lq], or null
  const uint8_t* kd_valid;  // [B, Ld], or null
  int Lq, Ld;

  __device__ __forceinline__ void range(int, int& lo, int& hi) const {
    lo = 0;
    hi = Lq + Ld;
  }
  __device__ __forceinline__ unsigned valid_byte(int b, int j) const {
    if (j < Lq) return kq_valid ? kq_valid[(long long)b * Lq + j] : 1u;
    return kd_valid ? kd_valid[(long long)b * Ld + (j - Lq)] : 1u;
  }
  __device__ __forceinline__ const T* row(int is_v, int b, int hk, int j) const {
    if (j < Lq)
      return is_v ? vq + b * vqs.b + hk * vqs.h + j * vqs.s
                  : kq + b * kqs.b + hk * kqs.h + j * kqs.s;
    j -= Lq;
    return is_v ? vd + b * vds.b + hk * vds.h + j * vds.s
                : kd + b * kds.b + hk * kds.h + j * kds.s;
  }
};

// The query rows, the output and the split partials of one call.
template <typename T>
struct Rows {
  const T* q;        // [B, Hq, 1, D], (batch, head) strides qsb, qsh
  T* o;              // the same shape, strides osb, osh
  float* part;       // [B, Hq, n_splits, D + 2] (m, l, acc), or null
  long long qsb, qsh, osb, osh;
  int Hq, R, n_rg, n_splits;
  int vec;           // every K/V row 16-byte aligned: cp.async copies
  float scale;
};

// 16 bytes of a K/V row into a lane's slot: cp.async when the rows are
// aligned, else plain loads; zero-filled (and not read) when !ok.
template <typename T>
__device__ __forceinline__ void copy16(void* dst, const T* src, bool ok, int vec) {
  if (vec) {
    tc::cp_async16(dst, src, ok);
    return;
  }
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    T* e = reinterpret_cast<T*>(&x);
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(T)); ++i) e[i] = src[i];
  }
  *reinterpret_cast<uint4*>(dst) = x;
}

// A lane's 8 staged elements of key k (kv 0: K, 1: V) as float32.
template <typename T, int D>
__device__ __forceinline__ void load8(const unsigned char* stage, int k, int kv, float (&f)[8]) {
  using G = Geo<T, D>;
#pragma unroll
  for (int n = 0; n < G::NV; ++n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        stage + (((k * 2 + kv) * G::NV + n) * kThreads + threadIdx.x) * 16);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < G::VEC; ++i) f[n * G::VEC + i] = to_f32(e[i]);
  }
}

template <typename T, int D, int RB, typename Keys>
__global__ void __launch_bounds__(kThreads)
sq1_attention_kernel(const Keys keys, const Rows<T> a) {
  using G = Geo<T, D>;
  static_assert(G::KG * RB * (D + 2) * (int)sizeof(float) <= G::kSmem,
                "the lane groups' merge must fit in the staging ring");
  extern __shared__ __align__(16) unsigned char sq1_smem[];
  unsigned char* const smem = sq1_smem;
  const int t = threadIdx.x, g = t / G::LPK, c = t % G::LPK;
  const int hk = blockIdx.x / a.n_rg, r0 = (blockIdx.x % a.n_rg) * RB;
  const int nr = min(RB, a.R - r0);
  const int b = blockIdx.y, split = blockIdx.z;
  const int h0 = hk * a.R + r0;        // the block's first query head
  int lo, hi;
  keys.range(b, lo, hi);
  const int chunk = split_chunk(hi - lo, a.n_splits);
  const int s_lo = lo + split * chunk, s_hi = min(hi, s_lo + chunk);
  auto partial = [&](int r) {
    return a.part + (((long long)b * a.Hq + h0 + r) * a.n_splits + split) * (D + 2);
  };
  if (a.n_splits > 1 && s_lo >= s_hi) {   // no key: the empty state
    if (t < nr) {
      partial(t)[0] = kNegInf;
      partial(t)[1] = 0.f;
    }
    return;
  }

  float qr[RB][8], acc[RB][8], m[RB], l[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const T* qp = a.q + b * a.qsb + (long long)(h0 + r) * a.qsh + 8 * c;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[r][e] = r < nr ? to_f32(qp[e]) : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int n_tiles = s_hi > s_lo ? (s_hi - s_lo + G::BN - 1) / G::BN : 0;
  constexpr int ST = G::kStages;
  // the validity bytes of this lane's keys of tile i (0 past the split)
  auto load_valid = [&](int i, unsigned (&vb)[kKeys]) {
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const int j = s_lo + i * G::BN + k * G::KG + g;
      vb[k] = i < n_tiles && j < s_hi ? keys.valid_byte(b, j) : 0u;
    }
  };
  auto bits_of = [](const unsigned (&vb)[kKeys]) {
    unsigned bits = 0u;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) bits |= (vb[k] != 0u ? 1u : 0u) << k;
    return bits;
  };
  // copy the valid keys (bit k: key k) of tile i into its stage's slots
  auto issue = [&](int i, unsigned bits) {
    if (i < n_tiles) {
      unsigned char* stage = smem + (i % ST) * G::kStageBytes;
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const int j = s_lo + i * G::BN + k * G::KG + g;
        const bool ok = (bits >> k) & 1u;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const T* src = keys.row(kv, b, hk, ok ? j : s_lo) + 8 * c;
#pragma unroll
          for (int n = 0; n < G::NV; ++n)
            copy16(stage + (((k * 2 + kv) * G::NV + n) * kThreads + t) * 16,
                   src + n * G::VEC, ok, a.vec);
        }
      }
    }
    tc::cp_async_commit();
  };

  // A tile's validity is loaded one iteration before its copies are
  // issued, so no copy waits on it; `ring` keeps the bits of the tiles in
  // flight, 4 a tile, the next tile to fold in the low bits.
  unsigned vb[ST][kKeys], ring = 0u;
#pragma unroll
  for (int i = 0; i < ST; ++i) load_valid(i, vb[i]);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    const unsigned bits = bits_of(vb[i]);
    issue(i, bits);
    ring |= bits << (4 * i);
  }
  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed in this lane's slots (only this lane reads them)
    tc::cp_async_wait<ST - 2>();
    const unsigned next = bits_of(vb[ST - 1]);
    issue(i + ST - 1, next);             // into the slots tile i - 1 used
    ring |= next << (4 * (ST - 1));
    load_valid(i + ST, vb[ST - 1]);      // for the next iteration's copies
    const unsigned bits = ring & 0xfu;
    ring >>= 4;
    const unsigned char* stage = smem + (i % ST) * G::kStageBytes;
    if (!__any_sync(0xffffffffu, bits != 0u)) continue;   // the warp's keys are masked
    bool ok[kKeys];
#pragma unroll
    for (int k = 0; k < kKeys; ++k) ok[k] = (bits >> k) & 1u;
    float s[kKeys][RB];
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      float kf[8];
      load8<T, D>(stage, k, 0, kf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[r][e], kf[e], dot);
#pragma unroll
        for (int off = G::LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[k][r] = ok[k] ? dot * a.scale : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int k = 0; k < kKeys; ++k) m_new = fmaxf(m_new, s[k][r]);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      float vf[8];
      load8<T, D>(stage, k, 1, vf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float p = ok[k] ? expf(s[k][r] - m[r]) : 0.f;
        l[r] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                       // the ring becomes the merge buffer

  float* mm = reinterpret_cast<float*>(smem);   // [KG][RB]
  float* ll = mm + G::KG * RB;                  // [KG][RB]
  float* aa = ll + G::KG * RB;                  // [KG][RB][D]
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (c == 0) {
      mm[g * RB + r] = m[r];
      ll[g * RB + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) aa[(g * RB + r) * D + 8 * c + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = t; idx < nr * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float mx = kNegInf;
    for (int gg = 0; gg < G::KG; ++gg) mx = fmaxf(mx, mm[gg * RB + r]);
    float den = 0.f, num = 0.f;
    for (int gg = 0; gg < G::KG; ++gg) {
      const float w = expf(mm[gg * RB + r] - mx);
      den = fmaf(ll[gg * RB + r], w, den);
      num = fmaf(aa[(gg * RB + r) * D + d], w, num);
    }
    if (a.n_splits == 1) {
      a.o[b * a.osb + (long long)(h0 + r) * a.osh + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
    } else {
      float* p = partial(r);
      if (d == 0) {
        p[0] = mx;
        p[1] = den;
      }
      p[2 + d] = num;
    }
  }
}

// Combine each row's n_splits partials in split order.  Grid (Hq, B).  The
// splits' m and l are read by parallel threads and turned into weights
// once, in shared memory; each thread then sums its dims' acc over the
// splits with loads that do not wait on each other.  Splits of weight 0
// (an empty split, which wrote no acc) are skipped.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
sq1_merge_kernel(const float* __restrict__ part, T* __restrict__ o, int Hq, int D, int n_splits,
                 long long osb, long long osh) {
  extern __shared__ float sq1_w[];            // [n_splits] weights, [n_splits] l * weight
  __shared__ float red[kMergeThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const float* p = part + ((long long)b * Hq + h) * n_splits * (D + 2);
  float mx = kNegInf;
  for (int i = t; i < n_splits; i += kMergeThreads)
    if (p[i * (D + 2) + 1] > 0.f) mx = fmaxf(mx, p[i * (D + 2)]);
  mx = warp_max(mx);
  if ((t & 31) == 0) red[t >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < kMergeThreads / 32; ++i) mx = fmaxf(mx, red[i]);
  for (int i = t; i < n_splits; i += kMergeThreads) {
    const float l = p[i * (D + 2) + 1];
    const float wi = l > 0.f ? expf(p[i * (D + 2)] - mx) : 0.f;
    sq1_w[i] = wi;
    sq1_w[n_splits + i] = l * wi;
  }
  __syncthreads();
  float den = 0.f;
  for (int i = 0; i < n_splits; ++i) den += sq1_w[n_splits + i];
  for (int d = t; d < D; d += kMergeThreads) {
    float num = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_splits; ++i) {
      const float wi = sq1_w[i];
      if (wi != 0.f) num = fmaf(p[i * (D + 2) + 2 + d], wi, num);
    }
    o[b * osb + (long long)h * osh + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

inline bool rows_aligned(const void* p, BHS s, int elt) {
  return ((uintptr_t)p & 15) == 0 && (s.b * elt) % 16 == 0 && (s.h * elt) % 16 == 0 &&
         (s.s * elt) % 16 == 0;
}

// The attention kernel, then the merge when n_splits > 1; *launched says
// how many kernels ran.  The dynamic shared-memory limit is raised once per
// (instantiation, device), not every launch.
template <typename T, int D, int RB, typename Keys>
int launch_d(const Keys& keys, const Rows<T>& a, int Hkv, int B, cudaStream_t s, int* launched) {
  constexpr int smem = Geo<T, D>::kSmem;
  static std::atomic<unsigned> raised{0};   // a bit a device
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(raised.load() & bit)) {
    if (int err = cudaFuncSetAttribute(sq1_attention_kernel<T, D, RB, Keys>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return err;
    raised.fetch_or(bit);
  }
  sq1_attention_kernel<T, D, RB, Keys>
      <<<dim3(Hkv * a.n_rg, B, a.n_splits), kThreads, smem, s>>>(keys, a);
  *launched = 1;
  if (a.n_splits > 1) {
    if (int err = (int)cudaGetLastError()) return err;
    sq1_merge_kernel<T><<<dim3(a.Hq, B), kMergeThreads, 2 * a.n_splits * sizeof(float), s>>>(
        a.part, a.o, a.Hq, D, a.n_splits, a.osb, a.osh);
    *launched = 2;
  }
  return (int)cudaGetLastError();
}

// Dispatch on the head dim and the padded group size RB (1, 2, 4 or
// kBlockRows; larger groups take row groups of kBlockRows).
template <typename T, typename Keys>
int launch(const Keys& keys, Rows<T> a, int D, int Hkv, int B, cudaStream_t s, int* launched) {
  if (a.R < 1 || a.n_splits < 1 || a.n_splits > kMaxSplits || B > 65535 ||
      (a.n_splits > 1 && !a.part))
    return (int)cudaErrorInvalidValue;
  const int RB = a.R == 1 ? 1 : a.R == 2 ? 2 : a.R <= 4 ? 4 : kBlockRows;
  a.n_rg = (a.R + RB - 1) / RB;
#define SQ1_LAUNCH_R(DD)                                                       \
  switch (RB) {                                                                \
    case 1: return launch_d<T, DD, 1>(keys, a, Hkv, B, s, launched);           \
    case 2: return launch_d<T, DD, 2>(keys, a, Hkv, B, s, launched);           \
    case 4: return launch_d<T, DD, 4>(keys, a, Hkv, B, s, launched);           \
    default: return launch_d<T, DD, kBlockRows>(keys, a, Hkv, B, s, launched); \
  }
  switch (D) {
    case 16: SQ1_LAUNCH_R(16)
    case 32: SQ1_LAUNCH_R(32)
    case 64: SQ1_LAUNCH_R(64)
    case 128: SQ1_LAUNCH_R(128)
    case 256: SQ1_LAUNCH_R(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SQ1_LAUNCH_R
}

}  // namespace
}  // namespace sq1
}  // namespace rt
