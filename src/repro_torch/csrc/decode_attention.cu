// Flash decode: one query row per query head against a K/V sequence, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// flash_decode_pallas (_decode_kernel), the whole contract: GQA groups,
// lengths, non-prefix validity and the sliding window.
//
// Computes, per (b, query head h = hk * R + r): softmax over the keys j
// with j < lengths[b], k_valid[b, j] and, for window > 0,
// q_pos - j < window (q_pos = lengths[b] - 1), of q.k / sqrt(D), times V.
// The R = Hq / Hkv heads of one GQA group read KV head hk.  Numerics as the
// Pallas kernel: float32 scores and online softmax, NEG_INF = -1e30,
// denominator max(l, 1e-30).  Keys past lengths[b] (and, with a window,
// before q_pos - window + 1) are never read; masked keys inside that range
// add nothing, so a row without a valid key writes 0.
//
// Bound on the H100: every K and V byte up to the row's last key is read
// once for 4 * D FLOPs per (query row, key) -- about R FLOPs per byte in
// bf16, far below either ridge, so memory bytes bound this kernel.  PreTTR's
// CLS-only final layer runs it at q [32, 12, 1, 64] against 512 keys; the
// LM decode step at q [B, 8, 1, 256] against K/V [B, 4, S, 256].
//
// Design: one block of four warps per (kv head, batch row).  Warps take
// strided 32-key tiles; within a tile the lanes split D (lane t owns dims
// t, t + 32, ...), so each K and V row is read coalesced, and each key's
// dot product is the lanes' partial sums reduced with xor shuffles.  Lane
// j keeps key j's score, so the tile's max and sum are warp reductions.
// Only the valid keys of a tile (a ballot) are loaded.  Each warp keeps the
// online-softmax state (m, l, acc[R][D]) of the group's R rows in
// registers; the four warps merge in shared memory at the end.  R is
// rounded up to 1, 2, 4 or 8 at compile time; the padding rows see q = 0
// and are not written.  No K/V staging in shared memory: the merge needs
// at most 33 KB (R = 8, D = 256).  Vector loads, TMA and a split over S
// for small B * Hkv are the next steps.
#include "attention_common.cuh"

namespace {

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;

template <typename T, int D, int RB>
__global__ void __launch_bounds__(kDecThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ lengths,
                        const uint8_t* __restrict__ k_valid, int R, int S,
                        long long qsb, long long qsh, rt::BHS ks, rt::BHS vs,
                        long long osb, long long osh, int window, float scale) {
  constexpr int DL = (D + 31) / 32;  // dims per lane (lanes >= D idle at D = 16)
  extern __shared__ float smem[];
  float* m_sh = smem;                       // [kDecWarps][RB]
  float* l_sh = m_sh + kDecWarps * RB;      // [kDecWarps][RB]
  float* acc_sh = l_sh + kDecWarps * RB;    // [kDecWarps][RB][D]

  const int b = blockIdx.y, hk = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int length = lengths[b];
  const int hi = min(length, S);
  // q_pos - j < window  <=>  j >= q_pos - window + 1
  const int lo = window > 0 ? max(0, length - window) : 0;

  float qr[RB][DL], acc[RB][DL], m[RB], l[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const T* qp = q + b * qsb + (long long)(hk * R + r) * qsh;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = i * 32 + lane;
      qr[r][i] = (r < R && d < D) ? rt::to_f32(qp[d]) : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = rt::kNegInf;
    l[r] = 0.f;
  }
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  const uint8_t* valid = k_valid + (long long)b * S;

  for (int t0 = (lo / 32) * 32 + warp * 32; t0 < hi; t0 += kDecThreads) {
    const int kpos = t0 + lane;
    const bool ok = kpos >= lo && kpos < hi && valid[kpos] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (mask == 0) continue;
    float s[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) s[r] = rt::kNegInf;
    for (unsigned rest = mask; rest; rest &= rest - 1) {
      const int j = __ffs(rest) - 1;
      const T* kr = kp + (long long)(t0 + j) * ks.s;
      float kv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = i * 32 + lane;
        kv[i] = d < D ? rt::to_f32(kr[d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) part = fmaf(qr[r][i], kv[i], part);
        part = rt::warp_sum(part);
        if (lane == j) s[r] = part * scale;
      }
    }
    // s becomes this lane's key's probability under the updated max
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float m_new = fmaxf(m[r], rt::warp_max(s[r]));
      const float corr = expf(m[r] - m_new);
      const float p = ok ? expf(s[r] - m_new) : 0.f;
      l[r] = l[r] * corr + rt::warp_sum(p);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= corr;
      m[r] = m_new;
      s[r] = p;
    }
    for (unsigned rest = mask; rest; rest &= rest - 1) {
      const int j = __ffs(rest) - 1;
      const T* vr = vp + (long long)(t0 + j) * vs.s;
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = i * 32 + lane;
        vv[i] = d < D ? rt::to_f32(vr[d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

  // merge the warps' states: rescale each to the common max
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (lane == 0) {
      m_sh[warp * RB + r] = m[r];
      l_sh[warp * RB + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = i * 32 + lane;
      if (d < D) acc_sh[(warp * RB + r) * D + d] = acc[r][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += kDecThreads) {
    const int r = idx / D, d = idx - r * D;
    float mx = rt::kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_sh[w * RB + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = expf(m_sh[w * RB + r] - mx);
      den = fmaf(l_sh[w * RB + r], c, den);
      num = fmaf(acc_sh[(w * RB + r) * D + d], c, num);
    }
    o[b * osb + (long long)(hk * R + r) * osh + d] = rt::from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch_decode(int RB, dim3 grid, cudaStream_t s, const void* q, const void* k,
                  const void* v, void* o, const int* lengths, const uint8_t* k_valid, int R,
                  int S, long long qsb, long long qsh, rt::BHS ks, rt::BHS vs, long long osb,
                  long long osh, int window, float scale) {
  const size_t smem = sizeof(float) * kDecWarps * RB * (2 + D);
#define LAUNCH_R(RB_)                                                                          \
  decode_attention_kernel<T, D, RB_><<<grid, kDecThreads, smem, s>>>(                          \
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lengths, k_valid, R, S, qsb, qsh, ks, vs, \
      osb, osh, window, scale)
  switch (RB) {
    case 1: LAUNCH_R(1); break;
    case 2: LAUNCH_R(2); break;
    case 4: LAUNCH_R(4); break;
    case 8: LAUNCH_R(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_R
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, int RB, dim3 grid, cudaStream_t s, const void* q, const void* k,
               const void* v, void* o, const int* lengths, const uint8_t* k_valid, int R, int S,
               long long qsb, long long qsh, rt::BHS ks, rt::BHS vs, long long osb,
               long long osh, int window, float scale) {
#define LAUNCH_D(DD)                                                                   \
  return launch_decode<T, DD>(RB, grid, s, q, k, v, o, lengths, k_valid, R, S, qsb, qsh, \
                              ks, vs, osb, osh, window, scale)
  switch (D) {
    case 16: LAUNCH_D(16);
    case 32: LAUNCH_D(32);
    case 64: LAUNCH_D(64);
    case 128: LAUNCH_D(128);
    case 256: LAUNCH_D(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_D
}

}  // namespace

// q, out: [B, Hq, 1, D] with (batch, head) strides; k, v: [B, Hkv, S, D]
// with (batch, head, seq) strides; lengths [B] int32; k_valid [B, S] bytes.
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   const void* lengths, const void* k_valid, int dtype, int B,
                                   int Hq, int Hkv, int S, int D, long long qsb, long long qsh,
                                   long long ksb, long long ksh, long long kss, long long vsb,
                                   long long vsh, long long vss, long long osb, long long osh,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int R = Hq / Hkv;
  if (R < 1 || R > 8) return (int)cudaErrorInvalidValue;
  const int RB = R == 1 ? 1 : R == 2 ? 2 : R <= 4 ? 4 : 8;
  const dim3 grid(Hkv, B);
  const rt::BHS ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = (const int*)lengths;
  const uint8_t* val = (const uint8_t*)k_valid;
  switch (dtype) {
    case rt::kF32:
      return dispatch_d<float>(D, RB, grid, s, q, k, v, o, len, val, R, S, qsb, qsh, ks, vs,
                               osb, osh, window, scale);
    case rt::kBF16:
      return dispatch_d<__nv_bfloat16>(D, RB, grid, s, q, k, v, o, len, val, R, S, qsb, qsh,
                                       ks, vs, osb, osh, window, scale);
    case rt::kF16:
      return dispatch_d<__half>(D, RB, grid, s, q, k, v, o, len, val, R, S, qsb, qsh, ks, vs,
                                osb, osh, window, scale);
    default: return (int)cudaErrorInvalidValue;
  }
}
