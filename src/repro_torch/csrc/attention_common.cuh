// Shared pieces of the port's hand-written Hopper kernels: element
// conversions, warp reductions, the dtype/head-dim dispatch, and the
// CUDA-core flash-attention core that split_attention.cu and
// join_attention.cu run for float32 q and the shapes their tensor-core
// kernels (attention_tc.cuh) do not take.
//
// Numerics follow the Pallas kernels they replace: NEG_INF = -1e30 (a
// finite mask, so all-pad rows stay finite), scale 1/sqrt(D) applied to
// the float32 dot, float32 online softmax, denominator max(l, 1e-30).
//
// Thread layout of the tiled core: a block of kThreads threads; each query
// row is owned by TPR = D / 16 neighbouring lanes of one warp, each lane
// holding 16 of the row's D dims of q and of the accumulator in registers
// (as four float4 chunks: lane t owns chunks t, t + TPR, t + 2 TPR,
// t + 3 TPR, so the lanes of a row read neighbouring 16-byte words of a
// shared-memory K/V row and never conflict).  A row's dot product is the
// lanes' partial sums reduced with TPR-wide xor shuffles, so every lane of
// the row ends with the full score.  Rows per block: kThreads / TPR
// (32 at D = 64, 8 at D = 256).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rt {

constexpr float kNegInf = -1e30f;
// element type codes of the C entry points (kI8: raw int8 doc K/V)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// Max and sum over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Strides in elements of a [B, H, S, D] operand whose D axis is contiguous.
struct BHS {
  long long b, h, s;
};

constexpr int kThreads = 128;  // threads per attention block
constexpr int kBlockK = 32;    // keys per shared-memory K/V tile
constexpr int kDims = 16;      // dims of a row held by one lane
constexpr int kChunks = kDims / 4;

template <int D>
struct Geo {
  static_assert(D % kDims == 0 && D / kDims <= 16, "head dim must be 16, 32, 64, 128 or 256");
  static constexpr int TPR = D / kDims;        // lanes per query row
  static constexpr int ROWS = kThreads / TPR;  // query rows per block
};

// Softmax state of one query row's slice, held in registers by its lane.
struct RowState {
  float q[kDims];
  float acc[kDims];
  float m, l;
};

// Dim index of element c of chunk i of lane t.
template <int D>
__device__ __forceinline__ int dim_of(int t, int i, int c) {
  return 4 * (t + Geo<D>::TPR * i) + c;
}

template <typename T, int D>
__device__ __forceinline__ void load_row(RowState& st, const T* qp, int t, bool active) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      st.q[4 * i + c] = active ? to_f32(qp[dim_of<D>(t, i, c)]) : 0.f;
      st.acc[4 * i + c] = 0.f;
    }
  st.m = kNegInf;
  st.l = 0.f;
}

template <typename T, int D>
__device__ __forceinline__ void store_row(const RowState& st, T* op, int t) {
  const float inv = 1.f / fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) op[dim_of<D>(t, i, c)] = from_f32<T>(st.acc[4 * i + c] * inv);
}

// Stage keys [k0, k0 + n) (n <= BK) of one K/V head into shared memory as
// float32, with each key's "side": -1 when masked (invalid or past
// `bound`), else its segment (0 or 1; always 0 without a split boundary).
// Raw int8 K/V (KT = int8_t) are widened and multiplied by their token's
// float32 scale (ksc/vsc, indexed by key position).  Called by every
// thread of the block; the caller synchronises around it.
template <typename KT, int D, int BK = kBlockK>
__device__ __forceinline__ void stage_tile(const KT* kp, const KT* vp, long long kss,
                                           long long vss, int k0, int n, const uint8_t* valid,
                                           int bound, int seg_boundary, float* ks, float* vs,
                                           int* kside, const float* ksc = nullptr,
                                           const float* vsc = nullptr) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    float kx = to_f32(kp[(long long)(k0 + j) * kss + d]);
    float vx = to_f32(vp[(long long)(k0 + j) * vss + d]);
    if constexpr (std::is_same<KT, int8_t>::value) {
      kx *= ksc[k0 + j];
      vx *= vsc[k0 + j];
    }
    ks[i] = kx;
    vs[i] = vx;
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int kpos = k0 + j;
    const bool ok = kpos < bound && valid[kpos] != 0;
    kside[j] = ok ? (seg_boundary >= 0 && kpos >= seg_boundary ? 1 : 0) : -1;
  }
}

// Fold one staged tile of n keys (n <= BK) into a row's online-softmax
// state: keys whose side differs from the row's are masked to NEG_INF, and
// so, for a row at position qi and a tile starting at position k0, are
// keys past the row (causal) or at or beyond `window` before it (window >
// 0), exactly as the Pallas kernel masks them inside a tile it does not
// skip.  Every lane of the block must call it (the shuffles span whole
// warps).
template <int D, int BK = kBlockK>
__device__ __forceinline__ void fold_tile(RowState& st, const float* ks, const float* vs,
                                          const int* kside, int n, int row_side, int t,
                                          float scale, int k0 = 0, int qi = 0,
                                          bool causal = false, int window = 0) {
  constexpr int TPR = Geo<D>::TPR;
  float s[BK];
  float m_tile = kNegInf;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + j * D + 4 * (t + TPR * i));
      part = fmaf(st.q[4 * i + 0], kv.x, part);
      part = fmaf(st.q[4 * i + 1], kv.y, part);
      part = fmaf(st.q[4 * i + 2], kv.z, part);
      part = fmaf(st.q[4 * i + 3], kv.w, part);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const int kpos = k0 + j;
    const bool keep = j < n && kside[j] == row_side && (!causal || kpos <= qi) &&
                      (window <= 0 || qi - kpos < window);
    const float sj = keep ? part * scale : kNegInf;
    s[j] = sj;
    m_tile = fmaxf(m_tile, sj);
  }
  const float m_new = fmaxf(st.m, m_tile);
  const float corr = expf(st.m - m_new);
#pragma unroll
  for (int d = 0; d < kDims; ++d) st.acc[d] *= corr;
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    if (j < n) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + 4 * (t + TPR * i));
        st.acc[4 * i + 0] = fmaf(p, vv.x, st.acc[4 * i + 0]);
        st.acc[4 * i + 1] = fmaf(p, vv.y, st.acc[4 * i + 1]);
        st.acc[4 * i + 2] = fmaf(p, vv.z, st.acc[4 * i + 2]);
        st.acc[4 * i + 3] = fmaf(p, vv.w, st.acc[4 * i + 3]);
      }
    }
  }
  st.l = st.l * corr + psum;
  st.m = m_new;
}

}  // namespace rt

// Instantiate LAUNCH(T, D) for the (dtype code, head dim) pair, or return
// cudaErrorInvalidValue for one the kernels do not take.
#define RT_DISPATCH_D(T, D_, LAUNCH)                 \
  switch (D_) {                                      \
    case 16: LAUNCH(T, 16); break;                   \
    case 32: LAUNCH(T, 32); break;                   \
    case 64: LAUNCH(T, 64); break;                   \
    case 128: LAUNCH(T, 128); break;                 \
    default: return (int)cudaErrorInvalidValue;      \
  }

#define RT_DISPATCH(dtype, D_, LAUNCH)                               \
  switch (dtype) {                                                   \
    case rt::kF32: RT_DISPATCH_D(float, D_, LAUNCH); break;          \
    case rt::kBF16: RT_DISPATCH_D(__nv_bfloat16, D_, LAUNCH); break; \
    case rt::kF16: RT_DISPATCH_D(__half, D_, LAUNCH); break;         \
    default: return (int)cudaErrorInvalidValue;                      \
  }
