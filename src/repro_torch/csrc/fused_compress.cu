// PreTTR's d -> e -> d compressor (paper section 4.2), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_compress/kernel.py, compress_pallas
// (_compress_kernel) and decompress_pallas (_decompress_kernel).
//
//  * compress:   out[T, e] = GELU_tanh(x[T, d] @ W[d, e] + b), stored as
//                fp16 or, for a quantising index codec (int8), float32
//  * decompress: out[T, d] = LayerNorm(r[T, e] widened @ W[e, d] + b)
//                            * gamma + beta, eps 1e-6, cast to bf16/f16/f32;
//                r is the fp16 index payload or, decoded from int8,
//                float32
// Both run float32 throughout, as the Pallas kernels do.
//
// Bound on the H100: at the main-path shapes (compress [64*480, 768] x
// [768, 256] at index time, decompress [32*480, 256] x [256, 768] per
// micro-batch) a row costs 2*d*e FLOPs against (d + e) * 2 bytes, about
// 190 FLOPs per byte: with a float32 weight this kernel is bound by
// float32 operations on CUDA cores (the bf16 tensor-core path is a later
// step).
//
// Design: one block of 256 threads owns a tile of 16 rows.  The rows are
// staged in shared memory as float32 once (row-major, so the staging
// writes never conflict); thread c owns output columns c, c + 256, ...
// (NC = ceil(n_cols / 256) of them: 1 for compress at e = 256, 3 for
// decompress at d = 768) and keeps NC x 16 accumulators in registers.  Per
// step of 4 along k it reads 4 weight elements per column (coalesced
// across the warp, each reused for 16 rows) and 16 float4 words of the
// staged rows (the same address across the warp: a broadcast), for
// 64 * NC FMAs.  The epilogue is fused in the same block: compress adds
// the bias, applies GELU and writes fp16; decompress writes bias-added
// rows to a shared row buffer of 16 x d float32 (48 KB at d = 768, above
// the default limit, so the launch raises
// cudaFuncAttributeMaxDynamicSharedMemorySize), then each warp normalises
// whole rows with shuffle reductions and writes the cast result.  The
// input rows are staged as float32 whatever their stored type, so a
// float32 input needs no more shared memory than fp16 (64 KB a block at
// e = 256, d = 768).
#include "attention_common.cuh"

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 256;
constexpr int kMaxCols = 4 * kThreads;   // NC <= 4

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Stage rows [row0, row0 + kRows) of a [T, n] matrix as float32 (zeros past T).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* src, float* dst, int row0, int T_rows, int n) {
  for (int i = threadIdx.x; i < kRows * n; i += kThreads) {
    const int r = i / n, c = i - r * n;
    const int row = row0 + r;
    dst[i] = row < T_rows ? rt::to_f32(src[(long long)row * n + c]) : 0.f;
  }
}

// acc[j][r] = sum_k xs[r, k] * w[k, c_j] for the block's kRows staged rows
// xs [kRows, k_dim] and this thread's columns c_j = threadIdx.x + j * kThreads
// (columns past n_cols read nothing and stay 0).  k_dim % 4 == 0.
template <int NC>
__device__ __forceinline__ void rows_times_columns(const float* xs, const float* __restrict__ w,
                                                   int k_dim, int n_cols, float (&acc)[NC][kRows]) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[j][r] = 0.f;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const int k4 = k_dim / 4;
  for (int kq = 0; kq < k4; ++kq) {
    float wk[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = threadIdx.x + j * kThreads;
#pragma unroll
      for (int u = 0; u < 4; ++u) wk[j][u] = c < n_cols ? w[(long long)(4 * kq + u) * n_cols + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 x = xs4[r * k4 + kq];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float a = acc[j][r];
        a = fmaf(x.x, wk[j][0], a);
        a = fmaf(x.y, wk[j][1], a);
        a = fmaf(x.z, wk[j][2], a);
        a = fmaf(x.w, wk[j][3], a);
        acc[j][r] = a;
      }
    }
  }
}

template <typename T, typename OutT, int NC>
__global__ void __launch_bounds__(kThreads)
compress_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, OutT* __restrict__ out, int T_rows, int d,
                int e) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // [kRows, d]
  const int row0 = blockIdx.x * kRows;
  stage_rows<T>(x, xs, row0, T_rows, d);
  __syncthreads();
  float acc[NC][kRows];
  rows_times_columns<NC>(xs, w, d, e, acc);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c >= e) continue;
    const float bc = bias[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < T_rows)
        out[(long long)(row0 + r) * e + c] = rt::from_f32<OutT>(gelu_tanh(acc[j][r] + bc));
  }
}

template <typename InT, typename OutT, int NC>
__global__ void __launch_bounds__(kThreads)
decompress_kernel(const InT* __restrict__ rin, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ gamma,
                  const float* __restrict__ beta, OutT* __restrict__ out, int T_rows, int e,
                  int d, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                      // [kRows, e]
  float* hs = smem + kRows * e;          // [kRows, d] row buffer
  const int row0 = blockIdx.x * kRows;
  stage_rows<InT>(rin, rs, row0, T_rows, e);
  __syncthreads();
  float acc[NC][kRows];
  rows_times_columns<NC>(rs, w, e, d, acc);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c >= d) continue;
    const float bc = bias[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) hs[r * d + c] = acc[j][r] + bc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    if (row0 + r >= T_rows) break;
    const float* h = hs + r * d;
    float sum = 0.f;
    for (int c = lane; c < d; c += 32) sum += h[c];
    const float mu = rt::warp_sum(sum) / d;
    float sq = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = h[c] - mu;
      sq += t * t;
    }
    const float rstd = rsqrtf(rt::warp_sum(sq) / d + eps);
    OutT* orow = out + (long long)(row0 + r) * d;
    for (int c = lane; c < d; c += 32)
      orow[c] = rt::from_f32<OutT>((h[c] - mu) * rstd * gamma[c] + beta[c]);
  }
}

constexpr int kMaxSmem = 227 * 1024;

// Instantiate LAUNCH(NC) for the number of columns per thread.
#define RT_DISPATCH_NC(n_cols, LAUNCH)                     \
  switch ((n_cols + kThreads - 1) / kThreads) {            \
    case 1: LAUNCH(1); break;                              \
    case 2: LAUNCH(2); break;                              \
    case 3: LAUNCH(3); break;                              \
    case 4: LAUNCH(4); break;                              \
    default: return (int)cudaErrorInvalidValue;            \
  }

template <typename T, typename OutT>
int launch_compress(const void* x, const void* w, const void* b, void* out, int T_rows, int d,
                    int e, size_t smem, cudaStream_t s) {
  const dim3 grid((T_rows + kRows - 1) / kRows);
#define LAUNCH(NC)                                                                           \
  do {                                                                                       \
    cudaFuncSetAttribute(compress_kernel<T, OutT, NC>,                                       \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);            \
    compress_kernel<T, OutT, NC><<<grid, kThreads, smem, s>>>(                               \
        (const T*)x, (const float*)w, (const float*)b, (OutT*)out, T_rows, d, e);            \
  } while (0)
  RT_DISPATCH_NC(e, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <typename InT, typename OutT>
int launch_decompress(const void* r, const void* w, const void* b, const void* gamma,
                      const void* beta, void* out, int T_rows, int e, int d, float eps,
                      size_t smem, cudaStream_t s) {
  const dim3 grid((T_rows + kRows - 1) / kRows);
#define LAUNCH(NC)                                                                           \
  do {                                                                                       \
    cudaFuncSetAttribute(decompress_kernel<InT, OutT, NC>,                                   \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);            \
    decompress_kernel<InT, OutT, NC><<<grid, kThreads, smem, s>>>(                           \
        (const InT*)r, (const float*)w, (const float*)b, (const float*)gamma,                \
        (const float*)beta, (OutT*)out, T_rows, e, d, eps);                                  \
  } while (0)
  RT_DISPATCH_NC(d, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <typename OutT>
int compress_in(int in_dtype, const void* x, const void* w, const void* b, void* out,
                int T_rows, int d, int e, size_t smem, cudaStream_t s) {
  switch (in_dtype) {
    case rt::kF32: return launch_compress<float, OutT>(x, w, b, out, T_rows, d, e, smem, s);
    case rt::kBF16:
      return launch_compress<__nv_bfloat16, OutT>(x, w, b, out, T_rows, d, e, smem, s);
    case rt::kF16: return launch_compress<__half, OutT>(x, w, b, out, T_rows, d, e, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename InT>
int decompress_out(int out_dtype, const void* r, const void* w, const void* b,
                   const void* gamma, const void* beta, void* out, int T_rows, int e, int d,
                   float eps, size_t smem, cudaStream_t s) {
  switch (out_dtype) {
    case rt::kF32:
      return launch_decompress<InT, float>(r, w, b, gamma, beta, out, T_rows, e, d, eps, smem,
                                           s);
    case rt::kBF16:
      return launch_decompress<InT, __nv_bfloat16>(r, w, b, gamma, beta, out, T_rows, e, d,
                                                   eps, smem, s);
    case rt::kF16:
      return launch_decompress<InT, __half>(r, w, b, gamma, beta, out, T_rows, e, d, eps, smem,
                                            s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [T, d] (in_dtype) -> out [T, e] (out_dtype: kF16 or kF32).
extern "C" int rt_compress(const void* x, const void* w, const void* b, void* out, int in_dtype,
                           int out_dtype, int T_rows, int d, int e, void* stream) {
  if (T_rows <= 0 || d <= 0 || e <= 0 || d % 4 != 0 || e > kMaxCols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * d;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case rt::kF16: return compress_in<__half>(in_dtype, x, w, b, out, T_rows, d, e, smem, s);
    case rt::kF32: return compress_in<float>(in_dtype, x, w, b, out, T_rows, d, e, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// r [T, e] (in_dtype: kF16 or kF32) -> out [T, d] (out_dtype).
extern "C" int rt_decompress(const void* r, const void* w, const void* b, const void* gamma,
                             const void* beta, void* out, int in_dtype, int out_dtype,
                             int T_rows, int e, int d, float eps, void* stream) {
  if (T_rows <= 0 || d <= 0 || e <= 0 || e % 4 != 0 || d > kMaxCols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * (e + d);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_dtype) {
    case rt::kF16:
      return decompress_out<__half>(out_dtype, r, w, b, gamma, beta, out, T_rows, e, d, eps,
                                    smem, s);
    case rt::kF32:
      return decompress_out<float>(out_dtype, r, w, b, gamma, beta, out, T_rows, e, d, eps,
                                   smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
