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
// Both keep float32 accuracy, as the Pallas kernels (which widen to
// float32 before the dot) do.
//
// Two kernels a function, routed by the C entry, which reports the one it
// ran (*kernel: 1 tensor cores, 0 CUDA cores):
//
// compress_tc_kernel / decompress_tc_kernel (the main path's shapes: d =
// 768, e = 256, every input type).  The products run on the tensor cores
// as split TF32 (gemm_tf32.cuh): W is split into hi + lo TF32 parts as its
// fragments are loaded, a 16-bit x / r is exact in TF32 and takes two
// mma.sync.m16n8k8 passes, a float32 one is split too and takes three;
// float32 accumulators.  Bound on the H100: 2 (or 3) x 2 T d e operations
// over TF32's 495 TFLOP/s against (T (d + e) x element bytes + d e x 4)
// over 3.35 TB/s: at T = 30,720 (compress) 0.049 ms of operations against
// 0.019 of bytes, so the products bound it.  mma.sync itself stops near
// two thirds of that rate on the H100 (tools/mma_rate.cu); wgmma, which
// reads both TF32 operands K-major from shared memory, is the way past.
//  * compress: a block computes a 128 x 128 output tile with 8 warps of
//    64 x 32 (4 x 4 m16n8 tiles); x and W tiles of 64 along k stream
//    through a two-stage cp.async ring (16-byte copies, rows past T
//    zero-filled; 96 KB for 16-bit x, so two blocks share an SM); 16-bit x
//    fragments come from ldmatrix, float32 ones as float2, W as float4.
//    Each of W's d x e x 4 bytes is read from L2 once per 128 rows.  The epilogue adds the bias, applies GELU (tanhf,
//    as the reference; tanh.approx would miss the float32 limit) and
//    stores eight neighbouring columns a thread in 16-byte writes.
//  * decompress: LayerNorm needs whole rows, so a block owns 32 rows and
//    all d columns (<= 768): 8 warps of 32 rows x 32 NG columns (NG =
//    ceil(d / 256) groups of 4 n-tiles; 96 accumulators a thread at d =
//    768).  The block's r rows are widened to float32 into shared memory
//    once, while the first W tile (32 rows of k, two-stage cp.async ring:
//    224 KB of shared memory with r at e = 256) is in flight.  The
//    epilogue adds the bias in registers, takes the mean, then the centred
//    variance (two passes, as the reference), each reduced over a row's
//    four lanes by shuffles and over the 8 warps through shared memory,
//    and writes (h - mu) rsqrt(var + eps) gamma + beta cast, 8 columns a
//    thread in 16-byte stores.  W's 786 KB (e = 256, d = 768) is read from
//    L2 once per 32 rows: 377 MB for a micro-batch of 15,360 rows.
//
// compress_kernel / decompress_kernel (every other shape: widths that are
// not multiples of the tiles', d > 768 for decompress, unaligned
// operands): float32 FMAs on CUDA cores.  One block of 256 threads owns a
// tile of 16 rows, staged in shared memory as float32; thread c owns
// output columns c, c + 256, ... (NC = ceil(n_cols / 256) of them) and
// keeps NC x 16 accumulators in registers, reading W straight from
// global memory.  Compress adds the bias, applies GELU and stores;
// decompress writes bias-added rows to a shared row buffer of 16 x d
// float32, then each warp normalises whole rows with shuffle reductions.
#include "gemm_tf32.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core kernels
// ---------------------------------------------------------------------------

namespace ctc {                 // compress_tc_kernel
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 2, NT = 256;
template <typename T>
struct Geo {
  static constexpr int kABytes = BM * BK * (int)sizeof(T);
  static constexpr int kStageBytes = kABytes + BK * BN * 4;
  static constexpr int kSmem = STAGES * kStageBytes;
};
}  // namespace ctc

// Position of chunk c of row r in an A (x / r) tile of type T.
template <typename T>
__device__ __forceinline__ int a_chunk(int r, int c) {
  if constexpr (sizeof(T) == 4) return rt::tf32::a32_chunk(r, c);
  else return rt::tf32::a16_chunk(r, c);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(ctc::NT, 2)
compress_tc_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, OutT* __restrict__ out, int M, int K, int N) {
  using namespace ctc;
  namespace tf = rt::tf32;
  namespace tc = rt::tc;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  constexpr int AC = BK / EPC;               // chunks an x row: 8 (16-bit) or 16
  constexpr int MG = F32 ? 2 : 4;            // m-tiles a product group
  constexpr int WC = BN / 4;                 // chunks a W row
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 x 32
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = K / BK;

  auto tile_x = [&](int st) { return reinterpret_cast<T*>(tc_smem + st * Geo<T>::kStageBytes); };
  auto tile_w = [&](int st) {
    return reinterpret_cast<float*>(tc_smem + st * Geo<T>::kStageBytes + Geo<T>::kABytes);
  };
  auto issue = [&](int st, int kt) {
    const int k0 = kt * BK;
    T* a = tile_x(st);
    for (int i = tid; i < BM * AC; i += NT) {
      const int r = i / AC, c = i - r * AC;
      const bool p = m0 + r < M;
      tc::cp_async16(a + r * BK + EPC * a_chunk<T>(r, c),
                     p ? (const void*)(x + (long long)(m0 + r) * K + k0 + c * EPC)
                       : (const void*)x, p);
    }
    float* b = tile_w(st);
    for (int i = tid; i < BK * WC; i += NT) {
      const int r = i / WC, c = i - r * WC;
      const bool p = n0 + 4 * c < N;
      tc::cp_async16(b + r * BN + 4 * tf::w_chunk(r, c),
                     p ? (const void*)(w + (long long)(k0 + r) * N + n0 + 4 * c)
                       : (const void*)w, p);
    }
  };

  float acc[4 / MG][MG][4][4];               // m-tile m is acc[m / MG][m % MG]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m / MG][m % MG][j][i] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) issue(st, st);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();                         // tile kt landed; tile kt - 1 read by all
    if (kt + STAGES - 1 < KT) issue((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    tc::cp_async_commit();
    const T* a = tile_x(kt % STAGES);
    const float* b = tile_w(kt % STAGES);
    uint32_t a16[4][4];                      // ldmatrix words of two k8 steps
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      if constexpr (!F32) {
        if ((s & 1) == 0) {
          // matrices q = lane / 8: rows 0-7 / 8-15 of the m-tile (q & 1)
          // at chunks s and s + 1 (q >> 1)
          const int q = lane >> 3, c = s + (q >> 1);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int r = wm * 64 + 16 * m + (lane & 7) + 8 * (q & 1);
            tc::ldsm_x4(a16[m], a + r * BK + EPC * a_chunk<T>(r, c));
          }
        }
      }
      tf::BFrag f;
      const int kr = 8 * s + 2 * t, wc = wn * 8 + g;
      tf::load_b(f, b + kr * BN + 4 * tf::w_chunk(kr, wc),
                 b + (kr + 1) * BN + 4 * tf::w_chunk(kr + 1, wc));
#pragma unroll
      for (int mg = 0; mg < 4 / MG; ++mg) {
        uint32_t ah[MG][4], al[MG][4];
#pragma unroll
        for (int i = 0; i < MG; ++i) {
          const int m = mg * MG + i;
          if constexpr (F32) {
            const int r = wm * 64 + 16 * m + g, c = 2 * s + (t >> 1), o = 2 * (t & 1);
            const float2 top =
                *reinterpret_cast<const float2*>(a + r * BK + 4 * a_chunk<T>(r, c) + o);
            const float2 bot =
                *reinterpret_cast<const float2*>(a + (r + 8) * BK + 4 * a_chunk<T>(r + 8, c) + o);
            const float v[4] = {top.x, bot.x, top.y, bot.y};
            tf::split_a(v, ah[i], al[i]);
          } else {
            const int h = 2 * (s & 1);
            tf::widen2<T>(a16[m][h], ah[i][0], ah[i][2]);
            tf::widen2<T>(a16[m][h + 1], ah[i][1], ah[i][3]);
          }
        }
        tf::mma_tile<MG, F32>(acc[mg], ah, al, f);
      }
    }
  }

  // c0 / c1 of n-tile j are columns 8t + j / 8t + 4 + j of rows g / g + 8
  const int col = n0 + wn * 32 + 8 * t;
  if (col >= N) return;
  float bv[8];
  tf::load8(bv, bias + col);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + 16 * m + g + 8 * hr;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = gelu_tanh(acc[m / MG][m % MG][j][2 * hr] + bv[j]);
        v[4 + j] = gelu_tanh(acc[m / MG][m % MG][j][2 * hr + 1] + bv[4 + j]);
      }
      tf::store8<OutT>(out + (long long)row * N + col, v);
    }
}

namespace dtc {                 // decompress_tc_kernel
constexpr int BM = 32, BK = 32, STAGES = 2, WARPS = 8, NT = 32 * WARPS;
constexpr int kMaxGroups = 3;   // d <= 768
// dynamic shared memory: r rows [BM, K] and the W ring (the row
// reductions reuse the ring)
inline int smem_bytes(int K, int ng) { return 4 * (BM * K + STAGES * BK * NT * ng); }
}  // namespace dtc

template <typename InT, typename OutT, int NG>
__global__ void __launch_bounds__(dtc::NT, 1)
decompress_tc_kernel(const InT* __restrict__ rin, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ gamma,
                     const float* __restrict__ beta, OutT* __restrict__ out, int M, int K, int N,
                     float eps) {
  using namespace dtc;
  namespace tf = rt::tf32;
  namespace tc = rt::tc;
  constexpr bool F32 = std::is_same<InT, float>::value;
  static_assert(F32 || std::is_same<InT, __half>::value, "r is float16 or float32");
  constexpr int COLS = WARPS * 32 * NG, WC = COLS / 4, STAGE = BK * COLS;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* sR = reinterpret_cast<float*>(tc_smem);   // [BM, K], chunks in a32_chunk order
  float* sW = sR + BM * K;                          // STAGES x [BK, COLS], w_chunk order
  float* red = sW;                                  // [2][WARPS][BM], after the loop
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int KT = K / BK;

  auto issue = [&](int st, int kt) {
    float* b = sW + st * STAGE;
    for (int i = tid; i < BK * WC; i += NT) {
      const int r = i / WC, c = i - r * WC;
      const bool p = 4 * c < N;
      tc::cp_async16(b + r * COLS + 4 * tf::w_chunk(r, c),
                     p ? (const void*)(w + (long long)(kt * BK + r) * N + 4 * c) : (const void*)w,
                     p);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) issue(st, st);
    tc::cp_async_commit();
  }
  // the block's rows of r, widened exactly to float32 (zeros past M)
  const int KC = K / 4;
  for (int i = tid; i < BM * KC; i += NT) {
    const int r = i / KC, c = i - r * KC;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < M) {
      const InT* src = rin + (long long)(m0 + r) * K + 4 * c;
      if constexpr (F32) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
        const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
        const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
    *reinterpret_cast<float4*>(sR + r * K + 4 * tf::a32_chunk(r, c)) = v;
  }

  float acc[NG][2][4][4];                           // [column group][m-tile][n-tile]
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][m][j][i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();                         // tile kt (and sR) landed; tile kt - 1 read
    if (kt + STAGES - 1 < KT) issue((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    tc::cp_async_commit();
    const float* b = sW + (kt % STAGES) * STAGE;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      uint32_t ah[2][4], al[2][4];
      const int c = (kt * BK + 8 * s) / 4 + (t >> 1), o = 2 * (t & 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 16 * m + g;
        const float2 top = *reinterpret_cast<const float2*>(sR + r * K + 4 * tf::a32_chunk(r, c) + o);
        const float2 bot =
            *reinterpret_cast<const float2*>(sR + (r + 8) * K + 4 * tf::a32_chunk(r + 8, c) + o);
        const float v[4] = {top.x, bot.x, top.y, bot.y};
        if constexpr (F32) {
          tf::split_a(v, ah[m], al[m]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) ah[m][i] = al[m][i] = __float_as_uint(v[i]);
        }
      }
      const int kr = 8 * s + 2 * t;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        tf::BFrag f;
        const int wc = (warp * NG + n) * 8 + g;
        tf::load_b(f, b + kr * COLS + 4 * tf::w_chunk(kr, wc),
                   b + (kr + 1) * COLS + 4 * tf::w_chunk(kr + 1, wc));
        tf::mma_tile<2, F32>(acc[n], ah, al, f);
      }
    }
  }

  __syncthreads();                                  // the ring is free for red
  // h = acc + bias; a thread's columns of group n are 8t .. 8t + 7 of the
  // warp's group (c0 / c1 of n-tile j: 8t + j / 8t + 4 + j); columns past
  // N hold nothing and stay out of the statistics.  Row of (m, hr): 16m +
  // 8hr + g.
  bool ok[NG];
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int col = (warp * NG + n) * 32 + 8 * t;
    ok[n] = col < N;
    if (!ok[n]) continue;
    float bv[8];
    tf::load8(bv, bias + col);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[n][m][j][0] += bv[j];
        acc[n][m][j][1] += bv[4 + j];
        acc[n][m][j][2] += bv[j];
        acc[n][m][j][3] += bv[4 + j];
      }
  }
  // a row's sum (pass 0) or centred squares (pass 1), over the block
  float mu[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, rstd[2][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float s = 0.f;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          if (!ok[n]) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float u = acc[n][m][j][2 * hr] - mu[m][hr];
            const float v = acc[n][m][j][2 * hr + 1] - mu[m][hr];
            s += pass ? u * u + v * v : u + v;
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) red[(pass * WARPS + warp) * BM + 16 * m + 8 * hr + g] = s;
      }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float tot = 0.f;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) tot += red[(pass * WARPS + v) * BM + 16 * m + 8 * hr + g];
        if (pass == 0) mu[m][hr] = tot / (float)N;
        else rstd[m][hr] = rsqrtf(tot / (float)N + eps);
      }
  }
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    if (!ok[n]) continue;
    const int col = (warp * NG + n) * 32 + 8 * t;
    float gv[8], be[8];
    tf::load8(gv, gamma + col);
    tf::load8(be, beta + col);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + 16 * m + 8 * hr + g;
        if (row >= M) continue;
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = (acc[n][m][j][2 * hr] - mu[m][hr]) * rstd[m][hr] * gv[j] + be[j];
          v[4 + j] = (acc[n][m][j][2 * hr + 1] - mu[m][hr]) * rstd[m][hr] * gv[4 + j] + be[4 + j];
        }
        tf::store8<OutT>(out + (long long)row * N + col, v);
      }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename T, typename OutT>
int launch_compress_tc(const void* x, const void* w, const void* b, void* out, int T_rows, int d,
                       int e, cudaStream_t s) {
  static std::atomic<unsigned> raised{0};
  constexpr int smem = ctc::Geo<T>::kSmem;
  if (int err = rt::tf32::allow_smem_once(compress_tc_kernel<T, OutT>, smem, raised)) return err;
  const dim3 grid((e + ctc::BN - 1) / ctc::BN, (T_rows + ctc::BM - 1) / ctc::BM);
  compress_tc_kernel<T, OutT><<<grid, ctc::NT, smem, s>>>((const T*)x, (const float*)w,
                                                          (const float*)b, (OutT*)out, T_rows, d, e);
  return (int)cudaGetLastError();
}

template <typename InT, typename OutT, int NG>
int launch_decompress_tc(const void* r, const void* w, const void* b, const void* gamma,
                         const void* beta, void* out, int T_rows, int e, int d, float eps,
                         cudaStream_t s) {
  static std::atomic<unsigned> raised{0};
  if (int err = rt::tf32::allow_smem_once(decompress_tc_kernel<InT, OutT, NG>, kMaxSmem, raised))
    return err;
  decompress_tc_kernel<InT, OutT, NG>
      <<<(T_rows + dtc::BM - 1) / dtc::BM, dtc::NT, dtc::smem_bytes(e, NG), s>>>(
          (const InT*)r, (const float*)w, (const float*)b, (const float*)gamma,
          (const float*)beta, (OutT*)out, T_rows, e, d, eps);
  return (int)cudaGetLastError();
}

template <typename InT, typename OutT>
int decompress_tc_groups(const void* r, const void* w, const void* b, const void* gamma,
                         const void* beta, void* out, int T_rows, int e, int d, float eps,
                         cudaStream_t s) {
  switch ((d + 255) / 256) {
    case 1: return launch_decompress_tc<InT, OutT, 1>(r, w, b, gamma, beta, out, T_rows, e, d, eps, s);
    case 2: return launch_decompress_tc<InT, OutT, 2>(r, w, b, gamma, beta, out, T_rows, e, d, eps, s);
    case 3: return launch_decompress_tc<InT, OutT, 3>(r, w, b, gamma, beta, out, T_rows, e, d, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
                    int e, bool tc, size_t smem, cudaStream_t s) {
  if (tc) return launch_compress_tc<T, OutT>(x, w, b, out, T_rows, d, e, s);
  const dim3 grid((T_rows + kRows - 1) / kRows);
#define LAUNCH(NC)                                                                           \
  do {                                                                                       \
    static std::atomic<unsigned> raised{0};                                                  \
    if (int err = rt::tf32::allow_smem_once(compress_kernel<T, OutT, NC>, kMaxSmem, raised)) \
      return err;                                                                            \
    compress_kernel<T, OutT, NC><<<grid, kThreads, smem, s>>>(                               \
        (const T*)x, (const float*)w, (const float*)b, (OutT*)out, T_rows, d, e);            \
  } while (0)
  RT_DISPATCH_NC(e, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <typename InT, typename OutT>
int launch_decompress(const void* r, const void* w, const void* b, const void* gamma,
                      const void* beta, void* out, int T_rows, int e, int d, float eps, bool tc,
                      size_t smem, cudaStream_t s) {
  if (tc) return decompress_tc_groups<InT, OutT>(r, w, b, gamma, beta, out, T_rows, e, d, eps, s);
  const dim3 grid((T_rows + kRows - 1) / kRows);
#define LAUNCH(NC)                                                                            \
  do {                                                                                        \
    static std::atomic<unsigned> raised{0};                                                   \
    if (int err =                                                                             \
            rt::tf32::allow_smem_once(decompress_kernel<InT, OutT, NC>, kMaxSmem, raised))    \
      return err;                                                                             \
    decompress_kernel<InT, OutT, NC><<<grid, kThreads, smem, s>>>(                            \
        (const InT*)r, (const float*)w, (const float*)b, (const float*)gamma,                 \
        (const float*)beta, (OutT*)out, T_rows, e, d, eps);                                   \
  } while (0)
  RT_DISPATCH_NC(d, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <typename OutT>
int compress_in(int in_dtype, const void* x, const void* w, const void* b, void* out,
                int T_rows, int d, int e, bool tc, size_t smem, cudaStream_t s) {
  switch (in_dtype) {
    case rt::kF32: return launch_compress<float, OutT>(x, w, b, out, T_rows, d, e, tc, smem, s);
    case rt::kBF16:
      return launch_compress<__nv_bfloat16, OutT>(x, w, b, out, T_rows, d, e, tc, smem, s);
    case rt::kF16: return launch_compress<__half, OutT>(x, w, b, out, T_rows, d, e, tc, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename InT>
int decompress_out(int out_dtype, const void* r, const void* w, const void* b,
                   const void* gamma, const void* beta, void* out, int T_rows, int e, int d,
                   float eps, bool tc, size_t smem, cudaStream_t s) {
  switch (out_dtype) {
    case rt::kF32:
      return launch_decompress<InT, float>(r, w, b, gamma, beta, out, T_rows, e, d, eps, tc,
                                           smem, s);
    case rt::kBF16:
      return launch_decompress<InT, __nv_bfloat16>(r, w, b, gamma, beta, out, T_rows, e, d,
                                                   eps, tc, smem, s);
    case rt::kF16:
      return launch_decompress<InT, __half>(r, w, b, gamma, beta, out, T_rows, e, d, eps, tc,
                                            smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [T, d] (in_dtype) -> out [T, e] (out_dtype: kF16 or kF32).  The routing
// rule: d a multiple of 32, e of 8, at most 65535 row tiles and 16-byte
// aligned operands take compress_tc_kernel (*kernel = 1), everything else
// compress_kernel (0).
extern "C" int rt_compress(const void* x, const void* w, const void* b, void* out, int in_dtype,
                           int out_dtype, int T_rows, int d, int e, void* stream, int* kernel) {
  if (T_rows <= 0 || d <= 0 || e <= 0 || d % 4 != 0 || e > kMaxCols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * d;
  using rt::tf32::aligned16;
  const bool tc = d % ctc::BK == 0 && e % 8 == 0 && (T_rows + ctc::BM - 1) / ctc::BM <= 65535 &&
                  aligned16(x) && aligned16(w) && aligned16(b) && aligned16(out);
  if (!tc && smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (kernel) *kernel = tc ? 1 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case rt::kF16: return compress_in<__half>(in_dtype, x, w, b, out, T_rows, d, e, tc, smem, s);
    case rt::kF32: return compress_in<float>(in_dtype, x, w, b, out, T_rows, d, e, tc, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// r [T, e] (in_dtype: kF16 or kF32) -> out [T, d] (out_dtype).  The
// routing rule: e a multiple of 32, d of 8 and at most 768, shared memory
// within the card's and 16-byte aligned operands take decompress_tc_kernel
// (*kernel = 1), everything else decompress_kernel (0).
extern "C" int rt_decompress(const void* r, const void* w, const void* b, const void* gamma,
                             const void* beta, void* out, int in_dtype, int out_dtype,
                             int T_rows, int e, int d, float eps, void* stream, int* kernel) {
  if (T_rows <= 0 || d <= 0 || e <= 0 || e % 4 != 0 || d > kMaxCols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * (e + d);
  using rt::tf32::aligned16;
  const bool tc = e % 32 == 0 && d % 8 == 0 && d <= 256 * dtc::kMaxGroups &&
                  dtc::smem_bytes(e, (d + 255) / 256) <= kMaxSmem && aligned16(r) &&
                  aligned16(w) && aligned16(b) && aligned16(gamma) && aligned16(beta) &&
                  aligned16(out);
  if (!tc && smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (kernel) *kernel = tc ? 1 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_dtype) {
    case rt::kF16:
      return decompress_out<__half>(out_dtype, r, w, b, gamma, beta, out, T_rows, e, d, eps, tc,
                                    smem, s);
    case rt::kF32:
      return decompress_out<float>(out_dtype, r, w, b, gamma, beta, out, T_rows, e, d, eps, tc,
                                   smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
