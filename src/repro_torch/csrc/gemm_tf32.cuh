// Float32-accurate products on Hopper's tensor cores: split TF32.
//
// TF32 keeps float32's 8-bit exponent and 10 of its 23 stored mantissa
// bits, and mma.sync.m16n8k8 multiplies TF32 operands into float32
// accumulators at up to 495 TFLOP/s on an H100 (dense), against 67 for
// float32 FMAs on the CUDA cores (mma.sync reaches about two thirds of
// that).  One TF32 pass keeps ~3 decimal digits; splitting an operand into
// hi = tf32(v) and lo = v - hi keeps ~21 bits, and the products below sum
// the pieces in float32:
//  * a 16-bit A operand (bf16 or fp16) is exact in TF32, so A.B takes two
//    passes: A.B_lo + A.B_hi;
//  * a float32 A takes three: A_lo.B_hi + A_hi.B_lo + A_hi.B_hi (A_lo.B_lo,
//    ~2^-22 of the product, is dropped; CUTLASS calls this 3xTF32).
// hi is rounded to nearest (ties away from zero) by integer ops on the
// float32 bits, as cvt.rna.tf32.f32 rounds a finite value, with the 13
// dropped bits cleared so that v - hi is exact; lo = v - hi goes to the MMA
// as it is, which reads a TF32 operand's top 19 bits (lo truncated toward
// zero: |v - hi - lo| <= 2^-21 |v|): three integer / float ops a value,
// cheaper than two cvt.rna conversions.
// tests/test_torch_compress_tc_numerics.py emulates both against the JAX
// package's float32 kernels.
//
// Fragment maps (PTX ISA, mma.m16n8k8 with .tf32; g = lane / 4, t = lane %
// 4): A 16 x 8 row-major, a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B 8 x 8, b0 (t, g), b1 (t + 4, g); C 16 x 8, c0 (g, 2t), c1 (g,
// 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// The kernels permute k and n so that every fragment load is one wide,
// conflict-free shared-memory read (a sum over k does not depend on the
// order of its terms, and a column of C is the column of B it came from):
//  * k, within each step of 8: logical t is physical 2t, t + 4 is 2t + 1,
//    so a thread's (a0, a2) are neighbours in a row of A (one 32-bit word
//    of two 16-bit values, or a float2) and its b0, b1 neighbouring rows of
//    B;
//  * n, within a warp's group of 32 columns: column c of n-tile j (j =
//    0..3) is physical column 4c + j, so a thread's b0 over the four
//    n-tiles is one float4 (physical columns 4g .. 4g + 3), and its c0 /
//    c1 over them are physical columns 8t .. 8t + 7 of rows g and g + 8:
//    each thread writes 8 neighbouring outputs a row.
// Shared-memory tiles XOR their 16-byte chunks by row (w_chunk, a_chunk)
// so that the eight rows a fragment load touches land in distinct banks.
#pragma once

#include <atomic>

#include "attention_tc.cuh"

namespace rt {
namespace tf32 {

// v rounded to TF32 (nearest, ties away from zero; finite v) with the 13
// dropped bits cleared, so v - hi is exact.
__device__ __forceinline__ uint32_t round_hi(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// What rounding v to hi left, for the MMA to truncate.
__device__ __forceinline__ uint32_t rest(float v, uint32_t hi) {
  return __float_as_uint(v - __uint_as_float(hi));
}

// c += a (16 x 8) . b (8 x 8), TF32 operands, float32 accumulators.  Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of one k8 step for the four n-tiles of a 32-column group,
// split: hi[h][j] / lo[h][j] are b0 (h = 0) and b1 (h = 1) of n-tile j.
struct BFrag {
  uint32_t hi[2][4], lo[2][4];
};

// Rows 2t and 2t + 1 of the step (row0, row1) at the thread's float4.
__device__ __forceinline__ void load_b(BFrag& f, const float* row0, const float* row1) {
  const float4 v[2] = {*reinterpret_cast<const float4*>(row0),
                       *reinterpret_cast<const float4*>(row1)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float x[4] = {v[h].x, v[h].y, v[h].z, v[h].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f.hi[h][j] = round_hi(x[j]);
      f.lo[h][j] = rest(x[j], f.hi[h][j]);
    }
  }
}

// acc[m][j] += A_m . B over MT m-tiles and the four n-tiles: two passes
// for an exact (16-bit) A, three for a split float32 one (SPLIT_A: a is
// its hi part, a_lo the rest; otherwise a_lo is not read).  Pass by pass,
// so 4 MT independent products separate two into one accumulator.
template <int MT, bool SPLIT_A>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][4][4], const uint32_t (&a)[MT][4],
                                         const uint32_t (&a_lo)[MT][4], const BFrag& f) {
  if constexpr (SPLIT_A) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[m][j], a_lo[m], f.hi[0][j], f.hi[1][j]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma(acc[m][j], a[m], f.lo[0][j], f.lo[1][j]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma(acc[m][j], a[m], f.hi[0][j], f.hi[1][j]);
}

// A float32 A fragment split into exact TF32 parts.
__device__ __forceinline__ void split_a(const float (&v)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = round_hi(v[i]);
    lo[i] = rest(v[i], hi[i]);
  }
}

// Two 16-bit values of one 32-bit word, widened exactly to TF32 (lo half
// first).
template <typename T>
__device__ __forceinline__ void widen2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    lo = w << 16;
    hi = w & 0xffff0000u;
  } else {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
    lo = __float_as_uint(f.x);
    hi = __float_as_uint(f.y);
  }
}

// Position of 16-byte chunk c of row k in a float32 B tile (rows of a
// multiple of 8 chunks): the k-permutation puts a warp's b0 / b1 reads on
// rows 2t, 2t + 1 of a step, so chunks XOR with ((k >> 1) & 3) << 1.
__device__ __forceinline__ int w_chunk(int k, int c) { return c ^ (((k >> 1) & 3) << 1); }

// Position of chunk c of row r in a float32 A tile (rows of a multiple of
// 8 chunks), read as float2 at (row g, chunk 2s + t / 2).
__device__ __forceinline__ int a32_chunk(int r, int c) { return c ^ ((r & 3) << 1); }

// Position of chunk c of row r in a 16-bit A tile of 8 chunks a row (64
// values of k), read by ldmatrix (8 rows at one chunk).
__device__ __forceinline__ int a16_chunk(int r, int c) { return c ^ (r & 7); }

// Eight neighbouring outputs of one row, in 16-byte stores.
template <typename OutT>
__device__ __forceinline__ void store8(OutT* p, const float (&v)[8]) {
  if constexpr (std::is_same<OutT, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 u;
    u.x = tc::pack2<OutT>(v[0], v[1]);
    u.y = tc::pack2<OutT>(v[2], v[3]);
    u.z = tc::pack2<OutT>(v[4], v[5]);
    u.w = tc::pack2<OutT>(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Raise a kernel's dynamic shared-memory limit once per (instantiation,
// device), not at every launch.
template <typename K>
inline int allow_smem_once(K kernel, int bytes, std::atomic<unsigned>& raised) {
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(raised.load() & bit)) {
    if (int err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
      return err;
    raised.fetch_or(bit);
  }
  return 0;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace tf32
}  // namespace rt
