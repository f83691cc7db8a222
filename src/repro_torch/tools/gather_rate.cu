// The rates at which this card's L2 serves the embedding-bag kernels
// (csrc/embedding_bag.cu): random row gathers, and its peak.
//
// - "gather": rows of 64 and 256 bytes, each lane moving 16 bytes, drawn
//   uniformly by a hash from a set that fits the 50 MB L2 (16 MB) and from
//   one far larger (8 GB); 4 independent rows in flight a lane group.
//   GB/s of row bytes (the rows are whole 32-byte sectors, so also the
//   sector rate).
// - "stream_read", "stream_write": every lane reads (L2 only, ld.global.cg)
//   or writes 16 bytes at neighbouring addresses of the 16 MB set, 4
//   accesses in flight, the grid sweeping the set over and over: the L2's
//   peak.  chip_smoke.py's L2_PEAK_RATE, the rate in the embedding bag's
//   l2_bound_ms, is the highest rate this prints.
//
// 8 blocks of 256 threads an SM.  Prints one JSON line a case.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/gather_rate \
//       src/repro_torch/tools/gather_rate.cu && ./build/gather_rate
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

constexpr int kInFlight = 4;

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  return x ^ (x >> 33);
}

// Each lane group of row_bytes / 16 lanes gathers `iters` x kInFlight rows.
__global__ void gather(const uint4* __restrict__ set, unsigned long long n_rows, int row_bytes,
                       int iters, unsigned seed, unsigned* out) {
  const int lanes = row_bytes / 16;
  const unsigned long long group =
      ((unsigned long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int sub = threadIdx.x % lanes;
  unsigned acc = 0;
  for (int it = 0; it < iters; ++it) {
    uint4 v[kInFlight];
#pragma unroll
    for (int f = 0; f < kInFlight; ++f) {
      const unsigned long long row =
          mix((group * iters + it) * kInFlight + f + ((unsigned long long)seed << 40)) % n_rows;
      v[f] = __ldg(set + row * lanes + sub);
    }
#pragma unroll
    for (int f = 0; f < kInFlight; ++f) acc ^= v[f].x ^ v[f].y ^ v[f].z ^ v[f].w;
  }
  if (acc == 0x9e3779b9u) out[0] = acc;  // keeps the loads live
}

// Every thread reads (or writes) `iters` x kInFlight 16-byte words: word
// (step x threads + thread) % n_words of the set at each step (n_words a
// power of two, so the index is a mask, not a division).
template <bool WRITE>
__global__ void stream(uint4* __restrict__ set, unsigned long long n_words, int iters,
                       unsigned* out) {
  const unsigned long long mask = n_words - 1;
  const unsigned long long threads = (unsigned long long)gridDim.x * blockDim.x;
  const unsigned long long t = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0;
  for (int it = 0; it < iters; ++it) {
    if constexpr (WRITE) {
#pragma unroll
      for (int f = 0; f < kInFlight; ++f) {
        const unsigned long long at = ((unsigned long long)(it * kInFlight + f) * threads + t) & mask;
        __stcg(set + at, make_uint4(it, f, (unsigned)t, 0u));
      }
    } else {
      uint4 v[kInFlight];
#pragma unroll
      for (int f = 0; f < kInFlight; ++f)
        v[f] = __ldcg(set + (((unsigned long long)(it * kInFlight + f) * threads + t) & mask));
#pragma unroll
      for (int f = 0; f < kInFlight; ++f) acc ^= v[f].x ^ v[f].y ^ v[f].z ^ v[f].w;
    }
  }
  if (acc == 0x9e3779b9u) out[0] = acc;
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "gather_rate: no CUDA device\n");
    return 2;
  }
  const size_t sets[2] = {16ull << 20, 8ull << 30};
  const int row_sizes[2] = {64, 256};
  unsigned* out;
  cudaMalloc(&out, sizeof(unsigned));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int threads = 256, blocks = prop.multiProcessorCount * 8, iters = 1024;
  const double moved = (double)blocks * threads * 16 * iters * kInFlight;
  auto report = [&](const char* name, size_t set_bytes, int row_bytes) {
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    printf("{\"device\": \"%s\", \"case\": \"%s\", \"set_bytes\": %zu, \"row_bytes\": %d, "
           "\"ms\": %.4f, \"gb_per_s\": %.1f}\n",
           prop.name, name, set_bytes, row_bytes, ms, moved / ms / 1e6);
  };
  for (size_t set_bytes : sets) {
    uint4* set;
    if (cudaMalloc(&set, set_bytes) != cudaSuccess) {
      fprintf(stderr, "gather_rate: cannot allocate %zu bytes\n", set_bytes);
      return 1;
    }
    cudaMemset(set, 1, set_bytes);
    for (int row_bytes : row_sizes) {
      const unsigned long long n_rows = set_bytes / row_bytes;
      gather<<<blocks, threads>>>(set, n_rows, row_bytes, 16, 1, out);  // warm-up
      cudaEventRecord(e0);
      gather<<<blocks, threads>>>(set, n_rows, row_bytes, iters, 2, out);
      cudaEventRecord(e1);
      report("gather", set_bytes, row_bytes);
    }
    if (set_bytes == sets[0]) {
      const unsigned long long n_words = set_bytes / 16;
      stream<false><<<blocks, threads>>>(set, n_words, 16, out);  // warm-up
      cudaEventRecord(e0);
      stream<false><<<blocks, threads>>>(set, n_words, iters, out);
      cudaEventRecord(e1);
      report("stream_read", set_bytes, 16);
      stream<true><<<blocks, threads>>>(set, n_words, 16, out);
      cudaEventRecord(e0);
      stream<true><<<blocks, threads>>>(set, n_words, iters, out);
      cudaEventRecord(e1);
      report("stream_write", set_bytes, 16);
    }
    cudaFree(set);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "gather_rate: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
