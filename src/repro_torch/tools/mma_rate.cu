// The rate mma.sync reaches on this card: the ceiling of the port's
// mma.sync kernels (split TF32 in csrc/gemm_tf32.cuh, bf16 / fp16 in
// csrc/attention_tc.cuh), which sit below the tensor cores' published
// dense peaks (wgmma's).
//
// One block an SM; each warp issues 8 independent MMA chains from
// registers, nothing else, for 4096 iterations.  Prints one JSON line a
// (shape, warps an SM) pair: TFLOP/s counted as 2 m n k a product.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_rate \
//       src/repro_torch/tools/mma_rate.cu && ./build/mma_rate
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

template <bool TF32>
__global__ void mma_chains(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345.f) out[0] = s;   // keeps the chains live
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "mma_rate: no CUDA device\n");
    return 2;
  }
  float* out;
  cudaMalloc(&out, sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096, sms = prop.multiProcessorCount;
  for (int tf32 = 1; tf32 >= 0; --tf32)
    for (int warps = 4; warps <= 32; warps *= 2) {
      auto kernel = tf32 ? mma_chains<true> : mma_chains<false>;
      kernel<<<sms, 32 * warps>>>(out, 16);   // warm-up
      cudaEventRecord(e0);
      kernel<<<sms, 32 * warps>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      if (cudaGetLastError() != cudaSuccess) return 1;
      const double flops = (double)sms * warps * iters * 8 * (tf32 ? 2 * 16 * 8 * 8 : 2 * 16 * 8 * 16);
      printf("{\"device\": \"%s\", \"mma\": \"%s\", \"warps_per_sm\": %d, \"tflops\": %.1f}\n",
             prop.name, tf32 ? "m16n8k8.tf32" : "m16n8k16.bf16", warps, flops / ms / 1e9);
    }
  return 0;
}
