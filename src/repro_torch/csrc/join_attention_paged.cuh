// The paged join's pool-type dispatch for one q type (join_attention_paged.cu).
// Each q type's instantiation is made in one translation unit only, named
// in its extern declaration below, so the three compile in parallel.
#pragma once
#include "join_attention.cuh"

namespace rt {

template <typename T>
int dispatch_paged_pool(int kd_dtype, const JoinArgs& a, cudaStream_t s, int* kernel) {
  switch (kd_dtype) {
    case kF32: return launch_join<T, float, true>(a, s, kernel);
    case kBF16: return launch_join<T, __nv_bfloat16, true>(a, s, kernel);
    case kF16: return launch_join<T, __half, true>(a, s, kernel);
    case kI8: return launch_join<T, int8_t, true>(a, s, kernel);
    default: return (int)cudaErrorInvalidValue;
  }
}

// join_attention_paged.cu
extern template int dispatch_paged_pool<float>(int, const JoinArgs&, cudaStream_t, int*);
// join_attention_paged_bf16.cu
extern template int dispatch_paged_pool<__nv_bfloat16>(int, const JoinArgs&, cudaStream_t,
                                                       int*);
// join_attention_paged_f16.cu
extern template int dispatch_paged_pool<__half>(int, const JoinArgs&, cudaStream_t, int*);

}  // namespace rt
