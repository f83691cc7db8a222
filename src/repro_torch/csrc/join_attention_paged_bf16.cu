// The paged join's pool-type dispatch for __nv_bfloat16 q (join_attention_paged.cu
// holds the entry point and the float32 dispatch): every pool type on
// join_tc_kernel and join_tiled_kernel, compiled apart from the other q
// types so the parallel build runs them at once.
#include "join_attention_paged.cuh"

template int rt::dispatch_paged_pool<__nv_bfloat16>(int, const rt::JoinArgs&, cudaStream_t, int*);
