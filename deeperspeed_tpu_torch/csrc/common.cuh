// Shared helpers for the hand-written Hopper kernels of deeperspeed_tpu_torch.
//
// Every kernel file exposes a plain C interface (extern "C") that takes raw
// device pointers, sizes and a cudaStream_t, launches on that stream without
// synchronising, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Tensors come in one of three element types,
// named by DST_DTYPE_* codes that the wrappers pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define DST_DTYPE_F32 0
#define DST_DTYPE_BF16 1
#define DST_DTYPE_F16 2

// Masking sentinel of the TPU kernels (ops/pallas_utils.py NEG_INF).
#define DST_NEG_INF (-1e30f)

__device__ __forceinline__ float dst_to_float(float v) { return v; }
__device__ __forceinline__ float dst_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float dst_to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T dst_from_float(float v);
template <> __device__ __forceinline__ float dst_from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 dst_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half dst_from_float<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float dst_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread gets the result.  `scratch` holds
// one float per warp.  Ends with a barrier, so scratch may be reused after.
__device__ __forceinline__ float dst_block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = dst_warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}
