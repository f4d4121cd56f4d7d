// B8: fused scaled softmax over the last dim, forward and backward.
//
// Replaces the TPU kernels of deeperspeed_tpu/ops/transformer/softmax.py:
// `_sm_fwd_kernel` and `_sm_bwd_kernel` (both launched through
// ops/pallas_utils.py `rowwise_call`).
//
//   forward   y  = softmax(scale x): m = max(scale x), e = exp(scale x - m),
//                  y = e / sum(e), in fp32, rounded once to x's type
//   backward  dx = p (dy - sum(p dy)) scale, from the saved output p
//
// fp32, bf16 or fp16 storage; every sum, exp and division in fp32 (`expf`,
// no fast-math).  Any row width W: the TPU kernel wanted W % 128 == 0 (the
// JAX package takes plain XLA otherwise); this one walks the row in strides.
//
// Bound on the H100: bytes.  Each element is read once and written once
// (the backward reads two) against a handful of flops.  Design: one CTA per
// row, W/8 threads rounded up to a warp (32 to 256).  The forward makes
// three passes over its row -- max, sum of exp, write -- and the backward
// two -- sum of p dy, write; the repeated reads of a row of a few KB hit
// the SM's L1/L2 rather than device memory.  The reductions are a warp
// shuffle tree and one shared-memory step across warps.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, scratch[w]);
  __syncthreads();
  return m;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int W, float scale) {
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * W;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    m = fmaxf(m, dst_to_float(x[base + i]) * scale);
  m = block_max(m, scratch);
  float s = 0.f;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    s += expf(dst_to_float(x[base + i]) * scale - m);
  s = dst_block_sum(s, scratch);
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    y[base + i] = dst_from_float<T>(expf(dst_to_float(x[base + i]) * scale - m) / s);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
softmax_bwd_kernel(const T* __restrict__ p, const T* __restrict__ dy, T* __restrict__ dx,
                   int W, float scale) {
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * W;
  float s = 0.f;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    s += dst_to_float(p[base + i]) * dst_to_float(dy[base + i]);
  s = dst_block_sum(s, scratch);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const float pv = dst_to_float(p[base + i]);
    dx[base + i] = dst_from_float<T>(pv * (dst_to_float(dy[base + i]) - s) * scale);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long rows, int W, float scale,
           cudaStream_t stream) {
  int threads = ((W / 8 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  if (b == nullptr)
    softmax_fwd_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<T*>(out), W, scale);
  else
    softmax_bwd_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), W, scale);
  return (int)cudaGetLastError();
}

int run(const void* a, const void* b, void* out, long long rows, int W, float scale,
        int dtype, cudaStream_t stream) {
  if (rows == 0 || W == 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DST_DTYPE_F32: return launch<float>(a, b, out, rows, W, scale, stream);
    case DST_DTYPE_BF16: return launch<__nv_bfloat16>(a, b, out, rows, W, scale, stream);
    case DST_DTYPE_F16: return launch<__half>(a, b, out, rows, W, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dst_softmax_fwd(const void* x, void* y, long long rows, int W, float scale,
                               int dtype, cudaStream_t stream) {
  return run(x, nullptr, y, rows, W, scale, dtype, stream);
}

extern "C" int dst_softmax_bwd(const void* p, const void* dy, void* dx, long long rows, int W,
                               float scale, int dtype, cudaStream_t stream) {
  return run(p, dy, dx, rows, W, scale, dtype, stream);
}
