// B9: tanh-GELU, forward and backward.
//
// Replaces the TPU kernels of deeperspeed_tpu/ops/transformer/activations.py:
// `_fwd_kernel` (launched by `_gelu` through ops/pallas_utils.py
// `elementwise_call`) and `_bwd_kernel` (`_gelu_bwd`).
//
//   forward   y  = 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
//   backward  dx = gelu'(x) dy, from the saved input x (not y)
//
// in fp32 whatever the storage type (fp32, bf16 or fp16), rounded once to
// the input's type.  `tanhf`, not `tanh.approx.f32` (about 2^-11 relative
// error, beyond the fp32 tolerance of the reference tests); no fast-math.
//
// Bound on the H100: bytes.  ~15 flops (forward) or ~20 (backward) per
// element against 2 (fp16/bf16: 4) bytes in and out; far below the card's
// balance point.  Design: one grid-stride pass, one element a thread per
// iteration, neighbouring threads on neighbouring addresses; the grid is
// sized to fill the card (at most 8 blocks of 256 threads per SM).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float C0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float C1 = 0.044715f;
constexpr int THREADS = 256;

// The reference's order of operations: ((C1 x) x) x and (0.5 x)(1 + t).
__device__ __forceinline__ float gelu(float x) {
  const float inner = C0 * (x + C1 * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float dgelu(float x) {
  const float inner = C0 * (x + C1 * x * x * x);
  const float t = tanhf(inner);
  const float dinner = C0 * (1.f + (3.f * C1) * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * dinner;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    y[i] = dst_from_float<T>(gelu(dst_to_float(x[i])));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                long long n) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    dx[i] = dst_from_float<T>(dgelu(dst_to_float(x[i])) * dst_to_float(dy[i]));
}

int grid_for(long long n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = 8LL * sms;
  return (int)(want < cap ? want : cap);
}

template <typename T>
int launch(const void* x, const void* dy, void* out, long long n, cudaStream_t stream) {
  const int grid = grid_for(n);
  if (dy == nullptr)
    gelu_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                     static_cast<T*>(out), n);
  else
    gelu_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

int run(const void* x, const void* dy, void* out, long long n, int dtype,
        cudaStream_t stream) {
  if (n == 0) return 0;
  switch (dtype) {
    case DST_DTYPE_F32: return launch<float>(x, dy, out, n, stream);
    case DST_DTYPE_BF16: return launch<__nv_bfloat16>(x, dy, out, n, stream);
    case DST_DTYPE_F16: return launch<__half>(x, dy, out, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dst_gelu_fwd(const void* x, void* y, long long n, int dtype,
                            cudaStream_t stream) {
  return run(x, nullptr, y, n, dtype, stream);
}

extern "C" int dst_gelu_bwd(const void* x, const void* dy, void* dx, long long n, int dtype,
                            cudaStream_t stream) {
  return run(x, dy, dx, n, dtype, stream);
}
