// K1: LayerNorm / RMSNorm forward.
//
// Replaces the TPU kernel deeperspeed_tpu/ops/transformer/normalize.py
// `_ln_fwd_kernel` (launched by `_ln_fwd_pallas` through
// ops/pallas_utils.py `rowwise_call`).
//
// Bound on the H100: bytes.  Each element is read once and written once
// (4 B/element in bf16) against ~8 flops of fp32 arithmetic, far below the
// card's ~20 flops/byte balance point for fp32 CUDA-core math.
//
// Design: one CTA per row.  The CTA loads its row once into shared memory
// as fp32, takes the mean with a block reduction, then the CENTRED variance
// sum((x - mean)^2) over the held values (what the TPU kernel does, not
// E[x^2] - mean^2), and writes (x - mean) * rsqrt(var + eps) * gamma (+ beta)
// in the input's type.  `rms` skips the mean (RMSNorm).  gamma and beta are
// fp32; x and y are fp32, bf16 or fp16.  Any H is taken: the row lives in
// dynamic shared memory (H * 4 bytes).
#include "common.cuh"

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, T* __restrict__ y, int H,
                              float eps, int rms) {
  extern __shared__ float row[];
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * H;
  float local = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = dst_to_float(x[base + i]);
    row[i] = v;
    local += v;
  }
  const float mean = rms ? 0.f : dst_block_sum(local, scratch) / (float)H;
  local = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float c = row[i] - mean;
    local += c * c;
  }
  const float var = dst_block_sum(local, scratch) / (float)H;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float out = (row[i] - mean) * rstd * gamma[i];
    if (beta != nullptr) out += beta[i];
    y[base + i] = dst_from_float<T>(out);
  }
}

template <typename T>
static cudaError_t launch_ln(const void* x, const float* gamma, const float* beta, void* y,
                             int rows, int H, float eps, int rms, cudaStream_t stream) {
  int threads = ((H / 4 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = (size_t)H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ln_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_fwd_kernel<T><<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), H, eps, rms);
  return cudaGetLastError();
}

extern "C" int dst_layer_norm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                                  int rows, int H, float eps, int rms, int dtype,
                                  cudaStream_t stream) {
  if (rows == 0) return 0;
  switch (dtype) {
    case DST_DTYPE_F32:
      return launch_ln<float>(x, gamma, beta, y, rows, H, eps, rms, stream);
    case DST_DTYPE_BF16:
      return launch_ln<__nv_bfloat16>(x, gamma, beta, y, rows, H, eps, rms, stream);
    case DST_DTYPE_F16:
      return launch_ln<__half>(x, gamma, beta, y, rows, H, eps, rms, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
