// K1: LayerNorm / RMSNorm forward, and K8: its backward.
//
// K1 replaces the TPU kernel deeperspeed_tpu/ops/transformer/normalize.py
// `_ln_fwd_kernel` (launched by `_ln_fwd_pallas` through
// ops/pallas_utils.py `rowwise_call`); K8 replaces `_ln_bwd_kernel`
// (`_ln_bwd_pallas`).  K8 is described after K1's launcher.
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

// K8: LayerNorm / RMSNorm backward.
//
// Bound on the H100: bytes (x and dy read, dx written: 6 B/element in bf16,
// ~20 flops of fp32 arithmetic per element).
//
// Design: like the TPU kernel, the statistics are recomputed from x rather
// than stored by the forward.  One CTA takes a group of `rows_per_cta`
// consecutive rows; each of its warps takes every nwarps-th row of the
// group, one row at a time, with warp shuffles for the row's sums (mean,
// centred variance, mean(dy*g), mean(dy*g*xhat)) and no block barrier.  The
// row is re-read from L1 between passes.  Each warp adds dy*xhat and dy
// into its own dgamma/dbeta accumulators in shared memory (8*H bytes a
// warp; fewer warps for a large H).  At the end the CTA sums its warps'
// accumulators in warp order into its fp32 partial row.  The TPU kernel
// carried those sums from one grid step to the next; here CTAs run in no
// order, so a second kernel sums the partials per column in CTA order.  No
// atomics: results do not vary between runs.  Any H up to 29,056 (one
// warp's accumulators) is taken; x, dy and dx are fp32, bf16 or fp16; gamma
// is fp32.
template <typename T>
__global__ void ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ dg_part, float* __restrict__ db_part, int rows,
                              int H, float eps, int rms, int rows_per_cta) {
  extern __shared__ float acc[];  // per warp: dgamma [H], then dbeta [H]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* dg = acc + (size_t)warp * 2 * H;
  float* db = dg + H;
  for (int i = lane; i < H; i += 32) dg[i] = db[i] = 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int r = r0 + warp; r < r1; r += nwarps) {
    const T* xr = x + (size_t)r * H;
    const T* dyr = dy + (size_t)r * H;
    float local = 0.f;
    for (int i = lane; i < H; i += 32) local += dst_to_float(xr[i]);
    const float mean = rms ? 0.f : dst_warp_sum(local) / (float)H;
    local = 0.f;
    for (int i = lane; i < H; i += 32) {
      const float c = dst_to_float(xr[i]) - mean;
      local += c * c;
    }
    const float rstd = rsqrtf(dst_warp_sum(local) / (float)H + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < H; i += 32) {
      const float xhat = (dst_to_float(xr[i]) - mean) * rstd;
      const float dyg = dst_to_float(dyr[i]) * gamma[i];
      s1 += dyg;
      s2 += dyg * xhat;
    }
    const float m1 = rms ? 0.f : dst_warp_sum(s1) / (float)H;
    const float m2 = dst_warp_sum(s2) / (float)H;
    T* dxr = dx + (size_t)r * H;
    for (int i = lane; i < H; i += 32) {
      const float xhat = (dst_to_float(xr[i]) - mean) * rstd;
      const float dyv = dst_to_float(dyr[i]);
      dxr[i] = dst_from_float<T>((dyv * gamma[i] - m1 - xhat * m2) * rstd);
      dg[i] += dyv * xhat;
      db[i] += dyv;
    }
  }
  __syncthreads();
  const size_t out = (size_t)blockIdx.x * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      sg += acc[(size_t)w * 2 * H + i];
      sb += acc[(size_t)w * 2 * H + H + i];
    }
    dg_part[out + i] = sg;
    db_part[out + i] = sb;
  }
}

// Column sums of the [nblk, H] partials, in CTA order.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ dg_part,
                                     const float* __restrict__ db_part, float* __restrict__ dg,
                                     float* __restrict__ db, int nblk, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < nblk; ++b) {
    sg += dg_part[(size_t)b * H + i];
    sb += db_part[(size_t)b * H + i];
  }
  dg[i] = sg;
  db[i] = sb;
}

template <typename T>
static cudaError_t launch_ln_bwd(const void* x, const float* gamma, const void* dy, void* dx,
                                 float* dg_part, float* db_part, float* dg, float* db, int rows,
                                 int H, float eps, int rms, int rows_per_cta,
                                 cudaStream_t stream) {
  // as many warps (up to 8) as their accumulators fit in ~200 KB
  const size_t per_warp = 2 * (size_t)H * sizeof(float);
  int warps = (int)((200 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const int threads = 32 * warps;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ln_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int nblk = (rows + rows_per_cta - 1) / rows_per_cta;
  ln_bwd_kernel<T><<<nblk, threads, smem, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), dg_part,
      db_part, rows, H, eps, rms, rows_per_cta);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd_reduce_kernel<<<(H + 255) / 256, 256, 0, stream>>>(dg_part, db_part, dg, db, nblk, H);
  return cudaGetLastError();
}

extern "C" int dst_layer_norm_bwd(const void* x, const float* gamma, const void* dy, void* dx,
                                  float* dg_part, float* db_part, float* dg, float* db, int rows,
                                  int H, float eps, int rms, int rows_per_cta, int dtype,
                                  cudaStream_t stream) {
  if (rows == 0) return 0;
  switch (dtype) {
    case DST_DTYPE_F32:
      return launch_ln_bwd<float>(x, gamma, dy, dx, dg_part, db_part, dg, db, rows, H, eps, rms,
                                  rows_per_cta, stream);
    case DST_DTYPE_BF16:
      return launch_ln_bwd<__nv_bfloat16>(x, gamma, dy, dx, dg_part, db_part, dg, db, rows, H,
                                          eps, rms, rows_per_cta, stream);
    case DST_DTYPE_F16:
      return launch_ln_bwd<__half>(x, gamma, dy, dx, dg_part, db_part, dg, db, rows, H, eps, rms,
                                   rows_per_cta, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
