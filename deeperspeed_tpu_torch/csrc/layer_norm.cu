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
// What K1 computes: fp32 statistics, the CENTRED variance
// mean((x - mean)^2) (what the TPU kernel does, not E[x^2] - mean^2), and
// (x - mean) * rsqrt(var + eps) * gamma (+ beta) in x's type.  `rms` skips
// the mean (RMSNorm).  x and y are fp32, bf16 or fp16; gamma and beta come
// in their own type (fp32, bf16 or fp16, the same for both) and are upcast
// in registers, which is exact.
//
// Design: the row lives in registers, so x is read from device memory once
// and the variance is a second sum over the held values.
//
// * A warp per row for H <= 32 * 8 vectors (2048 in a 2-byte type, 1024 in
//   fp32).  A CTA of ROW_WARPS warps takes that many consecutive rows.  Lane
//   l holds the vectors l, l + 32, ...; a vector is 16 bytes of x (8 bf16 or
//   fp16 values, 4 fp32), so neighbouring lanes load and store neighbouring
//   16-byte words.  The sums are warp shuffle trees: no shared memory, no
//   barrier.
// * A CTA per row above that: the same layout with the CTA's threads in
//   place of the lanes, the warps' shuffle sums crossing through one small
//   shared array per statistic (two barriers a row).  Up to 512 threads of
//   32 values (4 vectors in a 2-byte type, 8 in fp32) hold H <= 16,384; a
//   wider row loops over the row and reads x again from L2 for each pass.
// * When H is not a multiple of the vector width or x, y, gamma or beta is
//   not 16-byte aligned, the same kernel loads and stores element by element
//   into the same registers: one grid-uniform flag decided at launch.
// * Every sum runs in a fixed order (per thread in vector order, then fixed
//   shuffle trees, then warps in order), with no atomics: two launches give
//   the same bits.
// The 16-byte loads and stores are vec.cuh's, shared with B8's forward.
#include "vec.cuh"

namespace {

constexpr int ROW_WARPS = 4;       // rows (one warp each) per CTA, small H
constexpr int MAX_VECS = 8;        // vectors a thread holds in registers
constexpr int CTA_THREADS = 512;   // most threads of a CTA per row (128 registers)
constexpr int CTA_VALUES = 32;     // values a thread of a CTA per row holds
constexpr int LOOP = 0;            // NV of the variant that loops over a wide row

// Sum over the `width` threads of a row; every thread gets the result.  A
// warp per row: the shuffle tree.  A CTA per row: the shuffle tree, then the
// warps' sums in warp order through `part` (one slot a warp).
template <bool CTA>
__device__ __forceinline__ float row_sum(float v, float* part) {
  v = dst_warp_sum(v);
  if constexpr (CTA) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0.f;
    const int nwarps = blockDim.x >> 5;
    for (int w = 0; w < nwarps; ++w) v += part[w];
  }
  return v;
}

// NV vectors of VEC values a thread (NV == LOOP: loop over the row).  CTA:
// a CTA per row, else a warp per row.  G is gamma's and beta's type.
template <typename T, typename G, int NV, bool CTA>
__global__ void __launch_bounds__(CTA_THREADS)
ln_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma, const G* __restrict__ beta,
              T* __restrict__ y, int rows, int H, float eps, int rms, int vec) {
  constexpr int VEC = 16 / (int)sizeof(T);
  __shared__ float part[2][32];
  const int width = CTA ? blockDim.x : 32;
  const int t = CTA ? threadIdx.x : (threadIdx.x & 31);
  const int row = CTA ? blockIdx.x : blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (!CTA && row >= rows) return;   // a whole warp: no barrier follows
  const T* __restrict__ xr = x + (size_t)row * H;
  T* __restrict__ yr = y + (size_t)row * H;

  if constexpr (NV == LOOP) {
    // fp32 rows too wide for registers: three passes, x re-read from L2
    float s = 0.f;
    for (int i = t; i < H; i += width) s += dst_to_float(xr[i]);
    const float mean = rms ? 0.f : row_sum<CTA>(s, part[0]) / (float)H;
    s = 0.f;
    for (int i = t; i < H; i += width) {
      const float c = dst_to_float(xr[i]) - mean;
      s += c * c;
    }
    const float rstd = rsqrtf(row_sum<CTA>(s, part[1]) / (float)H + eps);
    for (int i = t; i < H; i += width) {
      float out = (dst_to_float(xr[i]) - mean) * rstd * dst_to_float(gamma[i]);
      if (beta != nullptr) out += dst_to_float(beta[i]);
      yr[i] = dst_from_float<T>(out);
    }
    return;
  } else {
    float v[NV][VEC];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * width + t) * VEC;
      if (vec) {
        if (e0 < H) load_vec<T, VEC>(xr + e0, v[j]);
        else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[j][c] = 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) v[j][c] = e0 + c < H ? dst_to_float(xr[e0 + c]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) s += v[j][c];
    }
    const float mean = rms ? 0.f : row_sum<CTA>(s, part[0]) / (float)H;
    s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * width + t) * VEC;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float d = e0 + c < H ? v[j][c] - mean : 0.f;
        s += d * d;
      }
    }
    const float rstd = rsqrtf(row_sum<CTA>(s, part[1]) / (float)H + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * width + t) * VEC;
      if (e0 >= H) continue;
      float g[VEC], b[VEC];
      if (vec) {
        load_vec<G, VEC>(gamma + e0, g);
        if (beta != nullptr) load_vec<G, VEC>(beta + e0, b);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          g[c] = e0 + c < H ? dst_to_float(gamma[e0 + c]) : 0.f;
          b[c] = beta != nullptr && e0 + c < H ? dst_to_float(beta[e0 + c]) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        v[j][c] = (v[j][c] - mean) * rstd * g[c];
        if (beta != nullptr) v[j][c] += b[c];
      }
      if (vec) {
        store_vec<T, VEC>(yr + e0, v[j]);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          if (e0 + c < H) yr[e0 + c] = dst_from_float<T>(v[j][c]);
      }
    }
  }
}

template <typename T, typename G, int NV, bool CTA>
cudaError_t launch_ln_nv(const void* x, const void* gamma, const void* beta, void* y, int rows,
                         int H, float eps, int rms, int vec, int threads, cudaStream_t stream) {
  const int grid = CTA ? rows : (rows + ROW_WARPS - 1) / ROW_WARPS;
  ln_fwd_kernel<T, G, NV, CTA><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma), static_cast<const G*>(beta),
      static_cast<T*>(y), rows, H, eps, rms, vec);
  return cudaGetLastError();
}

template <typename T, typename G, bool CTA>
cudaError_t launch_ln_cta(const void* x, const void* gamma, const void* beta, void* y, int rows,
                          int H, float eps, int rms, int vec, int nv, int threads,
                          cudaStream_t stream) {
#define DST_LN_NV(NV) \
  launch_ln_nv<T, G, NV, CTA>(x, gamma, beta, y, rows, H, eps, rms, vec, threads, stream)
  switch (nv) {
    case 1: return DST_LN_NV(1);
    case 2: return DST_LN_NV(2);
    case 4: return DST_LN_NV(4);
    default:   // 8 vectors: a warp per row, or fp32 in a CTA per row (CTA_VALUES)
      if constexpr (CTA && sizeof(T) == 2) return cudaErrorInvalidValue;
      else return DST_LN_NV(8);
  }
#undef DST_LN_NV
}

template <typename T, typename G>
cudaError_t launch_ln(const void* x, const void* gamma, const void* beta, void* y, int rows,
                      int H, float eps, int rms, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int vec = H % VEC == 0 && aligned16(x) && aligned16(y) && aligned16(gamma) &&
                  aligned16(beta);
  const int nvec = (H + VEC - 1) / VEC;   // vectors a row (the last may be partial)
  if (nvec <= 32 * MAX_VECS) {             // a warp per row
    const int nv = nvec <= 32 ? 1 : nvec <= 64 ? 2 : nvec <= 128 ? 4 : 8;
    return launch_ln_cta<T, G, false>(x, gamma, beta, y, rows, H, eps, rms, vec, nv,
                                      32 * ROW_WARPS, stream);
  }
  if (nvec <= CTA_THREADS * (CTA_VALUES / VEC)) {   // a CTA per row
    const int nv = nvec <= 512 ? 1 : nvec <= 1024 ? 2 : nvec <= 2048 ? 4 : 8;
    const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    return launch_ln_cta<T, G, true>(x, gamma, beta, y, rows, H, eps, rms, vec, nv, threads,
                                     stream);
  }
  return launch_ln_nv<T, G, LOOP, true>(x, gamma, beta, y, rows, H, eps, rms, vec, CTA_THREADS,
                                        stream);
}

template <typename T>
cudaError_t launch_ln_gamma(const void* x, const void* gamma, const void* beta, void* y,
                            int rows, int H, float eps, int rms, int gamma_dtype,
                            cudaStream_t stream) {
  switch (gamma_dtype) {
    case DST_DTYPE_F32: return launch_ln<T, float>(x, gamma, beta, y, rows, H, eps, rms, stream);
    case DST_DTYPE_BF16:
      return launch_ln<T, __nv_bfloat16>(x, gamma, beta, y, rows, H, eps, rms, stream);
    case DST_DTYPE_F16: return launch_ln<T, __half>(x, gamma, beta, y, rows, H, eps, rms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dst_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                  int rows, int H, float eps, int rms, int dtype,
                                  int gamma_dtype, cudaStream_t stream) {
  if (rows == 0) return 0;
  if (H <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DST_DTYPE_F32:
      return (int)launch_ln_gamma<float>(x, gamma, beta, y, rows, H, eps, rms, gamma_dtype,
                                         stream);
    case DST_DTYPE_BF16:
      return (int)launch_ln_gamma<__nv_bfloat16>(x, gamma, beta, y, rows, H, eps, rms,
                                                 gamma_dtype, stream);
    case DST_DTYPE_F16:
      return (int)launch_ln_gamma<__half>(x, gamma, beta, y, rows, H, eps, rms, gamma_dtype,
                                          stream);
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
