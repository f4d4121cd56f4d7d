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
#include <algorithm>

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
// ~16 fp32 operations an element).
//
// What K8 computes, as the TPU kernel: the row's statistics recomputed from
// x in fp32 (mean, the centred variance, rstd; no mean under `rms`), xhat
// and dyg = dy gamma, m1 = mean(dyg) and m2 = mean(dyg xhat), dx = (dyg -
// m1 - xhat m2) rstd in x's type, and dgamma = sum over rows of dy xhat,
// dbeta = sum over rows of dy, in fp32.  gamma comes in its own type (fp32,
// bf16 or fp16) and is upcast in registers, which is exact.
//
// Design: K1's two layouts, the row in registers, x and dy read once each
// with 16-byte loads (vec.cuh).
// * Each CTA takes one strip of consecutive rows, and the grid is sized to
//   fill the card: the kernel's occupancy times the SMs, at most the
//   wrapper's capacity of partial rows (a few CTAs an SM).
// * A warp per row for H <= 1024: 4 warps a CTA, warp w taking rows w,
//   w + 4, ... of the strip, lane l the vectors l, l + 32, ... of a row (at
//   most 32 values); the sums are shuffle trees.  A CTA per row up to 512
//   threads of 16 values (H <= 8192): fewer values a thread than K1's,
//   because each thread holds four arrays (x, then xhat and dx; dy, then
//   dyg; the two accumulators).  The mean and the centred variance are two
//   sums over the held values, m1 and m2 one pass of two sums; gamma is
//   read once a row (from L1), dx goes out through `store_vec`.
// * dgamma and dbeta in registers: a thread always holds the same columns
//   of every row it takes, so it sums dy xhat and dy for them over its rows
//   with no memory traffic an element.  At the end a CTA per row writes its
//   threads' sums as its fp32 partial row; the warps of a warp-per-row CTA
//   add theirs in warp order through shared memory (8 H bytes a warp).
// * Wider rows: a CTA per row that loops over the row, re-reading x and dy
//   from L2 for each pass, and keeps its partial row in device memory (each
//   thread its own columns: no atomics), so any H is taken.
// * A second kernel sums the CTAs' partial rows per column in CTA order,
//   32 columns a CTA over the card: its 8 warps each sum one strip of the
//   partial rows, and the strips' sums are added in order.
// * When H is not a multiple of the vector width or x, dy, dx or gamma is
//   not 16-byte aligned, the same kernel loads and stores element by
//   element into the same registers: one grid-uniform flag, as in K1.
// * Every sum runs in a fixed order and there are no atomics: two launches
//   give the same bits (the grid depends only on the card and the shape).
namespace {

constexpr int BWD_WARP_VALUES = 32;   // values a lane holds, a warp per row
constexpr int BWD_CTA_VALUES = 16;    // values a thread holds, a CTA per row

// The sums of two values over a row's threads, as `row_sum` (one barrier
// for both).
template <bool CTA>
__device__ __forceinline__ float2 row_sum2(float a, float b, float (*part)[32]) {
  a = dst_warp_sum(a);
  b = dst_warp_sum(b);
  if constexpr (CTA) {
    if ((threadIdx.x & 31) == 0) {
      part[0][threadIdx.x >> 5] = a;
      part[1][threadIdx.x >> 5] = b;
    }
    __syncthreads();
    a = b = 0.f;
    const int nwarps = blockDim.x >> 5;
    for (int w = 0; w < nwarps; ++w) {
      a += part[0][w];
      b += part[1][w];
    }
  }
  return make_float2(a, b);
}

// NV vectors of VEC values a thread (NV == LOOP: loop over the row).  CTA:
// a CTA per row, else a warp per row.  G is gamma's type.  `part` holds the
// grid's partial rows, dgamma's [gridDim.x, H] then dbeta's.
template <typename T, typename G, int NV, bool CTA>
__global__ void __launch_bounds__(CTA ? CTA_THREADS : 32 * ROW_WARPS)
ln_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ part, int rows, int H, float eps, int rms,
              int vec, int rows_per_cta) {
  constexpr int VEC = 16 / (int)sizeof(T);
  __shared__ float sums[4][32];        // a CTA per row: mean, variance, (m1, m2)
  extern __shared__ float warp_acc[];  // a warp per row: [warp][dgamma, dbeta][H]
  const int width = CTA ? blockDim.x : 32;
  const int t = CTA ? threadIdx.x : (threadIdx.x & 31);
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  float* __restrict__ pg = part + (size_t)blockIdx.x * H;
  float* __restrict__ pb = part + ((size_t)gridDim.x + blockIdx.x) * H;

  if constexpr (NV == LOOP) {
    // rows too wide for registers: four passes, x and dy re-read from L2
    for (int r = r0; r < r1; ++r) {
      const T* __restrict__ xr = x + (size_t)r * H;
      const T* __restrict__ dyr = dy + (size_t)r * H;
      T* __restrict__ dxr = dx + (size_t)r * H;
      float s = 0.f;
      for (int i = t; i < H; i += width) s += dst_to_float(xr[i]);
      const float mean = rms ? 0.f : row_sum<true>(s, sums[0]) / (float)H;
      s = 0.f;
      for (int i = t; i < H; i += width) {
        const float c = dst_to_float(xr[i]) - mean;
        s += c * c;
      }
      const float rstd = rsqrtf(row_sum<true>(s, sums[1]) / (float)H + eps);
      float s1 = 0.f, s2 = 0.f;
      for (int i = t; i < H; i += width) {
        const float xhat = (dst_to_float(xr[i]) - mean) * rstd;
        const float dyg = dst_to_float(dyr[i]) * dst_to_float(gamma[i]);
        s1 += dyg;
        s2 += dyg * xhat;
      }
      const float2 m = row_sum2<true>(s1, s2, sums + 2);
      const float m1 = rms ? 0.f : m.x / (float)H, m2 = m.y / (float)H;
      for (int i = t; i < H; i += width) {
        const float xhat = (dst_to_float(xr[i]) - mean) * rstd;
        const float dyv = dst_to_float(dyr[i]);
        dxr[i] = dst_from_float<T>((dyv * dst_to_float(gamma[i]) - m1 - xhat * m2) * rstd);
        pg[i] = (r == r0 ? 0.f : pg[i]) + dyv * xhat;
        pb[i] = (r == r0 ? 0.f : pb[i]) + dyv;
      }
    }
  } else {
    float xv[NV][VEC], dv[NV][VEC], ag[NV][VEC], ab[NV][VEC];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < VEC; ++c) ag[j][c] = ab[j][c] = 0.f;
    for (int r = r0 + (CTA ? 0 : warp); r < r1; r += CTA ? 1 : ROW_WARPS) {
      const T* __restrict__ xr = x + (size_t)r * H;
      const T* __restrict__ dyr = dy + (size_t)r * H;
      T* __restrict__ dxr = dx + (size_t)r * H;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e0 = (j * width + t) * VEC;
        if (vec) {
          if (e0 < H) {
            load_vec<T, VEC>(xr + e0, xv[j]);
            load_vec<T, VEC>(dyr + e0, dv[j]);
          } else {
#pragma unroll
            for (int c = 0; c < VEC; ++c) xv[j][c] = dv[j][c] = 0.f;
          }
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            const bool in = e0 + c < H;
            xv[j][c] = in ? dst_to_float(xr[e0 + c]) : 0.f;
            dv[j][c] = in ? dst_to_float(dyr[e0 + c]) : 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < VEC; ++c) s += xv[j][c];
      }
      const float mean = rms ? 0.f : row_sum<CTA>(s, sums[0]) / (float)H;
      s = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e0 = (j * width + t) * VEC;
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float d = e0 + c < H ? xv[j][c] - mean : 0.f;
          s += d * d;
        }
      }
      const float rstd = rsqrtf(row_sum<CTA>(s, sums[1]) / (float)H + eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e0 = (j * width + t) * VEC;
        float g[VEC];
        if (vec) {
          if (e0 < H) {
            load_vec<G, VEC>(gamma + e0, g);
          } else {
#pragma unroll
            for (int c = 0; c < VEC; ++c) g[c] = 0.f;
          }
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) g[c] = e0 + c < H ? dst_to_float(gamma[e0 + c]) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float xhat = e0 + c < H ? (xv[j][c] - mean) * rstd : 0.f;
          xv[j][c] = xhat;
          ag[j][c] += dv[j][c] * xhat;
          ab[j][c] += dv[j][c];
          dv[j][c] *= g[c];   // dyg
          s1 += dv[j][c];
          s2 += dv[j][c] * xhat;
        }
      }
      const float2 m = row_sum2<CTA>(s1, s2, sums + 2);
      const float m1 = rms ? 0.f : m.x / (float)H, m2 = m.y / (float)H;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e0 = (j * width + t) * VEC;
        if (e0 >= H) continue;
#pragma unroll
        for (int c = 0; c < VEC; ++c) xv[j][c] = (dv[j][c] - m1 - xv[j][c] * m2) * rstd;
        if (vec) {
          store_vec<T, VEC>(dxr + e0, xv[j]);
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            if (e0 + c < H) dxr[e0 + c] = dst_from_float<T>(xv[j][c]);
        }
      }
    }
    // this CTA's partial row of dgamma and dbeta
    float* __restrict__ og = CTA ? pg : warp_acc + (size_t)warp * 2 * H;
    float* __restrict__ ob = CTA ? pb : og + H;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * width + t) * VEC;
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        if (e0 + c < H) {
          og[e0 + c] = ag[j][c];
          ob[e0 + c] = ab[j][c];
        }
    }
    if constexpr (!CTA) {
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * H; i += blockDim.x) {
        float sum = 0.f;
        for (int w = 0; w < ROW_WARPS; ++w) sum += warp_acc[(size_t)w * 2 * H + i];
        if (i < H) pg[i] = sum;
        else pb[i - H] = sum;
      }
    }
  }
}

// dgamma and dbeta: the column sums of the [nblk, H] partial rows of each,
// in CTA order.  A CTA takes 32 of the 2 H columns (dgamma's, then
// dbeta's); warp w sums the w-th of 8 consecutive strips of partial rows,
// and the strips' sums are added in order.
__global__ void __launch_bounds__(256)
ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dg,
                     float* __restrict__ db, int nblk, int H) {
  __shared__ float strip[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int m = c < H ? 0 : 1;
  const int col = c - m * H;
  const int per = (nblk + 7) / 8;
  const int b1 = min(nblk, (w + 1) * per);
  float s = 0.f;
  if (c < 2 * H) {
    const float* __restrict__ p = part + (size_t)m * nblk * H + col;
#pragma unroll 4
    for (int b = w * per; b < b1; ++b) s += p[(size_t)b * H];
  }
  strip[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < 2 * H) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += strip[i][lane];
    (m ? db : dg)[col] = total;
  }
}

template <typename T, typename G, int NV, bool CTA>
cudaError_t launch_ln_bwd_nv(const void* x, const void* gamma, const void* dy, void* dx,
                             float* part, float* dg, float* db, int rows, int H, float eps,
                             int rms, int vec, int threads, int cap, cudaStream_t stream) {
  auto kernel = ln_bwd_kernel<T, G, NV, CTA>;
  const size_t smem = CTA ? 0 : (size_t)ROW_WARPS * 2 * H * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return e;
  // one strip of rows a CTA, as many CTAs as are resident at once (at most
  // `cap`, the partial rows the wrapper allocated)
  const int units = CTA ? rows : (rows + ROW_WARPS - 1) / ROW_WARPS;
  int nblk = std::min({cap, std::max(per_sm, 1) * sms, units});
  const int rows_per_cta = (rows + nblk - 1) / nblk;
  nblk = (rows + rows_per_cta - 1) / rows_per_cta;
  kernel<<<nblk, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, H, eps, rms, vec, rows_per_cta);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ln_bwd_reduce_kernel<<<(2 * H + 31) / 32, 256, 0, stream>>>(part, dg, db, nblk, H);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_ln_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                          float* part, float* dg, float* db, int rows, int H, float eps, int rms,
                          int cap, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int vec = H % VEC == 0 && aligned16(x) && aligned16(dy) && aligned16(dx) &&
                  aligned16(gamma);
  const int nvec = (H + VEC - 1) / VEC;   // vectors a row (the last may be partial)
#define DST_LN_BWD(NV, CTA, THREADS)                                                         \
  launch_ln_bwd_nv<T, G, NV, CTA>(x, gamma, dy, dx, part, dg, db, rows, H, eps, rms, vec,   \
                                  THREADS, cap, stream)
  if (nvec <= 32 * (BWD_WARP_VALUES / VEC)) {   // a warp per row
    const int nv = (nvec + 31) / 32;
    const int warp = 32 * ROW_WARPS;
    if constexpr (VEC == 8) {   // 2-byte types: up to 4 vectors a lane
      switch (nv) {
        case 1: return DST_LN_BWD(1, false, warp);
        case 2: return DST_LN_BWD(2, false, warp);
        case 3: return DST_LN_BWD(3, false, warp);
        default: return DST_LN_BWD(4, false, warp);
      }
    } else {                    // fp32: up to 8
      switch (nv) {
        case 1: return DST_LN_BWD(1, false, warp);
        case 2: return DST_LN_BWD(2, false, warp);
        case 3: case 4: return DST_LN_BWD(4, false, warp);
        case 5: case 6: return DST_LN_BWD(6, false, warp);
        default: return DST_LN_BWD(8, false, warp);
      }
    }
  }
  constexpr int CTA_NV = BWD_CTA_VALUES / VEC;   // 2 in 2-byte types, 4 in fp32
  if (nvec <= CTA_THREADS * CTA_NV) {             // a CTA per row
    const int nv = nvec <= CTA_THREADS ? 1 : nvec <= 2 * CTA_THREADS ? 2 : 4;
    const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    switch (nv) {
      case 1: return DST_LN_BWD(1, true, threads);
      case 2: return DST_LN_BWD(2, true, threads);
      default:
        if constexpr (CTA_NV == 4) return DST_LN_BWD(4, true, threads);
        else return cudaErrorInvalidValue;
    }
  }
  return DST_LN_BWD(LOOP, true, CTA_THREADS);
#undef DST_LN_BWD
}

template <typename T>
cudaError_t launch_ln_bwd_gamma(const void* x, const void* gamma, const void* dy, void* dx,
                                float* part, float* dg, float* db, int rows, int H, float eps,
                                int rms, int cap, int gamma_dtype, cudaStream_t stream) {
  switch (gamma_dtype) {
    case DST_DTYPE_F32:
      return launch_ln_bwd<T, float>(x, gamma, dy, dx, part, dg, db, rows, H, eps, rms, cap,
                                     stream);
    case DST_DTYPE_BF16:
      return launch_ln_bwd<T, __nv_bfloat16>(x, gamma, dy, dx, part, dg, db, rows, H, eps, rms,
                                             cap, stream);
    case DST_DTYPE_F16:
      return launch_ln_bwd<T, __half>(x, gamma, dy, dx, part, dg, db, rows, H, eps, rms, cap,
                                      stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// part: room for 2 x cap x H fp32 partial rows; dg, db: [H] fp32, every
// entry written.
extern "C" int dst_layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                  float* part, float* dg, float* db, int rows, int H, float eps,
                                  int rms, int cap, int dtype, int gamma_dtype,
                                  cudaStream_t stream) {
  if (rows == 0) return 0;
  if (H <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DST_DTYPE_F32:
      return (int)launch_ln_bwd_gamma<float>(x, gamma, dy, dx, part, dg, db, rows, H, eps, rms,
                                             cap, gamma_dtype, stream);
    case DST_DTYPE_BF16:
      return (int)launch_ln_bwd_gamma<__nv_bfloat16>(x, gamma, dy, dx, part, dg, db, rows, H,
                                                     eps, rms, cap, gamma_dtype, stream);
    case DST_DTYPE_F16:
      return (int)launch_ln_bwd_gamma<__half>(x, gamma, dy, dx, part, dg, db, rows, H, eps, rms,
                                              cap, gamma_dtype, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
