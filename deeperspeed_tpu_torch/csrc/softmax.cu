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
// fp32, bf16 or fp16 storage; every sum, exp and division in fp32 (no
// fast-math).  Any row width W: the TPU kernel wanted W % 128 == 0 (the JAX
// package takes plain XLA otherwise); this one takes any.
//
// Bound on the H100: bytes.  Each element is read once and written once
// (the backward reads two) against a handful of flops: at the byte bound
// the card moves ~3.6 bf16 elements per SM clock, which leaves ~35
// instructions an element for convert, scale, max, exp, sum and store.
//
// Forward design: the row lives in registers, so x is read from device
// memory once, and exp runs once per element (its result stays in
// registers for the store).
//
// * A warp per row for W <= 32 * 8 vectors (2048 in a 2-byte type, 1024 in
//   fp32); a CTA of ROW_WARPS warps takes that many consecutive rows.  Lane
//   l holds the vectors l, l + 32, ...; a vector is 16 bytes of x, so
//   neighbouring lanes load and store neighbouring 16-byte words.  The max
//   and the sum are warp shuffle trees: no shared memory, no barrier.
// * A CTA per row up to 16,384 values: the same layout with the CTA's
//   threads in place of the lanes (at most 512 threads of 32 values); the
//   warps' partial max and sum cross through one small shared array each.
// * Wider rows loop: one pass keeps an online (max, sum) per thread,
//   rescaling once a vector, and the partials merge in a fixed tree; a
//   second pass re-reads x from L2 and writes y.
// * When W is not a multiple of the vector width or x or y is not 16-byte
//   aligned, the same kernels load and store element by element into the
//   same registers: one grid-uniform flag decided at launch (as K1).
// * exp(d) is exp2(d log2 e) (as K5), one reciprocal of the sum per row and
//   a multiply per element.  Both move the last fp32 bit, inside the
//   tolerances that hold the kernel against its plain version.
// * Every reduction runs in a fixed order (per thread in vector order, then
//   fixed shuffle trees, then warps in order), with no atomics: two
//   launches give the same bits.
// * A row holding a NaN, or a row of -inf (m = -inf), gives NaN throughout,
//   as the plain version does.
//
// Backward design: one CTA per row, W/8 threads rounded up to a warp (32
// to 256), two passes -- sum of p dy, write -- the second re-reading the
// row from L1/L2; a warp shuffle tree and one shared-memory step across
// warps.
#include <cmath>

#include "vec.cuh"

namespace {

constexpr int MAX_THREADS = 256;   // backward: most threads of its CTA per row
constexpr int ROW_WARPS = 4;       // forward: rows (one warp each) per CTA, small W
constexpr int MAX_VECS = 8;        // forward: vectors a lane holds, a warp per row
constexpr int CTA_THREADS = 512;   // forward: most threads of a CTA per row
constexpr int CTA_VALUES = 32;     // forward: values a thread of a CTA per row holds
constexpr int LOOP = 0;            // NV of the forward variant that loops over a wide row
constexpr float L2E = 1.4426950408889634f;   // exp(d) = exp2(d log2 e)

// Max over the `width` threads of a row (fmaxf: a NaN is dropped here and
// propagates through the sum instead); every thread gets the result.
template <bool CTA>
__device__ __forceinline__ float row_max(float v, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if constexpr (CTA) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    v = part[0];
    const int nwarps = blockDim.x >> 5;
    for (int w = 1; w < nwarps; ++w) v = fmaxf(v, part[w]);
  }
  return v;
}

// Sum over the `width` threads of a row, the warps' sums in warp order.
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

// The factor that moves a sum taken at max m to max mn >= m (1 when they
// are equal, so two -inf maxima do not make a NaN).
__device__ __forceinline__ float rescale(float m, float mn) {
  return m == mn ? 1.f : exp2f((m - mn) * L2E);
}

// Online merge of (m, s) with (mb, sb); symmetric in its operands (the
// products are rounded alone), so a butterfly leaves every lane the same.
__device__ __forceinline__ void merge(float& m, float& s, float mb, float sb) {
  const float mn = fmaxf(m, mb);
  s = __fmul_rn(s, rescale(m, mn)) + __fmul_rn(sb, rescale(mb, mn));
  m = mn;
}

// NV vectors of VEC values a thread (NV == LOOP: loop over the row).  CTA:
// a CTA per row, else a warp per row.  The launch bound names a minimum of
// one CTA an SM: without it ptxas held the CTA-per-row instances to 64
// registers, and they spilled.
template <typename T, int NV, bool CTA>
__global__ void __launch_bounds__(CTA_THREADS, 1)
softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int rows, int W, float scale,
                   int vec) {
  constexpr int VEC = 16 / (int)sizeof(T);
  __shared__ float part[2][32];
  const int width = CTA ? blockDim.x : 32;
  const int t = CTA ? threadIdx.x : (threadIdx.x & 31);
  const int row = CTA ? blockIdx.x : blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (!CTA && row >= rows) return;   // a whole warp: no barrier follows
  const T* __restrict__ xr = x + (size_t)row * W;
  T* __restrict__ yr = y + (size_t)row * W;

  if constexpr (NV == LOOP) {
    // rows too wide for registers: an online (max, sum) a thread, rescaled
    // once a vector; then x again from L2 for the write
    float m = -INFINITY, s = 0.f;
    const int step = vec ? VEC : 1;
    for (int e0 = t * step; e0 < W; e0 += width * step) {
      float v[VEC];
      if (vec) load_vec<T, VEC>(xr + e0, v);
      else v[0] = dst_to_float(xr[e0]);
      float vm = -INFINITY;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        if (c < step) {
          v[c] *= scale;
          vm = fmaxf(vm, v[c]);
        }
      }
      const float mn = fmaxf(m, vm);
      float vs = 0.f;
#pragma unroll
      for (int c = 0; c < VEC; ++c)   // -inf adds 0 even while the max is -inf
        if (c < step) vs += v[c] == -INFINITY ? 0.f : exp2f((v[c] - mn) * L2E);
      s = __fmul_rn(s, rescale(m, mn)) + vs;
      m = mn;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      merge(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
    if ((threadIdx.x & 31) == 0) {
      part[0][threadIdx.x >> 5] = m;
      part[1][threadIdx.x >> 5] = s;
    }
    __syncthreads();
    m = part[0][0];
    s = part[1][0];
    const int nwarps = blockDim.x >> 5;
    for (int w = 1; w < nwarps; ++w) merge(m, s, part[0][w], part[1][w]);
    const float inv = 1.f / s;
    for (int e0 = t * step; e0 < W; e0 += width * step) {
      float v[VEC];
      if (vec) load_vec<T, VEC>(xr + e0, v);
      else v[0] = dst_to_float(xr[e0]);
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        if (c < step) v[c] = exp2f((v[c] * scale - m) * L2E) * inv;
      if (vec) store_vec<T, VEC>(yr + e0, v);
      else yr[e0] = dst_from_float<T>(v[0]);
    }
    return;
  } else {
    float v[NV][VEC];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * width + t) * VEC;
      if (vec) {
        if (e0 < W) {
          load_vec<T, VEC>(xr + e0, v[j]);
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[j][c] *= scale;
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[j][c] = -INFINITY;
        }
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          v[j][c] = e0 + c < W ? dst_to_float(xr[e0 + c]) * scale : -INFINITY;
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) m = fmaxf(m, v[j][c]);
    }
    m = row_max<CTA>(m, part[0]);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * width + t) * VEC;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        v[j][c] = exp2f((v[j][c] - m) * L2E);   // padding: exp2(-inf) = 0
        if (e0 + c < W) s += v[j][c];
      }
    }
    const float inv = 1.f / row_sum<CTA>(s, part[1]);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * width + t) * VEC;
      if (e0 >= W) continue;
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[j][c] *= inv;
      if (vec) {
        store_vec<T, VEC>(yr + e0, v[j]);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          if (e0 + c < W) yr[e0 + c] = dst_from_float<T>(v[j][c]);
      }
    }
  }
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

template <typename T, int NV, bool CTA>
cudaError_t launch_fwd_nv(const void* x, void* y, int rows, int W, float scale, int vec,
                          int threads, cudaStream_t stream) {
  const int grid = CTA ? rows : (rows - 1) / ROW_WARPS + 1;   // rows >= 1
  softmax_fwd_kernel<T, NV, CTA><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, W, scale, vec);
  return cudaGetLastError();
}

template <typename T, bool CTA>
cudaError_t launch_fwd_cta(const void* x, void* y, int rows, int W, float scale, int vec,
                           int nv, int threads, cudaStream_t stream) {
#define DST_SM_NV(NV) launch_fwd_nv<T, NV, CTA>(x, y, rows, W, scale, vec, threads, stream)
  switch (nv) {
    case 1: return DST_SM_NV(1);
    case 2: return DST_SM_NV(2);
    case 4: return DST_SM_NV(4);
    default:   // 8 vectors: a warp per row, or fp32 in a CTA per row (CTA_VALUES)
      if constexpr (CTA && sizeof(T) == 2) return cudaErrorInvalidValue;
      else return DST_SM_NV(8);
  }
#undef DST_SM_NV
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, int rows, int W, float scale,
                       cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int vec = W % VEC == 0 && aligned16(x) && aligned16(y);
  const int nvec = (W + VEC - 1) / VEC;   // vectors a row (the last may be partial)
  if (nvec <= 32 * MAX_VECS) {             // a warp per row
    const int nv = nvec <= 32 ? 1 : nvec <= 64 ? 2 : nvec <= 128 ? 4 : 8;
    return launch_fwd_cta<T, false>(x, y, rows, W, scale, vec, nv, 32 * ROW_WARPS, stream);
  }
  if (nvec <= CTA_THREADS * (CTA_VALUES / VEC)) {   // a CTA per row
    const int nv = nvec <= 512 ? 1 : nvec <= 1024 ? 2 : nvec <= 2048 ? 4 : 8;
    const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    return launch_fwd_cta<T, true>(x, y, rows, W, scale, vec, nv, threads, stream);
  }
  return launch_fwd_nv<T, LOOP, true>(x, y, rows, W, scale, vec, CTA_THREADS, stream);
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long rows, int W, float scale,
           cudaStream_t stream) {
  if (b == nullptr) return (int)launch_fwd<T>(a, out, (int)rows, W, scale, stream);
  int threads = ((W / 8 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
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
