// B5: fused dequant-reduce, the sum over peers of block-scaled 1-byte
// partials, in fp32.
//
// Replaces the TPU kernel deeperspeed_tpu/ops/quantizer/fused.py
// `_dequant_reduce_kernel` (launched by `_pallas_dequant_reduce`).  It is
// the local half of the qgZ gradient reduce-scatter (comm/compressed.py):
// after the all-to-all every rank holds n peers' quantized copies of its
// shard, and must compute
//
//   out[r, c] = sum_{k=0}^{n-1} float(q[k, r, c]) * s[k, r, c / g]
//
// q [n, rows, d] of 1-byte values (int8, fp8 e4m3fn or fp8 e5m2, named by a
// type code), s [n, rows, d / g] fp32, out [rows, d] fp32.
//
// The contract is `_xla_dequant_reduce` of the JAX package, bit for bit: the
// peers are summed in peer order, one thread per output element (no tree
// over peers, no atomics), starting from the first peer's product (the
// Pallas body starts from +0, which differs on -0.0 only), and every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn are never contracted
// into an FMA).  The plain version is ops/quantizer/fused.py
// `_dequant_reduce_plain`.
//
// Bound on the H100: bytes.  Each output element reads n value bytes and
// writes 4 bytes, for n multiplies and n - 1 adds.
//
// Design: a grid-stride walk.  Where every 16-element run lies inside one
// scale group (g % 16 == 0) and the values are 16-byte aligned, a thread
// takes 16 outputs at a time: one 16-byte load of values and one scale per
// peer, four float4 stores.  Otherwise a thread takes one element at a time.
#include "common.cuh"

#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;  // 1-byte values per 16-byte load

template <int QT> __device__ __forceinline__ float widen(uint8_t b);
template <> __device__ __forceinline__ float widen<0>(uint8_t b) {
  return (float)(int8_t)b;
}
template <> __device__ __forceinline__ float widen<1>(uint8_t b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}
template <> __device__ __forceinline__ float widen<2>(uint8_t b) {
  __nv_fp8_e5m2 v;
  v.__x = b;
  return static_cast<float>(v);
}

struct Shape {
  long long rows;   // rows of the output
  long long d;      // row length
  long long g;      // scale group length (divides d)
  long long peer;   // rows * d: one peer's values
  long long speer;  // rows * (d / g): one peer's scales
  int n;            // peers
};

template <int QT>
__global__ void __launch_bounds__(THREADS)
dequant_reduce_vec(const uint8_t* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ out, Shape sh) {
  const long long groups = sh.d / sh.g;
  const long long n_vec = sh.peer / VEC;
  for (long long v = blockIdx.x * (long long)THREADS + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * THREADS) {
    const long long e = v * VEC;
    const long long r = e / sh.d;
    const long long sidx = r * groups + (e - r * sh.d) / sh.g;
    float acc[VEC];
    for (int k = 0; k < sh.n; ++k) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q + k * sh.peer + e);
      const float sc = s[k * sh.speer + sidx];
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float p = __fmul_rn(widen<QT>(b[i]), sc);
        acc[i] = k == 0 ? p : __fadd_rn(acc[i], p);
      }
    }
    float4* o = reinterpret_cast<float4*>(out + e);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <int QT>
__global__ void __launch_bounds__(THREADS)
dequant_reduce_scalar(const uint8_t* __restrict__ q, const float* __restrict__ s,
                      float* __restrict__ out, Shape sh) {
  const long long groups = sh.d / sh.g;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < sh.peer;
       e += (long long)gridDim.x * THREADS) {
    const long long r = e / sh.d;
    const long long sidx = r * groups + (e - r * sh.d) / sh.g;
    float acc = 0.f;
    for (int k = 0; k < sh.n; ++k) {
      const float p = __fmul_rn(widen<QT>(q[k * sh.peer + e]), s[k * sh.speer + sidx]);
      acc = k == 0 ? p : __fadd_rn(acc, p);
    }
    out[e] = acc;
  }
}

// Blocks for `items` thread-items: at most 8 per SM (2048 resident threads an SM).
static int grid_for(long long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (items + THREADS - 1) / THREADS;
  const long long cap = 8ll * sms;
  return (int)(blocks < cap ? blocks : cap);
}

template <int QT>
int launch(const uint8_t* q, const float* s, float* out, const Shape& sh, cudaStream_t stream) {
  const bool vec = sh.g % VEC == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    dequant_reduce_vec<QT><<<grid_for(sh.peer / VEC), THREADS, 0, stream>>>(q, s, out, sh);
  else
    dequant_reduce_scalar<QT><<<grid_for(sh.peer), THREADS, 0, stream>>>(q, s, out, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// q: n x rows x d 1-byte values of type qtype (0 int8, 1 fp8 e4m3fn, 2 fp8
// e5m2); s: n x rows x (d / g) fp32; out: rows x d fp32.  g divides d.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// bad argument, without launching).
extern "C" int dst_dequant_reduce(const void* q, const void* s, void* out, int n,
                                  long long rows, long long d, long long g, int qtype,
                                  cudaStream_t stream) {
  if (n < 1 || d < 1 || g < 1 || d % g != 0 || qtype < 0 || qtype > 2)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Shape sh{rows, d, g, rows * d, rows * (d / g), n};
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  switch (qtype) {
    case 0: return launch<0>(qb, sf, o, sh, stream);
    case 1: return launch<1>(qb, sf, o, sh, stream);
    default: return launch<2>(qb, sf, o, sh, stream);
  }
}
