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
// Bound on the H100: bytes, but not by far.  `tanhf` and the polynomial
// come to ~26 instructions an element (`cuobjdump -sass`: 2 MUFU, ~16
// FMUL/FFMA/FADD), so at [8192, 3072] the instruction issue alone takes
// ~0.022 ms against 0.030 ms of bytes (fp16), and the loads must stay in
// flight while other threads compute.  Design: a CTA of 256 threads takes
// one chunk of UNROLL 16-byte vectors a thread (8 bf16/fp16 or 4 fp32
// values each, neighbouring threads on neighbouring vectors), issues all
// of its loads (x, and dy in the backward) before any arithmetic, and
// writes 16-byte stores.  The grid has a CTA a chunk: the block scheduler
// starts CTAs as others finish, so one CTA's loads overlap another's
// arithmetic.  (A grid of 8 CTAs an SM striding over 4-vector chunks ran in
// near lock-step, loads then arithmetic, and took 1.16x `F.gelu` in fp16.)
// The last n mod chunk elements, and every element when a pointer is not
// 16-byte aligned (a view at an odd offset), go through a scalar
// grid-stride loop in the same kernel.  The arithmetic is the one below on
// every path, so the paths agree bit for bit.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "vec.cuh"

namespace {

constexpr float C0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float C1 = 0.044715f;
constexpr int THREADS = 256;
constexpr int UNROLL = 2;                  // 16-byte vectors in flight a thread (per input)

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

template <bool BWD>
__device__ __forceinline__ float apply(float x, float dy) {
  if constexpr (BWD) return dgelu(x) * dy;
  else return gelu(x);
}

// BWD: dx = gelu'(x) dy; else y = gelu(x).  `vectors`: every pointer is
// 16-byte aligned.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
gelu_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ out,
            long long n, bool vectors) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr long long CHUNK = (long long)THREADS * UNROLL * V;
  long long done = 0;
  if (vectors) {
    const long long full = n / CHUNK;
    for (long long c = blockIdx.x; c < full; c += gridDim.x) {
      const long long base = c * CHUNK + (long long)threadIdx.x * V;
      float xv[UNROLL][V], gv[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load_vec<T, V>(x + base + u * THREADS * V, xv[u]);
      if constexpr (BWD) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) load_vec<T, V>(dy + base + u * THREADS * V, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) xv[u][i] = apply<BWD>(xv[u][i], BWD ? gv[u][i] : 0.f);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) store_vec<T, V>(out + base + u * THREADS * V, xv[u]);
    }
    done = full * CHUNK;
  }
  for (long long i = done + (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    out[i] = dst_from_float<T>(apply<BWD>(dst_to_float(x[i]), BWD ? dst_to_float(dy[i]) : 0.f));
}

template <typename T>
int launch(const void* x, const void* dy, void* out, long long n, cudaStream_t stream) {
  constexpr long long CHUNK = (long long)THREADS * UNROLL * (16 / sizeof(T));
  const bool vectors = aligned16(x) && aligned16(dy) && aligned16(out);
  // a CTA a chunk (vectors) or a CTA a 256-element block (scalar, or a
  // tensor shorter than one chunk)
  const long long chunks = vectors ? n / CHUNK : 0;
  const long long want = chunks > 0 ? chunks : (n + THREADS - 1) / THREADS;
  const int grid = (int)(want < INT_MAX ? want : INT_MAX);
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (dy == nullptr)
    gelu_kernel<T, false><<<grid, THREADS, 0, stream>>>(xt, nullptr, o, n, vectors);
  else
    gelu_kernel<T, true><<<grid, THREADS, 0, stream>>>(xt, static_cast<const T*>(dy), o, n,
                                                        vectors);
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
