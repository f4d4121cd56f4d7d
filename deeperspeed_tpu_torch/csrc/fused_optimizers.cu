// B6: fused Adam, and B7: fused Lion, each one launch over every parameter.
//
// B6 replaces the TPU kernel deeperspeed_tpu/ops/adam/pallas_adam.py
// `_adam_block_kernel` (launched per leaf by `fused_adam_kernel` through
// ops/pallas_utils.py `elementwise_call`); B7 replaces
// deeperspeed_tpu/ops/lion/fused_lion.py `_lion_kernel` (`fused_lion_kernel`).
// The reference framework does the same work as one multi-tensor CUDA launch
// (csrc/adam/multi_tensor_adam.cu); so do these.
//
// What they compute, elementwise in fp32 (g, m, v fp32):
//   B6: m' = b1 m + (1-b1) g;  v' = b2 v + ((1-b2) g) g;
//       u  = (m' / bc1) / (sqrt(v' / bc2) + eps), written over g;
//   B7: u  = sign(b1 m + (1-b1) g), written over g;  m' = b2 m + (1-b2) g.
// bc1 and bc2 (the bias corrections 1 - b^count) come from the host in fp32,
// as the TPU kernel takes them from SMEM.  The sign of 0 is 0 and the sign
// of NaN is NaN, as jnp.sign gives them, so a NaN gradient shows in the
// weights as it does under the JAX engine.  Nothing else
// is fused: weight decay, the learning rate and the compute-copy refresh stay
// outside, as they do around the TPU kernel.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn are
// never contracted into an FMA), in the order of the TPU kernel's
// expression, so m', v' and B7's u equal the plain version's
// (ops/adam/fused_adam.py, ops/lion/fused_lion.py) bit for bit; u of B6
// differs from a plain version only by how PyTorch divides by a scalar.
//
// Bound on the H100: bytes.  B6 reads g, m, v and writes u, m', v' (24 bytes
// an element) for ~12 flops; B7 reads g, m and writes u, m' (16 bytes) for
// ~6.  Both sit far below the card's ~20 flops/byte balance point.
//
// Design: a grid-stride walk over chunks of CHUNK elements.  The tensors
// come as a device table of entries {g, m, v, numel, first chunk}: the
// engine's moments and gradients are flat buffers, one entry; tensors that
// do not tile one buffer are one entry each, and a block finds its chunk's
// entry by binary search.  Inside a chunk each thread moves 16 bytes a load
// (float4) where the chunk's pointers are 16-byte aligned, one element a
// load otherwise, and for the ragged tail.  Grid: at most 8 blocks of 256
// threads per SM, enough loads in flight to cover the memory latency.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 4096;  // elements; a multiple of 4 keeps float4 alignment

struct Entry {
  long long g, m, v, n, first;  // pointers as integers, numel, first chunk index
};

struct AdamArgs {
  float b1, omb1, b2, omb2, eps, bc1, bc2;
};

struct LionArgs {
  float b1, omb1, b2, omb2;
};

__device__ __forceinline__ int find_entry(const Entry* __restrict__ table, int n_entries,
                                          long long chunk) {
  int lo = 0, hi = n_entries - 1;  // the last entry whose first chunk <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].first <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void adam_elem(float& g, float& m, float& v, const AdamArgs& a) {
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  g = __fdiv_rn(__fdiv_rn(m, a.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
}

__device__ __forceinline__ void lion_elem(float& g, float& m, const LionArgs& a) {
  const float c = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  m = __fadd_rn(__fmul_rn(a.b2, m), __fmul_rn(a.omb2, g));
  g = c != c ? c : (float)((c > 0.f) - (c < 0.f));
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

__global__ void __launch_bounds__(THREADS)
adam_kernel(const Entry* __restrict__ table, int n_entries, long long n_chunks, AdamArgs a) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Entry e = table[find_entry(table, n_entries, c)];
    const long long start = (c - e.first) * CHUNK;
    const long long len = min(CHUNK, e.n - start);
    float* g = reinterpret_cast<float*>(e.g) + start;
    float* m = reinterpret_cast<float*>(e.m) + start;
    float* v = reinterpret_cast<float*>(e.v) + start;
    long long done = 0;
    if (aligned16(g) && aligned16(m) && aligned16(v)) {
      const long long n4 = len >> 2;
      for (long long i = threadIdx.x; i < n4; i += THREADS) {
        float4 gg = reinterpret_cast<float4*>(g)[i];
        float4 mm = reinterpret_cast<float4*>(m)[i];
        float4 vv = reinterpret_cast<float4*>(v)[i];
        adam_elem(gg.x, mm.x, vv.x, a);
        adam_elem(gg.y, mm.y, vv.y, a);
        adam_elem(gg.z, mm.z, vv.z, a);
        adam_elem(gg.w, mm.w, vv.w, a);
        reinterpret_cast<float4*>(g)[i] = gg;
        reinterpret_cast<float4*>(m)[i] = mm;
        reinterpret_cast<float4*>(v)[i] = vv;
      }
      done = n4 << 2;
    }
    for (long long i = done + threadIdx.x; i < len; i += THREADS) {
      float gg = g[i], mm = m[i], vv = v[i];
      adam_elem(gg, mm, vv, a);
      g[i] = gg;
      m[i] = mm;
      v[i] = vv;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lion_kernel(const Entry* __restrict__ table, int n_entries, long long n_chunks, LionArgs a) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Entry e = table[find_entry(table, n_entries, c)];
    const long long start = (c - e.first) * CHUNK;
    const long long len = min(CHUNK, e.n - start);
    float* g = reinterpret_cast<float*>(e.g) + start;
    float* m = reinterpret_cast<float*>(e.m) + start;
    long long done = 0;
    if (aligned16(g) && aligned16(m)) {
      const long long n4 = len >> 2;
      for (long long i = threadIdx.x; i < n4; i += THREADS) {
        float4 gg = reinterpret_cast<float4*>(g)[i];
        float4 mm = reinterpret_cast<float4*>(m)[i];
        lion_elem(gg.x, mm.x, a);
        lion_elem(gg.y, mm.y, a);
        lion_elem(gg.z, mm.z, a);
        lion_elem(gg.w, mm.w, a);
        reinterpret_cast<float4*>(g)[i] = gg;
        reinterpret_cast<float4*>(m)[i] = mm;
      }
      done = n4 << 2;
    }
    for (long long i = done + threadIdx.x; i < len; i += THREADS) {
      float gg = g[i], mm = m[i];
      lion_elem(gg, mm, a);
      g[i] = gg;
      m[i] = mm;
    }
  }
}

// Blocks for n_chunks: at most 8 per SM (2048 resident threads an SM).
static int grid_for(long long n_chunks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = 8ll * sms;
  return (int)(n_chunks < cap ? n_chunks : cap);
}

}  // namespace

// `table`: device array of n_entries {g, m, v, numel, first chunk} (int64
// each), entries in order of their first chunk; n_chunks = the chunks of all
// entries together.  Returns cudaGetLastError() after the launch.
extern "C" int dst_fused_adam(const void* table, int n_entries, long long n_chunks, float b1,
                              float omb1, float b2, float omb2, float eps, float bc1, float bc2,
                              cudaStream_t stream) {
  if (n_chunks == 0) return 0;
  const AdamArgs a{b1, omb1, b2, omb2, eps, bc1, bc2};
  adam_kernel<<<grid_for(n_chunks), THREADS, 0, stream>>>(static_cast<const Entry*>(table),
                                                           n_entries, n_chunks, a);
  return (int)cudaGetLastError();
}

extern "C" int dst_fused_lion(const void* table, int n_entries, long long n_chunks, float b1,
                              float omb1, float b2, float omb2, cudaStream_t stream) {
  if (n_chunks == 0) return 0;
  const LionArgs a{b1, omb1, b2, omb2};
  lion_kernel<<<grid_for(n_chunks), THREADS, 0, stream>>>(static_cast<const Entry*>(table),
                                                           n_entries, n_chunks, a);
  return (int)cudaGetLastError();
}
