// K4: sorted top-k over logit rows.
//
// Replaces the TPU kernel deeperspeed_tpu/ops/sampling/topk.py `_topk_kernel`
// (launched by `sorted_topk`).
//
// Bound on the H100: bytes.  The row is read from device memory once
// (V * 4 bytes) and k values + k indices are written; the k selection
// rounds run out of shared memory.
//
// Design: one CTA of 1024 threads per row.  The row is loaded once into
// dynamic shared memory (50304 fp32 = 197 KB for the GPT-NeoX vocab, under
// the 227 KB a block may take), beside one bit per slot marking the slots
// already taken.  Each of the k rounds is a block-wide arg-max over the
// untaken slots, ties to the lowest index (the contract of lax.top_k), done
// as a per-thread scan, a warp shuffle reduction and a reduction over the
// warps; the winner is written out and its bit set.  Marking by a flag
// rather than overwriting with a -1e30 sentinel (as the TPU kernel does)
// keeps a row of values <= -1e30, or of -inf after a mask, from re-selecting
// a slot it already took.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, int V,
            int k) {
  extern __shared__ float row[];
  unsigned* taken = reinterpret_cast<unsigned*>(row + V);
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = (V + 31) / 32;
  const float* xr = x + (size_t)blockIdx.x * V;
  for (int i = tid; i < V; i += kThreads) row[i] = xr[i];
  for (int w = tid; w < words; w += kThreads) taken[w] = 0u;
  __syncthreads();

  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < V; i += kThreads) {
      if ((taken[i >> 5] >> (i & 31)) & 1u) continue;
      const float v = row[i];
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) {
        vals[(size_t)blockIdx.x * k + r] = bv;
        idx[(size_t)blockIdx.x * k + r] = bi < V ? bi : -1;
        if (bi < V) taken[bi >> 5] |= 1u << (bi & 31);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t dst_topk_smem_bytes(int V) {
  return (size_t)V * sizeof(float) + (size_t)((V + 31) / 32) * sizeof(unsigned);
}

// x [rows, V] fp32 -> vals [rows, k] fp32, idx [rows, k] int32
extern "C" int dst_sorted_topk(const float* x, float* vals, int* idx, int rows, int V, int k,
                               cudaStream_t stream) {
  if (k < 1 || k > V) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const size_t smem = dst_topk_smem_bytes(V);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_kernel<<<rows, kThreads, smem, stream>>>(x, vals, idx, V, k);
  return (int)cudaGetLastError();
}
