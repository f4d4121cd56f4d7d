// K2 / K3: paged-KV decode and speculative-decode attention.
//
// Replaces the TPU kernels deeperspeed_tpu/ops/attention/paged.py
// `_decode_kernel` (launched by `paged_decode_attention`) and
// `_spec_decode_kernel` (launched by `paged_spec_decode_attention`), with
// floating-point pools (K2, K3) and with `quantized=True` (K2q, K3q): pools
// of int8 or fp8 e4m3 payload [P, bs, N, D] beside fp32 scales [P, bs, N],
// one per (slot, head).
//
// Bound on the H100: bytes.  Each live KV token is read once per head
// (2 * D elements, plus 2 scales when quantized) for 4 * D flops per query,
// about 1 flop/byte in bf16 and 2 with a 1-byte payload.
//
// Design: one CTA of 128 threads per (sequence, head).  There is no scalar
// prefetch on CUDA, so the CTA reads its own block_tables[b, :] entries.  It
// walks only the live tokens t < limit (the loop bound skips dead blocks),
// TILE tokens at a time: the tile's K and V rows of this head are staged in
// shared memory as fp32 (each row is D contiguous elements, strided by N * D
// in the pool; a quantized element is decoded exactly to fp32 and multiplied
// by its token's scale at this load, k = float(q) * scale, before the score
// reduce and the p * V sum, so no dequantized copy of the cache ever exists
// in device memory), each warp scores whole tokens (lanes split D, shuffle
// reduce), one thread per query updates that query's running max m and sum
// l in fp32, and every thread rescales and accumulates its share of the
// [S, D] output in registers.  Masked scores are NEG_INF (-1e30) as in the
// TPU kernel, and masked tokens contribute p = 0.  A query that sees no
// token (a padding row with seq_len 0) writes zeros, never NaN.
//
// The softmax scale multiplies the score after the reduce; it is not folded
// into the KV scale.  Loads are one element per thread, so no head_dim is
// refused for alignment.
//
// One kernel serves all four: decode (S = 1) masks by t < seq_lens[b];
// speculative decode masks query sq by t <= positions[b, sq]; each query's
// sums run in the same order whatever S is, so speculative and plain
// decoding agree bit for bit on the same pool.
#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

// pool element types the wrappers name (0: the query's own type)
#define DST_POOL_FP 0
#define DST_POOL_INT8 1
#define DST_POOL_FP8_E4M3 2

__device__ __forceinline__ float dst_to_float(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float dst_to_float(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kMaxS = 8;
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kMaxS * kMaxD / kThreads;

// T: type of q and out.  KV: type of the pools; when it differs from T the
// pools are quantized and k_scale / v_scale [P, bs, N] are read.
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ pool_k,
                       const KV* __restrict__ pool_v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, const int* __restrict__ positions,
                       T* __restrict__ out, int S, int N, int D, int bs, int M, float scale) {
  constexpr bool kQuantized = !std::is_same<T, KV>::value;
  __shared__ float qs[kMaxS][kMaxD];
  __shared__ float ks[kTile][kMaxD];
  __shared__ float vs[kTile][kMaxD];
  __shared__ float sc[kMaxS][kTile];
  __shared__ float m_s[kMaxS], l_s[kMaxS], a_s[kMaxS];
  __shared__ int lim_s[kMaxS];

  const int b = blockIdx.x / N;
  const int n = blockIdx.x % N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int SD = S * D;

  if (tid < S) {
    // query sq sees pool tokens t < lim_s[sq]
    lim_s[tid] = seq_lens != nullptr ? seq_lens[b] : positions[b * S + tid] + 1;
    m_s[tid] = DST_NEG_INF;
    l_s[tid] = 0.f;
  }
  for (int idx = tid; idx < SD; idx += kThreads) {
    const int sq = idx / D, d = idx % D;
    qs[sq][d] = dst_to_float(q[(((size_t)b * S + sq) * N + n) * D + d]);
  }
  __syncthreads();

  int limit = 0;
  for (int sq = 0; sq < S; ++sq) limit = max(limit, lim_s[sq]);
  limit = min(limit, M * bs);  // never read past the table

  float acc[kAccPerThread];
#pragma unroll
  for (int c = 0; c < kAccPerThread; ++c) acc[c] = 0.f;

  const int* table = block_tables + (size_t)b * M;
  for (int t0 = 0; t0 < limit; t0 += kTile) {
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int tt = idx / D, d = idx % D;
      const int t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t < limit) {
        const size_t row = ((size_t)table[t / bs] * bs + t % bs) * N + n;
        kv = dst_to_float(pool_k[row * D + d]);
        vv = dst_to_float(pool_v[row * D + d]);
        if (kQuantized) {
          kv *= k_scale[row];
          vv *= v_scale[row];
        }
      }
      ks[tt][d] = kv;
      vs[tt][d] = vv;
    }
    __syncthreads();

    for (int tt = warp; tt < kTile; tt += kWarps) {
      const int t = t0 + tt;
      for (int sq = 0; sq < S; ++sq) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32) part += qs[sq][d] * ks[tt][d];
        part = dst_warp_sum(part);
        if (lane == 0) sc[sq][tt] = t < lim_s[sq] ? part * scale : DST_NEG_INF;
      }
    }
    __syncthreads();

    if (tid < S) {
      const int sq = tid;
      const float m_prev = m_s[sq];
      float m_new = m_prev;
      for (int tt = 0; tt < kTile; ++tt) m_new = fmaxf(m_new, sc[sq][tt]);
      float psum = 0.f;
      for (int tt = 0; tt < kTile; ++tt) {
        const float p = (t0 + tt) < lim_s[sq] ? expf(sc[sq][tt] - m_new) : 0.f;
        sc[sq][tt] = p;
        psum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[sq] = l_s[sq] * alpha + psum;
      m_s[sq] = m_new;
      a_s[sq] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kAccPerThread; ++c) {
      const int idx = tid + c * kThreads;
      if (idx < SD) {
        const int sq = idx / D, d = idx % D;
        float s = acc[c] * a_s[sq];
        for (int tt = 0; tt < kTile; ++tt) s += sc[sq][tt] * vs[tt][d];
        acc[c] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kAccPerThread; ++c) {
    const int idx = tid + c * kThreads;
    if (idx < SD) {
      const int sq = idx / D, d = idx % D;
      const float l = l_s[sq];
      out[(((size_t)b * S + sq) * N + n) * D + d] = dst_from_float<T>(l > 0.f ? acc[c] / l : 0.f);
    }
  }
}

struct Args {
  const void *q, *pool_k, *pool_v;
  const float *k_scale, *v_scale;
  const int *block_tables, *seq_lens, *positions;
  void* out;
  int B, S, N, D, bs, M;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV>
cudaError_t launch(const Args& a) {
  paged_attention_kernel<T, KV><<<a.B * a.N, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.pool_k),
      static_cast<const KV*>(a.pool_v), a.k_scale, a.v_scale, a.block_tables, a.seq_lens,
      a.positions, static_cast<T*>(a.out), a.S, a.N, a.D, a.bs, a.M, a.scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_pool(const Args& a, int pool) {
  switch (pool) {
    case DST_POOL_FP:
      return launch<T, T>(a);
    case DST_POOL_INT8:
      return launch<T, int8_t>(a);
    case DST_POOL_FP8_E4M3:
      return launch<T, __nv_fp8_e4m3>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Args& a, int dtype, int pool) {
  if (a.S < 1 || a.S > kMaxS || a.D < 1 || a.D > kMaxD) return (int)cudaErrorInvalidValue;
  if ((pool != DST_POOL_FP) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.N == 0) return 0;
  switch (dtype) {
    case DST_DTYPE_F32:
      return dispatch_pool<float>(a, pool);
    case DST_DTYPE_BF16:
      return dispatch_pool<__nv_bfloat16>(a, pool);
    case DST_DTYPE_F16:
      return dispatch_pool<__half>(a, pool);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, N, D]; pools [P, bs, N, D] of q's type (pool 0) or 1-byte (pool 1: int8, 2: fp8 e4m3)
// with k_scale / v_scale [P, bs, N] fp32, else null; block_tables [B, M]; seq_lens [B];
// out [B, N, D]
extern "C" int dst_paged_decode(const void* q, const void* pool_k, const void* pool_v,
                                const float* k_scale, const float* v_scale,
                                const int* block_tables, const int* seq_lens, void* out, int B,
                                int N, int D, int bs, int M, float scale, int dtype, int pool,
                                cudaStream_t stream) {
  const Args a{q, pool_k, pool_v, k_scale, v_scale, block_tables, seq_lens, nullptr, out,
               B, 1, N, D, bs, M, scale, stream};
  return dispatch(a, dtype, pool);
}

// q [B, S, N, D]; positions [B, S]; out [B, S, N, D]
extern "C" int dst_paged_spec_decode(const void* q, const void* pool_k, const void* pool_v,
                                     const float* k_scale, const float* v_scale,
                                     const int* block_tables, const int* positions, void* out,
                                     int B, int S, int N, int D, int bs, int M, float scale,
                                     int dtype, int pool, cudaStream_t stream) {
  const Args a{q, pool_k, pool_v, k_scale, v_scale, block_tables, nullptr, positions, out,
               B, S, N, D, bs, M, scale, stream};
  return dispatch(a, dtype, pool);
}
