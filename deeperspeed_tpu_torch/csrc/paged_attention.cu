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
// Design: one CTA of 4 warps per (sequence, head), no shared memory and no
// barrier in the walk.  There is no scalar prefetch on CUDA, so each lane
// reads the block_tables[b, :] entry of its own tokens, one per pool block
// it enters, a fetch ahead of the pool loads that need it.
//
// - Lane layout.  A lane owns E consecutive elements of a K or V row: 16
//   bytes of a 2- or 4-byte pool (E 8 or 4), 8 bytes of a 1-byte pool (E 8,
//   so the q fragments and the accumulators of 8 queries stay inside the
//   register file).  A token takes G lanes, the smallest power of two with
//   G >= 8 and G * E >= D, so a warp holds 32 / G token slots.  Each lane
//   keeps its elements of every query's q (fp32) and of every query's
//   output accumulator in registers.
// - Scores.  A lane's partial dot of each query is E FMAs.  The slot's G
//   lanes reduce them by xor-shuffles at offsets G/2 .. 1, and the first
//   log2(S) of those steps also split the queries between the lanes (a
//   reduce-scatter), so each lane ends with one query's whole score,
//   multiplied by `scale` after the reduce.  That lane alone keeps the
//   query's running max m and sum l in fp32 and takes one exp a token;
//   p (and, where the max grew, the rescale) goes back to the slot's lanes
//   by shuffles, and each lane adds p * v to its accumulators.  G >= 8 lets
//   a slot share out the 8 queries of the largest bucket.
// - Walk.  Token t belongs to warp (t / TPW) % 4 and slot t % TPW, with TPW
//   = 32 / G: a fixed deal that does not depend on the walk limit.  Each
//   slot runs its own online softmax.  K and V (and scales) are loaded into
//   a ring of registers 1 (S = 1) or 2 (S = 4, 8) walk steps ahead of the
//   math.  A quantized element is decoded exactly to fp32 and multiplied by
//   its token's scale at the load, k = float(q) * scale, so no dequantized
//   copy of the cache ever exists in device memory.
// - Merge.  The slots of a warp are merged by xor-shuffles, then the four
//   warps through shared memory in warp order, each part weighted by
//   exp(m_part - M) (a part that saw no live token has l = 0 and weight 0),
//   and one pass writes out[..] = a / l in q's type, or 0 where l = 0 (a
//   padding row with seq_len 0 writes zeros, never NaN).
//
// Loads are 16 (8) bytes when D * sizeof(KV) is a multiple of that and both
// pools are aligned to it (checked at launch); otherwise the same kernel
// loads element by element into the same registers.  q is read element by
// element once per CTA, so its alignment does not matter.  Only tokens below
// the walk limit (and below M * bs) are read, so table entries past a row's
// live blocks are never touched.
//
// One kernel serves all four: decode (S = 1) masks by t < seq_lens[b];
// speculative decode masks query sq by t <= positions[b, sq], and runs as
// the bucket S = 1, 4 or 8 (2-3 as 4, 5-7 as 8, padded queries masked
// out).  A masked token leaves a query's state untouched, the deal, the
// shuffle trees and the merge order do not depend on S or on the walk
// limit, and every product and sum is rounded on its own (__fmaf_rn /
// __fmul_rn / __fadd_rn), so speculative and plain decoding agree bit for
// bit on the same pool.
#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

// pool element types the wrappers name (0: the query's own type)
#define DST_POOL_FP 0
#define DST_POOL_INT8 1
#define DST_POOL_FP8_E4M3 2

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 8;
constexpr int kMaxD = 128;
// walk steps of K/V loads in flight a warp: of depths 1-4 timed on the
// H100 at the served shapes, the fastest for decode and for the S 4 / 8
// buckets (deeper rings cost registers and did not pay)
template <int S>
constexpr int kDepth = S == 1 ? 1 : 2;
constexpr unsigned kFull = 0xffffffffu;

// elements a lane loads at once, and the 32-bit words that hold them
template <typename KV>
struct Pack {
  static constexpr int kBytes = sizeof(KV) == 1 ? 8 : 16;
  static constexpr int E = kBytes / sizeof(KV);
  static constexpr int W = kBytes / 4;
};

template <typename KV>
struct Frag {
  uint32_t w[Pack<KV>::W];
};

// the raw bits of element i of a fragment
template <typename KV>
__device__ __forceinline__ uint32_t bits_of(const Frag<KV>& f, int i) {
  constexpr int per = 4 / sizeof(KV);
  constexpr uint32_t mask = sizeof(KV) == 4 ? 0xffffffffu : (1u << (8 * sizeof(KV))) - 1u;
  return (f.w[i / per] >> (8 * sizeof(KV) * (i % per))) & mask;
}

// a fragment's elements, decoded exactly to fp32
template <typename KV>
__device__ __forceinline__ void decode(const Frag<KV>& f, float* x) {
  constexpr int E = Pack<KV>::E;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const uint32_t b = bits_of(f, i);
    if constexpr (std::is_same<KV, float>::value) {
      x[i] = __uint_as_float(b);
    } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
      x[i] = __uint_as_float(b << 16);
    } else if constexpr (std::is_same<KV, __half>::value) {
      x[i] = __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
    } else if constexpr (std::is_same<KV, int8_t>::value) {
      x[i] = static_cast<float>(static_cast<int8_t>(b));
    } else {
      // e4m3 -> fp16 is exact
      const __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
      x[i] = __half2float(__half(h));
    }
  }
}

// E elements from p: one vector load, or element by element with those at
// or past `n_valid` set to 0
template <typename KV>
__device__ __forceinline__ Frag<KV> load(const KV* p, bool vec, int n_valid) {
  constexpr int W = Pack<KV>::W;
  Frag<KV> f;
  if (vec) {
    if constexpr (W == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      f.w[0] = v.x, f.w[1] = v.y, f.w[2] = v.z, f.w[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      f.w[0] = v.x, f.w[1] = v.y;
    }
  } else {
    constexpr int E = Pack<KV>::E;
    constexpr int per = 4 / sizeof(KV);
#pragma unroll
    for (int k = 0; k < W; ++k) f.w[k] = 0u;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (i < n_valid) {
        uint32_t b;
        if constexpr (sizeof(KV) == 4) {
          b = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
        } else if constexpr (sizeof(KV) == 2) {
          b = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
        } else {
          b = __ldg(reinterpret_cast<const unsigned char*>(p) + i);
        }
        f.w[i / per] |= b << (8 * sizeof(KV) * (i % per));
      }
    }
  }
  return f;
}

// one walk step's K and V fragments (and their tokens' scales) for a lane
template <typename KV>
struct Step {
  Frag<KV> k, v;
  float ks, vs;
};

// (m, l, a) of one part merged with (m2, l2, a2): symmetric in the two
// parts, and a part with l = 0 weighs 0 (its m is still NEG_INF)
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2, float l2,
                                      const float* a2) {
  const float M = fmaxf(m, m2);
  const float w1 = l > 0.f ? expf(__fsub_rn(m, M)) : 0.f;
  const float w2 = l2 > 0.f ? expf(__fsub_rn(m2, M)) : 0.f;
  l = __fadd_rn(__fmul_rn(l, w1), __fmul_rn(l2, w2));
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = __fadd_rn(__fmul_rn(a[e], w1), __fmul_rn(a2[e], w2));
  m = M;
}

// T: type of q and out.  KV: type of the pools; when it differs from T the
// pools are quantized and k_scale / v_scale [P, bs, N] are read.  S: the
// query bucket (1, 4 or 8); nq <= S queries are live.  lg = log2(G) >= 3.
template <typename T, typename KV, int S>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ pool_k,
                       const KV* __restrict__ pool_v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, const int* __restrict__ positions,
                       T* __restrict__ out, int nq, int N, int D, int bs, int M, float scale,
                       int lg, bool vec) {
  static_assert(S == 1 || S == 4 || S == 8, "query buckets are 1, 4 and 8");
  constexpr bool kQuantized = !std::is_same<T, KV>::value;
  constexpr int E = Pack<KV>::E;
  constexpr int LS = S == 1 ? 0 : S == 4 ? 2 : 3;  // log2(S)
  __shared__ float a_s[kWarps][S][kMaxD];
  __shared__ float m_s[kWarps][S], l_s[kWarps][S];

  const int b = blockIdx.x / N;
  const int n = blockIdx.x % N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = 1 << lg;
  const int tpw = 32 >> lg;             // token slots a warp
  const int slot = lane >> lg;
  const int base = slot << lg;          // the slot's first lane
  const int e0 = (lane - base) * E;     // this lane's first element of a row
  const int n_valid = min(E, D - e0);   // <= 0: the lane holds no element
  const int cap = M * bs;               // never read past the table
  // the reduce-scatter below leaves query qm's score on this lane; query s
  // is held by lane base + (s << sh) (and its neighbours up to the next)
  const int sh = lg - LS;
  const int qm = ((lane - base) >> sh) & (S - 1);

  // each query sees the pool tokens below its limit (query qm: my_lim); the
  // walk stops at the largest
  int my_lim = 0, limit = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    int v = 0;
    if (s < nq) v = seq_lens != nullptr ? seq_lens[b] : positions[b * nq + s] + 1;
    v = max(0, min(v, cap));
    limit = max(limit, v);
    if (s == qm) my_lim = v;
  }

  // q and the output accumulator of every query for this lane's elements;
  // the running max and sum of query qm of this slot
  float qf[S][E], acc[S][E];
  float m = DST_NEG_INF, l = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[s][e] = 0.f;
      qf[s][e] = (s < nq && e < n_valid)
                     ? dst_to_float(q[(((size_t)b * nq + s) * N + n) * D + e0 + e])
                     : 0.f;
    }
  }

  // this lane's token: t = (i * kWarps + warp) * tpw + slot at step i, in
  // pool block blk at offset off
  const int stride = kWarps * tpw;
  const int sblk = stride / bs, soff = stride % bs;
  int t = warp * tpw + slot;
  int blk = t / bs, off = t % bs;
  const int* table = block_tables + (size_t)b * M;
  const bool loads = n_valid > 0;

  auto advance = [&]() {
    t += stride;
    blk += sblk;
    off += soff;
    if (off >= bs) off -= bs, ++blk;
  };
  auto fetch = [&](int pb) {
    Step<KV> st;
#pragma unroll
    for (int k = 0; k < Pack<KV>::W; ++k) st.k.w[k] = st.v.w[k] = 0u;
    st.ks = st.vs = 0.f;
    if (t < limit && loads) {
      const size_t row = ((size_t)pb * bs + off) * N + n;
      st.k = load(pool_k + row * D + e0, vec, n_valid);
      st.v = load(pool_v + row * D + e0, vec, n_valid);
      if constexpr (kQuantized) {
        st.ks = __ldg(k_scale + row);
        st.vs = __ldg(v_scale + row);
      }
    }
    return st;
  };

  // kDepth steps of loads in flight: the ring's slot u is decoded, refilled
  // with the step kDepth ahead, then computed; the table entry of the next
  // step to fetch is read one fetch ahead
  Step<KV> ring[kDepth<S>];
  int pb = t < limit ? __ldg(table + blk) : 0;
#pragma unroll
  for (int u = 0; u < kDepth<S>; ++u) {
    ring[u] = fetch(pb);
    advance();
    pb = t < limit ? __ldg(table + blk) : 0;
  }
  for (int tb = warp * tpw; tb < limit; tb += kDepth<S> * stride) {
#pragma unroll
    for (int u = 0; u < kDepth<S>; ++u) {
      const int tbu = tb + u * stride;
      if (tbu >= limit) break;
      float kx[E], vx[E];
      decode(ring[u].k, kx);
      decode(ring[u].v, vx);
      if constexpr (kQuantized) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kx[e] = __fmul_rn(kx[e], ring[u].ks);
          vx[e] = __fmul_rn(vx[e], ring[u].vs);
        }
      }
      ring[u] = fetch(pb);
      advance();
      pb = t < limit ? __ldg(table + blk) : 0;

      // the S partial dots of this lane's elements, their reduce over the
      // slot, the softmax of query qm, and every query's a
      const int tc = tbu + slot;
      float sc[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        sc[s] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) sc[s] = __fmaf_rn(qf[s][e], kx[e], sc[s]);
      }
      // reduce over the slot's G lanes by xor-shuffles at offsets G/2 .. 1:
      // the first LS steps also halve the queries a lane keeps (the upper
      // half where the offset's lane bit is set), the rest only add.  Every
      // query's sum has the same tree whatever S is.
      int o = G >> 1;
#pragma unroll
      for (int k = 0; k < LS; ++k, o >>= 1) {
        const bool upper = (lane & o) != 0;
        const int h = S >> (k + 1);
#pragma unroll
        for (int i = 0; i < h; ++i) {
          const float keep = upper ? sc[i + h] : sc[i];
          const float send = upper ? sc[i] : sc[i + h];
          sc[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
        }
      }
#pragma unroll
      for (int k = LS; k < 5; ++k, o >>= 1)
        if (o > 0) sc[0] = __fadd_rn(sc[0], __shfl_xor_sync(kFull, sc[0], o));

      // online softmax of query qm with one exp: the larger of (m, score) is
      // the new max, the other is weighed by exp(smaller - larger).  A masked
      // token has p = 0 and alpha = 1, which leave l and a as they were (a
      // loaded token is a written one, so p * v is an exact 0).
      const bool live = tc < my_lim;
      const float x = __fmul_rn(sc[0], scale);
      const float ex = expf(__fsub_rn(fminf(m, x), fmaxf(m, x)));
      const bool grew = live && x > m;
      const float alpha = grew ? ex : 1.f;
      const float p = live ? (grew ? 1.f : ex) : 0.f;
      l = __fmaf_rn(l, alpha, p);
      m = grew ? x : m;
      // every lane takes each query's alpha and p from the lane holding it;
      // the max does not grow at every step, so rescale only where it did
      // (a * 1 is exact, so skipping it changes nothing)
      if (__any_sync(kFull, grew)) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float as = S == 1 ? alpha : __shfl_sync(kFull, alpha, base + (s << sh));
#pragma unroll
          for (int e = 0; e < E; ++e) acc[s][e] = __fmul_rn(acc[s][e], as);
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float ps = S == 1 ? p : __shfl_sync(kFull, p, base + (s << sh));
#pragma unroll
        for (int e = 0; e < E; ++e) acc[s][e] = __fmaf_rn(ps, vx[e], acc[s][e]);
      }
    }
  }

  // every query's (m, l) to every lane of the slot, then merge the warp's
  // token slots (lanes of one element range, xor G..16)
  float mq[S], lq[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    mq[s] = S == 1 ? m : __shfl_sync(kFull, m, base + (s << sh));
    lq[s] = S == 1 ? l : __shfl_sync(kFull, l, base + (s << sh));
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      if (o < G) continue;
      float a2[E];
#pragma unroll
      for (int e = 0; e < E; ++e) a2[e] = __shfl_xor_sync(kFull, acc[s][e], o);
      const float m2 = __shfl_xor_sync(kFull, mq[s], o);
      const float l2 = __shfl_xor_sync(kFull, lq[s], o);
      merge<E>(mq[s], lq[s], acc[s], m2, l2, a2);
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (lane == 0) m_s[warp][s] = mq[s], l_s[warp][s] = lq[s];
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < n_valid) a_s[warp][s][e0 + e] = acc[s][e];
    }
  }
  __syncthreads();

  // merge the warps in order and write out
  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int s = idx / D, d = idx % D;
    float mm = m_s[0][s], ll = l_s[0][s], aa = a_s[0][s][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge<1>(mm, ll, &aa, m_s[w][s], l_s[w][s], &a_s[w][s][d]);
    out[(((size_t)b * nq + s) * N + n) * D + d] =
        dst_from_float<T>(ll > 0.f ? __fdiv_rn(aa, ll) : 0.f);
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

template <typename T, typename KV, int S>
cudaError_t launch(const Args& a) {
  constexpr int E = Pack<KV>::E;
  constexpr uintptr_t kAlign = Pack<KV>::kBytes;
  // G = 2^lg lanes a token: enough for D, and at least 8 so that a token's
  // lanes can share out the softmax of up to 8 queries (the same G in
  // every bucket, so every bucket sums alike)
  int lg = 3;
  while ((E << lg) < a.D) ++lg;
  const bool vec = a.D % E == 0 && reinterpret_cast<uintptr_t>(a.pool_k) % kAlign == 0 &&
                   reinterpret_cast<uintptr_t>(a.pool_v) % kAlign == 0;
  paged_attention_kernel<T, KV, S><<<a.B * a.N, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.pool_k),
      static_cast<const KV*>(a.pool_v), a.k_scale, a.v_scale, a.block_tables, a.seq_lens,
      a.positions, static_cast<T*>(a.out), a.S, a.N, a.D, a.bs, a.M, a.scale, lg, vec);
  return cudaGetLastError();
}

// the query bucket: 1, 2-4 as 4, 5-8 as 8
template <typename T, typename KV>
cudaError_t launch_bucket(const Args& a) {
  if (a.S == 1) return launch<T, KV, 1>(a);
  if (a.S <= 4) return launch<T, KV, 4>(a);
  return launch<T, KV, 8>(a);
}

template <typename T>
int dispatch_pool(const Args& a, int pool) {
  switch (pool) {
    case DST_POOL_FP:
      return launch_bucket<T, T>(a);
    case DST_POOL_INT8:
      return launch_bucket<T, int8_t>(a);
    case DST_POOL_FP8_E4M3:
      return launch_bucket<T, __nv_fp8_e4m3>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Args& a, int dtype, int pool) {
  if (a.S < 1 || a.S > kMaxS || a.D < 1 || a.D > kMaxD || a.bs < 1)
    return (int)cudaErrorInvalidValue;
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
