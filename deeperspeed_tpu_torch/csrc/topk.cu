// K4: sorted top-k over logit rows.
//
// Replaces the TPU kernel deeperspeed_tpu/ops/sampling/topk.py `_topk_kernel`
// (launched by `sorted_topk`).
//
// What it computes, bit for bit the plain version's (ops/sampling/topk.py
// `_topk_reference`): x [rows, V] fp32 -> the k largest values of each row
// in descending order and their int32 indices.  Ties go to the lowest index
// (lax.top_k's contract); -0.0 == +0.0, so a tie between them goes to the
// lower index too; a slot is taken once, also among -inf or <= -1e30 values
// (the TPU kernel's -1e30 overwrite would take it again); and a row that
// holds a NaN anywhere gives NaN and index V in all k outputs (what the TPU
// kernel's NaN-propagating max gives).
//
// Bound on the H100: bytes.  The row is read from device memory once (V * 4
// bytes) and k values and k indices are written: 0.0039 ms for 64 rows of
// the GPT-NeoX vocabulary.  k rounds of block-wide arg-max (the round
// kernel below) take 55x that at k 50; this design spends a few passes over
// the row, not k.
//
// Design: a radix select, then a small sort.  One CTA of 1024 threads a row;
// the row streams from device memory, then L2, through 16-byte loads (an
// element path where V or x is not 16-byte aligned), two tiles in flight a
// thread.  Nothing holds the row in shared memory, so V has no limit.
//
// * Keys.  Each value maps to a 32-bit key whose unsigned order is the
//   value's order: -0.0 becomes +0.0, then the sign flips a positive value's
//   top bit and a negative value's every bit.
// * Pass 1 takes each thread's largest key and the row's NaN flag.  For
//   k <= 1024 the k-th largest of those 1024 tops, T (a radix select over
//   two digits of 11 bits, in shared memory), bounds the answer: k tops are
//   keys of distinct slots, so at least k keys are >= T, and on logits
//   barely more (51 at k 50 of 50,304 `randn` values).
// * Gather.  Pass 2 appends every key >= T to a shared buffer as
//   (key << 32 | ~index): a warp skips a tile none of whose keys reaches T,
//   else ballots and one atomic a warp; the order of appends does not
//   matter, the sort fixes it.
// * Sort.  A bitonic sort of the candidates, descending on (key, -index):
//   up to 128 of them in one warp's registers (shuffles, no barrier), more
//   in shared memory; the first k are written, the values reloaded from x
//   (so a -0.0 stays -0.0) with their indices.
// * Where more than K_MAX keys reach T (ties, or -inf past fewer than k
//   values) or k > 1024: the radix select over the row itself.  One pass
//   histograms the keys' top 11 bits into 2048 shared bins (one shared
//   atomic a value: that measured faster than aggregating a warp's lanes by
//   bin with `__match_any_sync`), a block scan from the top bin finds the
//   one holding the k-th largest key, and passes over the next 11 and the
//   last 10 bits refine it, counting only the keys with the chosen prefix,
//   until the keys at or above the prefix fit K_MAX.  The gather and the
//   sort follow; where even a whole 32-bit key's ties overflow the buffer,
//   the gather takes the keys above it and the lowest-index ties, by a block
//   scan a tile in index order.
// * Every count is exact and the sort's keys are unique, so two launches
//   give the same bits.
//
// k > K_MAX takes the port's first kernel, kept below (`topk_rounds_kernel`):
// k rounds of block-wide arg-max over the row in dynamic shared memory,
// which limits V to about 56K there.
#include <climits>
#include <cmath>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 1024;     // radix path: threads of the CTA per row
constexpr int BINS = 2048;         // 11-bit digits; two bins a thread in the scan
constexpr int K_MAX = 2048;        // candidates the radix path sorts (16 KB)
constexpr int LOAD_AHEAD = 2;      // 16-byte loads a thread keeps in flight
constexpr unsigned FULL = 0xffffffffu;

static_assert(BINS == 2 * kThreads, "select_bin gives each thread two bins");

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;                    // -0.0 == +0.0
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

// The row's values, VEC (4 or 1) at a time: thread t of a tile of kThreads *
// VEC values holds the VEC consecutive values at t * VEC.  A thread loads
// the vectors of LOAD_AHEAD tiles before it hands the first to `fn(index of
// the first value, values, number valid)`, tile by tile in index order.
// The trip count is the same for every thread, so `fn` may use warp-wide
// intrinsics and barriers.
template <typename F>
__device__ __forceinline__ void for_each_tile(const float* __restrict__ xr, int V, int vec,
                                              F fn) {
  const int step = vec ? 4 : 1, tile = kThreads * step;
  for (int base = 0; base < V; base += LOAD_AHEAD * tile) {
    float v[LOAD_AHEAD][4];
    int n[LOAD_AHEAD];
#pragma unroll
    for (int u = 0; u < LOAD_AHEAD; ++u) {
      const int i0 = base + u * tile + threadIdx.x * step;
      n[u] = 0;
      if (vec) {
        if (i0 < V) {
          const float4 f = *reinterpret_cast<const float4*>(xr + i0);
          v[u][0] = f.x; v[u][1] = f.y; v[u][2] = f.z; v[u][3] = f.w;
          n[u] = 4;
        }
      } else if (i0 < V) {
        v[u][0] = xr[i0];
        n[u] = 1;
      }
    }
#pragma unroll
    for (int u = 0; u < LOAD_AHEAD; ++u) fn(base + u * tile + threadIdx.x * step, v[u], n[u]);
  }
}

// Every thread's exclusive prefix sum of `v` over the CTA in thread order,
// and the CTA's total.  `wsum` holds one value a warp; ends with a barrier
// after the writes, so the caller must pass a barrier before the next call.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* wsum, uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  uint32_t before = 0, all = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    const uint32_t s = wsum[w];
    if (w < warp) before += s;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// The bin of the need-th largest key counted in `hist`, from the top: the
// keys in higher bins (`above`, fewer than need) and in the bin (`count`).
// Thread t holds bins BINS-1-2t and BINS-2-2t.
struct Pick {
  uint32_t bin, above, count;
};

__device__ __forceinline__ void select_bin(const uint32_t* hist, uint32_t need, uint32_t* wsum,
                                           Pick* pick) {
  const int b0 = BINS - 1 - 2 * (int)threadIdx.x, b1 = b0 - 1;
  const uint32_t h0 = hist[b0], h1 = hist[b1];
  uint32_t total;
  const uint32_t excl = block_scan(h0 + h1, wsum, &total);
  if (excl < need && excl + h0 >= need) *pick = {(uint32_t)b0, excl, h0};
  else if (excl + h0 < need && excl + h0 + h1 >= need) *pick = {(uint32_t)b1, excl + h0, h1};
  __syncthreads();
}

// Where a radix select stands: the top `known` bits of the need-th largest
// key are `prefix`, `above` keys have a larger prefix, and `fits` says that
// those and the keys with the prefix fit the candidate buffer.
struct Select {
  uint32_t prefix = 0, above = 0, need;
  int known = 0;
  bool fits = false;
};

// Radix select of the k-th largest key over up to `levels` of the digits
// 11 + 11 + 10 bits; with `stop_when_fits`, stops at the first digit whose
// candidates fit K_MAX.  `count(known, prefix, shift, bits)` adds every key
// whose top `known` bits are `prefix` to hist[(key >> shift) & (2^bits - 1)].
template <typename Count>
__device__ __forceinline__ Select radix_select(uint32_t* hist, uint32_t* wsum, Pick* pick,
                                               int k, int levels, bool stop_when_fits,
                                               Count count) {
  Select s;
  s.need = (uint32_t)k;
  for (int level = 0; level < levels && !(stop_when_fits && s.fits); ++level) {
    const int bits = level == 2 ? 10 : 11;
    for (int b = threadIdx.x; b < BINS; b += kThreads) hist[b] = 0;
    __syncthreads();
    count(s.known, s.prefix, 32 - s.known - bits, bits);
    __syncthreads();
    select_bin(hist, s.need, wsum, pick);
    const Pick p = *pick;
    s.prefix = (s.prefix << bits) | p.bin;
    s.known += bits;
    s.above += p.above;
    s.need -= p.above;
    s.fits = s.above + p.count <= (uint32_t)K_MAX;
  }
  return s;
}

__device__ __forceinline__ bool has_prefix(uint32_t key, int known, uint32_t prefix) {
  return known == 0 || (key >> (32 - known)) == prefix;
}

__device__ __forceinline__ unsigned long long packed(uint32_t key, int i) {
  return (unsigned long long)key << 32 | (0xffffffffu - (uint32_t)i);
}

// Appends to `cand` the row's keys >= lo or, with `ties`, the keys > lo and
// the first `need` keys == lo in index order (a block scan a tile), as
// packed(key, index); returns how many there were (the buffer keeps the
// first K_MAX).  Warp ballots and one atomic a warp: the order of appends
// is not the index order, and need not be.
__device__ __forceinline__ uint32_t gather(const float* __restrict__ xr, int V, int vec,
                                           uint32_t lo, bool ties, uint32_t need,
                                           unsigned long long* cand, uint32_t* ncand,
                                           uint32_t* wsum) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *ncand = 0;
  __syncthreads();
  uint32_t tie_taken = 0;
  for_each_tile(xr, V, vec, [&](int i0, const float* v, int n) {
    if (!ties) {                             // most tiles hold no candidate: skip them
      uint32_t most = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < n) most = max(most, order_key(v[c]));
      if (!__any_sync(FULL, most >= lo)) return;
    }
    int tied = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = c < n;
      const uint32_t key = order_key(in ? v[c] : 0.f);
      const bool take = in && (ties ? key > lo : key >= lo);
      tied += in && ties && key == lo;
      const unsigned ball = __ballot_sync(FULL, take);
      if (ball) {
        uint32_t base = 0;
        if (lane == __ffs(ball) - 1) base = atomicAdd(ncand, __popc(ball));
        const uint32_t slot = __shfl_sync(FULL, base, __ffs(ball) - 1) +
                              __popc(ball & ((1u << lane) - 1));
        if (take && slot < K_MAX) cand[slot] = packed(key, i0 + c);
      }
      if (!vec) break;
    }
    if (ties && tie_taken < need && __syncthreads_or(tied)) {
      uint32_t total;
      uint32_t r = tie_taken + block_scan(tied, wsum, &total);
#pragma unroll
      for (int c = 0; c < 4; ++c) {          // unrolled: v stays in registers
        if (c >= n) break;
        if (order_key(v[c]) != lo) continue;
        if (r++ < need) cand[atomicAdd(ncand, 1u)] = packed(lo, i0 + c);
      }
      tie_taken += total;
    }
  });
  __syncthreads();
  return *ncand;
}

// Writes output e of the sorted candidates: the index, and the value
// reloaded from the row, so a -0.0 stays -0.0.
__device__ __forceinline__ void write_out(unsigned long long c, int e,
                                          const float* __restrict__ xr,
                                          float* __restrict__ vr, int* __restrict__ ir) {
  const int j = (int)(0xffffffffu - (uint32_t)c);
  vr[e] = xr[j];
  ir[e] = j;
}

// One warp sorts 32 * E candidates (n of them, zeros after) in registers,
// descending, by a bitonic network: element e = lane + 32 j is v[j] of
// `lane`, so strides below 32 cross lanes by shuffles and the larger ones
// stay in a lane; then writes the first k.  No barrier, no shared memory
// traffic after the load.
template <int E>
__device__ __forceinline__ void warp_sort_write(const unsigned long long* cand, int n, int k,
                                                const float* __restrict__ xr,
                                                float* __restrict__ vr, int* __restrict__ ir) {
  const int lane = threadIdx.x & 31;
  unsigned long long v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = lane + 32 * j < n ? cand[lane + 32 * j] : 0ull;
  for (int size = 2; size <= 32 * E; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < 32) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const unsigned long long o = __shfl_xor_sync(FULL, v[j], stride);
          const bool desc = ((lane + 32 * j) & size) == 0, lower = (lane & stride) == 0;
          v[j] = lower == desc ? (v[j] > o ? v[j] : o) : (v[j] < o ? v[j] : o);
        }
      } else {
#pragma unroll
        for (int q = 1; q < E; q <<= 1) {
          if (q != stride >> 5) continue;
#pragma unroll
          for (int j = 0; j < E; ++j) {
            if (j & q) continue;             // v[j] pairs with v[j | q]
            const bool desc = ((lane + 32 * j) & size) == 0;
            const unsigned long long a = v[j], b = v[j | q];
            if ((a < b) == desc) { v[j] = b; v[j | q] = a; }
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (lane + 32 * j < k) write_out(v[j], lane + 32 * j, xr, vr, ir);
}

// Sorts the n candidates descending and writes the first k.  Up to 128
// candidates warp 0 sorts them in registers (four keys a lane: eight
// spilled under the 64 registers a thread of 1024 has); more, the CTA
// sorts them in shared memory (bitonic, a barrier a step).
__device__ __forceinline__ void sort_and_write(unsigned long long* cand, int n, int k,
                                               const float* __restrict__ xr,
                                               float* __restrict__ vr, int* __restrict__ ir) {
  int N = 1;
  while (N < n) N <<= 1;
  if (N <= 32 * 4) {
    if (threadIdx.x >= 32) return;
    if (N <= 32) warp_sort_write<1>(cand, n, k, xr, vr, ir);
    else if (N <= 64) warp_sort_write<2>(cand, n, k, xr, vr, ir);
    else warp_sort_write<4>(cand, n, k, xr, vr, ir);
    return;
  }
  const int tid = threadIdx.x;
  for (int i = n + tid; i < N; i += kThreads) cand[i] = 0ull;   // below every real key
  __syncthreads();
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < N / 2; t += kThreads) {
        const int i = 2 * stride * (t / stride) + (t % stride), j = i + stride;
        const unsigned long long a = cand[i], b = cand[j];
        if ((a < b) == ((i & size) == 0)) { cand[i] = b; cand[j] = a; }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kThreads) write_out(cand[i], i, xr, vr, ir);
}

// The kernel's phases; a STOP below ALL ends it after that phase (for
// tools/torch_topk_phases.py, which times the cut kernels; the launcher runs
// ALL).  What a cut kernel writes is meaningless.
enum { LAUNCHED, TOPS, SELECTED, GATHERED, ALL };

template <int STOP>
__global__ void __launch_bounds__(kThreads)
topk_radix_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx,
                  int V, int k, int vec) {
  __shared__ uint32_t hist[BINS];
  __shared__ unsigned long long cand[K_MAX];
  __shared__ uint32_t wsum[kThreads / 32];
  __shared__ Pick pick;
  __shared__ uint32_t ncand;
  const float* __restrict__ xr = x + (size_t)blockIdx.x * V;
  float* __restrict__ vr = vals + (size_t)blockIdx.x * k;
  int* __restrict__ ir = idx + (size_t)blockIdx.x * k;
  if (STOP == LAUNCHED) return;

  // ---- pass 1: each thread's largest key, and the row's NaN flag
  uint32_t top = 0;                         // below every real key
  bool nan = false;
  for_each_tile(xr, V, vec, [&](int, const float* v, int n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < n) {
        nan |= isnan(v[c]);
        top = max(top, order_key(v[c]));
      }
    }
  });
  if (__syncthreads_or(nan)) {
    for (int i = threadIdx.x; i < k; i += kThreads) { vr[i] = NAN; ir[i] = V; }
    return;
  }
  if (STOP == TOPS) {
    if (top == 0) ir[0] = 0;
    return;
  }

  // ---- T, the k-th largest of the threads' tops to 22 bits: k of the tops
  // are keys of the row, so at least k keys are >= T.  On logits few more
  // are, and pass 2 gathers them all.
  if (k <= kThreads) {
    const Select t = radix_select(hist, wsum, &pick, k, 2, false,
                                  [&](int known, uint32_t prefix, int shift, int bits) {
      if (has_prefix(top, known, prefix)) atomicAdd(&hist[(top >> shift) & ((1u << bits) - 1)], 1u);
    });
    if (STOP == SELECTED) {
      if (t.prefix == 0) ir[0] = 0;
      return;
    }
    const uint32_t n = gather(xr, V, vec, t.prefix << (32 - t.known), false, 0, cand, &ncand,
                              wsum);
    if (STOP == GATHERED) {
      if (n == 0) ir[0] = 0;
      return;
    }
    if (n <= (uint32_t)K_MAX) {
      sort_and_write(cand, (int)n, k, xr, vr, ir);
      return;
    }
  }

  // ---- otherwise (k > kThreads, or ties or -inf crowd the row): the radix
  // select over the row itself, one histogram pass a digit until the
  // candidates fit; ties in index order only where a 32-bit prefix still
  // overflows the buffer
  const Select s = radix_select(hist, wsum, &pick, k, 3, true,
                                [&](int known, uint32_t prefix, int shift, int bits) {
    for_each_tile(xr, V, vec, [&](int, const float* v, int n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= n) break;
        const uint32_t key = order_key(v[c]);
        if (has_prefix(key, known, prefix))
          atomicAdd(&hist[(key >> shift) & ((1u << bits) - 1)], 1u);
      }
    });
  });
  const uint32_t n = gather(xr, V, vec, s.prefix << (32 - s.known), !s.fits, s.need, cand, &ncand,
                            wsum);
  sort_and_write(cand, (int)n, k, xr, vr, ir);
}

template <int STOP>
int launch_radix(const float* x, float* vals, int* idx, int rows, int V, int k,
                 cudaStream_t stream) {
  const int vec = V % 4 == 0 && aligned16(x);
  topk_radix_kernel<STOP><<<rows, kThreads, 0, stream>>>(x, vals, idx, V, k, vec);
  return (int)cudaGetLastError();
}

// ---- k > K_MAX: the port's first design, k rounds of arg-max

constexpr int ROUND_THREADS = 1024;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// One CTA per row.  The row is loaded once into dynamic shared memory beside
// one bit per slot marking the slots already taken; each of the k rounds is
// a block-wide arg-max over the untaken slots, ties to the lowest index.
__global__ void __launch_bounds__(ROUND_THREADS)
topk_rounds_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx,
                   int V, int k) {
  extern __shared__ float row[];
  unsigned* taken = reinterpret_cast<unsigned*>(row + V);
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = (V + 31) / 32;
  const float* xr = x + (size_t)blockIdx.x * V;
  bool nan = false;
  for (int i = tid; i < V; i += ROUND_THREADS) {
    row[i] = xr[i];
    nan |= isnan(row[i]);
  }
  for (int w = tid; w < words; w += ROUND_THREADS) taken[w] = 0u;
  if (__syncthreads_or(nan)) {
    for (int i = tid; i < k; i += ROUND_THREADS) {
      vals[(size_t)blockIdx.x * k + i] = NAN;
      idx[(size_t)blockIdx.x * k + i] = V;
    }
    return;
  }

  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < V; i += ROUND_THREADS) {
      if ((taken[i >> 5] >> (i & 31)) & 1u) continue;
      const float v = row[i];
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
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

// x [rows, V] fp32 -> vals [rows, k] fp32, idx [rows, k] int32
extern "C" int dst_sorted_topk(const float* x, float* vals, int* idx, int rows, int V, int k,
                               cudaStream_t stream) {
  if (k < 1 || k > V) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (k <= K_MAX) return launch_radix<ALL>(x, vals, idx, rows, V, k, stream);
  // the row and its taken bits in shared memory: a row too long fails here
  const size_t smem = (size_t)V * sizeof(float) + (size_t)((V + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(topk_rounds_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_rounds_kernel<<<rows, ROUND_THREADS, smem, stream>>>(x, vals, idx, V, k);
  return (int)cudaGetLastError();
}
