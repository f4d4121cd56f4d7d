// B10: block-sparse flash attention -- forward, dq pass and dk/dv pass.
//
// Replaces the TPU kernels of
// deeperspeed_tpu/ops/sparse_attention/sparse_attention.py:
//   `_sp_fwd_kernel` (launched by `_sparse_fwd`),
//   `_sp_dq_kernel`  (`_sparse_bwd`, first pass),
//   `_sp_dkv_kernel` (`_sparse_bwd`, second pass).
// They are flash attention (ops/attention/pallas_flash.py) under a block
// layout: an int32 [LH, nb, nb] table (LH 1, broadcast over heads, or N;
// the head of folded row bh is bh % N) of which (query block, key block)
// pairs attend.  A zero entry skips its tiles in all three passes, so the
// work scales with the layout's density, not with S^2.
//
// Numerics, as the TPU kernels: scores are q.k^T in fp32, times `scale`
// (not a pre-scaled q); P is rounded to v's type before P.V and P^T.dO;
// dS = P (dP - delta) scale is rounded to q's type before dS.K and dS^T.Q;
// dq, dk and dv are summed in fp32 and rounded once.  Within a live tile,
// causality masks col > row.  Masked entries get P = 0 explicitly, so a
// query row with no live key writes zeros (O, dq, and its share of dk and
// dv), as the TPU kernel's docstring promises (that kernel itself takes
// exp(NEG_INF - NEG_INF) = 1 while its running max is still NEG_INF); its
// LSE is written as NEG_INF.
//
// Bound on the H100: operations on the live tiles (2 S_live D per product).
//
// Three implementations:
//
// * bf16 with blocks a multiple of 64 (every shipped config: block 64 or
//   128): the Hopper kernels of namespace `hopper` below, `sparse_fwd_kernel`,
//   `sparse_dq_kernel` and `sparse_dkv_kernel`, on TMA and `wgmma`
//   (hopper.cuh, the building blocks of flash K5-K7).  A CTA is one
//   warpgroup and owns a 64-row tile; it first compacts its layout row
//   (forward, dq) or column (dk/dv) into a list of live blocks in shared
//   memory (warp 0, a ballot and `__popc` over 32 entries at a time),
//   expands each into its block / 64 tiles, drops under causality the tiles
//   above the diagonal, and walks only that list: the tile after next is
//   loaded by TMA into a two-stage ring while this one is computed, across
//   gaps in the layout too.  Only a causal diagonal tile runs a masked body:
//   S is a multiple of the block, so no tile is ragged.  A walk of length
//   0 stores zeros (a key block no query attends to, a query block with
//   no live key; the forward's LSE there is NEG_INF).  Bound: operations,
//   2 (forward), 3 (dq) and 4 (dk/dv) products of 64 x 64 x D a live tile
//   pair.  What holds them back: one warpgroup runs its products and its
//   exps in turn (flash K5-K7's limit), other CTAs of the SM fill the gaps;
//   under Fixed the global key columns walk up to 5x the mean, a tail at
//   the end of the dk/dv grid.
// * bf16 with blocks of 16, 32 or 48 (mod 64): `mma.sync.m16n8k16` bf16 ->
//   fp32 on T = 32 or 16-row tiles (the larger that divides the block);
//   T / 16 warps, warp w owning rows 16 w .. 16 w + 15; scores, P and dS in
//   registers; operand tiles loaded synchronously into shared memory as
//   bf16 with pitch D + 8.  Every CTA steps over all S / T tiles of its row
//   or column and reads the layout entry of each.
// * fp32 on CUDA cores (256 threads as 16 x 16; thread (ty, tx) owns rows
//   R ty .. R ty + R - 1 and columns tx + 16 j of a T x T score tile,
//   R = T / 16; operand tiles in shared memory as fp32 with pitch D + 1).
//
// The bf16 kernels take D = 16, 32, 64 or 128 (the wrapper zero-pads D up
// to one of them; the scale is passed in, so padding changes no score)
// and 16-byte aligned operands (TMA's alignment too).
//
// Layout of q, k, v, o, dO, dq, dk, dv: contiguous [B, S, N, D]; a head's
// rows have stride N D.  LSE and delta: fp32 [B N, S].  Grid: (B N, S / T).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

__device__ __forceinline__ size_t row_off(int b, int s, int n, int S, int N, int D) {
  return (((size_t)b * S + s) * N + n) * D;
}

// The layout row (query block qb) or column (key block kb) of head n.
__device__ __forceinline__ const int* layout_of(const int* layout, int n, int LH, int nb) {
  return layout + (size_t)(LH == 1 ? 0 : n) * nb * nb;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* layout;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, S, N, D, LH, block, causal;
  float scale;
};

// ---------------------------------------------------------------- fp32
namespace f32 {

constexpr int THREADS = 256;  // 16 x 16

// T rows from row0 of head (b, n) into shared memory (pitch D + 1).
template <int T>
__device__ void load_tile(float* dst, const float* __restrict__ src, int b, int n, int row0,
                          int S, int N, int D) {
  const int pitch = D + 1;
  for (int idx = threadIdx.x; idx < T * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * pitch + d] = src[row_off(b, row0 + r, n, S, N, D) + d];
  }
}

// acc[i][j] = A[R ty + i, :] . Bm[tx + 16 j, :] over D columns.
template <int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R], const float* A, const float* Bm,
                                         int D, int ty, int tx) {
  const int pitch = D + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  const float* a0 = A + (R * ty) * pitch;
  const float* b0 = Bm + tx * pitch;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = a0[i * pitch + d];
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = b0[16 * j * pitch + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// acc[i][jj] += sum_r W[R ty + i, r] * M[r, tx + 16 jj], r < T (W pitch T + 1).
template <int T, int NJ>
__device__ __forceinline__ void tile_accum(float (&acc)[T / 16][NJ], const float* W,
                                           const float* M, int D, int ty, int tx) {
  constexpr int R = T / 16;
  const int pitch = D + 1;
  for (int r = 0; r < T; ++r) {
    float w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = W[(R * ty + i) * (T + 1) + r];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) {
        const float m = M[r * pitch + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][jj] = fmaf(w[i], m, acc[i][jj]);
      }
    }
  }
}

template <int T, int NJ>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Args a) {
  constexpr int R = T / 16;
  extern __shared__ float smem[];
  const int D = a.D, S = a.S, N = a.N, pitch = D + 1;
  float* Qs = smem;
  float* Ks = Qs + T * pitch;
  float* Vs = Ks + T * pitch;
  float* Ps = Vs + T * pitch;
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int q0 = blockIdx.y * T;
  const int nb = S / a.block;
  const int* lay = layout_of(a.layout, n, a.LH, nb) + (q0 / a.block) * nb;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  load_tile<T>(Qs, q, b, n, q0, S, N, D);
  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = DST_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += T) {
    if (a.causal && k0 > q0 + T - 1) break;  // this tile and all later ones masked
    if (lay[k0 / a.block] == 0) continue;
    __syncthreads();
    load_tile<T>(Ks, k, b, n, k0, S, N, D);
    load_tile<T>(Vs, v, b, n, k0, S, N, D);
    __syncthreads();
    float s[R][R];
    tile_dot<R>(s, Qs, Ks, D, ty, tx);
    const bool diag = a.causal && k0 + T - 1 > q0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + R * ty + i;
      float mx = DST_NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] *= a.scale;
        if (diag && k0 + tx + 16 * j > row) s[i][j] = DST_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool live = !(diag && k0 + tx + 16 * j > row);
        const float p = live ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Ps[(R * ty + i) * (T + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    tile_accum<T, NJ>(acc, Ps, Vs, D, ty, tx);
  }
  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + R * ty + i;
    const size_t base = row_off(b, row, n, S, N, D);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) o[base + c] = l[i] > 0.f ? acc[i][jj] / l[i] : 0.f;
    }
    if (tx == 0) a.lse_out[(size_t)bh * S + row] = l[i] > 0.f ? m[i] + logf(l[i]) : DST_NEG_INF;
  }
}

template <int T, int NJ>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args a) {
  constexpr int R = T / 16;
  extern __shared__ float smem[];
  const int D = a.D, S = a.S, N = a.N, pitch = D + 1;
  float* Qs = smem;
  float* dOs = Qs + T * pitch;
  float* Ks = dOs + T * pitch;
  float* Vs = Ks + T * pitch;
  float* dSs = Vs + T * pitch;
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int q0 = blockIdx.y * T;
  const int nb = S / a.block;
  const int* lay = layout_of(a.layout, n, a.LH, nb) + (q0 / a.block) * nb;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  load_tile<T>(Qs, q, b, n, q0, S, N, D);
  load_tile<T>(dOs, dout, b, n, q0, S, N, D);
  float row_lse[R], row_delta[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + R * ty + i;
    row_lse[i] = a.lse[(size_t)bh * S + row];
    row_delta[i] = a.delta[(size_t)bh * S + row];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += T) {
    if (a.causal && k0 > q0 + T - 1) break;
    if (lay[k0 / a.block] == 0) continue;
    __syncthreads();
    load_tile<T>(Ks, k, b, n, k0, S, N, D);
    load_tile<T>(Vs, v, b, n, k0, S, N, D);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<R>(s, Qs, Ks, D, ty, tx);
    tile_dot<R>(dp, dOs, Vs, D, ty, tx);
    const bool diag = a.causal && k0 + T - 1 > q0;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool live = !(diag && k0 + tx + 16 * j > q0 + R * ty + i);
        const float p = live ? expf(s[i][j] * a.scale - row_lse[i]) : 0.f;
        dSs[(R * ty + i) * (T + 1) + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * a.scale;
      }
    __syncthreads();
    tile_accum<T, NJ>(acc, dSs, Ks, D, ty, tx);
  }
  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t base = row_off(b, q0 + R * ty + i, n, S, N, D);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) dq[base + c] = acc[i][jj];
    }
  }
}

template <int T, int NJ>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args a) {
  constexpr int R = T / 16;
  extern __shared__ float smem[];
  const int D = a.D, S = a.S, N = a.N, pitch = D + 1;
  float* Ks = smem;
  float* Vs = Ks + T * pitch;
  float* Qs = Vs + T * pitch;
  float* dOs = Qs + T * pitch;
  float* PTs = dOs + T * pitch;       // P^T tile, [k row][q row]
  float* dSTs = PTs + T * (T + 1);    // dS^T tile
  float* Ls = dSTs + T * (T + 1);     // LSE of the q tile's rows
  float* Ds = Ls + T;                 // delta of the q tile's rows
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int k0 = blockIdx.y * T;
  const int nb = S / a.block;
  const int* lay = layout_of(a.layout, n, a.LH, nb) + k0 / a.block;  // column: stride nb
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  load_tile<T>(Ks, k, b, n, k0, S, N, D);
  load_tile<T>(Vs, v, b, n, k0, S, N, D);
  float dk_acc[R][NJ], dv_acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;
  for (int q0 = 0; q0 < S; q0 += T) {
    if (a.causal && q0 + T - 1 < k0) continue;  // every entry above the diagonal
    if (lay[(size_t)(q0 / a.block) * nb] == 0) continue;
    __syncthreads();
    load_tile<T>(Qs, q, b, n, q0, S, N, D);
    load_tile<T>(dOs, dout, b, n, q0, S, N, D);
    for (int r = threadIdx.x; r < T; r += THREADS) {
      Ls[r] = a.lse[(size_t)bh * S + q0 + r];
      Ds[r] = a.delta[(size_t)bh * S + q0 + r];
    }
    __syncthreads();
    float st[R][R], dpt[R][R];
    tile_dot<R>(st, Ks, Qs, D, ty, tx);   // st[i][j] = k row R ty + i . q row tx + 16 j
    tile_dot<R>(dpt, Vs, dOs, D, ty, tx);
    const bool diag = a.causal && k0 + T - 1 > q0;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qr = tx + 16 * j;
        const bool live = !(diag && k0 + R * ty + i > q0 + qr);
        const float p = live ? expf(st[i][j] * a.scale - Ls[qr]) : 0.f;
        PTs[(R * ty + i) * (T + 1) + qr] = p;
        dSTs[(R * ty + i) * (T + 1) + qr] = p * (dpt[i][j] - Ds[qr]) * a.scale;
      }
    __syncthreads();
    tile_accum<T, NJ>(dv_acc, PTs, dOs, D, ty, tx);
    tile_accum<T, NJ>(dk_acc, dSTs, Qs, D, ty, tx);
  }
  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t base = row_off(b, k0 + R * ty + i, n, S, N, D);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) {
        dk[base + c] = dk_acc[i][jj];
        dv[base + c] = dv_acc[i][jj];
      }
    }
  }
}

template <int T>
size_t smem_bytes(int which, int D) {
  const size_t tile = (size_t)T * (D + 1), ptile = (size_t)T * (T + 1);
  if (which == 0) return (3 * tile + ptile) * sizeof(float);
  if (which == 1) return (4 * tile + ptile) * sizeof(float);
  return (4 * tile + 2 * ptile + 2 * T) * sizeof(float);
}

}  // namespace f32

// ---------------------------------------------------------------- bf16
namespace tc {

typedef __nv_bfloat16 bf16;

// T rows from row0 of head (b, n) into shared memory (pitch D + 8) with
// 16-byte copies.
template <int T, int D>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int n, int row0,
                          int S, int N) {
  constexpr int VECS = D / 8, LD = D + 8, THREADS = 2 * T;
  for (int idx = threadIdx.x; idx < T * VECS; idx += THREADS) {
    const int r = idx / VECS;
    const int c = (idx - r * VECS) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + row_off(b, row0 + r, n, S, N, D) + c);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s[nt] = A[16 rows of this warp] . Bm[8 nt + (0..7)]^T over D columns: a
// 16 x T score block from two [T, D] tiles.
template <int T, int D>
__device__ __forceinline__ void scores(float (&s)[T / 8][4], const bf16* A, const bf16* Bm,
                                       int warp, int g, int t) {
  constexpr int LD = D + 8, NT = T / 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* ap = A + (16 * warp + g) * LD + 16 * ks + 2 * t;
    const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * LD), ld32(ap + 8), ld32(ap + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* bp = Bm + (8 * nt + g) * LD + 16 * ks + 2 * t;
      mma(s[nt], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[dt] += W . M over the tile's T rows: W a 16 x T block in score
// layout (rounded to bf16 here), M a [T, D] tile in shared memory.
template <int T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&w)[T / 8][4],
                                           const bf16* M, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < T / 16; ++j) {
    const uint32_t a[4] = {pack(w[2 * j][0], w[2 * j][1]), pack(w[2 * j][2], w[2 * j][3]),
                           pack(w[2 * j + 1][0], w[2 * j + 1][1]),
                           pack(w[2 * j + 1][2], w[2 * j + 1][3])};
    const bf16* m0 = M + (16 * j + 2 * t) * LD + g;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const bf16* mp = m0 + 8 * dt;
      mma(acc[dt], a, pack(mp[0], mp[LD]), pack(mp[8 * LD], mp[9 * LD]));
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows (row, row + 8) of a 16 x D accumulator block as bf16, scaled.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[D / 8][4],
                                           int b, int n, int row, int S, int N, int t,
                                           float scale0, float scale1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sc = h ? scale1 : scale0;
    bf16* base = out + row_off(b, row + 8 * h, n, S, N, D) + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(base + 8 * dt) =
          pack(acc[dt][2 * h] * sc, acc[dt][2 * h + 1] * sc);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
}

// Is score (row, col) of a tile live?  Only tiles on the diagonal mask.
__device__ __forceinline__ bool live(bool diag, int row, int col) { return !diag || col <= row; }

template <int T, int D>
__global__ void __launch_bounds__(2 * T) fwd_kernel(Args a) {
  constexpr int LD = D + 8, NT = T / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + T * LD;
  bf16* Vs = Ks + T * LD;
  const int S = a.S, N = a.N;
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int q0 = blockIdx.y * T;
  const int nb = S / a.block;
  const int* lay = layout_of(a.layout, n, a.LH, nb) + (q0 / a.block) * nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + 16 * warp + g;  // and row + 8
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  load_tile<T, D>(Qs, q, b, n, q0, S, N);
  float m[2] = {DST_NEG_INF, DST_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero<D>(acc);
  for (int k0 = 0; k0 < S; k0 += T) {
    if (a.causal && k0 > q0 + T - 1) break;
    if (lay[k0 / a.block] == 0) continue;
    __syncthreads();
    load_tile<T, D>(Ks, k, b, n, k0, S, N);
    load_tile<T, D>(Vs, v, b, n, k0, S, N);
    __syncthreads();
    float s[NT][4];
    scores<T, D>(s, Qs, Ks, warp, g, t);
    const bool diag = a.causal && k0 + T - 1 > q0;
    float mx[2] = {DST_NEG_INF, DST_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] *= a.scale;
        if (!live(diag, row + 8 * (i >> 1), k0 + 8 * nt + 2 * t + (i & 1)))
          s[nt][i] = DST_NEG_INF;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = live(diag, row + 8 * (i >> 1), k0 + 8 * nt + 2 * t + (i & 1));
        s[nt][i] = ok ? expf(s[nt][i] - m[i >> 1]) : 0.f;
        psum[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    accumulate<T, D>(acc, s, Vs, g, t);
  }
  store_rows<D>(static_cast<bf16*>(a.o), acc, b, n, row, S, N, t,
                l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      a.lse_out[(size_t)bh * S + row + 8 * h] = l[h] > 0.f ? m[h] + logf(l[h]) : DST_NEG_INF;
  }
}

template <int T, int D>
__global__ void __launch_bounds__(2 * T) dq_kernel(Args a) {
  constexpr int LD = D + 8, NT = T / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + T * LD;
  bf16* Ks = dOs + T * LD;
  bf16* Vs = Ks + T * LD;
  const int S = a.S, N = a.N;
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int q0 = blockIdx.y * T;
  const int nb = S / a.block;
  const int* lay = layout_of(a.layout, n, a.LH, nb) + (q0 / a.block) * nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + 16 * warp + g;
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  load_tile<T, D>(Qs, static_cast<const bf16*>(a.q), b, n, q0, S, N);
  load_tile<T, D>(dOs, static_cast<const bf16*>(a.dout), b, n, q0, S, N);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = a.lse[(size_t)bh * S + row + 8 * h];
    row_delta[h] = a.delta[(size_t)bh * S + row + 8 * h];
  }
  float acc[D / 8][4];
  zero<D>(acc);
  for (int k0 = 0; k0 < S; k0 += T) {
    if (a.causal && k0 > q0 + T - 1) break;
    if (lay[k0 / a.block] == 0) continue;
    __syncthreads();
    load_tile<T, D>(Ks, k, b, n, k0, S, N);
    load_tile<T, D>(Vs, v, b, n, k0, S, N);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    scores<T, D>(s, Qs, Ks, warp, g, t);
    scores<T, D>(dp, dOs, Vs, warp, g, t);
    const bool diag = a.causal && k0 + T - 1 > q0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const bool ok = live(diag, row + 8 * h, k0 + 8 * nt + 2 * t + (i & 1));
        const float p = ok ? expf(s[nt][i] * a.scale - row_lse[h]) : 0.f;
        s[nt][i] = p * (dp[nt][i] - row_delta[h]) * a.scale;  // dS
      }
    accumulate<T, D>(acc, s, Ks, g, t);
  }
  store_rows<D>(static_cast<bf16*>(a.dq), acc, b, n, row, S, N, t, 1.f, 1.f);
}

template <int T, int D>
__global__ void __launch_bounds__(2 * T) dkv_kernel(Args a) {
  constexpr int LD = D + 8, NT = T / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + T * LD;
  bf16* Qs = Vs + T * LD;
  bf16* dOs = Qs + T * LD;
  float* Ls = reinterpret_cast<float*>(dOs + T * LD);  // LSE of the q tile's rows
  float* Ds = Ls + T;                                   // delta of the q tile's rows
  const int S = a.S, N = a.N;
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int k0 = blockIdx.y * T;
  const int nb = S / a.block;
  const int* lay = layout_of(a.layout, n, a.LH, nb) + k0 / a.block;  // column: stride nb
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int krow = k0 + 16 * warp + g;  // and krow + 8
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  load_tile<T, D>(Ks, static_cast<const bf16*>(a.k), b, n, k0, S, N);
  load_tile<T, D>(Vs, static_cast<const bf16*>(a.v), b, n, k0, S, N);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  for (int q0 = 0; q0 < S; q0 += T) {
    if (a.causal && q0 + T - 1 < k0) continue;
    if (lay[(size_t)(q0 / a.block) * nb] == 0) continue;
    __syncthreads();
    load_tile<T, D>(Qs, q, b, n, q0, S, N);
    load_tile<T, D>(dOs, dout, b, n, q0, S, N);
    for (int i = threadIdx.x; i < T; i += 2 * T) {
      Ls[i] = a.lse[(size_t)bh * S + q0 + i];
      Ds[i] = a.delta[(size_t)bh * S + q0 + i];
    }
    __syncthreads();
    float st[NT][4], dpt[NT][4];
    scores<T, D>(st, Ks, Qs, warp, g, t);    // S^T: k rows . q rows
    scores<T, D>(dpt, Vs, dOs, warp, g, t);  // dP^T: v rows . dO rows
    const bool diag = a.causal && k0 + T - 1 > q0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = 8 * nt + 2 * t + (i & 1);
        const bool ok = live(diag, q0 + qc, krow + 8 * (i >> 1));
        const float p = ok ? expf(st[nt][i] * a.scale - Ls[qc]) : 0.f;
        st[nt][i] = p;                                      // P^T
        dpt[nt][i] = p * (dpt[nt][i] - Ds[qc]) * a.scale;  // dS^T
      }
    accumulate<T, D>(dv_acc, st, dOs, g, t);
    accumulate<T, D>(dk_acc, dpt, Qs, g, t);
  }
  store_rows<D>(static_cast<bf16*>(a.dk), dk_acc, b, n, krow, S, N, t, 1.f, 1.f);
  store_rows<D>(static_cast<bf16*>(a.dv), dv_acc, b, n, krow, S, N, t, 1.f, 1.f);
}

template <int T, int D>
size_t smem_bytes(int which) {
  const size_t tile = (size_t)T * (D + 8) * sizeof(bf16);
  if (which == 0) return 3 * tile;
  if (which == 1) return 4 * tile;
  return 4 * tile + 2 * T * sizeof(float);
}

}  // namespace tc

// ------------------------------------------------------------- bf16 on Hopper
// The forward, dq and dk/dv passes for blocks that are a multiple of 64:
// flash K5's, K7's and K6's forms (flash_attention.cu, namespace `hopper`)
// over the live tiles of the layout only, with B10's numerics: q is not
// pre-scaled, so the scores take the scale in fp32 in the exponent, exp2(s
// scale log2 e - m) with the forward's running max m in that domain; the
// LSE is stored in natural log, (m + log2 l) ln 2, and the backward passes
// take P = exp2(s scale log2 e - LSE log2 e); dS = P (dP - delta) scale
// carries the scale before it is rounded to bf16.
namespace hopper {

// The live entries among blocks lo .. hi - 1 of a layout row (stride 1) or
// column (stride nb), in order: their block ids into list[0 ..], their
// count into *count.  Run by one whole warp, 32 entries a ballot.
__device__ __forceinline__ void compact_live(int* list, int* count, const int* __restrict__ lay,
                                             int stride, int lo, int hi, int lane) {
  int c = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool keep = i < hi && lay[(size_t)i * stride] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) list[c + __popc(m & ((1u << lane) - 1))] = i;
    c += __popc(m);
  }
  if (lane == 0) *count = c;
}

// The walk of the forward and the dq pass: warp 0 compacts layout row qb
// of q tile qt into walk (its count of live blocks, then their ids); every
// thread gets the number of 64-row k tiles to visit.  Causal: the diagonal
// block, the list's last when live, keeps its k tiles up to this q tile.
__device__ __forceinline__ int row_walk(int* walk, const int* __restrict__ lay, int nb, int tpb,
                                        int qt, int causal, int warp, int lane) {
  const int qb = qt / tpb;
  if (warp == 0) compact_live(walk + 1, walk, lay, 1, 0, causal ? qb + 1 : nb, lane);
  __syncthreads();
  const int live = walk[0];
  return live == 0 ? 0
         : causal && walk[live] == qb ? (live - 1) * tpb + qt - qb * tpb + 1
                                      : live * tpb;
}

// The forward: rows are q rows, columns k rows (K5's orientation).  Scores
// go to the log2 domain, s scale log2 e, in place; the causal diagonal
// tile masks col > row to NEG_INF, whose exp2 is 0 against any finite
// running max.  mx gets each row's largest score of the tile.
template <bool MASKED>
__device__ __forceinline__ void sparse_fwd_scores(float (&s)[8][4], float (&mx)[2], float c,
                                                  int row, int k0, int t) {
  mx[0] = mx[1] = DST_NEG_INF;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] *= c;
      if (MASKED && k0 + 8 * nt + 2 * t + (i & 1) > row + 8 * (i >> 1)) s[nt][i] = DST_NEG_INF;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    }
}

// One warpgroup owns a 64-row q tile of head (b, n), in the dq pass's
// order (causal: in reverse; full: in order), and walks the live k tiles
// of its layout row as the dq pass does.  Q is loaded once by TMA; K and V
// go through K5's ring (`load_pair`).  S = Q K^T by `wgmma_ss`; the online
// softmax in fp32 on exp2 with the running max m in the log2 domain; P
// rounded to bf16 straight into the register A operand; O += P V by
// `wgmma_rs` with V the MN-major B.  A walk of length 0 (a query block
// with no live key) leaves l = 0: O is stored as zeros, the LSE as NEG_INF.
// Every row of a live walk has a key (the tiles below the diagonal are
// whole, the diagonal tile holds the row's own key), so m is finite after
// the first tile, and alpha = exp2(NEG_INF - m) = 0 there.
template <int DT>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const int* __restrict__ layout,
                  bf16* __restrict__ o, float* __restrict__ lse, int S, int N, int LH,
                  int block, int causal, float scale) {
  constexpr int DB = (DT + 3) / 4;
  constexpr uint32_t TILE_BYTES = DB * BOX_BYTES;
  constexpr float L2E = 1.4426950408889634f;
  constexpr float LN2 = 0.6931471805599453f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q | K stage 0 | V stage 0 | K stage 1 | V stage 1 | 3 mbarriers |
  // the walk: its count of live blocks, then their ids
  const uint32_t qs = smem_addr(smem_raw);
  if (qs & (ATOM_BYTES - 1)) __trap();             // the swizzle needs 1024-byte tiles
  const uint32_t ring = qs + TILE_BYTES;
  const uint32_t bars = ring + 4 * TILE_BYTES;     // Q's, then stage 0's and 1's
  int* walk = reinterpret_cast<int*>(smem_raw + 5 * TILE_BYTES + 3 * 8);
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + 16 * warp + g;   // and row + 8
  const int nb = S / block, tpb = block / TILE, qb = qt / tpb;
  const int* lay = layout + ((size_t)(LH == 1 ? 0 : n) * nb + qb) * nb;   // row qb

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, TILE_BYTES);
#pragma unroll
    for (int box = 0; box < DB; ++box)
      tma_load(qs + box * BOX_BYTES, &tq, bars, 64 * box, n, q0, b);
  }
  __syncwarp();
  const int tiles = row_walk(walk, lay, nb, tpb, qt, causal, warp, lane);
  auto key_tile = [&](int j) { return walk[1 + j / tpb] * tpb + j % tpb; };
  if (tid == 0 && tiles > 0) load_pair<DB>(ring, bars, &tk, &tv, 0, key_tile(0) * TILE, n, b);
  __syncwarp();

  const float c = scale * L2E;
  float m[2] = {DST_NEG_INF, DST_NEG_INF}, l[2] = {0.f, 0.f};   // m: log2 domain
  float acc[DB][8][4], s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = 0.f;
#pragma unroll
      for (int cc = 0; cc < DB; ++cc) acc[cc][nt][i] = 0.f;
    }
  mbar_wait(bars, 0);
  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    const int kt = key_tile(j);
    if (tid == 0 && j + 1 < tiles)   // its stage was freed at the end of j - 1
      load_pair<DB>(ring, bars, &tk, &tv, st ^ 1, key_tile(j + 1) * TILE, n, b);
    __syncwarp();
    mbar_wait(bars + 8 + 8 * st, (j >> 1) & 1);
    __syncwarp();
    const uint32_t kst = ring + 2 * TILE_BYTES * st;
    const uint32_t vst = kst + TILE_BYTES;
    issue_scores<DT>(s, qs, kst);
    wg_wait_all();
    fence_regs(s);

    float mx[2];
    if (causal && kt == qt)
      sparse_fwd_scores<true>(s, mx, c, row, kt * TILE, t);
    else
      sparse_fwd_scores<false>(s, mx, c, row, kt * TILE, t);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int cc = 0; cc < DB; ++cc) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[cc][nt][0] *= alpha[0];
        acc[cc][nt][1] *= alpha[0];
        acc[cc][nt][2] *= alpha[1];
        acc[cc][nt][3] *= alpha[1];
      }
      fence_regs(acc[cc]);
    }
    // P = exp2(s - m) straight into the A operand, rounded to bf16; keys
    // 16kk.. are score tiles 2kk and 2kk + 1
    float psum[2] = {0.f, 0.f};
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float e[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[jj][i] = exp2f(s[2 * kk + jj][i] - m[i >> 1]);
          psum[i >> 1] += e[jj][i];
        }
      pack_a(pa[kk], e[0], e[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(psum[h]);

    // O += P V, one 64-column box of V at a time
    wg_fence();
#pragma unroll
    for (int cc = 0; cc < DB; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[cc], pa[kk], desc(vst + cc * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                       ATOM_BYTES));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cc = 0; cc < DB; ++cc) fence_regs(acc[cc]);
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  store_rows<DT>(o, acc, b, n, row, S, N, t, l[0] > 0.f ? 1.f / l[0] : 0.f,
                 l[1] > 0.f ? 1.f / l[1] : 0.f);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)   // natural log, as the backward passes read it
      lse[(size_t)bh * S + row + 8 * h] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : DST_NEG_INF;
  }
}

// dq: rows are q rows, columns k rows (K7's orientation).  `c` = scale
// log2 e; lse2 = LSE log2 e of rows (row, row + 8).
template <bool MASKED>
__device__ __forceinline__ void sparse_dq_scores(float (&s)[8][4], const float (&dp)[8][4],
                                                 const float (&lse2)[2], const float (&dlt)[2],
                                                 float c, float scale, int row, int k0, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1;
      float p = exp2f(fmaf(s[nt][i], c, -lse2[h]));
      if (MASKED && k0 + 8 * nt + 2 * t + (i & 1) > row + 8 * h) p = 0.f;
      s[nt][i] = p * (dp[nt][i] - dlt[h]) * scale;   // dS
    }
}

// One warpgroup owns a 64-row q tile of head (b, n).  Causal, q tiles run
// in reverse, so under Fixed (1 -> 11 live blocks a row) the heaviest go
// first; full, in order, so the global rows of BigBird (block 0, 64 tiles
// against a mean of 11) do not make a tail.  Q and dO are loaded once by TMA, each thread's two rows of LSE
// and delta by plain loads; the walk's K and V tiles go through K5's ring
// (`load_pair`).  S = Q K^T and dP = dO V^T by `wgmma_ss`, issued together;
// dQ += dS K by `wgmma_rs` with K the MN-major B.
template <int DT>
__global__ void __launch_bounds__(THREADS)
sparse_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ layout, bf16* __restrict__ dq, int S, int N, int LH,
                 int block, int causal, float scale) {
  constexpr int DB = (DT + 3) / 4;
  constexpr uint32_t TILE_BYTES = DB * BOX_BYTES;
  constexpr float L2E = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q | dO | K stage 0 | V stage 0 | K stage 1 | V stage 1 | 3 mbarriers |
  // the walk: its count of live blocks, then their ids
  const uint32_t qs = smem_addr(smem_raw);
  if (qs & (ATOM_BYTES - 1)) __trap();             // the swizzle needs 1024-byte tiles
  const uint32_t dos = qs + TILE_BYTES;
  const uint32_t ring = dos + TILE_BYTES;
  const uint32_t bars = ring + 4 * TILE_BYTES;     // Q/dO's, then stage 0's and 1's
  int* walk = reinterpret_cast<int*>(smem_raw + 6 * TILE_BYTES + 3 * 8);
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + 16 * warp + g;   // and row + 8
  const int nb = S / block, tpb = block / TILE, qb = qt / tpb;
  const int* lay = layout + ((size_t)(LH == 1 ? 0 : n) * nb + qb) * nb;   // row qb

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * TILE_BYTES);
#pragma unroll
    for (int box = 0; box < DB; ++box) {
      tma_load(qs + box * BOX_BYTES, &tq, bars, 64 * box, n, q0, b);
      tma_load(dos + box * BOX_BYTES, &tdo, bars, 64 * box, n, q0, b);
    }
  }
  __syncwarp();
  const int tiles = row_walk(walk, lay, nb, tpb, qt, causal, warp, lane);
  auto key_tile = [&](int j) { return walk[1 + j / tpb] * tpb + j % tpb; };
  if (tid == 0 && tiles > 0) load_pair<DB>(ring, bars, &tk, &tv, 0, key_tile(0) * TILE, n, b);
  __syncwarp();

  const float c = scale * L2E;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = lse[(size_t)bh * S + row + 8 * h] * L2E;
    dlt[h] = delta[(size_t)bh * S + row + 8 * h];
  }
  float acc[DB][8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int cc = 0; cc < DB; ++cc) acc[cc][nt][i] = 0.f;
    }
  mbar_wait(bars, 0);
  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    const int kt = key_tile(j);
    if (tid == 0 && j + 1 < tiles)   // its stage was freed at the end of j - 1
      load_pair<DB>(ring, bars, &tk, &tv, st ^ 1, key_tile(j + 1) * TILE, n, b);
    __syncwarp();
    mbar_wait(bars + 8 + 8 * st, (j >> 1) & 1);
    __syncwarp();
    const uint32_t kst = ring + 2 * TILE_BYTES * st;
    const uint32_t vst = kst + TILE_BYTES;
    issue_scores<DT>(s, qs, kst);     // S: q rows . k rows
    issue_scores<DT>(dp, dos, vst);   // dP: dO rows . v rows
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    if (causal && kt == qt)
      sparse_dq_scores<true>(s, dp, lse2, dlt, c, scale, row, kt * TILE, t);
    else
      sparse_dq_scores<false>(s, dp, lse2, dlt, c, scale, row, kt * TILE, t);
    // keys 16kk.. are score tiles 2kk and 2kk + 1
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], s[2 * kk], s[2 * kk + 1]);

    // dQ += dS K, one 64-column box of K at a time
    wg_fence();
#pragma unroll
    for (int cc = 0; cc < DB; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[cc], da[kk], desc(kst + cc * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                       ATOM_BYTES));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cc = 0; cc < DB; ++cc) fence_regs(acc[cc]);
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  store_rows<DT>(dq, acc, b, n, row, S, N, t, 1.f, 1.f);
}

// dk/dv: rows are k rows, columns q rows (K6's orientation); the q tile's
// LSE log2 e and delta come from the stage's table.
template <bool MASKED>
__device__ __forceinline__ void sparse_dkv_probs(float (&st)[8][4], float (&dpt)[8][4],
                                                 const float* lse2, const float* dlt, float c,
                                                 float scale, int q0, int krow, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int qc = 8 * nt + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse2 + qc);
    const float2 d = *reinterpret_cast<const float2*>(dlt + qc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = exp2f(fmaf(st[nt][i], c, -((i & 1) ? l.y : l.x)));
      if (MASKED && krow + 8 * (i >> 1) > q0 + qc + (i & 1)) p = 0.f;
      st[nt][i] = p;                                                  // P^T
      dpt[nt][i] = p * (dpt[nt][i] - ((i & 1) ? d.y : d.x)) * scale;   // dS^T
    }
  }
}

// One warpgroup owns a 64-row k tile of head (b, n); k tiles run in order.
// K and V are loaded once by TMA; the walk's Q and dO tiles go through K6's
// ring, each stage with its q rows' LSE log2 e and delta (plain loads, one
// value a thread, stored into the other stage at the end of a tile).
// S^T = K Q^T and dP^T = V dO^T by `wgmma_ss`; dV += P^T dO and dK += dS^T Q
// by `wgmma_rs` with dO and Q the MN-major B.
template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
sparse_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ layout, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int S, int N, int LH, int block, int causal, float scale) {
  constexpr int DB = (DT + 3) / 4;
  constexpr uint32_t TILE_BYTES = DB * BOX_BYTES;
  constexpr float L2E = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // K | V | stage 0: Q, dO | stage 1: Q, dO | the stages' LSE and delta |
  // 3 mbarriers | the walk: its count of live blocks, then their ids
  const uint32_t ks = smem_addr(smem_raw);
  if (ks & (ATOM_BYTES - 1)) __trap();             // the swizzle needs 1024-byte tiles
  const uint32_t vs = ks + TILE_BYTES;
  const uint32_t ring = vs + TILE_BYTES;
  float* rows = reinterpret_cast<float*>(smem_raw + 6 * TILE_BYTES);  // [stage][LSE, delta][64]
  const uint32_t bars = ks + 6 * TILE_BYTES + 4 * TILE * sizeof(float);  // K/V's, stage 0's, 1's
  int* walk = reinterpret_cast<int*>(smem_raw + 6 * TILE_BYTES + 4 * TILE * sizeof(float) + 3 * 8);
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int kt = blockIdx.y;
  const int k0 = kt * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int krow = k0 + 16 * warp + g;   // and krow + 8
  const int nb = S / block, tpb = block / TILE, kb = kt / tpb;
  const int* lay = layout + (size_t)(LH == 1 ? 0 : n) * nb * nb + kb;   // column kb: stride nb

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * TILE_BYTES);
#pragma unroll
    for (int box = 0; box < DB; ++box) {
      tma_load(ks + box * BOX_BYTES, &tk, bars, 64 * box, n, k0, b);
      tma_load(vs + box * BOX_BYTES, &tv, bars, 64 * box, n, k0, b);
    }
  }
  __syncwarp();
  if (warp == 0) compact_live(walk + 1, walk, lay, nb, causal ? kb : 0, nb, lane);
  __syncthreads();
  const int live = walk[0];
  // causal: the diagonal block, the list's first when live, drops its q
  // tiles above this k tile
  const int skip = live > 0 && causal && walk[1] == kb ? kt - kb * tpb : 0;
  const int tiles = live * tpb - skip;
  auto q_tile = [&](int j) {
    const int i = j + skip;
    return walk[1 + i / tpb] * tpb + i % tpb;
  };
  // thread tid's entry of a stage's table for q tile qt: LSE log2 e of row
  // tid (tid < 64) or delta of row tid - 64
  auto row_value = [&](int qt) -> float {
    const int r = qt * TILE + (tid & (TILE - 1));
    return tid < TILE ? lse[(size_t)bh * S + r] * L2E : delta[(size_t)bh * S + r];
  };
  if (tiles > 0) {
    if (tid == 0) load_pair<DB>(ring, bars, &tq, &tdo, 0, q_tile(0) * TILE, n, b);
    rows[tid] = row_value(q_tile(0));
  }
  __syncthreads();

  const float c = scale * L2E;
  float dka[DB][8][4], dva[DB][8][4], st[8][4], dpt[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
      for (int cc = 0; cc < DB; ++cc) dka[cc][nt][i] = dva[cc][nt][i] = 0.f;
    }
  mbar_wait(bars, 0);
  for (int j = 0; j < tiles; ++j) {
    const int stg = j & 1;
    const int qt = q_tile(j);
    const bool more = j + 1 < tiles;
    const int qn = more ? q_tile(j + 1) : 0;
    if (tid == 0 && more)   // its stage was freed at the end of tile j - 1
      load_pair<DB>(ring, bars, &tq, &tdo, stg ^ 1, qn * TILE, n, b);
    const float next = more ? row_value(qn) : 0.f;   // stored at the tile's end
    __syncwarp();
    mbar_wait(bars + 8 + 8 * stg, (j >> 1) & 1);
    __syncwarp();
    const uint32_t qs = ring + 2 * TILE_BYTES * stg;
    const uint32_t dos = qs + TILE_BYTES;
    issue_scores<DT>(st, ks, qs);    // S^T: k rows . q rows
    issue_scores<DT>(dpt, vs, dos);  // dP^T: v rows . dO rows
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const float* lse2 = rows + 2 * TILE * stg;
    if (causal && qt == kt)
      sparse_dkv_probs<true>(st, dpt, lse2, lse2 + TILE, c, scale, qt * TILE, krow, t);
    else
      sparse_dkv_probs<false>(st, dpt, lse2, lse2 + TILE, c, scale, qt * TILE, krow, t);
    // q rows 16kk.. are score tiles 2kk and 2kk + 1
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
      pack_a(da[kk], dpt[2 * kk], dpt[2 * kk + 1]);
    }

    // dV += P^T dO and dK += dS^T Q, one 64-column box at a time
    wg_fence();
#pragma unroll
    for (int cc = 0; cc < DB; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dva[cc], pa[kk], desc(dos + cc * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                       ATOM_BYTES));
#pragma unroll
    for (int cc = 0; cc < DB; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dka[cc], da[kk], desc(qs + cc * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                       ATOM_BYTES));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cc = 0; cc < DB; ++cc) {
      fence_regs(dva[cc]);
      fence_regs(dka[cc]);
    }
    if (more) rows[2 * TILE * (stg ^ 1) + tid] = next;
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  store_rows<DT>(dk, dka, b, n, krow, S, N, t, 1.f, 1.f);
  store_rows<DT>(dv, dva, b, n, krow, S, N, t, 1.f, 1.f);
}

// forward: Q, a two-stage ring of K and V, three mbarriers and the walk.
template <int DT>
size_t fwd_smem_bytes(int nb) {
  return 5 * (size_t)((DT + 3) / 4) * BOX_BYTES + 3 * 8 + (nb + 1) * sizeof(int);
}

// dq: Q, dO, a two-stage ring of K and V, three mbarriers and the walk.
template <int DT>
size_t dq_smem_bytes(int nb) {
  return 6 * (size_t)((DT + 3) / 4) * BOX_BYTES + 3 * 8 + (nb + 1) * sizeof(int);
}

// dk/dv: K, V, a two-stage ring of Q and dO, the stages' LSE and delta,
// three mbarriers and the walk.
template <int DT>
size_t dkv_smem_bytes(int nb) {
  return 6 * (size_t)((DT + 3) / 4) * BOX_BYTES + 4 * TILE * sizeof(float) + 3 * 8 +
         (nb + 1) * sizeof(int);
}

}  // namespace hopper

// ------------------------------------------------------------------ launchers
template <typename K, typename... P>
cudaError_t start(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                  const P&... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// which: 0 forward, 1 dq, 2 dk/dv.
template <int T, int NJ>
cudaError_t launch_f32(int which, const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.N, a.S / T);
  const size_t smem = f32::smem_bytes<T>(which, a.D);
  switch (which) {
    case 0: return start(f32::fwd_kernel<T, NJ>, grid, f32::THREADS, smem, stream, a);
    case 1: return start(f32::dq_kernel<T, NJ>, grid, f32::THREADS, smem, stream, a);
    default: return start(f32::dkv_kernel<T, NJ>, grid, f32::THREADS, smem, stream, a);
  }
}

template <int T>
cudaError_t f32_by_head_dim(int which, const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch_f32<T, 1>(which, a, stream);
  if (a.D <= 32) return launch_f32<T, 2>(which, a, stream);
  if (a.D <= 64) return launch_f32<T, 4>(which, a, stream);
  return launch_f32<T, 8>(which, a, stream);
}

template <int T, int D>
cudaError_t launch_tc(int which, const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.N, a.S / T);
  const size_t smem = tc::smem_bytes<T, D>(which);
  switch (which) {
    case 0: return start(tc::fwd_kernel<T, D>, grid, 2 * T, smem, stream, a);
    case 1: return start(tc::dq_kernel<T, D>, grid, 2 * T, smem, stream, a);
    default: return start(tc::dkv_kernel<T, D>, grid, 2 * T, smem, stream, a);
  }
}

template <int T>
cudaError_t tc_by_head_dim(int which, const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_tc<T, 16>(which, a, stream);
    case 32: return launch_tc<T, 32>(which, a, stream);
    case 64: return launch_tc<T, 64>(which, a, stream);
    case 128: return launch_tc<T, 128>(which, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// which: 0 forward, 1 dq, 2 dk/dv, on the Hopper kernels (bf16, block % 64
// == 0).  The forward has no dO to map.
template <int DT>
cudaError_t launch_hopper(int which, const Args& a, cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  const int D = DT * 16, nb = a.S / a.block;
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::head_map(&tq, a.q, a.B, a.S, a.N, D) ||
      !hopper::head_map(&tk, a.k, a.B, a.S, a.N, D) ||
      !hopper::head_map(&tv, a.v, a.B, a.S, a.N, D) ||
      (which != 0 && !hopper::head_map(&tdo, a.dout, a.B, a.S, a.N, D)))
    return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.N, a.S / hopper::TILE);
  switch (which) {
    case 0:
      return start(hopper::sparse_fwd_kernel<DT>, grid, hopper::THREADS,
                   hopper::fwd_smem_bytes<DT>(nb), stream, tq, tk, tv, a.layout,
                   static_cast<bf16*>(a.o), a.lse_out, a.S, a.N, a.LH, a.block, a.causal,
                   a.scale);
    case 1:
      return start(hopper::sparse_dq_kernel<DT>, grid, hopper::THREADS,
                   hopper::dq_smem_bytes<DT>(nb), stream, tq, tk, tv, tdo, a.lse, a.delta,
                   a.layout, static_cast<bf16*>(a.dq), a.S, a.N, a.LH, a.block, a.causal,
                   a.scale);
    default:
      return start(hopper::sparse_dkv_kernel<DT>, grid, hopper::THREADS,
                   hopper::dkv_smem_bytes<DT>(nb), stream, tq, tk, tv, tdo, a.lse, a.delta,
                   a.layout, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.N,
                   a.LH, a.block, a.causal, a.scale);
  }
}

cudaError_t hopper_by_head_dim(int which, const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_hopper<1>(which, a, stream);
    case 32: return launch_hopper<2>(which, a, stream);
    case 64: return launch_hopper<4>(which, a, stream);
    case 128: return launch_hopper<8>(which, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int T>
cudaError_t by_type(int which, const Args& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case DST_DTYPE_F32: return f32_by_head_dim<T>(which, a, stream);
    case DST_DTYPE_BF16:
      if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout) ||
          !aligned16(a.o) || !aligned16(a.dq) || !aligned16(a.dk) || !aligned16(a.dv))
        return cudaErrorInvalidValue;
      // all three passes on Hopper when a block holds whole 64-row tiles
      // (T = 64), on mma.sync otherwise: no tc kernel is built at T = 64
      if constexpr (T == 64) return hopper_by_head_dim(which, a, stream);
      else return tc_by_head_dim<T>(which, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, Args& a, int dtype, cudaStream_t stream) {
  if (a.B * a.N == 0 || a.S == 0) return 0;
  if (a.D < 1 || a.D > 128 || a.block < 16 || a.block % 16 != 0 || a.S % a.block != 0 ||
      (a.LH != 1 && a.LH != a.N))
    return (int)cudaErrorInvalidValue;
  if (a.block % 64 == 0) return (int)by_type<64>(which, a, dtype, stream);
  if (a.block % 32 == 0) return (int)by_type<32>(which, a, dtype, stream);
  return (int)by_type<16>(which, a, dtype, stream);
}

Args make(const void* q, const void* k, const void* v, const int* layout, int B, int S, int N,
          int D, int LH, int block, int causal, float scale) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.layout = layout;
  a.B = B; a.S = S; a.N = N; a.D = D; a.LH = LH; a.block = block; a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" int dst_sparse_fwd(const void* q, const void* k, const void* v, const int* layout,
                              void* o, float* lse, int B, int S, int N, int D, int LH,
                              int block, int causal, float scale, int dtype,
                              cudaStream_t stream) {
  Args a = make(q, k, v, layout, B, S, N, D, LH, block, causal, scale);
  a.o = o; a.lse_out = lse;
  return run(0, a, dtype, stream);
}

extern "C" int dst_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* layout,
                                 void* dq, int B, int S, int N, int D, int LH, int block,
                                 int causal, float scale, int dtype, cudaStream_t stream) {
  Args a = make(q, k, v, layout, B, S, N, D, LH, block, causal, scale);
  a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  return run(1, a, dtype, stream);
}

extern "C" int dst_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  const int* layout, void* dk, void* dv, int B, int S, int N,
                                  int D, int LH, int block, int causal, float scale, int dtype,
                                  cudaStream_t stream) {
  Args a = make(q, k, v, layout, B, S, N, D, LH, block, causal, scale);
  a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  return run(2, a, dtype, stream);
}
