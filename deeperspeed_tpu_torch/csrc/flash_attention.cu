// K5 / K6 / K7: flash attention forward and its two-pass backward.
//
// Replaces the TPU kernels of deeperspeed_tpu/ops/attention/pallas_flash.py:
//   K5 `_fwd_kernel` (launched by `_fwd_call`),
//   K6 `_dkv_kernel` (`_bwd_call`, second pass),
//   K7 `_dq_kernel`  (`_bwd_call`, first pass),
// and, together, `_dkv_fused_kernel` (`_bwd_call_fused`): its contract is
// (q, k, v, dO, LSE, delta) -> (dq, dk, dv) with dq summed in fp32 before one
// rounding, which is what K7 + K6 compute.  The TPU fused the dq partials
// into the dk/dv pass because at its 1024-wide tile S 1024 has one k tile;
// at this card's 64-row tiles S 1024 has 16, and per-tile fp32 dq partials
// would cost 16 x |dq| of device memory, so the port runs FlashAttention-2's
// deterministic two-pass backward (no atomics: results do not vary between
// runs).
//
// Bound on the H100: operations.  At S 1024, D 64 a (b, n) head does
// ~2 S^2 D causal multiply-adds per product against S D of input bytes.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous [B, S, N, D] (the
// wrapper makes them so); each kernel reads a head's rows with stride N*D,
// so no [B*N, S, D] fold copies are made.  LSE and delta are fp32 [B*N, S].
// q arrives pre-scaled by the softmax scale (in q's type), as in the TPU
// kernels; the wrapper post-scales dq.
//
// Two implementations of each kernel, one per type:
//
// * bf16 runs the Hopper kernels of namespace `hopper`: TMA loads into a
//   two-stage ring and `wgmma` products (described there), K5 the
//   forward, K6 the dk/dv pass and K7 the dq pass.  All take D a multiple of
//   16 (every preset: D 64, 80, 128) and 16-byte aligned operands; the
//   wrapper zero-pads D = 8 mod 16 and copies a misaligned view, and the
//   launcher refuses anything else.
// * fp32 runs the CUDA-core kernels below:
//   256 threads per CTA as a 16 x 16 grid; thread (ty, tx) owns the four
//   tile rows 4ty..4ty+3 and the columns tx + 16j.  Every operand tile
//   ([64, D]) is staged in shared memory as fp32 with a pitch of D + 1
//   (odd, so the column reads of a warp hit distinct banks).  A 64 x 64
//   score tile is a register-blocked outer product (4 x 4 per thread); row
//   reductions run over the 16 lanes of a half warp with shuffles.
//
// Both follow the TPU kernels' rounding: P is rounded to v's type before
// P.V and P^T.dO, dS to q's type before dS.K and dS^T.Q (a no-op in fp32);
// every product accumulates in fp32.  Causal tiles wholly above the diagonal are skipped;
// the ragged edge (S not a multiple of 64) is masked by bounds, with no
// padding copies.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"  // the TMA, mbarrier and wgmma building blocks of namespace hopper

namespace {

constexpr int TILE = 64;      // rows of a q tile and of a k tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PPITCH = TILE + 1;

__device__ __forceinline__ size_t row_off(int b, int s, int n, int S, int N, int D) {
  return (((size_t)b * S + s) * N + n) * D;
}

// Rows row0 .. row0+63 of head (b, n) into shared memory; rows >= S are 0.
__device__ void load_tile(float* dst, const float* __restrict__ src, int b, int n, int row0,
                          int S, int N, int D) {
  const int pitch = D + 1;
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int s = row0 + r;
    dst[r * pitch + d] = s < S ? src[row_off(b, s, n, S, N, D) + d] : 0.f;
  }
}

// acc[i][j] = A[4ty+i, :] . Bm[tx+16j, :] over the D columns of two tiles.
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* A, const float* Bm,
                                         int D, int ty, int tx) {
  const int pitch = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a0 = A + (4 * ty) * pitch;
  const float* b0 = Bm + tx * pitch;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * pitch + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b0[16 * j * pitch + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// acc[i][jj] += sum_r W[4ty+i, r] * M[r, tx+16jj] for r < 64 (W pitch 65).
template <int NJ>
__device__ __forceinline__ void tile_accum(float acc[4][NJ], const float* W, const float* M,
                                           int D, int ty, int tx) {
  const int pitch = D + 1;
  for (int r = 0; r < TILE; ++r) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(4 * ty + i) * PPITCH + r];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) {
        const float m = M[r * pitch + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(w[i], m, acc[i][jj]);
      }
    }
  }
}

// Reductions over the 16 lanes that share ty (one half of a warp).
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

__device__ __forceinline__ bool live(int row, int col, int S, int causal) {
  return row < S && col < S && (!causal || col <= row);
}

// ---------------------------------------------------------------- K5: forward
template <int NJ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int S, int N, int D, int causal) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* Qs = smem;
  float* Ks = Qs + TILE * pitch;
  float* Vs = Ks + TILE * pitch;
  float* Ps = Vs + TILE * pitch;
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(Qs, q, b, n, q0, S, N, D);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = DST_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  const int nk = (S + TILE - 1) / TILE;
  const int kt_end = causal ? qt + 1 : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, b, n, k0, S, N, D);
    load_tile(Vs, v, b, n, k0, S, N, D);
    __syncthreads();
    float s[4][4];
    tile_dot(s, Qs, Ks, D, ty, tx);
    const bool edge = (causal && kt == qt) || k0 + TILE > S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = DST_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows >= S are computed on zeros and never stored
        if (edge && !live(q0 + 4 * ty + i, k0 + tx + 16 * j, S, causal)) s[i][j] = DST_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(4 * ty + i) * PPITCH + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    tile_accum<NJ>(acc, Ps, Vs, D, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const size_t base = row_off(b, row, n, S, N, D);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) o[base + c] = acc[i][jj] / l[i];
    }
    if (tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------ K7: dq pass
template <int NJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int S, int N, int D, int causal) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* Qs = smem;
  float* dOs = Qs + TILE * pitch;
  float* Ks = dOs + TILE * pitch;
  float* Vs = Ks + TILE * pitch;
  float* dSs = Vs + TILE * pitch;
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(Qs, q, b, n, q0, S, N, D);
  load_tile(dOs, dout, b, n, q0, S, N, D);
  float row_lse[4], row_delta[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    row_lse[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    row_delta[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  const int nk = (S + TILE - 1) / TILE;
  const int kt_end = causal ? qt + 1 : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile(Ks, k, b, n, k0, S, N, D);
    load_tile(Vs, v, b, n, k0, S, N, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, D, ty, tx);
    tile_dot(dp, dOs, Vs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = live(q0 + 4 * ty + i, k0 + tx + 16 * j, S, causal);
        const float p = ok ? expf(s[i][j] - row_lse[i]) : 0.f;
        dSs[(4 * ty + i) * PPITCH + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();
    tile_accum<NJ>(acc, dSs, Ks, D, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const size_t base = row_off(b, row, n, S, N, D);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) dq[base + c] = acc[i][jj];
    }
  }
}

// --------------------------------------------------------- K6: dk/dv pass
template <int NJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int S, int N, int D,
                     int causal) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* Ks = smem;
  float* Vs = Ks + TILE * pitch;
  float* Qs = Vs + TILE * pitch;
  float* dOs = Qs + TILE * pitch;
  float* PTs = dOs + TILE * pitch;   // P^T tile, [k row][q row]
  float* dSTs = PTs + TILE * PPITCH;  // dS^T tile
  float* Ls = dSTs + TILE * PPITCH;   // LSE of the q tile's rows
  float* Ds = Ls + TILE;              // delta of the q tile's rows
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int kt = blockIdx.y;          // causal: the lightest tiles are the last ones
  const int k0 = kt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(Ks, k, b, n, k0, S, N, D);
  load_tile(Vs, v, b, n, k0, S, N, D);
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;
  const int nq = (S + TILE - 1) / TILE;
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile(Qs, q, b, n, q0, S, N, D);
    load_tile(dOs, dout, b, n, q0, S, N, D);
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      const bool in = q0 + r < S;
      Ls[r] = in ? lse[(size_t)bh * S + q0 + r] : 0.f;
      Ds[r] = in ? delta[(size_t)bh * S + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_dot(st, Ks, Qs, D, ty, tx);   // st[i][j] = k row 4ty+i . q row tx+16j
    tile_dot(dpt, Vs, dOs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j;
        const bool ok = live(q0 + qr, k0 + 4 * ty + i, S, causal);
        const float p = ok ? expf(st[i][j] - Ls[qr]) : 0.f;
        PTs[(4 * ty + i) * PPITCH + qr] = p;
        dSTs[(4 * ty + i) * PPITCH + qr] = p * (dpt[i][j] - Ds[qr]);
      }
    __syncthreads();
    tile_accum<NJ>(dv_acc, PTs, dOs, D, ty, tx);
    tile_accum<NJ>(dk_acc, dSTs, Qs, D, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= S) continue;
    const size_t base = row_off(b, row, n, S, N, D);
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


// ------------------------------------------------------------------------
// K5 on Hopper (bf16, D a multiple of 16 up to 128).
//
// One CTA is one warpgroup (128 threads) and owns a 64-row q tile of one
// (b, n) head; warp w owns rows 16w..16w+15.  Heavy causal tiles are
// scheduled first.
//
// Loads: TMA, one tensor map each for q, k and v over their [B, S, N, D]
// layout (dims (D, N, S, B), no fold copy), a box of 64 columns x 1 head x
// 64 rows with 128-byte swizzle; D > 64 takes two boxes.  TMA zero-fills
// columns past D and rows past S.  Q is loaded once; K and V go through a
// two-stage ring with one mbarrier a stage, armed with `expect_tx` for the
// full boxes (out-of-bounds bytes count).  Thread 0 issues tile j + 1's
// loads before tile j's math; a barrier at the end of tile j frees its
// stage for tile j + 2.
//
// Products: S = Q K^T by `wgmma m64n64k16` with Q and K both K-major in
// shared memory (D / 16 k-steps, each 32 bytes further along the swizzled
// 128-byte rows).  O += P V by `wgmma m64n64k16` with P as the register A
// operand (the score accumulator's layout rounded to bf16 pairs) and V as
// an MN-major B operand (the transpose bit), one 64-column box at a time:
// D 80..112 compute the zero columns of the second box, which the epilogue
// drops.  In each warp the `wgmma` accumulator has the `mma.sync` m16n8 C
// layout over its 16 rows: lane (g = lane / 4, t = lane % 4) holds rows g
// and g + 8 at the column pairs 8 nt + 2t, so a row's max and sum reduce
// over the four lanes that share g (`quad_max`/`quad_sum`), and the
// accumulator packed to bf16 pairs is the A operand of the next product.
// The online softmax is fp32 with the alpha rescale.  exp(x) is taken as
// exp2(x log2 e): at 64 exps per
// 64 x 64 x D product the softmax's instructions, not the tensor cores,
// set a tile's time, and `expf`'s range reduction costs more than the
// multiply.
//
// Bound: near the card's balance point at S 1024, D 64 (bytes for the
// causal training shape, operations without the mask).  What holds it
// back: one warpgroup runs its S product, its softmax and its P V product
// in turn, so the tensor cores idle during the softmax unless another CTA
// of the SM (5 at D <= 64 by registers, 2 above by shared memory) fills
// the gap.
//
// Rounding: P to bf16 before P V, every sum in fp32; O in bf16, LSE
// m + log l in fp32.
namespace hopper {

template <int DT>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, int S, int N, int causal) {
  constexpr int DB = (DT + 3) / 4;                 // 64-column boxes a tile
  constexpr uint32_t TILE_BYTES = DB * BOX_BYTES;
  constexpr float L2E = 1.4426950408889634f;      // exp(x) = exp2(x log2 e)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q | K stage 0 | V stage 0 | K stage 1 | V stage 1 | 3 mbarriers
  const uint32_t qs = smem_addr(smem_raw);
  if (qs & (ATOM_BYTES - 1)) __trap();             // the swizzle needs 1024-byte tiles
  const uint32_t ring = qs + TILE_BYTES;
  const uint32_t bars = ring + 4 * TILE_BYTES;     // Q's, then stage 0's and 1's
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + 16 * warp + g;   // and row + 8
  const int nk = (S + TILE - 1) / TILE;
  // causal: the key tiles up to the one holding the tile's last row
  const int kt_end = causal ? min(nk, (q0 + 2 * TILE - 1) / TILE) : nk;

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
    load_pair<DB>(ring, bars, &tk, &tv, 0, 0, n, b);
  }
  __syncwarp();

  float m[2] = {DST_NEG_INF, DST_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DB][8][4];
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int c = 0; c < DB; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][nt][i] = 0.f;
  mbar_wait(bars, 0);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    if (tid == 0 && kt + 1 < kt_end)   // its stage was freed at the end of kt - 1
      load_pair<DB>(ring, bars, &tk, &tv, (kt + 1) & 1, (kt + 1) * TILE, n, b);
    __syncwarp();
    mbar_wait(bars + 8 + 8 * st, (kt >> 1) & 1);
    __syncwarp();
    const uint32_t kst = ring + 2 * TILE_BYTES * st;
    const uint32_t vst = kst + TILE_BYTES;
    issue_scores<DT>(s, qs, kst);
    wg_wait_all();
    fence_regs(s);

    const int k0 = kt * TILE;
    // masked: a tile reaching past this q tile's first row (causal), or the ragged edge
    const bool edge = (causal && k0 + TILE - 1 > q0) || k0 + TILE > S;
    float mx[2] = {DST_NEG_INF, DST_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // rows >= S are computed on zeros and never stored
        if (edge && !live(row + 8 * (i >> 1), k0 + 8 * nt + 2 * t + (i & 1), S, causal))
          s[nt][i] = DST_NEG_INF;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = exp2f((m[h] - m_new) * L2E);
      m[h] = m_new;
    }
#pragma unroll
    for (int c = 0; c < DB; ++c) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[c][nt][0] *= alpha[0];
        acc[c][nt][1] *= alpha[0];
        acc[c][nt][2] *= alpha[1];
        acc[c][nt][3] *= alpha[1];
      }
      fence_regs(acc[c]);
    }
    // P = exp(S - m) straight into the A operand, rounded to bf16; keys
    // 16kk.. are score tiles 2kk and 2kk + 1
    float psum[2] = {0.f, 0.f};
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float e[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[j][i] = exp2f((s[2 * kk + j][i] - m[i >> 1]) * L2E);
          psum[i >> 1] += e[j][i];
        }
      pack_a(pa[kk], e[0], e[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(psum[h]);

    // O += P V, one 64-column box of V at a time
    wg_fence();
#pragma unroll
    for (int c = 0; c < DB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[c], pa[kk], desc(vst + c * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                      ATOM_BYTES));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < DB; ++c) fence_regs(acc[c]);
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  store_rows<DT>(o, acc, b, n, row, S, N, t, 1.f / l[0], 1.f / l[1]);
  if (t == 0) {
    if (row < S) lse[(size_t)bh * S + row] = m[0] + logf(l[0]);
    if (row + 8 < S) lse[(size_t)bh * S + row + 8] = m[1] + logf(l[1]);
  }
}

// ------------------------------------------------------------------------
// K6 on Hopper: one CTA (one warpgroup) owns a 64-row k tile of one (b, n)
// head and walks the q tiles that attend to it (causal: from the diagonal
// tile down; k tiles are scheduled in order, so the heaviest go first).
//
// Loads: K and V once, by TMA (the tensor maps of K5); Q and dO through a
// two-stage ring, one mbarrier a stage, q tile j + 1 issued by thread 0
// before tile j's math.  Each stage also holds its q rows' LSE (times
// log2 e) and delta, 64 fp32 each: a 1-D bulk copy would need a 16-byte
// aligned source, which (bh S + q0) 4 bytes is not when S mod 4 != 0, so
// each thread loads one of the 128 values with a plain load at the start
// of tile j and stores it into the other stage at the end of tile j.
//
// Products, all K5's two forms: S^T = K Q^T and dP^T = V dO^T with K (V)
// the K-major A and Q (dO) the K-major B (`issue_scores`, K5's Q K^T with
// the roles swapped), then dV += P^T dO and dK += dS^T Q with P^T (dS^T) in
// registers as the A operand and dO (Q) the MN-major B (`wgmma_rs`, K5's
// P V), one 64-column box at a time.  The same swizzled Q and dO tiles
// serve as K-major and as MN-major B: only the descriptor differs.
//
// In registers the accumulator's rows are k rows and its columns q rows,
// so the LSE, delta and the causal mask are indexed by the column
// 8 nt + 2t + (0, 1).  P = exp2(s log2 e - LSE log2 e) as in K5.  The
// diagonal tile (causal) and the ragged last q tile have a masked body, the
// q tiles below the diagonal an unmasked one (`pl.when(qi > ki)` in the
// TPU kernel); rows past S are zero (TMA fill, LSE and delta 0), so they
// add nothing even unmasked.  dK and dV are rounded to bf16 once and
// stored by each thread from its accumulator fragments: no atomics, so
// launches repeat bit for bit.
//
// Bound: operations (4 products of 64 x 64 x D a pair of tiles).  What
// holds it back: as in K5, one warpgroup runs its products and its
// elementwise part in turn; a second CTA on the SM fills the gaps.
//
// Rounding: P to bf16 before P^T dO, dS = P (dP - delta) from the fp32 P
// rounded to bf16 before dS^T Q, every sum in fp32.
template <bool MASKED>
__device__ __forceinline__ void dkv_probs(float (&st)[8][4], float (&dpt)[8][4],
                                          const float* lse2, const float* dlt, int q0, int krow,
                                          int S, int causal, int t) {
  constexpr float L2E = 1.4426950408889634f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int qc = 8 * nt + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse2 + qc);
    const float2 d = *reinterpret_cast<const float2*>(dlt + qc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = exp2f(fmaf(st[nt][i], L2E, -((i & 1) ? l.y : l.x)));
      if (MASKED && !live(q0 + qc + (i & 1), krow + 8 * (i >> 1), S, causal)) p = 0.f;
      st[nt][i] = p;                                        // P^T
      dpt[nt][i] = p * (dpt[nt][i] - ((i & 1) ? d.y : d.x));  // dS^T
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int N, int causal) {
  constexpr int DB = (DT + 3) / 4;
  constexpr uint32_t TILE_BYTES = DB * BOX_BYTES;
  constexpr float L2E = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // K | V | stage 0: Q, dO | stage 1: Q, dO | the stages' LSE and delta | 3 mbarriers
  const uint32_t ks = smem_addr(smem_raw);
  if (ks & (ATOM_BYTES - 1)) __trap();             // the swizzle needs 1024-byte tiles
  const uint32_t vs = ks + TILE_BYTES;
  const uint32_t ring = vs + TILE_BYTES;
  float* rows = reinterpret_cast<float*>(smem_raw + 6 * TILE_BYTES);  // [stage][LSE, delta][64]
  const uint32_t bars = ks + 6 * TILE_BYTES + 4 * TILE * sizeof(float);  // K/V's, stage 0's, 1's
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int kt = blockIdx.y;
  const int k0 = kt * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int krow = k0 + 16 * warp + g;   // and krow + 8
  const int nq = (S + TILE - 1) / TILE;
  const int qt0 = causal ? kt : 0;
  const int tiles = nq - qt0;
  // thread tid's entry of a stage's table for q tile qt: LSE log2 e of row
  // tid (tid < 64) or delta of row tid - 64; 0 past S
  auto row_value = [&](int qt) -> float {
    const int r = qt * TILE + (tid & (TILE - 1));
    if (r >= S) return 0.f;
    return tid < TILE ? lse[(size_t)bh * S + r] * L2E : delta[(size_t)bh * S + r];
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  rows[tid] = row_value(qt0);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * TILE_BYTES);
#pragma unroll
    for (int box = 0; box < DB; ++box) {
      tma_load(ks + box * BOX_BYTES, &tk, bars, 64 * box, n, k0, b);
      tma_load(vs + box * BOX_BYTES, &tv, bars, 64 * box, n, k0, b);
    }
    load_pair<DB>(ring, bars, &tq, &tdo, 0, qt0 * TILE, n, b);
  }
  __syncwarp();

  float dka[DB][8][4], dva[DB][8][4], st[8][4], dpt[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
      for (int c = 0; c < DB; ++c) dka[c][nt][i] = dva[c][nt][i] = 0.f;
    }
  mbar_wait(bars, 0);
  for (int j = 0; j < tiles; ++j) {
    const int stg = j & 1;
    const int q0 = (qt0 + j) * TILE;
    const bool more = j + 1 < tiles;
    if (tid == 0 && more)   // its stage was freed at the end of tile j - 1
      load_pair<DB>(ring, bars, &tq, &tdo, stg ^ 1, q0 + TILE, n, b);
    const float next = more ? row_value(qt0 + j + 1) : 0.f;   // stored at the tile's end
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
    if ((causal && q0 == k0) || q0 + TILE > S)
      dkv_probs<true>(st, dpt, lse2, lse2 + TILE, q0, krow, S, causal, t);
    else
      dkv_probs<false>(st, dpt, lse2, lse2 + TILE, q0, krow, S, causal, t);
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
    for (int c = 0; c < DB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dva[c], pa[kk], desc(dos + c * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                      ATOM_BYTES));
#pragma unroll
    for (int c = 0; c < DB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dka[c], da[kk], desc(qs + c * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                      ATOM_BYTES));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      fence_regs(dva[c]);
      fence_regs(dka[c]);
    }
    if (more) rows[2 * TILE * (stg ^ 1) + tid] = next;
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  store_rows<DT>(dk, dka, b, n, krow, S, N, t, 1.f, 1.f);
  store_rows<DT>(dv, dva, b, n, krow, S, N, t, 1.f, 1.f);
}

// ------------------------------------------------------------------------
// K7 on Hopper: one CTA (one warpgroup) owns a 64-row q tile of one (b, n)
// head and walks the k tiles it attends to (causal: up to the diagonal
// tile), as K5 does; heavy causal tiles are scheduled first.
//
// Loads: Q and dO once, by TMA (the tensor maps of K6); K and V through
// K5's two-stage ring (`load_pair`), k tile j + 1 issued by thread 0 before
// tile j's math.  Each thread's two rows of LSE (times log2 e) and delta
// are plain loads at the start.
//
// Products, all K5's forms: S = Q K^T and dP = dO V^T with both operands
// K-major (`issue_scores`), issued together and waited for once; then
// dQ += dS K with dS in registers as the A operand and K the MN-major B
// (`wgmma_rs`, K5's P V with V replaced by K), one 64-column box at a time.
//
// Rows are q rows and columns k rows, K5's orientation: LSE and delta are
// indexed by the row (row, row + 8), the causal mask by the column
// 8 nt + 2t + (0, 1).  P = exp2(s log2 e - LSE log2 e), dS = P (dP - delta).
// The diagonal tile (causal) and the ragged last k tile have a masked body,
// the k tiles below the diagonal an unmasked one (`pl.when(ki < qi)` in the
// TPU kernel).  Key rows past S arrive as zeros and would add nothing to
// dS K, but their P would be exp2(-LSE log2 e), not 0: the masked body
// zeroes it by bounds, so P is the reference's.  q rows past S are zero
// with LSE and delta 0 (dS = 0) and are never stored.  dQ is rounded to
// bf16 once and stored by each thread from its fragments: no atomics, so
// launches repeat bit for bit.
//
// Bound: operations (3 products of 64 x 64 x D a pair of tiles).  What
// holds it back: as in K5 and K6, one warpgroup runs its products and its
// elementwise part in turn; other CTAs of the SM fill the gaps.
//
// Rounding: P in fp32, dS rounded to bf16 before dS K, every sum in fp32.
template <bool MASKED>
__device__ __forceinline__ void dq_scores(float (&s)[8][4], const float (&dp)[8][4],
                                          const float (&lse2)[2], const float (&dlt)[2],
                                          int row, int k0, int S, int causal, int t) {
  constexpr float L2E = 1.4426950408889634f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1;
      float p = exp2f(fmaf(s[nt][i], L2E, -lse2[h]));
      if (MASKED && !live(row + 8 * h, k0 + 8 * nt + 2 * t + (i & 1), S, causal)) p = 0.f;
      s[nt][i] = p * (dp[nt][i] - dlt[h]);   // dS
    }
}

template <int DT>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int S, int N, int causal) {
  constexpr int DB = (DT + 3) / 4;
  constexpr uint32_t TILE_BYTES = DB * BOX_BYTES;
  constexpr float L2E = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q | dO | K stage 0 | V stage 0 | K stage 1 | V stage 1 | 3 mbarriers
  const uint32_t qs = smem_addr(smem_raw);
  if (qs & (ATOM_BYTES - 1)) __trap();             // the swizzle needs 1024-byte tiles
  const uint32_t dos = qs + TILE_BYTES;
  const uint32_t ring = dos + TILE_BYTES;
  const uint32_t bars = ring + 4 * TILE_BYTES;     // Q/dO's, then stage 0's and 1's
  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + 16 * warp + g;   // and row + 8
  const int nk = (S + TILE - 1) / TILE;
  const int kt_end = causal ? qt + 1 : nk;

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
    load_pair<DB>(ring, bars, &tk, &tv, 0, 0, n, b);
  }
  __syncwarp();

  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse2[h] = r < S ? lse[(size_t)bh * S + r] * L2E : 0.f;
    dlt[h] = r < S ? delta[(size_t)bh * S + r] : 0.f;
  }
  float acc[DB][8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int c = 0; c < DB; ++c) acc[c][nt][i] = 0.f;
    }
  mbar_wait(bars, 0);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    if (tid == 0 && kt + 1 < kt_end)   // its stage was freed at the end of kt - 1
      load_pair<DB>(ring, bars, &tk, &tv, (kt + 1) & 1, (kt + 1) * TILE, n, b);
    __syncwarp();
    mbar_wait(bars + 8 + 8 * st, (kt >> 1) & 1);
    __syncwarp();
    const uint32_t kst = ring + 2 * TILE_BYTES * st;
    const uint32_t vst = kst + TILE_BYTES;
    issue_scores<DT>(s, qs, kst);     // S: q rows . k rows
    issue_scores<DT>(dp, dos, vst);   // dP: dO rows . v rows
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const int k0 = kt * TILE;
    if ((causal && kt == qt) || k0 + TILE > S)
      dq_scores<true>(s, dp, lse2, dlt, row, k0, S, causal, t);
    else
      dq_scores<false>(s, dp, lse2, dlt, row, k0, S, causal, t);
    // keys 16kk.. are score tiles 2kk and 2kk + 1
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], s[2 * kk], s[2 * kk + 1]);

    // dQ += dS K, one 64-column box of K at a time
    wg_fence();
#pragma unroll
    for (int c = 0; c < DB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[c], da[kk], desc(kst + c * BOX_BYTES + kk * 2 * ATOM_BYTES, BOX_BYTES,
                                      ATOM_BYTES));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < DB; ++c) fence_regs(acc[c]);
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  store_rows<DT>(dq, acc, b, n, row, S, N, t, 1.f, 1.f);
}


// K5: Q, a two-stage ring of K and V, and three mbarriers.
template <int DT>
constexpr size_t smem_bytes() {
  return 5 * (size_t)((DT + 3) / 4) * BOX_BYTES + 3 * 8;
}

// K6: K, V, a two-stage ring of Q and dO, the stages' LSE and delta, and
// three mbarriers.
template <int DT>
constexpr size_t dkv_smem_bytes() {
  return 6 * (size_t)((DT + 3) / 4) * BOX_BYTES + 4 * TILE * sizeof(float) + 3 * 8;
}

// K7: Q, dO, a two-stage ring of K and V, and three mbarriers.
template <int DT>
constexpr size_t dq_smem_bytes() {
  return 6 * (size_t)((DT + 3) / 4) * BOX_BYTES + 3 * 8;
}


}  // namespace hopper

// ------------------------------------------------------------------ launchers
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, S, N, D, causal;
};

template <int NJ>
cudaError_t launch_fwd(const Args& a, cudaStream_t stream) {
  const size_t smem = (3 * (size_t)TILE * (a.D + 1) + TILE * PPITCH) * sizeof(float);
  cudaError_t e = prepare(flash_fwd_kernel<NJ>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.N, (a.S + TILE - 1) / TILE);
  flash_fwd_kernel<NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v),
      static_cast<float*>(a.o), a.lse_out, a.S, a.N, a.D, a.causal);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = (4 * (size_t)TILE * (a.D + 1) + TILE * PPITCH) * sizeof(float);
  cudaError_t e = prepare(flash_bwd_dq_kernel<NJ>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.N, (a.S + TILE - 1) / TILE);
  flash_bwd_dq_kernel<NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dq), a.S, a.N, a.D,
      a.causal);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (4 * (size_t)TILE * (a.D + 1) + 2 * TILE * PPITCH + 2 * TILE) * sizeof(float);
  cudaError_t e = prepare(flash_bwd_dkv_kernel<NJ>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.N, (a.S + TILE - 1) / TILE);
  flash_bwd_dkv_kernel<NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.S, a.N, a.D, a.causal);
  return cudaGetLastError();
}

// which: 0 forward, 1 dq, 2 dk/dv.  NJ = columns per thread / 16, by D.
template <int NJ>
cudaError_t launch(int which, const Args& a, cudaStream_t stream) {
  switch (which) {
    case 0: return launch_fwd<NJ>(a, stream);
    case 1: return launch_dq<NJ>(a, stream);
    default: return launch_dkv<NJ>(a, stream);
  }
}

cudaError_t by_head_dim(int which, const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<1>(which, a, stream);
  if (a.D <= 32) return launch<2>(which, a, stream);
  if (a.D <= 64) return launch<4>(which, a, stream);
  if (a.D <= 96) return launch<6>(which, a, stream);
  if (a.D <= 128) return launch<8>(which, a, stream);
  return cudaErrorInvalidValue;
}


template <int DT>
cudaError_t launch_tc(int which, const Args& a, cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  const int D = DT * 16;
  const dim3 grid(a.B * a.N, (a.S + TILE - 1) / TILE);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  cudaError_t e;
  if (which == 0) {
    CUtensorMap tq, tk, tv;
    if (!hopper::head_map(&tq, q, a.B, a.S, a.N, D) ||
        !hopper::head_map(&tk, k, a.B, a.S, a.N, D) ||
        !hopper::head_map(&tv, v, a.B, a.S, a.N, D))
      return cudaErrorInvalidValue;
    const size_t smem = hopper::smem_bytes<DT>();
    if ((e = prepare(hopper::fwd_kernel<DT>, smem)) != cudaSuccess) return e;
    hopper::fwd_kernel<DT><<<grid, hopper::THREADS, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(a.o), a.lse_out, a.S, a.N, a.causal);
  } else {
    CUtensorMap tq, tk, tv, tdo;
    if (!hopper::head_map(&tq, q, a.B, a.S, a.N, D) ||
        !hopper::head_map(&tk, k, a.B, a.S, a.N, D) ||
        !hopper::head_map(&tv, v, a.B, a.S, a.N, D) ||
        !hopper::head_map(&tdo, a.dout, a.B, a.S, a.N, D))
      return cudaErrorInvalidValue;
    if (which == 1) {
      const size_t smem = hopper::dq_smem_bytes<DT>();
      if ((e = prepare(hopper::dq_kernel<DT>, smem)) != cudaSuccess) return e;
      hopper::dq_kernel<DT><<<grid, hopper::THREADS, smem, stream>>>(
          tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.S, a.N, a.causal);
    } else {
      const size_t smem = hopper::dkv_smem_bytes<DT>();
      if ((e = prepare(hopper::dkv_kernel<DT>, smem)) != cudaSuccess) return e;
      hopper::dkv_kernel<DT><<<grid, hopper::THREADS, smem, stream>>>(
          tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
          a.S, a.N, a.causal);
    }
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tensor-core kernels take bf16 with D a multiple of 16 and 16-byte
// aligned operands.
cudaError_t by_head_dim_tc(int which, const Args& a, cudaStream_t stream) {
  switch (a.D / 16) {
    case 1: return launch_tc<1>(which, a, stream);
    case 2: return launch_tc<2>(which, a, stream);
    case 3: return launch_tc<3>(which, a, stream);
    case 4: return launch_tc<4>(which, a, stream);
    case 5: return launch_tc<5>(which, a, stream);
    case 6: return launch_tc<6>(which, a, stream);
    case 7: return launch_tc<7>(which, a, stream);
    default: return launch_tc<8>(which, a, stream);
  }
}

int run(int which, const Args& a, int dtype, cudaStream_t stream) {
  if (a.B * a.N == 0 || a.S == 0) return 0;
  if (a.D % 8 != 0 || a.D > 128) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DST_DTYPE_F32: return (int)by_head_dim(which, a, stream);
    case DST_DTYPE_BF16:
      if (a.D % 16 != 0 || !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
          !aligned16(a.dout) || !aligned16(a.o) || !aligned16(a.dq) || !aligned16(a.dk) ||
          !aligned16(a.dv))
        return (int)cudaErrorInvalidValue;
      return (int)by_head_dim_tc(which, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dst_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int S, int N, int D, int causal, int dtype,
                             cudaStream_t stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.B = B; a.S = S; a.N = N; a.D = D; a.causal = causal;
  return run(0, a, dtype, stream);
}

extern "C" int dst_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, int B, int S,
                                int N, int D, int causal, int dtype, cudaStream_t stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  a.B = B; a.S = S; a.N = N; a.D = D; a.causal = causal;
  return run(1, a, dtype, stream);
}

extern "C" int dst_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv, int B,
                                 int S, int N, int D, int causal, int dtype,
                                 cudaStream_t stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.B = B; a.S = S; a.N = N; a.D = D; a.causal = causal;
  return run(2, a, dtype, stream);
}
