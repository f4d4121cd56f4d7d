// Building blocks of the Hopper (sm_90a) attention kernels: flash attention
// K5-K7 (flash_attention.cu) and the block-sparse passes of B10
// (sparse_attention.cu).  Each source that includes this header builds its
// own library, so everything here has internal linkage (an anonymous
// namespace), as the kernels that use it do.
//
// A 64-row tile of a [B, S, N, D] bf16 tensor reaches shared memory by TMA
// as one or two boxes of 64 rows x 64 columns (128-byte swizzle; columns
// past D and rows past S arrive as zeros), and is read by `wgmma` through
// a 128-byte-swizzle descriptor, K-major (a score product) or MN-major
// (the transpose bit; the B of an accumulation).  Here:
//
// * mbarriers: `mbar_init`, `mbar_expect_tx`, and `mbar_wait`, a bounded
//   wait that traps after ~10 s instead of hanging the card;
// * `tma_load` of one box, and `load_pair`, which fills a stage of a
//   two-stage ring with the same 64 rows of two tensors;
// * `desc`, the swizzled shared-memory matrix descriptor;
// * `wgmma_ss` (A and B in shared memory) and `wgmma_rs` (A in registers,
//   B MN-major), 64 x 64 x 16 each, with the accumulator fence
//   `fence_regs` and the group fences;
// * `issue_scores`, A B^T of two 64-row K-major tiles; `pack_a`, a score
//   tile as the register A operand of the next product, rounded to bf16;
// * `store_rows`, a thread's accumulator fragments stored as bf16;
// * `head_map`, the tensor map of a [B, S, N, D] tensor, encoded through
//   `cudaGetDriverEntryPoint` (no -lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <cstdint>

#include "common.cuh"

namespace {
namespace hopper {

constexpr int TILE = 64;                     // rows of a tile
constexpr int THREADS = 128;                 // one warpgroup
constexpr uint32_t BOX_BYTES = TILE * 128;   // 64 rows of 64 bf16 columns
constexpr uint32_t ATOM_BYTES = 1024;        // 8 swizzled 128-byte rows

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max and sum over the four lanes that hold one row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A load that never
// lands traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// One box of a [B, S, N, D] tensor: columns c0.., head n, rows s0.., batch b.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int n, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(n), "r"(s0),
        "r"(b)
      : "memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle; byte offsets
// `lbo` and `sbo` (the tile bases are 1024-byte aligned, so base offset 0).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

#define DST_WG_D32(d)                                                                     \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),   \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),             \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),             \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),             \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),             \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

#define DST_WG_REGS32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B for a 64 x 64 x 16 step, A and B K-major in shared memory;
// d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DST_WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DST_WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for a 64 x 64 x 16 step, A (bf16 pairs) in registers, B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DST_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DST_WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Rows row0 .. row0+63 of head (b, n) of two tensors (K and V for K5, Q and
// dO for K6) into stage `st` of the ring at `ring` (the first tensor, then
// the second, DB boxes each), arming the stage's mbarrier for the full
// boxes (out-of-bounds bytes count).
template <int DB>
__device__ __forceinline__ void load_pair(uint32_t ring, uint32_t bars, const CUtensorMap* ta,
                                          const CUtensorMap* tb, int st, int row0, int n,
                                          int b) {
  constexpr uint32_t TILE_BYTES = DB * BOX_BYTES;
  const uint32_t ast = ring + 2 * TILE_BYTES * st;
  const uint32_t bar = bars + 8 + 8 * st;
  mbar_expect_tx(bar, 2 * TILE_BYTES);
#pragma unroll
  for (int box = 0; box < DB; ++box) {
    tma_load(ast + box * BOX_BYTES, ta, bar, 64 * box, n, row0, b);
    tma_load(ast + TILE_BYTES + box * BOX_BYTES, tb, bar, 64 * box, n, row0, b);
  }
}

// s = A B^T for two 64-row tiles, both K-major over D (K5: Q K^T; K6: K Q^T
// and V dO^T): DT k-steps of 16, each 32 bytes further along the swizzled
// 128-byte rows, the second box from k-step 4; issued and committed, the
// caller waits.
template <int DT>
__device__ __forceinline__ void issue_scores(float (&s)[8][4], uint32_t as, uint32_t bs) {
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < DT; ++ks) {
    const uint32_t off = (ks >> 2) * BOX_BYTES + (ks & 3) * 32;
    wgmma_ss(s, desc(as + off, 16, ATOM_BYTES), desc(bs + off, 16, ATOM_BYTES), ks > 0);
  }
  wg_commit();
}

// The A operand of one k-step of 16 columns from two 8-column score tiles
// in the accumulator's layout, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// Write rows (row, row + 8) of a 64 x D accumulator (DB boxes of 64
// columns; each warp holds its 16 rows in the `mma.sync` C layout) as
// bf16, scaled; columns past D and rows past S are dropped.
template <int DT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[(DT + 3) / 4][8][4], int b, int n,
                                           int row, int S, int N, int t, float scale0,
                                           float scale1) {
  constexpr int D = DT * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= S) continue;
    const float sc = h ? scale1 : scale0;
    bf16* base = out + (((size_t)b * S + r) * N + n) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 2 * DT; ++dt)
      *reinterpret_cast<uint32_t*>(base + 8 * dt) =
          pack(acc[dt >> 3][dt & 7][2 * h] * sc, acc[dt >> 3][dt & 7][2 * h + 1] * sc);
  }
}


#undef DST_WG_D32
#undef DST_WG_REGS32

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (the
// library links no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a [B, S, N, D] bf16 tensor as dims (D, N, S, B), with a
// box of 64 columns x 1 head x 64 rows, 128-byte swizzle, zero fill.
bool head_map(CUtensorMap* map, const void* base, int B, int S, int N, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2,
                                 (cuuint64_t)S * N * D * 2};
  const cuuint32_t box[4] = {64, 1, TILE, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace
