#!/usr/bin/env python3
"""K4 (sorted top-k) phase by phase, on the card.

    python3 tools/torch_topk_phases.py

Builds a small library that includes ``deeperspeed_tpu_torch/csrc/topk.cu``
and launches:

- ``topk_radix_kernel<STOP>``, the radix kernel cut after phase STOP (0 the
  launch alone, 1 the pass over the row for each thread's largest key and
  the NaN flag, 2 the select of the k-th largest of those, 3 the gather of
  the keys at or above it, 4 the sort and the write: the whole kernel), so
  the differences of their times are the phases';
- ``hist_kernel<MODE>``, a kernel of its own: one histogram pass of the
  keys' top 11 bits into 2048 shared bins (the fallback path's pass, over
  the same loads), with the bins added three ways: one shared atomic a
  value (what K4 does), one atomic for the lanes of a warp that share a
  bin (``__match_any_sync``), or into four sub-histograms picked by lane.

For 64 and 8 rows of 50,304 ``randn`` logits (phase 3's and the served
shape), k 50, and for 64 rows of three values repeated (the bins the tie
test crowds), it checks that the cut-after-4 kernel equals
``sorted_topk`` and the three histograms agree and sum to V, and prints
each time (20 launches captured in a CUDA graph, its replay timed with
CUDA events: the device's time alone) with the card's name and power
limit.  Needs nvcc and a CUDA device; exits 2 without one.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "topk.cu"

namespace {
constexpr int COPIES = 4, STRIDE = BINS + 1;   // lane-indexed sub-histograms, banks apart

template <int MODE>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, uint32_t* __restrict__ out, int V, int vec) {
  __shared__ uint32_t hist[COPIES * STRIDE];
  for (int b = threadIdx.x; b < COPIES * STRIDE; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for_each_tile(x + (size_t)blockIdx.x * V, V, vec, [&](int, const float* v, int n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = c < n;
      const uint32_t bin = order_key(in ? v[c] : 0.f) >> 21;
      if (MODE == 1) {
        const unsigned peers = __match_any_sync(0xffffffffu, in ? bin : 0xffffffffu);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      } else if (in) {
        atomicAdd(&hist[(MODE == 2 ? (lane & (COPIES - 1)) * STRIDE : 0) + bin], 1u);
      }
      if (!vec) break;
    }
  });
  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += kThreads) {
    uint32_t h = hist[b];
    if (MODE == 2)
      for (int c = 1; c < COPIES; ++c) h += hist[c * STRIDE + b];
    out[(size_t)blockIdx.x * BINS + b] = h;
  }
}
}  // namespace

extern "C" int dst_topk_phases(const float* x, float* vals, int* idx, int rows, int V, int k,
                               int cut, cudaStream_t stream) {
  switch (cut) {
    case LAUNCHED: return launch_radix<LAUNCHED>(x, vals, idx, rows, V, k, stream);
    case TOPS: return launch_radix<TOPS>(x, vals, idx, rows, V, k, stream);
    case SELECTED: return launch_radix<SELECTED>(x, vals, idx, rows, V, k, stream);
    case GATHERED: return launch_radix<GATHERED>(x, vals, idx, rows, V, k, stream);
    default: return launch_radix<ALL>(x, vals, idx, rows, V, k, stream);
  }
}

extern "C" int dst_topk_hist(const float* x, uint32_t* out, int rows, int V, int mode,
                             cudaStream_t stream) {
  const int vec = V % 4 == 0;
  if (mode == 0) hist_kernel<0><<<rows, kThreads, 0, stream>>>(x, out, V, vec);
  else if (mode == 1) hist_kernel<1><<<rows, kThreads, 0, stream>>>(x, out, V, vec);
  else hist_kernel<2><<<rows, kThreads, 0, stream>>>(x, out, V, vec);
  return (int)cudaGetLastError();
}
"""

PHASES = {0: "launch", 1: "pass 1 (tops, NaN)", 2: "select over tops", 3: "gather",
          4: "sort + write"}
MODES = {0: "one atomic a value (K4)", 1: "warp-aggregated", 2: "4 lane sub-histograms"}


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_topk_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _graph_ms
    from deeperspeed_tpu_torch.ops import cuda_utils
    from deeperspeed_tpu_torch.ops.sampling import topk

    out_dir = cuda_utils.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "topk_phases.cu", out_dir / "topk_phases.so"
    src.write_text(SOURCE)
    build = subprocess.run([cuda_utils._nvcc(), *cuda_utils.NVCC_FLAGS, "-I",
                            str(cuda_utils.CSRC), "-o", str(lib_path), str(src)],
                           capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dst_topk_phases.argtypes, lib.dst_topk_phases.restype = [vp, vp, vp] + [i] * 4 + [vp], i
    lib.dst_topk_hist.argtypes, lib.dst_topk_hist.restype = [vp, vp, i, i, i, vp], i
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    V, k = 50304, 50
    cases = {"randn rows=64": torch.randn(64, V, generator=gen, device="cuda"),
             "randn rows=8": torch.randn(8, V, generator=gen, device="cuda"),
             "three values rows=64": torch.randint(0, 3, (64, V), generator=gen,
                                                   device="cuda").float()}
    for what, x in cases.items():
        rows = x.shape[0]
        hists = {m: torch.empty(rows, 2048, dtype=torch.int32, device="cuda") for m in MODES}

        def hist(mode):
            if lib.dst_topk_hist(x.data_ptr(), hists[mode].data_ptr(), rows, V, mode,
                                 torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("histogram launch failed")

        times = {m: _graph_ms(torch, lambda: hist(m)) for m in MODES}
        if not (all(torch.equal(hists[0], h) for h in hists.values())
                and bool((hists[0].sum(1) == V).all())):
            raise AssertionError(f"{what}: the histograms disagree")
        print(f"[topk histogram pass] {card} {what} V={V}: " + ", ".join(
            f"{MODES[m]} {t:.4f} ms" for m, t in times.items()), flush=True)
        if what.startswith("three"):
            continue
        vals = torch.empty(rows, k, device="cuda")
        idx = torch.empty(rows, k, dtype=torch.int32, device="cuda")

        def cut(p):
            if lib.dst_topk_phases(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, V, k,
                                   p, torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("phases launch failed")

        cum = {p: _graph_ms(torch, lambda: cut(p)) for p in PHASES}
        want_v, want_i = topk.sorted_topk(x, k)
        cut(4)
        if not (torch.equal(idx, want_i) and torch.equal(vals, want_v)):
            raise AssertionError(f"{what}: the whole phases kernel disagrees with sorted_topk")
        whole = _graph_ms(torch, lambda: topk._topk_cuda(x, k))
        print(f"[topk phases] {card} {what} V={V} k={k}: " + ", ".join(
            f"{PHASES[p]} {cum[p] - (cum[p - 1] if p else 0):.4f} ms" for p in PHASES)
            + f"; cut after 4 {cum[4]:.4f} ms, sorted_topk's kernel {whole:.4f} ms",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
