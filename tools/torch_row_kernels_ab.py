#!/usr/bin/env python3
"""K1, K4 and B8 of the PyTorch port at ``chip_smoke.py`` phase 3's shapes,
for one checkout, on the card.

    python3 tools/torch_row_kernels_ab.py [--root CHECKOUT] [--label NAME]

Imports the kernels of the checkout at ``--root`` (this one by default;
another checkout, such as a ``git archive`` of a parent commit, to compare
two trees on one card: run parent, change, change, parent in one call) and
prints one line a row, each with the card's name and power limit:

- K1 ``layer_norm`` at rows 64 and 4096 of H 768, bf16 x, gamma and beta:
  the public call (200 back to back) and the kernel alone (``_ln_cuda``,
  20 bare launches in a CUDA graph);
- K4 ``sorted_topk`` at 64 and 8 rows of 50,304, k 50: the call, the kernel
  alone, ``torch.topk``;
- B8 at [16, 12, 1024, 1024] bf16, [4, 12, 1024, 1024] fp32 and
  [4, 12, 1024, 1000] bf16, scale 0.125: the forward (call and alone),
  ``torch.softmax`` of the pre-scaled input, the backward and
  ``torch._softmax_backward_data``.

Timing is ``chip_smoke.py``'s (CUDA events over warm launches).  Needs a
CUDA device; exits 2 without one.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """This checkout's chip_smoke.py (its timers), whatever --root is."""
    spec = importlib.util.spec_from_file_location("_smoke_timers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout to measure")
    ap.add_argument("--label", default="tree", help="a name for the printed lines")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_row_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from deeperspeed_tpu_torch.ops import cuda_utils
    from deeperspeed_tpu_torch.ops.sampling import topk
    from deeperspeed_tpu_torch.ops.transformer import normalize, softmax

    cuda_utils.build(["layer_norm", "topk", "softmax"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    ms, graph = smoke._time_ms, smoke._graph_ms
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def line(what, **vals):
        print(f"[rows {args.label}] {card} {what}: "
              + " ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)

    H = 768
    for rows in (64, 4096):
        x = torch.randn(rows, H, generator=gen, device=dev).to(bf16)
        g = (1 + 0.1 * torch.randn(H, generator=gen, device=dev)).to(bf16)
        b = (0.1 * torch.randn(H, generator=gen, device=dev)).to(bf16)
        line(f"K1 layer_norm rows={rows} H={H} bf16",
             ms=ms(torch, lambda: normalize.layer_norm(x, g, b), iters=200),
             device_ms=graph(torch, lambda: normalize._ln_cuda(x, g, b, 1e-5, False)),
             library_ms=ms(torch, lambda: F.layer_norm(x, (H,), g, b, 1e-5), iters=200))

    V, k = 50304, 50
    for rows in (64, 8):
        x = torch.randn(rows, V, generator=gen, device=dev)
        line(f"K4 sorted_topk rows={rows} V={V} k={k} fp32",
             ms=ms(torch, lambda: topk.sorted_topk(x, k)),
             device_ms=graph(torch, lambda: topk._topk_cuda(x, k)),
             library_ms=ms(torch, lambda: torch.topk(x, k)))
        del x

    for shape, dtype in (((16, 12, 1024, 1024), bf16), ((4, 12, 1024, 1024), torch.float32),
                         ((4, 12, 1024, 1000), bf16)):
        x = (4 * torch.randn(*shape, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        xs, scale = x * 0.125, 0.125
        y = softmax._fwd_cuda(x, scale)
        line(f"B8 softmax {list(shape)} {str(dtype).replace('torch.', '')}",
             fwd_ms=ms(torch, lambda: softmax._fwd_cuda(x, scale)),
             fwd_device_ms=graph(torch, lambda: softmax._fwd_cuda(x, scale)),
             library_fwd_ms=ms(torch, lambda: torch.softmax(xs, dim=-1)),
             bwd_ms=ms(torch, lambda: softmax._bwd_cuda(y, dy, scale)),
             library_bwd_ms=ms(torch, lambda: torch._softmax_backward_data(dy, y, -1, dtype)))
        del x, dy, xs, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
