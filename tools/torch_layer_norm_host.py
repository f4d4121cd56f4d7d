#!/usr/bin/env python3
"""Host cost of one LayerNorm forward call of the PyTorch port, on the card.

    python3 tools/torch_layer_norm_host.py [--root CHECKOUT] [--label NAME]

For ``normalize.layer_norm`` of the checkout at ``--root`` (this one by
default; another checkout, such as a ``git archive`` of a parent commit,
to compare two trees in one run) at 64 and 4096 rows of H 768 in bf16, it
prints the host microseconds of one call (300 calls on the host clock with
no synchronize inside, over the count) with gamma/beta in bf16 and in
fp32, with grad mode on and under ``inference_mode``, beside
``F.layer_norm``'s; then the device time of the kernel alone
(``_ln_cuda``, 20 bare launches captured in a CUDA graph) beside
``F.layer_norm``'s.  Needs a CUDA device; exits 2 without one.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_us(torch, fn, iters=300):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def graph_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout to measure")
    ap.add_argument("--label", default="tree", help="a name for the printed lines")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_layer_norm_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from deeperspeed_tpu_torch.ops.transformer import normalize

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev, bf16, H = torch.device("cuda"), torch.bfloat16, 768
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows in (64, 4096):
        x = torch.randn(rows, H, generator=gen, device=dev).to(bf16)
        g32 = 1 + 0.1 * torch.randn(H, generator=gen, device=dev)
        b32 = 0.1 * torch.randn(H, generator=gen, device=dev)
        g16, b16 = g32.to(bf16), b32.to(bf16)
        out = {}
        for mode in ("grad_on", "inference_mode"):
            ctx = torch.inference_mode() if mode == "inference_mode" else torch.enable_grad()
            with ctx:
                out[f"{mode} gamma bf16"] = host_us(torch, lambda: normalize.layer_norm(x, g16, b16))
                out[f"{mode} gamma fp32"] = host_us(torch, lambda: normalize.layer_norm(x, g32, b32))
                out[f"{mode} F.layer_norm"] = host_us(
                    torch, lambda: F.layer_norm(x, (H,), g16, b16, 1e-5))
        kernel = graph_ms(torch, lambda: normalize._ln_cuda(x, g32, b32, 1e-5, False))
        library = graph_ms(torch, lambda: F.layer_norm(x, (H,), g16, b16, 1e-5))
        print(f"[layer_norm host {args.label}] {card} rows={rows} H={H} bf16: " + " ".join(
            f"{k}={v:.2f}us" for k, v in out.items())
            + f" | device: _ln_cuda {kernel:.4f} ms, F.layer_norm {library:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
