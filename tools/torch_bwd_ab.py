#!/usr/bin/env python3
"""The flash backward (K6, K7) and the LayerNorm backward (K8) of the
PyTorch port, each alone on the card, for one checkout.

    python3 tools/torch_bwd_ab.py [--root CHECKOUT] [--label NAME]

Imports the kernels of the checkout at ``--root`` (this one by default;
another checkout, such as a ``git archive`` of a parent commit, to compare
two trees on one card: run parent, change, change, parent in one call) and
prints one line a row, each with the card's name and power limit:

- K7 ``flash_bwd_dq`` and K6 ``flash_bwd_dkv`` at ``chip_smoke.py`` phase
  3's five shapes (bf16), each alone: 20 launches captured in a CUDA graph
  (``chip_smoke._graph_ms``);
- K8 ``layer_norm_bwd`` at rows 16384, H 768 in bf16 (gamma in fp32, which
  every tree takes): the whole call timed with CUDA events; the call from
  a CUDA graph (its kernels and fills, no host work); the device time of
  each kernel the call launches, by name, from ``torch.profiler`` over 20
  calls; and ``aten.native_layer_norm_backward`` alone, event-timed and
  from a graph, on the saved mean and rstd of ``aten.native_layer_norm``.

Needs a CUDA device; exits 2 without one.
"""

import argparse
import importlib.util
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH_SHAPES = ((16, 1024, 12, 64, True), (4, 1000, 12, 64, True), (4, 1024, 16, 128, True),
                (4, 1024, 12, 64, False), (1, 4096, 12, 64, True))
LN_ROWS, LN_H = 16384, 768


def _smoke():
    """This checkout's chip_smoke.py (its timers), whatever --root is."""
    spec = importlib.util.spec_from_file_location("_smoke_timers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels_ms(torch, fn, iters=20):
    """Device ms a call of ``fn`` spends in each kernel, by the kernel's
    name without its template arguments: ``torch.profiler`` over ``iters``
    calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].strip().replace(" ", "_")
            out[name] += e.self_device_time_total / 1e3 / iters
    return dict(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout to measure")
    ap.add_argument("--label", default="tree", help="a name for the printed lines")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from deeperspeed_tpu_torch.ops import cuda_utils
    from deeperspeed_tpu_torch.ops.attention import flash
    from deeperspeed_tpu_torch.ops.transformer import normalize

    cuda_utils.build(["flash_attention", "layer_norm"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    graph = smoke._graph_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def line(what, **vals):
        print(f"[bwd {args.label}] {card} {what}: "
              + " ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)

    for B, S, N, D, causal in FLASH_SHAPES:
        q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = flash._fwd_cuda(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
        dq_ms = graph(torch, lambda: flash._dq_cuda(q, k, v, do, lse, delta, causal))
        dkv_ms = graph(torch, lambda: flash._dkv_cuda(q, k, v, do, lse, delta, causal))
        line(f"K7 flash_bwd_dq B={B} S={S} N={N} D={D} {'causal' if causal else 'full'} bf16",
             dq_device_ms=dq_ms, dkv_device_ms=dkv_ms, dq_plus_dkv_device_ms=dq_ms + dkv_ms)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()

    x = (2 * torch.randn(LN_ROWS, LN_H, generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    dy = torch.randn(LN_ROWS, LN_H, generator=gen, device=dev).to(torch.bfloat16)
    g = 1 + 0.1 * torch.randn(LN_H, generator=gen, device=dev)

    def call():
        return normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)

    parts = _kernels_ms(torch, call)
    line(f"K8 layer_norm_bwd rows={LN_ROWS} H={LN_H} bf16",
         call_ms=smoke._time_ms(torch, call), call_device_ms=graph(torch, call),
         **{f"{name}_ms": ms for name, ms in sorted(parts.items())})
    wb = g.to(torch.bfloat16)
    bb = torch.zeros(LN_H, device=dev, dtype=torch.bfloat16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [LN_H], wb, bb, 1e-5)

    def library():
        return torch.ops.aten.native_layer_norm_backward(dy, x, [LN_H], mean, rstd, wb, bb,
                                                         [True, True, True])

    lib_parts = _kernels_ms(torch, library)
    line(f"aten.native_layer_norm_backward rows={LN_ROWS} H={LN_H} bf16 (bf16 weight)",
         ms=smoke._time_ms(torch, library), device_ms=graph(torch, library),
         **{f"{name}_ms": ms for name, ms in sorted(lib_parts.items())})
    return 0


if __name__ == "__main__":
    sys.exit(main())
