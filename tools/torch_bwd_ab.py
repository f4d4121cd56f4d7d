#!/usr/bin/env python3
"""B9 and K6 of the PyTorch port at ``chip_smoke.py`` phase 3's shapes, for
one checkout, on the card.

    python3 tools/torch_bwd_ab.py [--root CHECKOUT] [--label NAME] [--digests FILE]

Imports the kernels of the checkout at ``--root`` (this one by default;
another checkout, such as a ``git archive`` of a parent commit, to compare
two trees on one card: run parent, change, change, parent in one call) and
prints one line a row, each with the card's name and power limit:

- B9 tanh-GELU forward and backward at [8192, 3072] in fp32, bf16 and
  fp16: the kernel alone (20 launches captured in a CUDA graph) beside
  ``F.gelu(approximate="tanh")`` and ``aten.gelu_backward``, timed the
  same way;
- K6 ``flash_bwd_dkv`` at phase 3's five shapes (bf16), alone from a CUDA
  graph, with K7 ``flash_bwd_dq`` beside it.

With ``--digests FILE`` the run writes the SHA-256 of each B9 output under
its label into FILE (JSON) and compares them with every other label's
already there: it exits 1 if any differ, so a second tree's B9 is held bit
for bit against the first's on the same inputs.

Timing is ``chip_smoke.py``'s (``_graph_ms``).  Needs a CUDA device; exits
2 without one.
"""

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH_SHAPES = ((16, 1024, 12, 64, True), (4, 1000, 12, 64, True), (4, 1024, 16, 128, True),
                (4, 1024, 12, 64, False), (1, 4096, 12, 64, True))


def _smoke():
    """This checkout's chip_smoke.py (its timers), whatever --root is."""
    spec = importlib.util.spec_from_file_location("_smoke_timers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(torch, t):
    """SHA-256 of a tensor's bytes."""
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return hashlib.sha256(t.contiguous().view(bits).cpu().numpy().tobytes()).hexdigest()


def _compare(path, label, digests):
    """Add this run's digests to the JSON file at ``path``; the labels whose
    digests differ from them."""
    path = Path(path)
    known = json.loads(path.read_text()) if path.exists() else {}
    differ = [other for other, theirs in known.items()
              if other != label and theirs != digests]
    known[label] = digests
    path.write_text(json.dumps(known, indent=1, sort_keys=True))
    return [other for other in known if other != label], differ


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout to measure")
    ap.add_argument("--label", default="tree", help="a name for the printed lines")
    ap.add_argument("--digests", help="a JSON file of B9 output digests by label")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from deeperspeed_tpu_torch.ops import cuda_utils
    from deeperspeed_tpu_torch.ops.attention import flash
    from deeperspeed_tpu_torch.ops.transformer import activations

    cuda_utils.build(["activations", "flash_attention"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    graph = smoke._graph_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def line(what, **vals):
        print(f"[bwd {args.label}] {card} {what}: "
              + " ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)

    digests = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype).replace("torch.", "")
        x = (3 * torch.randn(8192, 3072, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(8192, 3072, generator=gen, device=dev).to(dtype)
        digests[f"gelu_fwd {name}"] = _digest(torch, activations._gelu_cuda(x))
        digests[f"gelu_bwd {name}"] = _digest(torch, activations._dgelu_cuda(x, dy))
        line(f"B9 gelu [8192, 3072] {name}",
             fwd_device_ms=graph(torch, lambda: activations._gelu_cuda(x)),
             library_fwd_device_ms=graph(torch, lambda: F.gelu(x, approximate="tanh")),
             bwd_device_ms=graph(torch, lambda: activations._dgelu_cuda(x, dy)),
             library_bwd_device_ms=graph(torch, lambda: torch.ops.aten.gelu_backward(
                 dy, x, approximate="tanh")))
        del x, dy

    for B, S, N, D, causal in FLASH_SHAPES:
        q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = flash._fwd_cuda(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
        line(f"K6 flash_bwd_dkv B={B} S={S} N={N} D={D} {'causal' if causal else 'full'} bf16",
             dkv_device_ms=graph(torch, lambda: flash._dkv_cuda(q, k, v, do, lse, delta, causal)),
             dq_device_ms=graph(torch, lambda: flash._dq_cuda(q, k, v, do, lse, delta, causal)))
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()

    if args.digests:
        others, differ = _compare(args.digests, args.label, digests)
        print(f"[bwd {args.label}] B9 outputs against {others or 'no earlier run'}: "
              f"{'differ from ' + str(differ) if differ else 'equal bit for bit'}", flush=True)
        if differ:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
