#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` (the Llama family) alone, on the card.

    python3 tools/torch_llama_phase.py [PART ...]

Builds the kernels, then runs the parts named (all by default), in order:
``kernels`` (the kernel rows at the family's shapes), ``served`` ((a) and
(c): Mistral-7B-v0.2's shape through the v2 engine, the scheduler and the
v1 engine in bf16 / int8 / int4), ``window`` ((b)), ``trained`` ((d)) and
``tp`` ((e), two processes at tp 2).  Each part prints ``chip_smoke.py``'s
lines for it and its seconds; a part that fails prints its traceback and
the next one runs.  Exits 1 if any part failed, 2 without a CUDA device.
"""

import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_llama_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deeperspeed_tpu_torch.ops import cuda_utils

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t = time.perf_counter()
    cuda_utils.build()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    launches = cuda_utils.LAUNCHES
    parts = {
        "kernels": lambda: cs.phase_llama_kernels(torch, {}),
        "served": lambda: cs.phase_llama_served(torch, np, launches, card),
        "window": lambda: cs.phase_llama_window(torch, np, launches, card),
        "trained": lambda: cs.phase_llama_trained(torch, np, launches, card),
        "tp": lambda: cs.phase_llama_tp(torch, np, card),
    }
    failed = []
    for name in sys.argv[1:] or list(parts):
        t = time.perf_counter()
        try:
            parts[name]()
        except Exception:       # report the part and go on with the next
            failed.append(name)
            traceback.print_exc()
        torch.cuda.empty_cache()
        print(f"[part] {name}: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
