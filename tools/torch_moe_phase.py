#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` (MoE) alone, on the card.

    python3 tools/torch_moe_phase.py [PART ...]

Builds the kernels, turns TF32 off (``chip_smoke.py`` does so in phase 4),
then runs the parts named (all by default), in order: ``checked`` ((a):
tiny MoE card against CPU), ``trained`` ((b): Pythia-160M-MoE-8 at phase
9's step, top-1 then top-2), ``ep`` ((c): two processes at ep 2 and tp 2
against one) and ``served`` ((d): the v2 engine at batch 32, then v1
against v2).  Each part prints ``chip_smoke.py``'s lines for it and its
seconds; a part that fails prints its traceback and the next one runs.
Exits 1 if any part failed, 2 without a CUDA device.
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
        print("torch_moe_phase: no CUDA device", file=sys.stderr)
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = cuda_utils.LAUNCHES
    parts = {
        "checked": lambda: cs.phase_moe_checked(torch, np),
        "trained": lambda: cs.phase_moe_trained(torch, np, launches, card),
        "ep": lambda: cs.phase_moe_ep(torch, np, card),
        "served": lambda: cs.phase_moe_served(torch, np, launches, card),
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
