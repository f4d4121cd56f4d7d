#!/usr/bin/env python3
"""Phase 28 of ``chip_smoke.py`` (sequence parallelism) alone, on the card.

    python3 tools/torch_sequence_phase.py

Builds the kernels and the host libraries, turns TF32 off (``chip_smoke.py``
does so in phase 4), then runs phase 28: the two ``--sp-worker`` processes
((a) Pythia-160M at seq 2048 at sp 1 (dp 2), then at sp 2 under ``ulysses``
and ``ring``; (b) Llama-2-7B's width at 2 layers at sp 2 and sp 1), joined
and held against each other.  Prints ``chip_smoke.py``'s lines, the
launches and the seconds.  Exits 1 if the phase failed, 2 without a CUDA
device.
"""

import json
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
        print("torch_sequence_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deeperspeed_tpu_torch import op_builder
    from deeperspeed_tpu_torch.ops import cuda_utils

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t = time.perf_counter()
    cuda_utils.build()
    for builder in (op_builder.CPUAdamBuilder(), op_builder.AsyncIOBuilder()):
        builder.build()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    try:
        paths = cs.phase_sequence(torch, np, card)
        print(f"[part] phase 28: {time.perf_counter() - t:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        cs.stop_held_workers()
    print(f"[launches] {json.dumps(paths)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
