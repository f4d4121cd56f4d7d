#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` (offload) alone, on the card, and with
``planners`` phase 25 (the planners) after it.

    python3 tools/torch_offload_phase.py [dp] [planners]

Builds the kernels and the host libraries, turns TF32 off (``chip_smoke.py``
does so in phase 4), prints the host's memory, cores and CPU, then runs
phase 24's parts (a)-(e): the host update of Pythia-1.4B against the device
update, the pinned-host tier, the NVMe tier and ZeRO-Infinity at 1.4B's
width and 4 layers, and the async checkpoint writer.  With ``dp`` it first runs
phases 13-14 (two ``--dp-worker`` processes, ~3-4 minutes), whose workers
run (f), the pinned-host tier at world 2, and (c) of phase 25, and checks
them.  Prints ``chip_smoke.py``'s lines and each part's seconds; exits 1 if
a phase failed, 2 without a CUDA device.
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
        print("torch_offload_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deeperspeed_tpu_torch import op_builder
    from deeperspeed_tpu_torch.ops import cuda_utils

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    cpu = next((line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
                if line.startswith("model name")), "unknown")
    print(card, torch.__version__, torch.version.cuda, flush=True)
    cores = subprocess.run(["nproc"], capture_output=True, text=True).stdout.strip()
    print(f"[host] {cpu}; {cores} cores; {cs._host_available_gb():.1f} GiB available",
          flush=True)
    t = time.perf_counter()
    cuda_utils.build()
    op_builder.CPUAdamBuilder().build()
    op_builder.AsyncIOBuilder().build()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp_ranks = None
    try:
        if "dp" in sys.argv[1:]:
            t = time.perf_counter()
            dp_ranks = cs.phase_dp(torch, np)[2]
            print(f"[part] phases 13-14: {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        phase = "phase 24"
        paths, inf = cs.phase_offload(torch, np, cuda_utils.LAUNCHES, card, dp_ranks)
        print(f"[part] phase 24: {time.perf_counter() - t:.1f} s; launches by path {paths}",
              flush=True)
        if "planners" in sys.argv[1:]:
            t = time.perf_counter()
            phase = "phase 25"
            paths = cs.phase_planners(torch, np, cuda_utils.LAUNCHES, card, dp_ranks, inf)
            print(f"[part] phase 25: {time.perf_counter() - t:.1f} s; launches by path "
                  f"{paths}", flush=True)
    except Exception:
        traceback.print_exc()
        print(f"failed: {phase}", flush=True)
        return 1
    print("failed: []", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
