#!/usr/bin/env python3
"""Phases 26 and 27 of ``chip_smoke.py`` (pipelines) alone, on the card.

    python3 tools/torch_pipe_phase.py

Builds the kernels and the host libraries, turns TF32 off (``chip_smoke.py``
does so in phase 4), then runs phase 26: the two ``--pipe-worker`` stage
processes ((a) 1f1b and (b) gpipe on Pythia-160M at pp 2, both at gas 8 for
their memory, phase 27 (c)'s host update, (c) Llama-2-7B's width at 4
layers) and the four ``--pipe-dp-worker`` processes ((d) the interpreted
engine at pp 2 x dp 2), started together and joined after the flat runs
this process makes, then (d)'s checkpoint reloaded at pp 1; then phase 27:
the four ``--pipe-tp-worker`` processes (pp 2 x tp 2: (a) Pythia-160M, (b)
Llama-2-7B's width at 4 layers) beside (d), ZeRO-Infinity over
``GPTNeoXPipe``.  Prints ``chip_smoke.py``'s lines for them, their launches
and their seconds.  Exits 1 if one failed, 2 without a CUDA device.
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
        print("torch_pipe_phase: no CUDA device", file=sys.stderr)
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
        paths, p26 = cs.phase_pipeline(torch, np, card)
        print(f"[part] phase 26: {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        paths.update(cs.phase_pipe_tp(torch, np, card, p26))
        print(f"[part] phase 27: {time.perf_counter() - t:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        cs.stop_held_workers()
    print(f"[launches] {json.dumps(paths)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
