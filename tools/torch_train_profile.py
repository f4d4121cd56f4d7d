#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on the card.

    python3 tools/torch_train_profile.py [--fused] [--json PATH]

Trains ``chip_smoke.py``'s trained configuration (``TRAIN_CONFIG``,
``trained_model``, ``trained_batch``: bench.py's step, Pythia-160M in bf16,
batch 16 of 1024 tokens, Adam, clip 1.0, ZeRO-0, random weights from a
seed) through ``deeperspeed_tpu_torch.initialize`` and
``engine.train_batch``: 2 warm-up steps, then ``torch.profiler`` traces 3
steps.  ``--fused`` trains phase 11's configuration instead
(``FUSED_TRAIN_CONFIG``, ``fused_trained_model``, ``fused_training_data``:
the same step with FusedAdam, ``ce_chunk_tokens`` 4096 and block recompute,
fed through ``training_data=`` and ``train_batch()``).  It prints one JSON line: the host wall time per step (ending in a
synchronize), the device time per step summed over kernels, the device's
idle share (1 - device/wall, unclamped: a negative share means kernels
were counted twice or overlap), and the kernels in order of device time;
``--json`` also writes the whole report, every kernel included under its
full name, to PATH.
Needs a CUDA device; exits 2 without one.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARMUP, STEPS = 2, 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the full report to this file")
    ap.add_argument("--fused", action="store_true",
                    help="profile phase 11's configuration (FusedAdam, chunked "
                         "loss, block recompute, training_data=)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from chip_smoke import (FUSED_TRAIN_CONFIG, TRAIN_CONFIG, fused_trained_model,
                            fused_training_data, trained_batch, trained_model)

    import deeperspeed_tpu_torch as dst

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    if args.fused:
        model = fused_trained_model()
        engine = dst.initialize(model=model, config=FUSED_TRAIN_CONFIG,
                                training_data=fused_training_data(
                                    np, model.config.vocab_size))[0]
        batch = None                          # train_batch() pulls from the loader
    else:
        model = trained_model()
        engine = dst.initialize(model=model, config=TRAIN_CONFIG)[0]
        batch = {k: v.cuda() for k, v in trained_batch(model).items()}
    for _ in range(WARMUP):
        engine.train_batch(batch=batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key
        ms, calls = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + us / 1e3, calls + evt.count)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    report = {
        "card": card, "torch": torch.__version__, "steps": STEPS,
        "config": "fused" if args.fused else "trained",
        "loss": float(loss),
        "wall_ms_per_step": wall * 1e3 / STEPS,
        "device_ms_per_step": busy / STEPS,
        "device_idle_share": 1.0 - busy / (wall * 1e3),
        "kernels": [{"name": n, "ms_per_step": ms / STEPS,
                     "launches_per_step": c / STEPS} for n, (ms, c) in top],
    }
    print(f"[train] {card}: wall {report['wall_ms_per_step']:.3f} ms/step, device "
          f"{report['device_ms_per_step']:.3f} ms/step, idle share "
          f"{report['device_idle_share']:.3f}", flush=True)
    for k in report["kernels"][:20]:
        print(f"    {k['ms_per_step']:9.4f} ms  x{k['launches_per_step']:7.1f}  "
              f"{k['name'][:90]}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
