#!/usr/bin/env python3
"""Where a serving round of the PyTorch port spends its time on the card.

    python3 tools/torch_serving_profile.py [--json PATH]

Serves ``chip_smoke.py``'s served configuration (``SERVED_ECFG``,
``served_model``, ``served_prompts``: Pythia-160M in bf16, random weights
from a seed, a 4096 x 16 block KV pool, prompts of 128-512 tokens) through
``deeperspeed_tpu_torch``'s ``InferenceEngineV2``, then traces with
``torch.profiler`` two windows: one prefill round of 8 prompts, and 8
pure-decode rounds at ``SERVED_BATCH`` sequences.  A third window is the
scheduled configuration (``scheduled_ecfg``, ``scheduled_prompts``: an fp8
KV pool, n-gram speculation with k 4, ``SCHEDULED_BATCH`` sequences behind
``DSScheduler``): 8 scheduler steps once every prompt is decoding, drafter,
quantize-on-write and the K2q/K3q kernels included.  For each window it
prints one JSON line: the host wall time per round (ending in a
synchronize), the device time per round summed over kernels, the device's
idle share (1 - device/wall, unclamped: a negative share means kernels were
counted twice or overlap), and the kernels in order of device time;
``--json`` also writes the whole report, every kernel included, to PATH.
Needs a CUDA device; exits 2 without one.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_ROUNDS = 8
PREFILL_PROMPTS = 8


def _window(torch, profile, activities, fn, rounds):
    """Trace ``rounds`` calls of ``fn``; per-round wall and device times."""
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key[:90]
        ms, calls = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + us / 1e3, calls + evt.count)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "rounds": rounds,
        "wall_ms_per_round": wall * 1e3 / rounds,
        "device_ms_per_round": busy / rounds,
        "device_idle_share": 1.0 - busy / (wall * 1e3),
        "kernels": [{"name": n, "ms_per_round": ms / rounds,
                     "launches_per_round": c / rounds} for n, (ms, c) in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the full report to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (SCHEDULED_BATCH, SERVED_BATCH, SERVED_ECFG, scheduled_ecfg,
                            scheduled_prompts, served_model, served_prompts)
    from deeperspeed_tpu_torch.inference.v2 import DSScheduler, InferenceEngineV2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    model = served_model()
    eng = InferenceEngineV2(model, SERVED_ECFG)
    batch = SERVED_BATCH
    prompts = served_prompts(np, model.config.vocab_size, batch + PREFILL_PROMPTS)
    nxt = {}
    for lo in range(0, batch, PREFILL_PROMPTS):
        out = eng.put_round(list(range(lo, lo + PREFILL_PROMPTS)),
                            prompts[lo:lo + PREFILL_PROMPTS])
        nxt.update({lo + i: int(t) for i, t in enumerate(out.tokens[:, -1])})
    uids = list(range(batch))

    def decode():
        out = eng.put_round(uids, [[nxt[u]] for u in uids])
        nxt.update({u: int(out.tokens[i, -1]) for i, u in enumerate(uids)})

    for _ in range(4):                      # warm the decode path
        decode()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    extra = list(range(batch, batch + PREFILL_PROMPTS))
    report = {
        "card": card, "torch": torch.__version__,
        "prefill": _window(torch, profile, acts, lambda: eng.put_round(
            extra, prompts[batch:]), 1),
        "decode": _window(torch, profile, acts, decode, DECODE_ROUNDS),
    }
    report["decode"]["batch"] = batch
    report["decode"]["tokens_per_s"] = (
        batch * 1e3 / report["decode"]["wall_ms_per_round"])
    del eng
    torch.cuda.empty_cache()

    # the scheduled path: every prompt prefilled and decoding, then traced
    seng = InferenceEngineV2(model, scheduled_ecfg(model.config.head_dim))
    sched = DSScheduler(seng)
    for u, p in enumerate(scheduled_prompts(np, model.config.vocab_size, SCHEDULED_BATCH)):
        sched.request(u, p)
    emitted = [0]

    def scheduled_step():
        for u, toks in sched.step().items():
            emitted[0] += len(toks)
            sched.request(u, [int(toks[-1])])

    while sched.waiting:
        scheduled_step()
    for _ in range(4):                      # warm the decode path
        scheduled_step()
    emitted[0] = 0
    report["scheduled_decode"] = _window(torch, profile, acts, scheduled_step,
                                         DECODE_ROUNDS)
    w = report["scheduled_decode"]
    w["batch"] = len(sched.live)
    w["speculative_k"] = sched.governor.effective_k
    w["tokens_per_round"] = emitted[0] / DECODE_ROUNDS
    w["tokens_per_s"] = w["tokens_per_round"] * 1e3 / w["wall_ms_per_round"]
    for key in ("prefill", "decode", "scheduled_decode"):
        w = report[key]
        print(f"[{key}] {card}: wall {w['wall_ms_per_round']:.3f} ms/round, "
              f"device {w['device_ms_per_round']:.3f} ms/round, idle share "
              f"{w['device_idle_share']:.3f}", flush=True)
        for k in w["kernels"][:12]:
            print(f"    {k['ms_per_round']:8.4f} ms  x{k['launches_per_round']:6.1f}  "
                  f"{k['name']}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] if k in ("card", "torch") else
                      {kk: vv for kk, vv in report[k].items() if kk != "kernels"}
                      for k in report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
