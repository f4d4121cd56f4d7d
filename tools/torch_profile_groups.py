#!/usr/bin/env python3
"""Group the kernels of profile reports into the families ``PERF.md`` tracks.

    python3 tools/torch_profile_groups.py REPORT.json [REPORT.json ...]

Reads reports written by ``tools/torch_train_profile.py --json`` (per step)
or ``tools/torch_serving_profile.py --json`` (per round, one window each:
prefill, decode, scheduled decode) and prints, for each report and window,
the wall and device milliseconds, the idle share, and the device
milliseconds and launches of each family of kernels.  A kernel belongs to
the first family whose pattern its name matches.  Runs anywhere: it reads
JSON only.
"""

import json
import re
import sys
from pathlib import Path

# (family, pattern over the kernel's name), first match wins
FAMILIES = [
    ("B10 block-sparse", r"hopper::sparse_(fwd|dq|dkv)_kernel|(tc|f32)::(fwd|dq|dkv)_kernel"),
    ("flash K5-K7", r"hopper::(fwd|dkv|dq)_kernel|flash_(fwd|bwd)"),
    ("LayerNorm K1 + K8", r"ln_fwd_kernel|ln_bwd"),
    ("paged K2/K3", r"paged_attention_kernel"),
    ("B6/B7 fused optimizers", r"adam_kernel|lion_kernel"),
    ("products", r"nvjet|gemm|Gemm|cutlass|xmma"),
    ("copies, casts and cat", r"copy|Copy|CatArray"),
    ("foreach", r"multi_tensor_apply|foreach"),
    ("reductions and exp", r"reduce|Reduce|softmax|exp"),
    ("other elementwise", r""),
]


def group(kernels, unit):
    out = {name: [0.0, 0.0] for name, _ in FAMILIES}
    for k in kernels:
        for name, pattern in FAMILIES:
            if re.search(pattern, k["name"]):
                out[name][0] += k[f"ms_per_{unit}"]
                out[name][1] += k[f"launches_per_{unit}"]
                break
    return out


def windows(report):
    if "kernels" in report:
        yield report.get("config", "train"), "step", report
    for key in ("prefill", "decode", "scheduled_decode"):
        if key in report:
            yield key, "round", report[key]


def main(paths):
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    for path in paths:
        report = json.loads(Path(path).read_text())
        for label, unit, w in windows(report):
            print(f"[groups] {path} {label}: wall {w[f'wall_ms_per_{unit}']:.3f} ms/{unit}, "
                  f"device {w[f'device_ms_per_{unit}']:.3f} ms/{unit}, idle share "
                  f"{w['device_idle_share']:.3f}")
            for name, (ms, n) in group(w["kernels"], unit).items():
                if n:
                    print(f"    {name:26s} {ms:9.4f} ms  x{n:8.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
