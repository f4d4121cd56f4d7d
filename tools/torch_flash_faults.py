#!/usr/bin/env python3
"""Does chip_smoke.py's flash check fail a wrong kernel?

    python3 tools/torch_flash_faults.py

At the training shape of ``chip_smoke.py`` (B 16, S 1024, N 12, D 64,
causal, bf16, the same seeded inputs) it holds the outputs of K5 (O), K7
(dq) and K6 (dk, dv) against their plain versions with ``flash_shares``,
the check ``chip_smoke.py`` applies, and then holds the outputs that a
faulty kernel would write against the same plain versions:

- K5 or K7 skipping k tile 8 (keys 512-575) in its loop;
- K6 skipping q tile 8 (queries 512-575) in its loop;
- K7 leaving dq zero for queries 512 and above, K6 dk and dv for keys
  512 and above.

A faulty output is computed with plain PyTorch ops in the kernels' own
rounding (P and dS rounded to bf16 before their products).  It prints one
line per output (the share of its limit that the worst element and the
worst head used; above 1 fails the check) and a JSON line last, and exits
1 if a kernel's output fails or a faulty one passes.  Needs a CUDA device;
exits 2 without one.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILE = 64
FAULT_TILE = 8          # keys / queries 512-575
ZERO_FROM = 512


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_faults: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SEED, TRAIN_BATCH, TRAIN_SEQ, flash_shares

    from deeperspeed_tpu_torch.ops.attention import flash
    from deeperspeed_tpu_torch.ops.cuda_utils import NEG_INF

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, S, N, D = TRAIN_BATCH, TRAIN_SEQ, 12, 64
    # chip_smoke.py's phase 3 draws its first flash shape from this generator
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(bf16)
                   for _ in range(4))
    o, lse = flash._fwd_cuda(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
    dq = flash._dq_cuda(q, k, v, do, lse, delta, True)
    dk, dv = flash._dkv_cuda(q, k, v, do, lse, delta, True)
    ro, _ = flash._fwd_reference(q, k, v, True)
    rdq, rdk, rdv = flash._bwd_reference(q, k, v, do, lse, delta, True)

    lo, hi = FAULT_TILE * TILE, (FAULT_TILE + 1) * TILE
    tile = torch.zeros(S, dtype=torch.bool, device=dev)
    tile[lo:hi] = True
    s = flash._scores(q, k, True)                       # [B, N, S, S] fp32

    # K5 without k tile 8: rows from 512 on never see its keys
    sf = s.clone()
    sf[:, :, lo:, lo:hi] = NEG_INF
    m = sf.amax(-1, keepdim=True)
    p = torch.exp(sf - m)
    o_skip = torch.einsum("bnqk,bknd->bqnd", p.to(bf16).float(), v.float())
    o_skip = (o_skip / p.sum(-1).transpose(1, 2)[..., None]).to(bf16)
    del sf, m, p

    live = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    p = torch.exp(s - lse.reshape(B, N, S, 1)).masked_fill(~live, 0.0)
    ds = p * (torch.einsum("bqnd,bknd->bnqk", do.float(), v.float())
              - delta.reshape(B, N, S, 1))
    p, ds = p.to(bf16).float(), ds.to(bf16).float()
    del s
    # K7 without k tile 8; K6 without q tile 8
    dq_skip = torch.einsum("bnqk,bknd->bqnd", ds.masked_fill(tile, 0.0), k.float())
    rows = tile[:, None]
    dk_skip = torch.einsum("bnqk,bqnd->bknd", ds.masked_fill(rows, 0.0), q.float())
    dv_skip = torch.einsum("bnqk,bqnd->bknd", p.masked_fill(rows, 0.0), do.float())
    del p, ds

    def zeroed(t):
        t = t.clone()
        t[:, ZERO_FROM:] = 0
        return t

    cases = [
        ("K5 O", o, ro, False),
        ("K7 dq", dq, rdq, False),
        ("K6 dk", dk, rdk, False),
        ("K6 dv", dv, rdv, False),
        ("K5 O, k tile 8 skipped", o_skip, ro, True),
        ("K7 dq, k tile 8 skipped", dq_skip.to(bf16), rdq, True),
        ("K6 dk, q tile 8 skipped", dk_skip.to(bf16), rdk, True),
        ("K6 dv, q tile 8 skipped", dv_skip.to(bf16), rdv, True),
        ("K7 dq, zero from query 512", zeroed(dq), rdq, True),
        ("K6 dk, zero from key 512", zeroed(dk), rdk, True),
        ("K6 dv, zero from key 512", zeroed(dv), rdv, True),
    ]
    results, wrong = [], []
    for name, got, want, faulty in cases:
        err, elem, head = flash_shares(torch, got, want)
        caught = max(elem, head) > 1.0
        if caught != faulty:
            wrong.append(name)
        results.append({"output": name, "faulty": faulty, "max_abs_err": err,
                        "element_share": elem, "head_share": head, "fails_check": caught})
        print(f"[faults] {name}: max abs err {err:.4e}, worst element {elem:.4f}, "
              f"worst head {head:.4f} of the limit -> "
              f"{'fails' if caught else 'passes'} the check", flush=True)
    print(json.dumps({"card": card, "shape": [B, S, N, D], "results": results,
                      "wrong": wrong}))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
