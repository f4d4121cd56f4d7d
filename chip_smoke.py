#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package, and goes through these phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the build of every kernel from ``deeperspeed_tpu_torch/csrc`` with nvcc;
3. each kernel (K1 LayerNorm forward, K2 paged decode, K3 paged speculative
   decode, K4 sorted top-k) at the serving path's shapes, held against its
   plain PyTorch version on the card, with its time, the plain version's,
   one library call's, and the least time the card could take (bound);
4. Pythia-160M (12 layers, full width) in fp32 served through
   ``InferenceEngineV2`` on the card and on the CPU from the same seeded
   weights: logits must agree to 2e-3 every round, and tokens wherever the
   top-2 margin exceeds that;
5. Pythia-160M in bf16 with a 4096 x 16 block KV pool serving 32 prompts of
   128-512 tokens, 64 decode rounds and a 4-token extend round (greedy),
   then a sampled run (temperature 0.8, top-k 50); every kernel's launch
   counter must rise during these runs.

The second-to-last line is the JSON summary of the kernels, the last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device, or outside a checkout, it exits 2 and prints no
result.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
SEED = 1234
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2     # K2/K3 vs plain: rtol is one bf16 rounding

# The served configuration (phase 5), shared with tools/torch_serving_profile.py.
SERVED_BATCH = 32
SERVED_ECFG = {"dtype": "bfloat16", "kv_cache": {"num_blocks": 4096, "block_size": 16},
               "state_manager": {"max_context": 1024, "max_ragged_batch_size": 4096,
                                 "max_ragged_sequence_count": 64,
                                 "max_decode_batch": SERVED_BATCH}}


def served_model(device=None):
    """Pythia-160M at full width and depth, random weights from ``SEED``."""
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(GPTNeoXConfig.pythia_160m(), device=device, seed=SEED)


def served_prompts(np, vocab, n):
    """``n`` prompts of 128-512 tokens; the first k are the same for any n >= k."""
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, vocab, int(rng.integers(128, 513))).tolist()
            for _ in range(n)]


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _close(torch, got, want, atol, rtol, what):
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(max abs err {err.max().item():.3e}, atol {atol}, "
                             f"rtol {rtol})")
    return err.max().item()


def phase_kernels(torch):
    """Phase 3: every kernel against its plain version at the path's shapes."""
    import torch.nn.functional as F

    from deeperspeed_tpu_torch.ops.attention import paged
    from deeperspeed_tpu_torch.ops.sampling import topk
    from deeperspeed_tpu_torch.ops.transformer import normalize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    rows_out = {}

    def report(key, line, entry):
        print(f"[kernels] {line}: max_abs_err={entry['max_abs_err']:.3e} "
              f"ms={entry['ms']:.4f} plain_ms={entry['plain_ms']:.4f} "
              f"library_ms={entry['library_ms']:.4f} "
              f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']})",
              flush=True)
        rows_out.setdefault(key, entry)     # the first shape is the path's

    # ---- K1: LayerNorm forward, decode-round rows and prefill rows, bf16
    H = 768
    for rows in (64, 4096):
        x = torch.randn(rows, H, generator=gen, device=dev).to(bf16)
        g = 1 + 0.1 * torch.randn(H, generator=gen, device=dev)
        b = 0.1 * torch.randn(H, generator=gen, device=dev)
        y = normalize.layer_norm(x, g, b)
        ref = normalize._ln_ref(x, g, b, 1e-5, False)
        err = _close(torch, y, ref, 1e-2, 1e-2, f"layer_norm rows={rows}")
        gb, bb = g.to(bf16), b.to(bf16)
        t, by = _bound(2 * rows * H * 2 + 2 * H * 4, 8 * rows * H, bf16)
        report("layer_norm", f"K1 layer_norm rows={rows} H={H} bf16", dict(
            max_abs_err=err,
            ms=_time_ms(torch, lambda: normalize.layer_norm(x, g, b)),
            plain_ms=_time_ms(torch, lambda: normalize._ln_ref(x, g, b, 1e-5, False)),
            library_ms=_time_ms(torch, lambda: F.layer_norm(x, (H,), gb, bb, 1e-5)),
            bound_ms=t, bound_by=by))

    # ---- K2 / K3: paged attention over a scattered bf16 pool
    def pools(B, N, D, ctx, bs=16):
        P = B * ctx // bs
        pk = torch.randn(P, bs, N, D, generator=gen, device=dev).to(bf16)
        pv = torch.randn(P, bs, N, D, generator=gen, device=dev).to(bf16)
        perm = torch.randperm(P, generator=gen, device=dev)
        tables = perm.view(B, ctx // bs).to(torch.int32).contiguous()
        return pk, pv, tables

    def gathered(pool, tables, B, ctx, N, D):
        return pool[tables.long()].reshape(B, ctx, N, D).transpose(1, 2).contiguous()

    for B, N, D, ctx in ((64, 12, 64, 1024), (64, 16, 128, 1024)):
        pk, pv, tables = pools(B, N, D, ctx)
        q = torch.randn(B, N, D, generator=gen, device=dev).to(bf16)
        full = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        ragged = torch.randint(1, ctx + 1, (B,), generator=gen, device=dev,
                               dtype=torch.int32)
        scale = D ** -0.5
        err = max(_close(torch, paged.paged_decode_attention(q, pk, pv, tables, lens),
                         paged._decode_reference(q, pk, pv, tables, lens, scale),
                         ATTN_ATOL, ATTN_RTOL, f"paged_decode B={B} N={N} D={D}")
                  for lens in (ragged, full))
        K, V = gathered(pk, tables, B, ctx, N, D), gathered(pv, tables, B, ctx, N, D)
        q4 = q[:, :, None, :]
        nbytes = 2 * B * ctx * N * D * 2 + 2 * B * N * D * 2 + tables.numel() * 4 + B * 4
        t, by = _bound(nbytes, 4 * B * N * ctx * D, bf16)
        report("paged_decode", f"K2 paged_decode B={B} N={N} D={D} bs=16 ctx={ctx} bf16", dict(
            max_abs_err=err,
            ms=_time_ms(torch, lambda: paged.paged_decode_attention(q, pk, pv, tables, full)),
            plain_ms=_time_ms(torch, lambda: paged._decode_reference(
                q, pk, pv, tables, full, scale), iters=5),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(q4, K, V)),
            bound_ms=t, bound_by=by))

        if D != 64:
            continue
        s1 = paged.paged_spec_decode_attention(q[:, None].contiguous(), pk, pv, tables,
                                               (ragged - 1)[:, None].contiguous())
        _close(torch, s1[:, 0], paged.paged_decode_attention(q, pk, pv, tables, ragged),
               0.0, 0.0, "paged_spec_decode S=1 vs paged_decode")
        # S 4 and 8 are the buckets the served path gives K3 (its 4-token
        # extend round is S 4, reported first); S 5 is an extra odd case.
        for S in (4, 8, 5):
            qs = torch.randn(B, S, N, D, generator=gen, device=dev).to(bf16)
            pos = (ctx - S + torch.arange(S, device=dev, dtype=torch.int32))[None] \
                .repeat(B, 1)
            # one query of a ragged row sees fewer tokens than the last
            pos_ragged = (ragged[:, None] - S + torch.arange(S, device=dev)) \
                .clamp(min=0).to(torch.int32).contiguous()
            err = max(_close(torch, paged.paged_spec_decode_attention(qs, pk, pv, tables, p),
                             paged._spec_decode_reference(qs, pk, pv, tables, p, scale),
                             ATTN_ATOL, ATTN_RTOL, f"paged_spec_decode S={S}")
                      for p in (pos_ragged, pos))
            mask = (torch.arange(ctx, device=dev)[None, None, :] <= pos[:, :, None])[:, None]
            qs4 = qs.transpose(1, 2)
            t, by = _bound(nbytes + (S - 1) * 2 * B * N * D * 2 + B * S * 4,
                           4 * B * N * S * ctx * D, bf16)
            report("paged_spec_decode",
                   f"K3 paged_spec_decode B={B} S={S} N={N} D={D} bs=16 ctx={ctx} bf16",
                   dict(max_abs_err=err,
                        ms=_time_ms(torch, lambda: paged.paged_spec_decode_attention(
                            qs, pk, pv, tables, pos)),
                        plain_ms=_time_ms(torch, lambda: paged._spec_decode_reference(
                            qs, pk, pv, tables, pos, scale), iters=5),
                        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                            qs4, K, V, attn_mask=mask)),
                        bound_ms=t, bound_by=by))

    # ---- K4: sorted top-k over the GPT-NeoX vocab
    rows, V, k = 64, 50304, 50
    x = torch.randn(rows, V, generator=gen, device=dev)
    masked = x.clone()
    masked[:, 20:] = float("-inf")     # fewer finite values than k
    for inp in (masked, x):
        kv, ki = topk.sorted_topk(inp, k)
        rv, ri = topk._topk_reference(inp, k)
        if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
            raise AssertionError("sorted_topk disagrees with its plain version")
    t, by = _bound(rows * V * 4 + rows * k * 8, rows * V, torch.float32)
    report("sorted_topk", f"K4 sorted_topk rows={rows} V={V} k={k} fp32", dict(
        max_abs_err=0.0,
        ms=_time_ms(torch, lambda: topk.sorted_topk(x, k)),
        plain_ms=_time_ms(torch, lambda: topk._topk_reference(x, k), iters=3),
        library_ms=_time_ms(torch, lambda: torch.topk(x, k)),
        bound_ms=t, bound_by=by))
    return rows_out


def phase_checked(torch, np):
    """Phase 4: fp32 Pythia-160M on the card against the same on the CPU."""
    from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[checked] TF32 off for matmul and cuDNN: fp32 products in full fp32",
          flush=True)
    tol = 2e-3
    ecfg = {"dtype": "float32", "kv_cache": {"num_blocks": 128, "block_size": 16},
            "state_manager": {"max_context": 256, "max_ragged_batch_size": 512,
                              "max_decode_batch": 4}}
    cpu_model = served_model("cpu")
    gpu = InferenceEngineV2(copy.deepcopy(cpu_model), ecfg)
    cpu = InferenceEngineV2(cpu_model, ecfg, device="cpu")
    rng = np.random.default_rng(SEED)
    V = cpu_model.config.vocab_size
    uids = [0, 1, 2, 3]
    feed = [rng.integers(0, V, n).tolist() for n in (17, 33, 24, 40)]
    worst, compared, rounds = 0.0, 0, []
    for rnd in range(17):
        if rnd == 16:   # one 4-token extend round (the speculative-decode kernel)
            feed = [f + rng.integers(0, V, 3).tolist() for f in feed]
        og, oc = gpu.put_round(uids, feed), cpu.put_round(uids, feed)
        lg = og.logits[:4].cpu()
        lc = oc.logits[:4]
        diff = (lg - lc).abs().max().item()
        worst = max(worst, diff)
        if diff > tol:
            raise AssertionError(f"round {rnd}: card and CPU logits differ by {diff:.3e}")
        top2 = lc.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).numpy()
        for i in range(4):
            if margin[i] > tol:
                compared += 1
                if og.tokens[i, -1] != oc.tokens[i, -1]:
                    raise AssertionError(f"round {rnd} row {i}: token "
                                         f"{og.tokens[i, -1]} != {oc.tokens[i, -1]}")
        rounds.append(diff)
        feed = [[int(t)] for t in oc.tokens[:, -1]]   # both continue from the CPU's choice
    print(f"[checked] Pythia-160M fp32, 4 prompts, 1 prefill + 15 decode + 1 extend "
          f"rounds: max |logit diff| card vs CPU {worst:.3e} (last round "
          f"{rounds[-1]:.3e}, tol {tol}); {compared} tokens compared, all equal",
          flush=True)
    del gpu, cpu
    torch.cuda.empty_cache()


def phase_served(torch, np, launches):
    """Phase 5: bf16 serving with the full-size pool; counts kernel launches."""
    from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2

    model = served_model()
    eng = InferenceEngineV2(model, SERVED_ECFG)
    V = model.config.vocab_size
    n_prompts, decode_rounds = SERVED_BATCH, 64
    prompts = served_prompts(np, V, n_prompts)
    rng = np.random.default_rng(SEED + 2)             # the extend round's tokens
    uids = list(range(n_prompts))
    print(f"[served] Pythia-160M bf16, KV pools {eng.kv_pool_bytes / 1e9:.2f} GB, "
          f"{n_prompts} prompts of {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens", flush=True)

    launches.clear()                                  # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, nxt = [], {}
    for lo in range(0, n_prompts, 8):                 # 8 prompts per prefill round
        out = eng.put_round(uids[lo:lo + 8], prompts[lo:lo + 8])
        done = time.perf_counter() - t0               # put_round waited for the tokens
        for i, u in enumerate(uids[lo:lo + 8]):
            ttft.append(done)
            nxt[u] = int(out.tokens[i, -1])
        if not out.finite.all():
            raise AssertionError("non-finite logits in a prefill round")
    t_dec = time.perf_counter()
    for _ in range(decode_rounds):
        out = eng.put_round(uids, [[nxt[u]] for u in uids])
        if not out.finite.all():
            raise AssertionError("non-finite logits in a decode round")
        nxt = {u: int(out.tokens[i, -1]) for i, u in enumerate(uids)}
    dt = time.perf_counter() - t_dec
    out = eng.put_round(uids, [[nxt[u]] + rng.integers(0, V, 3).tolist() for u in uids])
    toks = out.tokens
    if not out.finite.all() or toks.min() < 0 or toks.max() >= V:
        raise AssertionError("bad tokens in the extend round")
    greedy = dict(launches)
    for name in ("layer_norm", "paged_decode", "paged_spec_decode"):
        if greedy.get(name, 0) < 1:
            raise AssertionError(f"greedy run never launched {name}: {greedy}")
    print(f"[served] greedy: decode {n_prompts * decode_rounds / dt:.1f} tokens/s "
          f"({dt / decode_rounds * 1e3:.2f} ms/round at batch {n_prompts}); "
          f"TTFT median {np.median(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f} ms "
          f"(4 prefill rounds of 8 prompts); launches {greedy}", flush=True)
    del eng
    torch.cuda.empty_cache()

    sampled = InferenceEngineV2(model, {**SERVED_ECFG, "sampling": {
        "temperature": 0.8, "top_k": 50, "seed": SEED}})
    t1 = time.perf_counter()
    outs = sampled.generate([np.asarray(p) for p in prompts[:8]], max_new_tokens=16)
    dt = time.perf_counter() - t1
    for p, o in zip(prompts[:8], outs):
        gen_toks = o[len(p):]
        if len(gen_toks) != 16 or gen_toks.min() < 0 or gen_toks.max() >= V:
            raise AssertionError("sampled run gave bad tokens")
    counts = dict(launches)
    if counts.get("sorted_topk", 0) < 1:
        raise AssertionError(f"sampled run never launched sorted_topk: {counts}")
    print(f"[served] sampled (temperature 0.8, top-k 50): 8 prompts x 16 tokens in "
          f"{dt:.2f} s; launches {counts}", flush=True)
    return counts


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    if not (ROOT / "deeperspeed_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from deeperspeed_tpu_torch.ops import cuda_utils

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = cuda_utils.build()
    for name, (secs, log) in logs.items():
        print(f"[build] {name}.cu: {secs:.1f} s", flush=True)
        print(log, file=sys.stderr)
    print(f"[build] all kernels in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)", flush=True)

    rows = phase_kernels(torch)
    phase_checked(torch, np)
    counts = phase_served(torch, np, cuda_utils.LAUNCHES)

    sources = {
        "layer_norm": ("deeperspeed_tpu_torch/csrc/layer_norm.cu",
                       "deeperspeed_tpu/ops/transformer/normalize.py:33"),
        "paged_decode": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                         "deeperspeed_tpu/ops/attention/paged.py:36"),
        "paged_spec_decode": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                              "deeperspeed_tpu/ops/attention/paged.py:89"),
        "sorted_topk": ("deeperspeed_tpu_torch/csrc/topk.cu",
                        "deeperspeed_tpu/ops/sampling/topk.py:25"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        e = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts.get(name, 0),
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
