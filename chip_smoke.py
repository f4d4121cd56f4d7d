#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package, and goes through these phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the build of every kernel from ``deeperspeed_tpu_torch/csrc`` with nvcc
   (one process per source, all started together);
3. each kernel at the shapes its path gives it, held against its plain
   PyTorch version on the card, with its time, the plain version's, one
   library call's (where one PyTorch call computes the same function), and
   the least time the card could take (bound): serving's K1 LayerNorm
   forward, K2 paged decode, K3 paged speculative decode, K4 sorted top-k,
   and training's K5 flash-attention forward, K7 its dq pass, K6 its dk/dv
   pass and K8 the LayerNorm backward;
4. Pythia-160M (12 layers, full width) in fp32 served through
   ``InferenceEngineV2`` on the card and on the CPU from the same seeded
   weights: logits must agree to 2e-3 every round, and tokens wherever the
   top-2 margin exceeds that;
5. Pythia-160M in bf16 with a 4096 x 16 block KV pool serving 32 prompts of
   128-512 tokens, 64 decode rounds and a 4-token extend round (greedy),
   then a sampled run (temperature 0.8, top-k 50); every serving kernel's
   launch counter must rise during these runs;
6. Pythia-160M at full width with 2 layers in fp32 trained 3 Adam steps
   (clip 1.0) by the engine on the card and on the CPU from the same seeded
   weights and batches: losses and the first step's grad norm must agree
   to 1e-4 relative;
7. ``bench.py``'s training step: Pythia-160M at full depth in bf16, batch
   16 of 1024 tokens, Adam lr 1e-4, clip 1.0, ZeRO-0; 2 warm-up steps and
   10 timed ones; the loss must be finite and the counters of K1, K5, K6,
   K7 and K8 must rise.

The second-to-last line is the JSON summary of the kernels (a kernel's
``launches`` sums its counts on the two main paths, serving in phase 5 and
training in phase 7, each read right after its own run and listed in
``launches_by_path``), the last ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without a CUDA device, or outside a
checkout, it exits 2 and prints no result.
"""

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
SEED = 1234
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2     # K2/K3 vs plain: rtol is one bf16 rounding
# K5-K7 vs plain in bf16 ((rtol, row, floor, head) of flash_close), each
# output held on its own scale.  rtol 2^-7 is one bf16 ulp of the element:
# both sides round once, from fp32 sums taken in other orders.  row 2^-6 is
# two ulps of the row's RMS over D: the kernel rounds P to bf16 at its
# running max per 64-key tile, the plain version at the row's final max, so
# each P may differ by one ulp, and the row sums those differences over its
# keys (queries for dk/dv) with random signs.  floor 2^-10, absolute on
# inputs of unit scale, covers rows whose exact value is 0 (dq of causal row
# 0, where both sides keep only fp32 noise).  head 1e-2 bounds
# ||got - ref|| / ||ref|| over each (b, n) head.
FLASH_TOL = (2 ** -7, 2 ** -6, 2 ** -10, 1e-2)

# The served configuration (phase 5), shared with tools/torch_serving_profile.py.
SERVED_BATCH = 32
SERVED_ECFG = {"dtype": "bfloat16", "kv_cache": {"num_blocks": 4096, "block_size": 16},
               "state_manager": {"max_context": 1024, "max_ragged_batch_size": 4096,
                                 "max_ragged_sequence_count": 64,
                                 "max_decode_batch": SERVED_BATCH}}


# The trained configuration (phase 7), bench.py's training step
# (bench.py:296-335), shared with tools/torch_train_profile.py.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 16, 10
TRAIN_CONFIG = {"train_batch_size": TRAIN_BATCH,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                "steps_per_print": 1000000}


def trained_model(device=None):
    """Pythia-160M at full width and depth in bf16, random weights from ``SEED``."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16, max_seq_len=TRAIN_SEQ),
                   device=device, seed=SEED)


def trained_batch(model):
    """bench.py's batch: one fixed batch of random tokens, reused each step."""
    return model.example_batch(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)


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


def flash_shares(torch, got, want, tol=FLASH_TOL):
    """A flash output [B, S, N, D] against its plain version: per element
    |got - ref| <= rtol |ref| + row rms_D(ref) + floor, and per (b, n) head
    ||got - ref|| <= head ||ref|| + floor sqrt(S D).  Returns (max abs
    error, the share of its limit the worst element used, the share the
    worst head used)."""
    rtol, row, floor, head = tol
    g, w = got.float(), want.float()
    diff = g - w
    limit = rtol * w.abs() + row * w.pow(2).mean(-1, keepdim=True).sqrt() + floor
    elem = (diff.abs() / limit).max().item()
    head_limit = head * torch.linalg.vector_norm(w, dim=(1, 3)) \
        + floor * (w.shape[1] * w.shape[3]) ** 0.5
    heads = (torch.linalg.vector_norm(diff, dim=(1, 3)) / head_limit).max().item()
    return diff.abs().max().item(), elem, heads


def flash_close(torch, got, want, what, tol=FLASH_TOL):
    """Raise unless :func:`flash_shares` holds; returns (max abs error, the
    larger share used)."""
    err, elem, heads = flash_shares(torch, got, want, tol)
    if not (elem <= 1.0 and heads <= 1.0):
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(element {elem:.3g}, head {heads:.3g} of their limits "
                             f"(rtol, row, floor, head) = {tol})")
    return err, max(elem, heads)


def _reporter(rows_out):
    def report(key, line, entry):
        lib = entry["library_ms"]
        print(f"[kernels] {line}: max_abs_err={entry['max_abs_err']:.3e} "
              f"ms={entry['ms']:.4f} plain_ms={entry['plain_ms']:.4f} "
              f"library_ms={'none' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']})",
              flush=True)
        rows_out.setdefault(key, entry)     # the first shape is the path's
    return report


def phase_kernels(torch):
    """Phase 3, serving: K1-K4 against their plain versions."""
    import torch.nn.functional as F

    from deeperspeed_tpu_torch.ops.attention import paged
    from deeperspeed_tpu_torch.ops.sampling import topk
    from deeperspeed_tpu_torch.ops.transformer import normalize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    rows_out = {}
    report = _reporter(rows_out)

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


def phase_training_kernels(torch, rows_out):
    """Phase 3, training: K5-K8 against their plain versions."""
    import torch.nn.functional as F

    from deeperspeed_tpu_torch.ops.attention import flash
    from deeperspeed_tpu_torch.ops.transformer import normalize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf16 = torch.bfloat16
    report = _reporter(rows_out)

    # the training shape first (B 16, S 1024, N 12, D 64, causal), then a
    # ragged S, D 128 and full (non-causal) attention
    for B, S, N, D, causal in ((16, 1024, 12, 64, True), (4, 1000, 12, 64, True),
                               (4, 1024, 16, 128, True), (4, 1024, 12, 64, False)):
        q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(bf16)
                       for _ in range(4))
        what = f"B={B} S={S} N={N} D={D} {'causal' if causal else 'full'} bf16"
        o, lse = flash._fwd_cuda(q, k, v, causal)
        ro, rlse = flash._fwd_reference(q, k, v, causal)
        err_fwd, use_o = flash_close(torch, o, ro, f"flash_fwd {what}")
        _close(torch, lse, rlse, 1e-4, 1e-5, f"flash_fwd LSE {what}")
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
        rdq, rdk, rdv = flash._bwd_reference(q, k, v, do, lse, delta, causal)
        err_dq, use_dq = flash_close(torch, flash._dq_cuda(q, k, v, do, lse, delta, causal),
                                     rdq, f"flash_bwd_dq {what}")
        dk, dv = flash._dkv_cuda(q, k, v, do, lse, delta, causal)
        (err_dk, use_dk), (err_dv, use_dv) = (
            flash_close(torch, dk, rdk, f"flash_bwd_dkv dk {what}"),
            flash_close(torch, dv, rdv, f"flash_bwd_dkv dv {what}"))
        err_dkv = max(err_dk, err_dv)
        print(f"[kernels] flash {what}: share of the limit used (largest of per "
              f"element and per head) O {use_o:.3f}, dq {use_dq:.3f}, dk {use_dk:.3f}, "
              f"dv {use_dv:.3f}", flush=True)
        del rdq, rdk, rdv, dk, dv
        # live (query, key) pairs: the products' work on these inputs
        live = S * (S + 1) // 2 if causal else S * S
        mac, io, vec = B * N * D * live, B * S * N * D * 2, B * N * S * 4
        q4, k4, v4, do4 = (t.transpose(1, 2) for t in (q, k, v, do))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            torch.autograd.grad(out, (qg, kg, vg), do4)

        lib_fwd_bwd = _time_ms(torch, sdpa_fwd_bwd, iters=10)
        t, by = _bound(4 * io + vec, 2 * 2 * mac, bf16)
        report("flash_fwd", f"K5 flash_fwd {what}", dict(
            max_abs_err=err_fwd,
            ms=_time_ms(torch, lambda: flash._fwd_cuda(q, k, v, causal)),
            plain_ms=_time_ms(torch, lambda: flash._fwd_reference(q, k, v, causal), iters=3),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)),
            bound_ms=t, bound_by=by))
        t, by = _bound(5 * io + 2 * vec, 3 * 2 * mac, bf16)
        bwd_plain = _time_ms(torch, lambda: flash._bwd_reference(
            q, k, v, do, lse, delta, causal), iters=3)
        report("flash_bwd_dq", f"K7 flash_bwd_dq {what}", dict(
            max_abs_err=err_dq,
            ms=_time_ms(torch, lambda: flash._dq_cuda(q, k, v, do, lse, delta, causal)),
            plain_ms=bwd_plain, library_ms=None, bound_ms=t, bound_by=by))
        t, by = _bound(6 * io + 2 * vec, 4 * 2 * mac, bf16)
        report("flash_bwd_dkv", f"K6 flash_bwd_dkv {what}", dict(
            max_abs_err=err_dkv,
            ms=_time_ms(torch, lambda: flash._dkv_cuda(q, k, v, do, lse, delta, causal)),
            plain_ms=bwd_plain, library_ms=None, bound_ms=t, bound_by=by))
        print(f"[kernels] library yardstick {what}: SDPA forward + backward "
              f"{lib_fwd_bwd:.4f} ms (no one library call computes dq alone or "
              f"dk/dv alone; plain_ms of K6 and K7 is the whole plain backward)",
              flush=True)
        del q, k, v, do, o, lse, ro, rlse, qg, kg, vg
        torch.cuda.empty_cache()

    # ---- K8: LayerNorm backward at the training rows (B 16 x S 1024)
    rows, H = TRAIN_BATCH * TRAIN_SEQ, 768
    x = (2 * torch.randn(rows, H, generator=gen, device=dev) + 0.5).to(bf16)
    dy = torch.randn(rows, H, generator=gen, device=dev).to(bf16)
    g = 1 + 0.1 * torch.randn(H, generator=gen, device=dev)
    dx, dg, db = normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)
    rdx, rdg, rdb = normalize._ln_bwd_ref(x, g, dy, 1e-5, False)
    # dx: one bf16 rounding; dgamma/dbeta: fp32 sums of 16384 rows in
    # another order, held on the scale of their largest entry
    err = _close(torch, dx, rdx, 1e-2, 1e-2, "layer_norm_bwd dx")
    for got, want, name in ((dg, rdg, "dgamma"), (db, rdb, "dbeta")):
        err = max(err, _close(torch, got, want, 1e-5 * want.abs().max().item(), 1e-4,
                              f"layer_norm_bwd {name}"))
    xl = x.clone().requires_grad_()
    gl = g.to(bf16).requires_grad_()
    bl = torch.zeros(H, device=dev, dtype=bf16, requires_grad=True)
    yl = F.layer_norm(xl, (H,), gl, bl, 1e-5)
    t, by = _bound(3 * rows * H * 2 + 3 * H * 4, 20 * rows * H, torch.float32)
    report("layer_norm_bwd", f"K8 layer_norm_bwd rows={rows} H={H} bf16", dict(
        max_abs_err=err,
        ms=_time_ms(torch, lambda: normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)),
        plain_ms=_time_ms(torch, lambda: normalize._ln_bwd_ref(x, g, dy, 1e-5, False)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            yl, (xl, gl, bl), dy, retain_graph=True)),
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


def phase_trained_checked(torch, np):
    """Phase 6: fp32 training, 2 full-width layers, on the card vs the CPU."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig

    # TF32 stays off (phase 4): fp32 products in full fp32
    tol = 1e-4     # summation order over 768-4096-wide products and the CE
    cfg = {"train_batch_size": 2, "gradient_clipping": 1.0,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
    two_layers = dataclasses.replace(GPTNeoXConfig.pythia_160m(), num_layers=2)
    engines = [dst.initialize(model=GPTNeoX(two_layers, device=d, seed=SEED),
                              config=cfg, device=d)[0] for d in ("cuda", "cpu")]
    rng = np.random.default_rng(SEED + 3)
    V = engines[1].module.config.vocab_size
    worst = 0.0
    for step in range(3):
        toks = rng.integers(0, V, (2, 129))
        batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
        lg, lc = (float(e.train_batch(batch=batch)) for e in engines)
        rel = abs(lg - lc) / abs(lc)
        worst = max(worst, rel)
        if rel > tol:
            raise AssertionError(f"step {step}: card loss {lg} vs CPU {lc}")
        if step == 0:
            ng, nc = (e.get_global_grad_norm() for e in engines)
            if abs(ng - nc) > tol * nc:
                raise AssertionError(f"step 0 grad norm: card {ng} vs CPU {nc}")
    print(f"[trained-checked] Pythia-160M width, 2 layers, fp32, B 2 x S 128, 3 Adam "
          f"steps: losses card vs CPU within {worst:.2e} relative (tol {tol}); "
          f"step-0 grad norm {ng:.6f} vs {nc:.6f}; last loss {lg:.6f}", flush=True)
    del engines
    torch.cuda.empty_cache()


def phase_trained(torch, launches):
    """Phase 7: bench.py's training step, timed; counts kernel launches."""
    import deeperspeed_tpu_torch as dst

    model = trained_model()
    engine = dst.initialize(model=model, config=TRAIN_CONFIG)[0]
    batch = {k: v.cuda() for k, v in trained_batch(model).items()}
    for _ in range(2):                                # warm-up
        loss = engine.train_batch(batch=batch)
    first = float(loss)
    torch.cuda.reset_peak_memory_stats()
    launches.clear()                                  # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        loss = engine.train_batch(batch=batch)
    loss = float(loss)                                # waits for the last step
    dt = time.perf_counter() - t0
    counts = dict(launches)
    if not (math.isfinite(first) and math.isfinite(loss)):
        raise AssertionError(f"non-finite training loss: {first}, {loss}")
    for name in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"training never launched {name}: {counts}")
    cfg = model.config
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / dt
    # bench.py:341-351: 6 N (input embedding excluded) + the attention term
    n_params = sum(p.numel() for p in engine.master_params.values()) \
        - cfg.vocab_size * cfg.hidden_size
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ
    mfu = flops_per_token * tokens_per_s / PEAK_OPS_PER_S["bfloat16"]
    print(f"[trained] Pythia-160M bf16, B {TRAIN_BATCH} x S {TRAIN_SEQ}, Adam, clip 1.0, "
          f"ZeRO-0: {dt / TRAIN_STEPS * 1e3:.2f} ms/step over {TRAIN_STEPS} steps, "
          f"{tokens_per_s:.1f} tokens/s, model-FLOPs share {mfu:.4f} of 989 TFLOP/s; "
          f"loss {first:.4f} -> {loss:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"[trained] launches in the timed steps {counts}", flush=True)
    del engine, model
    torch.cuda.empty_cache()
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

    rows = phase_training_kernels(torch, phase_kernels(torch))
    phase_checked(torch, np)
    # each main path's counts, read right after its own run
    paths = {"serving": phase_served(torch, np, cuda_utils.LAUNCHES)}
    phase_trained_checked(torch, np)
    paths["training"] = phase_trained(torch, cuda_utils.LAUNCHES)

    sources = {
        "layer_norm": ("deeperspeed_tpu_torch/csrc/layer_norm.cu",
                       "deeperspeed_tpu/ops/transformer/normalize.py:33"),
        "paged_decode": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                         "deeperspeed_tpu/ops/attention/paged.py:36"),
        "paged_spec_decode": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                              "deeperspeed_tpu/ops/attention/paged.py:89"),
        "sorted_topk": ("deeperspeed_tpu_torch/csrc/topk.cu",
                        "deeperspeed_tpu/ops/sampling/topk.py:25"),
        "flash_fwd": ("deeperspeed_tpu_torch/csrc/flash_attention.cu",
                      "deeperspeed_tpu/ops/attention/pallas_flash.py:72"),
        "flash_bwd_dkv": ("deeperspeed_tpu_torch/csrc/flash_attention.cu",
                          "deeperspeed_tpu/ops/attention/pallas_flash.py:154"),
        "flash_bwd_dq": ("deeperspeed_tpu_torch/csrc/flash_attention.cu",
                         "deeperspeed_tpu/ops/attention/pallas_flash.py:117"),
        "layer_norm_bwd": ("deeperspeed_tpu_torch/csrc/layer_norm.cu",
                           "deeperspeed_tpu/ops/transformer/normalize.py:44"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        e = rows[name]
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
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
