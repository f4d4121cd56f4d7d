#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package, and goes through these phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the build of every kernel from ``deeperspeed_tpu_torch/csrc`` with nvcc
   (one process per source, all started together), with each source's
   ``ptxas`` registers and spill bytes;
3. each kernel at the shapes its path gives it, held against its plain
   PyTorch version on the card, with its time, the plain version's, one
   library call's (where one PyTorch call computes the same function), and
   the least time the card could take (bound): serving's K1 LayerNorm
   forward (also its kernel alone, from a CUDA graph of bare launches, and
   one call's host microseconds at a decode round's 64 rows), K2 paged
   decode (also 4 sequences at a 4096-token context), K3 paged speculative
   decode, K4 sorted top-k (64 rows and the sampled run's 8, each also
   alone from a CUDA graph, and rows with a NaN or masked to fewer finite
   values than k, bit for bit), training's K5 flash-attention forward, K7 its
   dq pass, K6 its dk/dv pass (also at one 4096-token sequence; two
   launches of each bit for bit; beside them the library's attention
   backward alone, the op that ``F.scaled_dot_product_attention``
   dispatches to, named and timed from the saved forward outputs) and K8
   the LayerNorm backward (two launches bit for bit; also its two kernels
   alone from a CUDA graph, beside ``aten.native_layer_norm_backward``
   alone), and the optimizers' B6 fused Adam
   and B7 fused Lion over Pythia-160M's 162,322,944 parameters, and the qgZ
   gradient path's B5 fused dequant-reduce at its largest shape (the input
   embedding at world 2, [2, 150912, 128]) over int8, fp8 e5m2 and e4m3,
   bit for bit, and the legacy ops' B9 tanh-GELU forward and backward
   over [16 x 512, 3072] (fp32, bf16, fp16), B8 the fused softmax forward and
   backward over attention scores ([16, 12, 1024, 1024] bf16 at scale
   0.125, [4, 12, 1024, 1024] fp32, a width of 1000; the forward also
   alone from a CUDA graph), and B10 block-sparse
   attention's forward, dq and dk/dv passes at [4, 4096, 12, 64] bf16
   under the Fixed layout (block 128, causal; each pass two launches bit
   for bit, also alone from CUDA graphs, beside SDPA's backward alone
   under the layout as a token mask; the Hopper kernels' walk lengths
   under phase 17's layouts), beside dense flash K5-K7 at the same shape;
4. Pythia-160M (12 layers, full width) in fp32 served through
   ``InferenceEngineV2`` on the card and on the CPU from the same seeded
   weights: logits must agree to 2e-3 every round, and tokens wherever the
   top-2 margin exceeds that;
5. Pythia-160M in bf16 with a 4096 x 16 block KV pool serving 32 prompts of
   128-512 tokens, 64 decode rounds and a 4-token extend round (greedy),
   then a sampled run (temperature 0.8, top-k 50); every serving kernel's
   launch counter must rise during these runs;
6. scheduled serving, checked: Pythia-160M at full width with 2 layers in
   fp32 through ``DSScheduler.generate`` over an fp8 KV pool with n-gram
   speculation (k 4), on the card and on the CPU from the same seeded
   weights: greedy tokens must be equal, and on the card speculative
   decoding must equal plain decoding;
7. scheduled serving at full size: Pythia-160M in bf16, ``kv_cache.dtype``
   "fp8" with the pool sized to phase 5's bytes, ``speculative`` n-gram k 4:
   ``DSScheduler.generate`` on 64 prompts of 128-512 tokens with repeated
   spans, 64 new tokens each (the counters of K1 and K3q must rise); the
   same without speculation (K1 and K2q); then the same prompts over the
   bf16 pool without speculation, for comparison;
8. Pythia-160M at full width with 2 layers in fp32 trained 3 Adam steps
   (clip 1.0) by the engine on the card and on the CPU from the same seeded
   weights and batches: losses and the first step's grad norm must agree
   to 1e-4 relative;
9. ``bench.py``'s training step: Pythia-160M at full depth in bf16, batch
   16 of 1024 tokens, Adam lr 1e-4, clip 1.0, ZeRO-0; 2 warm-up steps and
   10 timed ones; the loss must be finite and the counters of K1, K5, K6,
   K7 and K8 must rise;
10. the rest of single-card training, checked: Pythia-160M at full width
    with 2 layers in fp32, 3 steps on the card and on the CPU from the same
    seeded weights and batches, losses within 1e-4 relative, for FusedAdam
    and FusedLion with weight decay 0.01, and for Adam with the chunked
    loss (``ce_chunk_tokens`` 96 over 2 x 128 tokens), block recompute
    (``activation_checkpointing``) and gas 2 driven through the legacy
    ``forward``/``backward``/``step``; on the card the chunked loss must
    equal the monolithic loss of the same weights within 1e-5;
11. the rest of single-card training at full size: phase 9's model and
    batch shape with FusedAdam, fed through ``training_data=`` (a seeded
    numpy column store of 12 batches) with ``train_batch()`` taking no
    arguments, ``ce_chunk_tokens`` 4096 and block recompute; 2 warm-up
    steps and 10 timed ones: B6 must launch exactly once a step and K1,
    K5-K8 must rise; then 3 steps with FusedLion (B7 once a step);
12. dropout on the card: 2 full-width layers in bf16 with hidden and
    attention dropout 0.1, 3 steps: losses finite, two engines from one
    seed equal, the flash counters flat while training (attention takes
    the dense path, as in the JAX package), and ``eval_batch`` equal to the
    same weights' loss without dropout;
13. data-parallel training, checked: two processes share the card over
    ``gloo`` (NCCL refuses two ranks on one device; every collective is
    staged through host memory), spawned once (``--dp-worker``) after the
    build, for phases 13 and 14.  Pythia-160M at full width with 2 layers in
    fp32, global batch 4 x 128 (2 rows a rank), 3 Adam steps with clip 1.0,
    at ZeRO stages 0-3, each held against one process on the card from the
    same weights and batches (losses and the first grad norm within 1e-4
    relative, as phase 8); stages 1-3 hold half the fp32 masters and Adam
    moments, stage 3 half the partitioned compute parameters, in fewer
    allocated bytes than the one process; then stage 0 with
    ``comm.quantized`` int8 and fp8: losses within 1e-3 relative of the one
    process (the first within 1e-4), equal on both ranks, and B5 launched
    once a step for each parameter of at least 128 x 2 elements;
14. data-parallel training at full size: phase 9's step (Pythia-160M bf16,
    global batch 16 x 1024, 8 rows a rank, Adam lr 1e-4, clip 1.0) at world
    2 on the card, at ZeRO stage 2 and at stage 0 with ``comm.quantized``
    int8; 1 warm-up step and 3 timed ones: losses finite and equal on both
    ranks, B5 once a step for each of the 148 parameters under qgZ; wall
    ms/step over gloo via host, two ranks on one card; then (for phase 19)
    phase 13's stage-2 run saves a checkpoint at world 2;
15. the legacy layer, checked: two ``DeeperSpeedTransformerLayer``s at full
    width (768 / 12 heads / 3072) in fp32, 2 x 128 tokens, trained 3 Adam
    steps through ``initialize(model=..., loss_fn=...)`` on the card and
    on the CPU from the same seeded weights and batches (the mean square
    against a seeded target), pre- and post-LN, without a mask (flash on
    the card) and with a key-padding mask (the dense path): losses within
    1e-4 relative;
16. the legacy layer at full size: 12 layers at those widths, 16 x 512
    tokens, Adam lr 1e-4, 2 warm-up and 5 timed steps, in fp32 without
    dropout (flash K5-K7, K1/K8, B9) and with ``fp16=True`` and dropout
    0.1 (the dense attention, K1/K8, B9): losses finite, B9 12 forward and
    12 backward launches a step, flash rising in fp32 and flat in fp16;
    ms/step, tokens/s, peak memory;
17. sparse attention: ``SparseSelfAttention`` in fp32 at [2, 512, 2, 16]
    (block 128), card against CPU, for Dense and every config; the Dense
    layout against flash K5-K7 at [4, 4096, 12, 64] bf16; then Fixed,
    BSLongformer, BigBird, Variable and Fixed with a layout per head at
    that shape in bf16, forward and backward through autograd, against the
    plain version in fp32 on the card: B10 launches once a pass; then each
    config's device time a pass by kernel (``torch.profiler``);
18. ``fused_softmax`` forward and backward through autograd at phase 3's
    bf16 shape: B8 launches once each way;
19. checkpoints (into a temporary directory under ``.build``, removed at
    the end): phase 9's step (bf16 Pythia-160M, B 16 x S 1024, Adam, clip
    1.0) takes 2 steps, saves and takes 2 more; a fresh engine loads and
    takes the same 2 (K1, K5-K8 must launch): the losses and a digest of
    the fp32 masters and moments must be equal bit for bit; each file's
    bytes, the save, verify and load seconds and GB/s beside the card's
    name and power limit.  The same on 2 full-width layers for FusedAdam in
    bf16 (B6's flat buffers), fp16 with an overflow on the first step after
    the save (loss scale, ``skipped_steps``, ``step_count``) and dropout 0.1
    (the generator); phase 13's workers' stage-2 save at world 2 loaded at
    world 1 (digest equal to the workers' gathered state); and 4 prompts x
    16 greedy tokens (top-k 1, through K4) served by ``InferenceEngineV2``
    from the checkpoint's model file (``load_module_params`` then
    ``params_from_jax``) equal to those served from the live masters.

The second-to-last line is the JSON summary of the kernels (a kernel's
``launches`` sums its counts on the main paths, serving in phase 5,
scheduled serving in phase 7, training in phase 9, the rest of training
in phase 11 (FusedAdam, then FusedLion), data-parallel training in
phase 14 (rank 0's counts, stage 2, then qgZ), the legacy layer in phase
16 (fp32, then fp16), sparse attention in phase 17, the fused softmax in
phase 18 and the resumed steps of phase 19, each read right after its own
run and listed in ``launches_by_path``), the last ``{"ok": true,
"device": {...}}``.  Any
failure, of a phase or of a worker, raises and exits non-zero; without a
CUDA device, or outside a checkout, it exits 2 and prints no result.
"""

import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
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

# The scheduled configuration (phase 7), shared with
# tools/torch_serving_profile.py: the served model behind DSScheduler.
SCHEDULED_BATCH, SCHEDULED_NEW_TOKENS, SCHEDULED_SPEC_K = 64, 64, 4


def scheduled_ecfg(head_dim, kv_dtype="fp8", speculative=True):
    """``SERVED_ECFG`` with 64 sequences a round; a quantized pool gets the
    blocks that fit the bf16 pool's bytes (D + 4 bytes per (slot, head)
    against 2 D), and ``speculative`` turns the n-gram drafter on."""
    blocks, bs = (SERVED_ECFG["kv_cache"][k] for k in ("num_blocks", "block_size"))
    if kv_dtype:
        blocks = blocks * 2 * head_dim // (head_dim + 4)
    cfg = {"dtype": "bfloat16",
           "kv_cache": {"num_blocks": blocks, "block_size": bs, "dtype": kv_dtype},
           "state_manager": {**SERVED_ECFG["state_manager"],
                             "max_decode_batch": SCHEDULED_BATCH}}
    if speculative:
        cfg["speculative"] = {"method": "ngram", "k": SCHEDULED_SPEC_K}
    return cfg


def scheduled_prompts(np, vocab, n, lo=128, hi=512):
    """``n`` prompts of lo-hi tokens with repeated spans (a span of 8-32
    random tokens tiled to the length, one token in ten redrawn), so the
    n-gram drafter finds its tail earlier in the history."""
    rng = np.random.default_rng(SEED + 4)
    out = []
    for _ in range(n):
        length = int(rng.integers(lo, hi + 1))
        span = rng.integers(0, vocab, int(rng.integers(8, 33)))
        toks = np.resize(span, length)
        noise = rng.random(length) < 0.1
        toks[noise] = rng.integers(0, vocab, int(noise.sum()))
        out.append(toks.astype(np.int32))
    return out


# The trained configuration (phase 9), bench.py's training step
# (bench.py:296-335), shared with tools/torch_train_profile.py.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 16, 10
TRAIN_CONFIG = {"train_batch_size": TRAIN_BATCH,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                "steps_per_print": 1000000}


def trained_model(device=None, **config):
    """Pythia-160M at full width and depth in bf16, random weights from ``SEED``."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16, max_seq_len=TRAIN_SEQ,
                                             **config),
                   device=device, seed=SEED)


def trained_batch(model):
    """bench.py's batch: one fixed batch of random tokens, reused each step."""
    return model.example_batch(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)


# The rest of single-card training (phase 11), shared with
# tools/torch_train_profile.py --fused: phase 9's step with FusedAdam, the
# loader over training_data=, the chunked loss and block recompute.
FUSED_CE_CHUNK, FUSED_DATA_BATCHES = 4096, 12
FUSED_TRAIN_CONFIG = {**TRAIN_CONFIG,
                      "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}},
                      "activation_checkpointing": {"partition_activations": True}}


def fused_trained_model(device=None):
    """Phase 9's model with ``ce_chunk_tokens`` 4096."""
    return trained_model(device, ce_chunk_tokens=FUSED_CE_CHUNK)


def fused_training_data(np, vocab):
    """A seeded numpy column store of ``FUSED_DATA_BATCHES`` batches of
    ``TRAIN_BATCH`` rows of ``TRAIN_SEQ`` next-token pairs."""
    toks = np.random.default_rng(SEED + 5).integers(
        0, vocab, (FUSED_DATA_BATCHES * TRAIN_BATCH, TRAIN_SEQ + 1))
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


# Data-parallel training (phases 13 and 14): two processes on the one card,
# gloo as the transport (NCCL refuses two ranks on one device).
DP_WORLD = 2
DP_CHECK_STEPS, DP_CHECK_ROWS, DP_CHECK_SEQ = 3, 4, 128
DP_CHECK_CONFIG = {"train_batch_size": DP_CHECK_ROWS, "gradient_clipping": 1.0,
                   "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
DP_CHECK_RUNS = {
    **{f"stage{s}": {**DP_CHECK_CONFIG, "zero_optimization": {"stage": s}}
       for s in range(4)},
    **{f"qgz-{w}": {**DP_CHECK_CONFIG, "comm": {"quantized": {"enabled": True,
                                                            "wire_dtype": w}}}
       for w in ("int8", "fp8")}}
DP_QGZ_TOL, DP_QGZ_NORM_TOL = 1e-3, 1e-2   # see phase_dp_checked
DP_FULL_STEPS = 3
DP_FULL_RUNS = {
    "stage2": {**TRAIN_CONFIG, "zero_optimization": {"stage": 2}},
    "qgz-int8": {**TRAIN_CONFIG, "comm": {"quantized": {"enabled": True}}}}


def dp_check_model(device=None):
    """Phase 8's model: Pythia-160M at full width with 2 layers, fp32."""
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(dataclasses.replace(GPTNeoXConfig.pythia_160m(), num_layers=2),
                   device=device, seed=SEED)


def dp_check_batches(np, vocab):
    rng = np.random.default_rng(SEED + 40)
    out = []
    for _ in range(DP_CHECK_STEPS):
        toks = rng.integers(0, vocab, (DP_CHECK_ROWS, DP_CHECK_SEQ + 1))
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


# The legacy encoder layer (phases 15 and 16), shared with
# tests/test_torch_legacy_ops.py: a stack of DeeperSpeedTransformerLayers
# trained on the mean square against a seeded target.
def legacy_stack(torch, cfg, n_layers, device=None, seed=SEED):
    """``n_layers`` legacy layers of ``cfg`` in sequence, layer i from seed
    ``seed + i``; ``forward(x, mask=None, rng=None)``."""
    from deeperspeed_tpu_torch.ops.transformer.transformer import \
        DeeperSpeedTransformerLayer

    class LegacyStack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList(
                DeeperSpeedTransformerLayer(cfg, device=device, seed=seed + i)
                for i in range(n_layers))

        def forward(self, x, mask=None, rng=None):
            for layer in self.layers:
                x = layer(x, mask, rng)
            return x

    return LegacyStack()


def legacy_loss(model, batch, rng):
    """The engine's ``loss(model, batch, rng)`` for :func:`legacy_stack`."""
    out = model(batch["x"], batch.get("mask"), rng)
    return (out.float() - batch["y"]).pow(2).mean()


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


def _graph_ms(torch, fn, iters=20):
    """Mean device time of ``fn``'s launches alone: ``iters`` calls captured
    in one CUDA graph, its replay timed with CUDA events (no host work
    between the launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def _kernels_ms(torch, fn, iters=20, counts=False):
    """Device ms a call of ``fn`` spends in each kernel, by the kernel's
    name without its template arguments: ``torch.profiler`` over ``iters``
    calls after a warm-up, one call a profiler step.  The profiler's own
    warm-up step comes first and is not counted: a trace on the H100 late
    in a long process was seen to drop the first call's records without
    it.  With ``counts``, also each kernel's launches a call in the trace."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    traces = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(iters + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    out, launches = defaultdict(float), defaultdict(float)
    for e in traces[0]:
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].strip().replace(" ", "_")
            out[name] += e.self_device_time_total / 1e3 / iters
            launches[name] += e.count / iters
    return (dict(out), dict(launches)) if counts else dict(out)


def _sparse_pass_ms(torch, fn, iters=3, tries=3):
    """Device ms of one block-sparse attention pass (``fn``: forward and
    backward), by kernel, from ``torch.profiler``: (total, {B10 kernel:
    ms}, the rest), B10's kernels being those of namespaces ``tc``, ``f32``
    and ``hopper::sparse_*``.  A trace that does not hold each of B10's
    three kernels once a pass is taken again (a trace on the H100 was
    seen to drop kernels), up to ``tries`` times; then None, after a line
    that says what the last trace held."""
    for _ in range(tries):
        parts, launches = _kernels_ms(torch, fn, iters, counts=True)
        b10 = {k: ms for k, ms in parts.items()
               if k.startswith(("tc::", "f32::", "hopper::sparse_"))}
        if len(b10) == 3 and all(launches[k] == 1 for k in b10):
            total = sum(parts.values())
            return total, b10, total - sum(b10.values())
    print(f"[profile] the last trace held, launches a pass: "
          + ", ".join(f"{k} {launches[k]:g}" for k in sorted(parts)), flush=True)
    return None


def _host_us(torch, fn, iters=200):
    """Host microseconds of one call of ``fn``: a loop of calls on the host
    clock with no synchronize inside, over the count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _backward_ops(torch, out, inputs, grad):
    """The names of the aten backward ops that ``out``'s autograd node runs
    (one ``torch.autograd.grad`` under the profiler, host side only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
    return sorted({e.key for e in prof.key_averages()
                   if e.key.startswith("aten::") and "backward" in e.key})


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
        extra = "".join(f" {k}={entry[k]:.4f}" for k in (
            "device_ms", "library_device_ms", "host_us", "library_host_us") if k in entry)
        ratio = "" if lib is None else f" x_library={entry['ms'] / lib:.3f}"
        print(f"[kernels] {line}: max_abs_err={entry['max_abs_err']:.3e} "
              f"ms={entry['ms']:.4f} plain_ms={entry['plain_ms']:.4f} "
              f"library_ms={'none' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']}) "
              f"bound_share={entry['bound_ms'] / entry['ms']:.3f}{ratio}{extra}",
              flush=True)
        rows_out.setdefault(key, entry)     # the first shape is the path's
    return report


def phase_kernels(torch):
    """Phase 3, serving: K1-K4, K2q and K3q against their plain versions."""
    import torch.nn.functional as F

    from deeperspeed_tpu_torch.ops.attention import paged
    from deeperspeed_tpu_torch.ops.quantizer import byte_view, dequantize_kv, quantize_kv
    from deeperspeed_tpu_torch.ops.sampling import topk
    from deeperspeed_tpu_torch.ops.transformer import normalize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    rows_out = {}
    report = _reporter(rows_out)

    # ---- K1: LayerNorm forward, decode-round rows and prefill rows, bf16
    # x, gamma and beta (the served model's types).  ms is the call through
    # the public function, which at both row counts is the host's enqueue
    # rate, so it and the library's are averaged over 200 calls (a single
    # host stall moves a 20-call mean by several microseconds); device_ms
    # is the kernel alone (20 bare launches in a CUDA graph); host_us is
    # one call's host time, with no synchronize in the loop.
    H = 768
    for rows in (64, 4096):
        x = torch.randn(rows, H, generator=gen, device=dev).to(bf16)
        g = (1 + 0.1 * torch.randn(H, generator=gen, device=dev)).to(bf16)
        b = (0.1 * torch.randn(H, generator=gen, device=dev)).to(bf16)
        y = normalize.layer_norm(x, g, b)
        ref = normalize._ln_ref(x, g, b, 1e-5, False)
        err = _close(torch, y, ref, 1e-2, 1e-2, f"layer_norm rows={rows}")
        t, by = _bound(2 * rows * H * 2 + 2 * H * 2, 8 * rows * H, bf16)
        entry = dict(
            max_abs_err=err,
            ms=_time_ms(torch, lambda: normalize.layer_norm(x, g, b), iters=200),
            plain_ms=_time_ms(torch, lambda: normalize._ln_ref(x, g, b, 1e-5, False)),
            library_ms=_time_ms(torch, lambda: F.layer_norm(x, (H,), g, b, 1e-5), iters=200),
            bound_ms=t, bound_by=by,
            device_ms=_graph_ms(torch, lambda: normalize._ln_cuda(x, g, b, 1e-5, False)),
            library_device_ms=_graph_ms(torch, lambda: F.layer_norm(x, (H,), g, b, 1e-5)))
        if rows == 64:
            with torch.inference_mode():
                entry["host_us"] = _host_us(torch, lambda: normalize.layer_norm(x, g, b))
                entry["library_host_us"] = _host_us(
                    torch, lambda: F.layer_norm(x, (H,), g, b, 1e-5))
        report("layer_norm", f"K1 layer_norm rows={rows} H={H} bf16", entry)

    # ---- K2 / K3 over a scattered bf16 pool, and K2q / K3q over the same
    # values quantized into 1-byte pools with per-(slot, head) fp32 scales
    def pools(B, N, D, ctx, bs=16):
        P = B * ctx // bs
        pk = torch.randn(P, bs, N, D, generator=gen, device=dev).to(bf16)
        pv = torch.randn(P, bs, N, D, generator=gen, device=dev).to(bf16)
        perm = torch.randperm(P, generator=gen, device=dev)
        tables = perm.view(B, ctx // bs).to(torch.int32).contiguous()
        return pk, pv, tables

    def gathered(pool, tables, B, ctx):
        """The table's blocks of a payload or scale pool, heads first."""
        raw = byte_view(pool)
        return raw[tables.long()].reshape(B, ctx, *pool.shape[2:]).transpose(1, 2) \
            .contiguous().view(pool.dtype)

    def paged_case(B, N, D, ctx, pk, pv, tables, kv_dtype, spec=True):
        """Decode and (at D 64, unless ``spec`` is False) speculative decode
        over one pair of pools: K2 and K3 (``kv_dtype`` None) or K2q and K3q
        (the pools quantized first)."""
        scale = D ** -0.5
        sk = sv = None
        if kv_dtype is not None:
            (pk, sk), (pv, sv) = quantize_kv(pk, kv_dtype), quantize_kv(pv, kv_dtype)
        scales = {} if sk is None else {"k_scale": sk, "v_scale": sv}
        q_tag = "" if sk is None else "q"
        pool_tag = "" if sk is None else f"{kv_dtype} pool "
        K, V = gathered(pk, tables, B, ctx), gathered(pv, tables, B, ctx)
        if sk is not None:
            Ks, Vs = gathered(sk, tables, B, ctx), gathered(sv, tables, B, ctx)

        def library(q4, mask=None):
            """One SDPA call on the gathered K/V; a quantized pool's are
            dequantized with tensor ops first, inside the timed call."""
            if sk is None:
                return F.scaled_dot_product_attention(q4, K, V, attn_mask=mask)
            return F.scaled_dot_product_attention(
                q4, dequantize_kv(K, Ks, bf16), dequantize_kv(V, Vs, bf16), attn_mask=mask)

        q = torch.randn(B, N, D, generator=gen, device=dev).to(bf16)
        full = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        ragged = torch.randint(1, ctx + 1, (B,), generator=gen, device=dev,
                               dtype=torch.int32)

        def decode(lens):
            return paged.paged_decode_attention(q, pk, pv, tables, lens, **scales)

        def decode_plain(lens):
            return paged._decode_reference(q, pk, pv, tables, lens, scale, sk, sv)

        err = max(_close(torch, decode(lens), decode_plain(lens), ATTN_ATOL, ATTN_RTOL,
                         f"paged_decode{q_tag} {pool_tag}B={B} N={N} D={D}")
                  for lens in (ragged, full))
        # each live token's K and V once (a quantized one: 1-byte payload and
        # its 4-byte scale), q, the output, the tables and the lengths
        per_head = 2 * D if sk is None else D + 4
        nbytes = 2 * B * ctx * N * per_head + 2 * B * N * D * 2 + tables.numel() * 4 + B * 4
        dequant_ops = 0 if sk is None else 2 * B * N * ctx * D
        t, by = _bound(nbytes, 4 * B * N * ctx * D + dequant_ops, bf16)
        report(f"paged_decode{'_q' if q_tag else ''}",
               f"K2{q_tag} paged_decode {pool_tag}B={B} N={N} D={D} bs=16 ctx={ctx} bf16",
               dict(max_abs_err=err,
                    ms=_time_ms(torch, lambda: decode(full)),
                    plain_ms=_time_ms(torch, lambda: decode_plain(full), iters=5),
                    library_ms=_time_ms(torch, lambda: library(q[:, :, None, :])),
                    bound_ms=t, bound_by=by))
        if D != 64 or not spec:
            return

        def spec(qs, pos):
            return paged.paged_spec_decode_attention(qs, pk, pv, tables, pos, **scales)

        def spec_plain(qs, pos):
            return paged._spec_decode_reference(qs, pk, pv, tables, pos, scale, sk, sv)

        # one kernel body serves both: S 1 must equal the decode bit for bit
        _close(torch, spec(q[:, None].contiguous(), (ragged - 1)[:, None].contiguous())[:, 0],
               decode(ragged), 0.0, 0.0,
               f"paged_spec_decode{q_tag} {pool_tag}S=1 vs paged_decode{q_tag}")
        # S 4 and 8 are the buckets the served paths give K3 and K3q (S 4, the
        # served extend round, is reported first); S 5 is an extra odd case.
        for S in (4, 8, 5) if sk is None else (4, 8):
            qs = torch.randn(B, S, N, D, generator=gen, device=dev).to(bf16)
            pos = (ctx - S + torch.arange(S, device=dev, dtype=torch.int32))[None] \
                .repeat(B, 1)
            # one query of a ragged row sees fewer tokens than the last
            pos_ragged = (ragged[:, None] - S + torch.arange(S, device=dev)) \
                .clamp(min=0).to(torch.int32).contiguous()
            err = max(_close(torch, spec(qs, p), spec_plain(qs, p), ATTN_ATOL, ATTN_RTOL,
                             f"paged_spec_decode{q_tag} {pool_tag}S={S}")
                      for p in (pos_ragged, pos))
            mask = (torch.arange(ctx, device=dev)[None, None, :] <= pos[:, :, None])[:, None]
            t, by = _bound(nbytes + (S - 1) * 2 * B * N * D * 2 + B * S * 4,
                           4 * B * N * S * ctx * D + dequant_ops, bf16)
            report(f"paged_spec_decode{'_q' if q_tag else ''}",
                   f"K3{q_tag} paged_spec_decode {pool_tag}B={B} S={S} N={N} D={D} bs=16 "
                   f"ctx={ctx} bf16",
                   dict(max_abs_err=err,
                        ms=_time_ms(torch, lambda: spec(qs, pos)),
                        plain_ms=_time_ms(torch, lambda: spec_plain(qs, pos), iters=5),
                        library_ms=_time_ms(torch, lambda: library(qs.transpose(1, 2), mask)),
                        bound_ms=t, bound_by=by))

    for B, N, D, ctx in ((64, 12, 64, 1024), (64, 16, 128, 1024)):
        pk, pv, tables = pools(B, N, D, ctx)
        # fp8 before int8: it is the pool the scheduled path (phase 7) serves from
        for kv_dtype in (None, "fp8", "int8"):
            paged_case(B, N, D, ctx, pk, pv, tables, kv_dtype)
    # few sequences at long context: one CTA per (sequence, head) gives 48
    # CTAs on the 132 SMs
    B, N, D, ctx = 4, 12, 64, 4096
    pk, pv, tables = pools(B, N, D, ctx)
    paged_case(B, N, D, ctx, pk, pv, tables, None, spec=False)

    # ---- K4: sorted top-k over the GPT-NeoX vocab: 64 rows, then the
    # served sampled run's 8; device_ms is the kernel alone (a CUDA graph)
    V, k = 50304, 50
    for rows in (64, 8):
        x = torch.randn(rows, V, generator=gen, device=dev)
        masked = x.clone()
        masked[:, 20:] = float("-inf")     # fewer finite values than k
        nan = x.clone()
        nan[::2, V // 3] = float("nan")    # NaN and index V in every output
        for inp in (masked, x, nan):
            kv, ki = topk.sorted_topk(inp, k)
            rv, ri = topk._topk_reference(inp, k)
            if not (torch.equal(ki, ri) and torch.equal(kv.isnan(), rv.isnan())
                    and torch.equal(kv.nan_to_num(), rv.nan_to_num())):
                raise AssertionError("sorted_topk disagrees with its plain version")
        if not (bool(kv[::2].isnan().all()) and bool((ki[::2] == V).all())):
            raise AssertionError("sorted_topk: a row with a NaN must give NaN and index V")
        t, by = _bound(rows * V * 4 + rows * k * 8, rows * V, torch.float32)
        report("sorted_topk", f"K4 sorted_topk rows={rows} V={V} k={k} fp32", dict(
            max_abs_err=0.0,
            ms=_time_ms(torch, lambda: topk.sorted_topk(x, k)),
            plain_ms=_time_ms(torch, lambda: topk._topk_reference(x, k), iters=3),
            library_ms=_time_ms(torch, lambda: torch.topk(x, k)),
            bound_ms=t, bound_by=by,
            device_ms=_graph_ms(torch, lambda: topk._topk_cuda(x, k))))
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
    # ragged S, D 128, full (non-causal) attention and one long sequence
    for B, S, N, D, causal in ((16, 1024, 12, 64, True), (4, 1000, 12, 64, True),
                               (4, 1024, 16, 128, True), (4, 1024, 12, 64, False),
                               (1, 4096, 12, 64, True)):
        q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(bf16)
                       for _ in range(4))
        what = f"B={B} S={S} N={N} D={D} {'causal' if causal else 'full'} bf16"
        o, lse = flash._fwd_cuda(q, k, v, causal)
        ro, rlse = flash._fwd_reference(q, k, v, causal)
        err_fwd, use_o = flash_close(torch, o, ro, f"flash_fwd {what}")
        _close(torch, lse, rlse, 1e-4, 1e-5, f"flash_fwd LSE {what}")
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
        rdq, rdk, rdv = flash._bwd_reference(q, k, v, do, lse, delta, causal)
        dq = flash._dq_cuda(q, k, v, do, lse, delta, causal)
        err_dq, use_dq = flash_close(torch, dq, rdq, f"flash_bwd_dq {what}")
        if not torch.equal(dq, flash._dq_cuda(q, k, v, do, lse, delta, causal)):
            raise AssertionError(f"flash_bwd_dq {what}: two launches differ")
        dk, dv = flash._dkv_cuda(q, k, v, do, lse, delta, causal)
        (err_dk, use_dk), (err_dv, use_dv) = (
            flash_close(torch, dk, rdk, f"flash_bwd_dkv dk {what}"),
            flash_close(torch, dv, rdv, f"flash_bwd_dkv dv {what}"))
        err_dkv = max(err_dk, err_dv)
        dk2, dv2 = flash._dkv_cuda(q, k, v, do, lse, delta, causal)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash_bwd_dkv {what}: two launches differ")
        print(f"[kernels] flash {what}: share of the limit used (largest of per "
              f"element and per head) O {use_o:.3f}, dq {use_dq:.3f}, dk {use_dk:.3f}, "
              f"dv {use_dv:.3f}; dq and dk/dv repeat bit for bit", flush=True)
        del rdq, rdk, rdv, dq, dk, dv, dk2, dv2
        # live (query, key) pairs: the products' work on these inputs
        live = S * (S + 1) // 2 if causal else S * S
        mac, io, vec = B * N * D * live, B * S * N * D * 2, B * N * S * 4
        q4, k4, v4, do4 = (t.transpose(1, 2) for t in (q, k, v, do))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            torch.autograd.grad(out, (qg, kg, vg), do4)

        lib_fwd_bwd = _time_ms(torch, sdpa_fwd_bwd, iters=10)
        # the library's backward alone, from the saved forward outputs
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        lib_bwd_ops = _backward_ops(torch, out, (qg, kg, vg), do4)
        lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do4, retain_graph=True), iters=10)
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
        # device_ms: the kernel alone from a CUDA graph (at B 4 a launch takes
        # about as long on the host as on the card, so events time the host)
        def dq_call():
            return flash._dq_cuda(q, k, v, do, lse, delta, causal)

        def dkv_call():
            return flash._dkv_cuda(q, k, v, do, lse, delta, causal)

        ms_dq, dev_dq = _time_ms(torch, dq_call), _graph_ms(torch, dq_call)
        report("flash_bwd_dq", f"K7 flash_bwd_dq {what}", dict(
            max_abs_err=err_dq, ms=ms_dq, plain_ms=bwd_plain, library_ms=None,
            bound_ms=t, bound_by=by, device_ms=dev_dq))
        t, by = _bound(6 * io + 2 * vec, 4 * 2 * mac, bf16)
        ms_dkv, dev_dkv = _time_ms(torch, dkv_call), _graph_ms(torch, dkv_call)
        report("flash_bwd_dkv", f"K6 flash_bwd_dkv {what}", dict(
            max_abs_err=err_dkv, ms=ms_dkv, plain_ms=bwd_plain, library_ms=None,
            bound_ms=t, bound_by=by, device_ms=dev_dkv))
        print(f"[kernels] library yardstick {what}: SDPA backward alone "
              f"({out.grad_fn.name()}: {', '.join(lib_bwd_ops)}) {lib_bwd:.4f} ms from the "
              f"saved forward outputs; K7 + K6 together {ms_dq + ms_dkv:.4f} ms = "
              f"{(ms_dq + ms_dkv) / lib_bwd:.3f}x it (alone, from CUDA graphs, "
              f"{dev_dq + dev_dkv:.4f} ms = {(dev_dq + dev_dkv) / lib_bwd:.3f}x); SDPA "
              f"forward + backward {lib_fwd_bwd:.4f} ms (no one library call computes dq "
              f"alone or dk/dv alone, so library_ms of K6 and K7 is none; plain_ms of both "
              f"is the whole plain backward)", flush=True)
        del q, k, v, do, o, lse, ro, rlse, qg, kg, vg, out
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
    if not all(torch.equal(a, b) for a, b in zip(
            (dx, dg, db), normalize._ln_bwd_cuda(x, g, dy, 1e-5, False))):
        raise AssertionError("layer_norm_bwd: two launches differ")
    # the library's LayerNorm backward kernels alone, on the saved mean and
    # rstd of its forward (bf16 weight and bias, as under mixed precision)
    gl, bl = g.to(bf16), torch.zeros(H, device=dev, dtype=bf16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [H], gl, bl, 1e-5)

    def library():
        return torch.ops.aten.native_layer_norm_backward(dy, x, [H], mean, rstd, gl, bl,
                                                         [True, True, True])

    # and through autograd, as a training step reaches it
    xl, gr, br = (a.clone().requires_grad_() for a in (x, gl, bl))
    yl = F.layer_norm(xl, (H,), gr, br, 1e-5)
    autograd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        yl, (xl, gr, br), dy, retain_graph=True))
    print(f"[kernels] K8 yardstick rows={rows} H={H} bf16: torch.autograd.grad through "
          f"F.layer_norm {autograd_ms:.4f} ms", flush=True)
    t, by = _bound(3 * rows * H * 2 + 3 * H * 4, 20 * rows * H, torch.float32)
    report("layer_norm_bwd", f"K8 layer_norm_bwd rows={rows} H={H} bf16", dict(
        max_abs_err=err,
        ms=_time_ms(torch, lambda: normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)),
        plain_ms=_time_ms(torch, lambda: normalize._ln_bwd_ref(x, g, dy, 1e-5, False)),
        library_ms=_time_ms(torch, library),
        bound_ms=t, bound_by=by,
        device_ms=_graph_ms(torch, lambda: normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)),
        library_device_ms=_graph_ms(torch, library)))
    return rows_out


def param_shapes(cfg):
    """The parameter shapes of a GPT-NeoX config, in the module's order."""
    H, V, F4 = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    layer = [(H,), (H,), (H,), (H,), (3 * H, H), (3 * H,), (H, H), (H,),
             (F4, H), (F4,), (H, F4), (H,)]
    return [(V, H)] + layer * cfg.num_layers + [(H,), (H,), (V, H)]


def phase_optimizer_kernels(torch, rows_out):
    """Phase 3, the optimizers: B6 and B7 against their plain versions over
    Pythia-160M's parameters as the engine holds them (flat fp32 buffers,
    a view per parameter)."""
    from deeperspeed_tpu_torch.models import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.adam import fused_adam
    from deeperspeed_tpu_torch.ops.lion import fused_lion
    from deeperspeed_tpu_torch.runtime.optimizers import _bias_correction

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    report = _reporter(rows_out)
    shapes = param_shapes(GPTNeoXConfig.pythia_160m())
    n = sum(math.prod(s) for s in shapes)
    b1, b2, eps, count = 0.9, 0.999, 1e-8, 3
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    ulp2 = 2.0 ** -22                     # two fp32 ulps, relative

    def views(flat):
        out, off = [], 0
        for shape in shapes:
            size = math.prod(shape)
            out.append(flat[off:off + size].view(shape))
            off += size
        return out

    def rel_err(got, want, rtol, what, where=None):
        err = (got - want).abs()
        bad = err > rtol * want.abs()
        if where is not None:
            bad &= where
        if bool(bad.any()):
            raise AssertionError(f"{what}: kernel disagrees with its plain version "
                                 f"at {int(bad.sum())} elements (max abs err "
                                 f"{err.max().item():.3e}, rtol {rtol})")
        return err.max().item()

    g = torch.randn(n, generator=gen, device=dev) * 1e-2
    m = torch.randn(n, generator=gen, device=dev) * 1e-2
    v = torch.randn(n, generator=gen, device=dev).square() * 1e-4
    # ---- B6
    gk, mk, vk = g.clone(), m.clone(), v.clone()
    gp, mp, vp = g.clone(), m.clone(), v.clone()
    lists = [views(gk), views(mk), views(vk)]
    fused_adam.fused_adam_(*lists, count, b1, b2, eps)
    fused_adam._adam_leaf_update_plain([gp], [mp], [vp], bc1, bc2, b1, b2, eps)
    err = max(rel_err(mk, mp, ulp2, "fused_adam m"), rel_err(vk, vp, ulp2, "fused_adam v"),
              rel_err(gk, gp, 2e-6, "fused_adam u"))
    exact = bool(torch.equal(mk, mp) and torch.equal(vk, vp))
    del gp, mp, vp
    param = torch.nn.Parameter(m.clone())
    param.grad = g.clone()
    library = torch.optim.Adam([param], lr=1e-4, betas=(b1, b2), eps=eps, fused=True)
    t, by = _bound(24 * n, 12 * n, torch.float32)
    report("fused_adam", f"B6 fused_adam n={n} fp32 (library: torch.optim.Adam "
           f"fused=True, which also applies lr)", dict(
               max_abs_err=err,
               ms=_time_ms(torch, lambda: fused_adam.fused_adam_(
                   *lists, count, b1, b2, eps)),
               plain_ms=_time_ms(torch, lambda: fused_adam._adam_leaf_update_plain(
                   [gk], [mk], [vk], bc1, bc2, b1, b2, eps), iters=5),
               library_ms=_time_ms(torch, library.step),
               bound_ms=t, bound_by=by))
    print(f"[kernels] B6 m' and v' equal the plain version's bit for bit: {exact}",
          flush=True)
    del gk, mk, vk, param, library, lists
    # ---- B7
    gk, mk = g.clone(), m.clone()
    gp, mp = g.clone(), m.clone()
    lists = [views(gk), views(mk)]
    fused_lion.fused_lion_(*lists, b1, 0.99)
    fused_lion._lion_leaf_plain([gp], [mp], b1, 0.99)
    bm, bg = b1 * m, (1.0 - b1) * g
    clear = (bm + bg).abs() > ulp2 * (bm.abs() + bg.abs())
    err = rel_err(mk, mp, ulp2, "fused_lion m")
    if bool(((gk != gp) & clear).any()):
        raise AssertionError("fused_lion u: kernel's sign differs from its plain version")
    exact = bool(torch.equal(gk, gp) and torch.equal(mk, mp))
    del gp, mp, bm, bg, clear
    t, by = _bound(16 * n, 6 * n, torch.float32)
    report("fused_lion", f"B7 fused_lion n={n} fp32", dict(
        max_abs_err=err,
        ms=_time_ms(torch, lambda: fused_lion.fused_lion_(*lists, b1, 0.99)),
        plain_ms=_time_ms(torch, lambda: fused_lion._lion_leaf_plain([gk], [mk], b1, 0.99),
                          iters=5),
        library_ms=None, bound_ms=t, bound_by=by))
    print(f"[kernels] B7 u and m' equal the plain version's bit for bit: {exact}; "
          f"no PyTorch call computes Lion", flush=True)
    del g, m, v, gk, mk, lists
    torch.cuda.empty_cache()
    return rows_out


def phase_quantizer_kernel(torch, rows_out):
    """Phase 3, the qgZ path: B5 against its plain version at the input
    embedding's shape at world 2 ([2, 150912, 128]: 38,633,472 elements a
    peer, one scale a row of 128), for int8, fp8 e5m2 (the gradient wire's
    fp8) and fp8 e4m3; bit for bit."""
    from deeperspeed_tpu_torch.ops.quantizer import fused
    from deeperspeed_tpu_torch.quantization import BlockScaledTensor

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    report = _reporter(rows_out)
    n, rows, d = 2, 150912, 128
    x = torch.randn(n, rows, d, generator=gen, device=dev) * 1e-3
    for wire in ("int8", "fp8_e5m2", "fp8_e4m3"):
        t = BlockScaledTensor.quantize(x, wire, d)
        q3, s3, g = fused._normalize(t.values, t.scales, d)
        got = fused.fused_dequant_reduce(t)
        want = fused._dequant_reduce_plain(q3, s3, g)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(f"dequant_reduce {wire}: {bad} elements differ from the "
                                 f"plain version's bits")
        # each value byte and scale read once, the fp32 sum written once
        t_b, by = _bound(n * rows * d + 4 * n * rows + 4 * rows * d,
                         (2 * n - 1) * rows * d, torch.float32)
        report("dequant_reduce", f"B5 dequant_reduce {wire} [{n}, {rows}, {d}] -> fp32 "
               f"(library: none, no PyTorch call sums block-scaled peers)", dict(
                   max_abs_err=(got - want).abs().max().item(),
                   ms=_time_ms(torch, lambda: fused.fused_dequant_reduce(t)),
                   plain_ms=_time_ms(torch, lambda: fused._dequant_reduce_plain(q3, s3, g),
                                     iters=5),
                   library_ms=None, bound_ms=t_b, bound_by=by))
        print(f"[kernels] B5 {wire}: equal to the plain version bit for bit", flush=True)
    del x, t, got, want
    torch.cuda.empty_cache()
    return rows_out


# B10's full-size shape (phases 3 and 17): Pythia-160M's attention width
# over a long sequence, under the Fixed layout.
SPARSE_SHAPE = (4, 4096, 12, 64)
SPARSE_BLOCK = 128
SPARSE_FIXED = {"num_local_blocks": 4, "num_global_blocks": 1,
                "attention": "unidirectional"}
# B8/B9 tolerances in the working type: one ulp of the element (rtol) plus a
# floor.  Both sides compute in fp32 and round once, so they differ by at
# most one rounding; the floor covers results below the type's normal
# range (gelu of large negative x) and, for B8's backward, the fp32 sum
# sum(p dy) taken in another order (on unit-scale inputs, about 1e-7 of a
# term, magnified by the scale at most 1).
ULP_TOL = {"bfloat16": (2 ** -7, 1e-6), "float16": (2 ** -10, 1e-6)}


def _ulp_close(torch, got, want, what, fp32_tol):
    """fp32: the JAX tests' (rtol, atol); bf16/fp16: :data:`ULP_TOL`."""
    rtol, atol = fp32_tol if got.dtype == torch.float32 else \
        ULP_TOL[str(got.dtype).replace("torch.", "")]
    return _close(torch, got, want, atol, rtol, what)


def _live_pairs(np, layout, block, causal):
    """(query, key) pairs a layout [LH, nb, nb] keeps, summed over its heads:
    the work B10 does on these inputs (causal: the blocks below the
    diagonal whole, those on it as triangles)."""
    lay = np.asarray(layout, dtype=np.int64)
    if not causal:
        return int(lay.sum()) * block * block
    diag = int(np.trace(lay, axis1=1, axis2=2).sum())
    below = int(np.tril(lay, -1).sum())
    return below * block * block + diag * (block * (block + 1) // 2)


def _walk_lengths(np, layout, block, causal):
    """The walks of B10's Hopper backward kernels on a layout [LH, nb, nb]:
    for each layout head and 64-row tile, the live k tiles a q tile visits
    (dq) and the live q tiles a k tile visits (dk/dv), causal: at or below
    the diagonal.  Two int arrays [LH, S / 64]."""
    tpb = block // 64
    live = (np.asarray(layout) != 0).repeat(tpb, 1).repeat(tpb, 2)
    if causal:
        live = live & np.tri(live.shape[1], dtype=bool)
    return live.sum(2), live.sum(1)


def phase_legacy_kernels(torch, np, rows_out):
    """Phase 3, the legacy ops and sparse attention: B9 tanh-GELU at the
    legacy layer's FFN activation, B8 the fused softmax at attention-score
    shapes, and B10 block-sparse attention at SPARSE_SHAPE under the Fixed
    layout, each against its plain version."""
    import torch.nn.functional as F

    import deeperspeed_tpu_torch.ops.sparse_attention as sa
    from deeperspeed_tpu_torch.ops.attention import flash
    from deeperspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    from deeperspeed_tpu_torch.ops.sparse_attention import sparse_attention as _sa
    from deeperspeed_tpu_torch.ops.transformer import activations, softmax

    sparse = sys.modules[_sa.__module__]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    report = _reporter(rows_out)
    f32 = torch.float32

    # ---- B9 over [16 x 512, 3072]: the FFN activation of phase 16's batch
    for dtype in (f32, torch.bfloat16, torch.float16):
        x = (3 * torch.randn(16 * 512, 3072, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(16 * 512, 3072, generator=gen, device=dev).to(dtype)
        n, e = x.numel(), x.element_size()
        what = f"[{16 * 512}, 3072] {str(dtype).replace('torch.', '')}"
        err = _ulp_close(torch, activations._gelu_cuda(x), activations._gelu_ref(x),
                         f"gelu_fwd {what}", (1e-5, 1e-6))
        t, by = _bound(2 * n * e, 15 * n, f32)      # fp32 arithmetic whatever the type
        report("gelu_fwd", f"B9 gelu_fwd {what}", dict(
            max_abs_err=err, ms=_time_ms(torch, lambda: activations._gelu_cuda(x)),
            plain_ms=_time_ms(torch, lambda: activations._gelu_ref(x)),
            library_ms=_time_ms(torch, lambda: F.gelu(x, approximate="tanh")),
            bound_ms=t, bound_by=by,
            device_ms=_graph_ms(torch, lambda: activations._gelu_cuda(x)),
            library_device_ms=_graph_ms(torch, lambda: F.gelu(x, approximate="tanh"))))
        # the JAX test's gradient tolerance: gelu'(x) cancels near its zero
        # (x ~ -0.75), where FMA contraction moves the fp32 result by ~1e-6
        err = _ulp_close(torch, activations._dgelu_cuda(x, dy),
                         activations._dgelu_ref(x, dy), f"gelu_bwd {what}", (1e-4, 1e-5))
        t, by = _bound(3 * n * e, 20 * n, f32)
        report("gelu_bwd", f"B9 gelu_bwd {what}", dict(
            max_abs_err=err, ms=_time_ms(torch, lambda: activations._dgelu_cuda(x, dy)),
            plain_ms=_time_ms(torch, lambda: activations._dgelu_ref(x, dy)),
            library_ms=_time_ms(torch, lambda: torch.ops.aten.gelu_backward(
                dy, x, approximate="tanh")),
            bound_ms=t, bound_by=by,
            device_ms=_graph_ms(torch, lambda: activations._dgelu_cuda(x, dy)),
            library_device_ms=_graph_ms(torch, lambda: torch.ops.aten.gelu_backward(
                dy, x, approximate="tanh"))))
        del x, dy

    # ---- B8 over attention scores: [16, 12, 1024, 1024] bf16 at scale
    # 0.125, [4, 12, 1024, 1024] fp32, and a width of 1000
    for shape, dtype in (((16, 12, 1024, 1024), torch.bfloat16),
                         ((4, 12, 1024, 1024), f32), ((4, 12, 1024, 1000), torch.bfloat16)):
        x = (4 * torch.randn(*shape, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        n, e, scale = x.numel(), x.element_size(), 0.125
        what = f"{list(shape)} {str(dtype).replace('torch.', '')} scale {scale}"
        y = softmax._fwd_cuda(x, scale)
        err = _ulp_close(torch, y, softmax._softmax_ref(x, scale), f"softmax_fwd {what}",
                         (1e-5, 1e-6))
        xs = x * scale
        t, by = _bound(2 * n * e, 5 * n, f32)
        report("softmax_fwd", f"B8 softmax_fwd {what} (library: torch.softmax of the "
               f"pre-scaled input)", dict(
                   max_abs_err=err, ms=_time_ms(torch, lambda: softmax._fwd_cuda(x, scale)),
                   plain_ms=_time_ms(torch, lambda: softmax._softmax_ref(x, scale), iters=5),
                   library_ms=_time_ms(torch, lambda: torch.softmax(xs, dim=-1)),
                   bound_ms=t, bound_by=by,
                   device_ms=_graph_ms(torch, lambda: softmax._fwd_cuda(x, scale))))
        err = _ulp_close(torch, softmax._bwd_cuda(y, dy, scale),
                         softmax._softmax_bwd_ref(y, dy, scale), f"softmax_bwd {what}",
                         (1e-4, 1e-5))
        t, by = _bound(3 * n * e, 4 * n, f32)
        report("softmax_bwd", f"B8 softmax_bwd {what} (library: "
               f"torch._softmax_backward_data, without the scale)", dict(
                   max_abs_err=err, ms=_time_ms(torch, lambda: softmax._bwd_cuda(y, dy, scale)),
                   plain_ms=_time_ms(torch, lambda: softmax._softmax_bwd_ref(y, dy, scale),
                                     iters=5),
                   library_ms=_time_ms(torch, lambda: torch._softmax_backward_data(
                       dy, y, -1, dtype)),
                   bound_ms=t, bound_by=by))
        del x, dy, y, xs
        torch.cuda.empty_cache()

    # ---- B10 at SPARSE_SHAPE, bf16, block 128, Fixed layout, causal
    B, S, N, D = SPARSE_SHAPE
    bf16, causal, scale = torch.bfloat16, True, D ** -0.5
    cfg = FixedSparsityConfig(num_heads=N, block=SPARSE_BLOCK, **SPARSE_FIXED)
    host_layout = cfg.make_layout(S)
    layout = sparse.device_layout(host_layout, dev)
    q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(bf16)
                   for _ in range(4))
    what = f"B={B} S={S} N={N} D={D} block {SPARSE_BLOCK} Fixed causal bf16"

    def fwd_call():
        return sparse._fwd_cuda(q, k, v, layout, causal, scale, SPARSE_BLOCK)

    o, lse = fwd_call()
    ro, rlse = sparse._fwd_reference(q, k, v, layout, causal, scale)
    err_fwd, use_o = flash_close(torch, o, ro, f"sparse_fwd {what}")
    _close(torch, lse, rlse, 1e-4, 1e-5, f"sparse_fwd LSE {what}")
    o2, lse2 = fwd_call()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"sparse_fwd {what}: two launches differ")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
    rdq, rdk, rdv = sparse._bwd_reference(q, k, v, do, lse, delta, layout, causal, scale)

    def dq_call():
        return sparse._dq_cuda(q, k, v, do, lse, delta, layout, causal, scale, SPARSE_BLOCK)

    def dkv_call():
        return sparse._dkv_cuda(q, k, v, do, lse, delta, layout, causal, scale, SPARSE_BLOCK)

    dq, (dk, dv) = dq_call(), dkv_call()
    err_dq, use_dq = flash_close(torch, dq, rdq, f"sparse_bwd_dq {what}")
    (err_dk, use_dk), (err_dv, use_dv) = (flash_close(torch, dk, rdk, f"sparse dk {what}"),
                                          flash_close(torch, dv, rdv, f"sparse dv {what}"))
    dk2, dv2 = dkv_call()
    if not (torch.equal(dq, dq_call()) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"sparse backward {what}: two launches differ")
    print(f"[kernels] sparse {what}: share of the limit used O {use_o:.3f}, dq "
          f"{use_dq:.3f}, dk {use_dk:.3f}, dv {use_dv:.3f}; the forward, dq and dk/dv "
          f"repeat bit for bit", flush=True)
    del rdq, rdk, rdv, ro, rlse, dq, dk, dv, dk2, dv2, o2, lse2
    torch.cuda.empty_cache()
    # the Hopper backward's walks under each of phase 17's layouts (a long
    # dk/dv walk at the end of the grid is a tail)
    for name, (cls, kw, cfg_causal) in SPARSE_CONFIGS.items():
        lay = getattr(sa, cls)(num_heads=N, block=SPARSE_BLOCK, **kw).make_layout(S)
        dq_walk, dkv_walk = _walk_lengths(np, lay, SPARSE_BLOCK, cfg_causal)
        print(f"[kernels] B10 walk {name} ({'causal' if cfg_causal else 'full'}): 64-row "
              f"tiles visited by a forward or dq CTA largest {dq_walk.max()} mean "
              f"{dq_walk.mean():.2f}, "
              f"by a dk/dv CTA largest {dkv_walk.max()} mean {dkv_walk.mean():.2f} "
              f"(of {S // 64})", flush=True)
    live = _live_pairs(np, host_layout, SPARSE_BLOCK, causal)
    density = live / (N * (S * (S + 1) // 2))
    mac, io, vec = B * live * D, B * S * N * D * 2, B * N * S * 4
    # the library yardstick: SDPA with the layout expanded to a token mask
    tok = sparse._token_mask(layout, S, causal)            # [1 or N, S, S] bool
    q4, k4, v4, do4 = (t.transpose(1, 2) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    lib_fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                    attn_mask=tok), iters=5)
    # its backward alone, from the saved forward outputs: event-timed, and
    # its kernels' device time (torch.profiler)
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=tok)
    lib_bwd_ops = _backward_ops(torch, out, (qg, kg, vg), do4)

    def sdpa_bwd():
        return torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True)

    lib_bwd = _time_ms(torch, sdpa_bwd, iters=5)
    lib_bwd_kernels = _kernels_ms(torch, sdpa_bwd, iters=5)
    lib_bwd_dev = sum(lib_bwd_kernels.values())
    t, by = _bound(4 * io + vec, 2 * 2 * mac, bf16)
    dev_fwd = _graph_ms(torch, fwd_call)
    report("sparse_fwd", f"B10 sparse_fwd {what} (live share {density:.4f})", dict(
        max_abs_err=err_fwd, ms=_time_ms(torch, fwd_call),
        plain_ms=_time_ms(torch, lambda: sparse._fwd_reference(q, k, v, layout, causal,
                                                               scale), iters=3),
        library_ms=lib_fwd, bound_ms=t, bound_by=by, device_ms=dev_fwd))
    bwd_plain = _time_ms(torch, lambda: sparse._bwd_reference(
        q, k, v, do, lse, delta, layout, causal, scale), iters=3)
    t, by = _bound(5 * io + 2 * vec, 3 * 2 * mac, bf16)
    ms_dq, dev_dq = _time_ms(torch, dq_call), _graph_ms(torch, dq_call)
    report("sparse_bwd_dq", f"B10 sparse_bwd_dq {what}", dict(
        max_abs_err=err_dq, ms=ms_dq, plain_ms=bwd_plain, library_ms=lib_bwd_dev,
        bound_ms=t, bound_by=by, device_ms=dev_dq))
    t, by = _bound(6 * io + 2 * vec, 4 * 2 * mac, bf16)
    ms_dkv, dev_dkv = _time_ms(torch, dkv_call), _graph_ms(torch, dkv_call)
    report("sparse_bwd_dkv", f"B10 sparse_bwd_dkv {what}", dict(
        max_abs_err=max(err_dk, err_dv), ms=ms_dkv, plain_ms=bwd_plain,
        library_ms=lib_bwd_dev, bound_ms=t, bound_by=by, device_ms=dev_dkv))
    print(f"[kernels] B10 library yardstick {what}: SDPA backward alone under the token mask "
          f"({out.grad_fn.name()}: {', '.join(lib_bwd_ops)}) {lib_bwd:.4f} ms event-timed, "
          f"its kernels {lib_bwd_dev:.4f} ms ("
          + ", ".join(f"{n} {ms:.4f}" for n, ms in sorted(lib_bwd_kernels.items()))
          + f"); B10 dq + dk/dv alone {dev_dq + dev_dkv:.4f} ms = "
          f"{(dev_dq + dev_dkv) / lib_bwd_dev:.3f}x it (library_ms of both passes is the "
          f"whole SDPA backward's kernels; plain_ms of both is the whole plain backward)",
          flush=True)
    # dense flash at the same shape: time scales with the live share
    fo, flse = flash._fwd_cuda(q, k, v, causal)
    fdelta = (do.float() * fo.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
    dense_calls = (lambda: flash._fwd_cuda(q, k, v, causal),
                   lambda: flash._dq_cuda(q, k, v, do, flse, fdelta, causal),
                   lambda: flash._dkv_cuda(q, k, v, do, flse, fdelta, causal))
    dense = [_time_ms(torch, fn) for fn in dense_calls]
    dense_dev = [_graph_ms(torch, fn) for fn in dense_calls]
    print(f"[kernels] B10 beside dense flash at {what}: K5 {dense[0]:.4f} ms, K7 "
          f"{dense[1]:.4f} ms, K6 {dense[2]:.4f} ms over all {S * (S + 1) // 2} causal "
          f"pairs a head (alone, from CUDA graphs: K5 {dense_dev[0]:.4f}, K7 "
          f"{dense_dev[1]:.4f}, K6 {dense_dev[2]:.4f}); the layout keeps {density:.4f} of "
          f"them.  B10's forward alone {dev_fwd:.4f} ms = {dev_fwd / dense_dev[0]:.3f}x "
          f"K5's; its backward alone {dev_dq + dev_dkv:.4f} ms = "
          f"{(dev_dq + dev_dkv) / sum(dense_dev[1:]):.3f}x dense flash's "
          f"({sum(dense_dev[1:]):.4f} ms)", flush=True)
    del q, k, v, do, o, lse, delta, tok, q4, k4, v4, do4, qg, kg, vg, out, fo, flse, fdelta
    torch.cuda.empty_cache()
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


def _pool_clean(eng):
    """Raise unless every KV block is free again (cached prefix blocks
    evicted first) and the allocator's audit holds."""
    sm = eng.state_manager
    total = sm.allocator.total_blocks
    if sm.prefix_cache is not None:
        sm.prefix_cache.evict(total)
    sm.allocator.audit()
    if sm.allocator.free_blocks != total:
        raise AssertionError(f"KV blocks leaked: {sm.allocator.free_blocks} of "
                             f"{total} free after the run")


def phase_scheduled_checked(torch, np):
    """Phase 6: fp32 scheduler + fp8 pool + speculation, card vs CPU."""
    from deeperspeed_tpu_torch.inference.v2 import DSScheduler, InferenceEngineV2
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig

    # TF32 stays off (phase 4): fp32 products in full fp32
    two_layers = dataclasses.replace(GPTNeoXConfig.pythia_160m(), num_layers=2)
    new_tokens = 24

    def ecfg(speculative):
        cfg = {"dtype": "float32",
               "kv_cache": {"num_blocks": 128, "block_size": 16, "dtype": "fp8"},
               "state_manager": {"max_context": 256, "max_ragged_batch_size": 128,
                                 "max_decode_batch": 4}}
        if speculative:
            cfg["speculative"] = {"method": "ngram", "k": SCHEDULED_SPEC_K}
        return cfg

    prompts = scheduled_prompts(np, two_layers.vocab_size, 4, lo=24, hi=72)
    runs = {}
    for name, device, speculative in (("card, speculative", None, True),
                                      ("card, plain", None, False),
                                      ("CPU, speculative", "cpu", True)):
        eng = InferenceEngineV2(GPTNeoX(two_layers, device="cpu", seed=SEED),
                                ecfg(speculative), device=device)
        sched = DSScheduler(eng, prefill_chunk=48)      # the longer prompts run in chunks
        runs[name] = sched.generate([p.copy() for p in prompts], new_tokens)
        _pool_clean(eng)
        print(f"[scheduled-checked] {name}: {eng.dispatch_count} rounds", flush=True)
    want = runs["card, speculative"]
    for name in ("card, plain", "CPU, speculative"):
        for i, (a, b) in enumerate(zip(want, runs[name])):
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"prompt {i}: card speculative tokens {a[-new_tokens:].tolist()} "
                    f"differ from {name} {b[-new_tokens:].tolist()}")
    print(f"[scheduled-checked] Pythia-160M width, 2 layers, fp32, fp8 KV pool, 4 prompts "
          f"of {min(map(len, prompts))}-{max(map(len, prompts))} tokens in 48-token chunks, "
          f"{new_tokens} new tokens each: greedy tokens equal card vs CPU, and "
          f"speculative (n-gram, k {SCHEDULED_SPEC_K}) vs plain on the card", flush=True)
    torch.cuda.empty_cache()


def phase_scheduled(torch, np, launches):
    """Phase 7: DSScheduler.generate over the fp8 pool at full size, with
    speculation (K3q) and without (K2q); then the bf16 pool without
    speculation for comparison.  Returns the fp8 runs' launch counts."""
    from deeperspeed_tpu_torch.inference.v2 import DSScheduler, InferenceEngineV2
    from deeperspeed_tpu_torch.telemetry import (TelemetryRegistry, get_registry,
                                                 serving, set_registry)

    model = served_model()
    cfg = model.config
    prompts = scheduled_prompts(np, cfg.vocab_size, SCHEDULED_BATCH)
    new_total = SCHEDULED_BATCH * SCHEDULED_NEW_TOKENS
    old_reg, results = get_registry(), {}
    for name, kv_dtype, speculative in (("fp8 pool, n-gram k 4", "fp8", True),
                                        ("fp8 pool, plain", "fp8", False),
                                        ("bf16 pool, plain", "", False)):
        # the registry is on in both runs: it holds the speculation counters
        reg = set_registry(TelemetryRegistry(enabled=True, jsonl=False))
        eng = InferenceEngineV2(model, scheduled_ecfg(cfg.head_dim, kv_dtype, speculative))
        sched = DSScheduler(eng)
        step, decode_ms = sched.step, []

        def timed_step():
            # a round with nothing waiting is pure decode (put_round waits
            # for the round's tokens, so the host clock covers the device)
            pure_decode = not sched.waiting
            t = time.perf_counter()
            out = step()
            if pure_decode:
                decode_ms.append((time.perf_counter() - t) * 1e3)
            return out

        sched.step = timed_step
        launches.clear()                              # main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = sched.generate([p.copy() for p in prompts], SCHEDULED_NEW_TOKENS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(launches)
        for p, o in zip(prompts, outs):
            new = o[len(p):]
            if len(new) != SCHEDULED_NEW_TOKENS or new.min() < 0 or new.max() >= cfg.vocab_size:
                raise AssertionError(f"scheduled run ({name}) gave bad tokens")
        if sched.step_failure_count:
            raise AssertionError(f"scheduled run ({name}): {sched.step_failure_count} "
                                 f"failed rounds")
        _pool_clean(eng)
        rounds = eng.dispatch_count
        drafted = reg.counter(serving.SPEC_DRAFTED).total
        accepted = reg.counter(serving.SPEC_ACCEPTED).total
        prompt_tokens = sum(map(len, prompts))
        print(f"[scheduled] {name}: KV pools {eng.kv_pool_bytes / 1e9:.3f} GB in "
              f"{eng.config.kv_cache.num_blocks} blocks of "
              f"{eng.config.kv_cache.block_size}; {SCHEDULED_BATCH} prompts "
              f"({prompt_tokens} tokens) + {new_total} new tokens in {dt:.3f} s: "
              f"{new_total / dt:.1f} new tokens/s, {rounds} rounds, "
              f"{dt / rounds * 1e3:.2f} ms/round wall, "
              f"{new_total / rounds:.1f} new tokens/round; {len(decode_ms)} pure-decode "
              f"rounds, median {np.median(decode_ms):.2f} ms wall; "
              f"drafted {int(drafted)} accepted {int(accepted)} "
              f"(accept rate {accepted / drafted if drafted else 0.0:.3f}), "
              f"speculation breaches {sched.governor.breaches}, "
              f"preemptions {sched.preemption_count}; launches "
              f"{sum(counts.values())} ({sum(counts.values()) / rounds:.1f} a round) {counts}",
              flush=True)
        results[name] = (outs, counts)
        del eng, sched
        torch.cuda.empty_cache()
    set_registry(old_reg)
    (spec_outs, spec_counts), (fp8_outs, fp8_counts), (bf16_outs, _) = results.values()
    if spec_counts.get("layer_norm", 0) < 1 or spec_counts.get("paged_spec_decode_q", 0) < 1:
        raise AssertionError(f"speculative fp8 run never launched K1 and K3q: {spec_counts}")
    if fp8_counts.get("layer_norm", 0) < 1 or fp8_counts.get("paged_decode_q", 0) < 1:
        raise AssertionError(f"plain fp8 run never launched K1 and K2q: {fp8_counts}")
    counts = {k: spec_counts.get(k, 0) + fp8_counts.get(k, 0)
              for k in {*spec_counts, *fp8_counts}}
    if counts.get("paged_decode", 0) or counts.get("paged_spec_decode", 0):
        raise AssertionError(f"fp8 pool went through the fp kernels: {counts}")

    def equal_share(a_outs, b_outs):
        equal = sum(int((a[len(p):] == b[len(p):]).sum())
                    for p, a, b in zip(prompts, a_outs, b_outs))
        first = [next((i for i in range(SCHEDULED_NEW_TOKENS)
                       if a[len(p) + i] != b[len(p) + i]), SCHEDULED_NEW_TOKENS)
                 for p, a, b in zip(prompts, a_outs, b_outs)]
        return f"{equal / new_total:.4f} equal, median equal prefix " \
               f"{int(np.median(first))} of {SCHEDULED_NEW_TOKENS}"

    print(f"[scheduled] greedy tokens of {new_total} (reported, not asserted: bf16 "
          f"products at other batch shapes, random weights, and a first differing token "
          f"changes the rest of its sequence): fp8 speculative vs fp8 plain "
          f"{equal_share(spec_outs, fp8_outs)}; fp8 plain vs bf16 plain "
          f"{equal_share(fp8_outs, bf16_outs)}; fp8 speculative vs bf16 plain "
          f"{equal_share(spec_outs, bf16_outs)}", flush=True)
    return counts


def phase_trained_checked(torch, np):
    """Phase 8: fp32 training, 2 full-width layers, on the card vs the CPU."""
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
    """Phase 9: bench.py's training step, timed; counts kernel launches."""
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


def phase_fused_checked(torch, np):
    """Phase 10: FusedAdam, FusedLion, and Adam with the chunked loss, block
    recompute and the legacy API, 2 full-width layers in fp32, card vs CPU."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig

    # TF32 stays off (phase 4): fp32 products in full fp32
    tol = 1e-4     # summation order over 768-4096-wide products and the CE (phase 8)
    base = {"train_batch_size": 2, "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
    cases = {
        "FusedAdam, weight decay 0.01": (
            {**base, "optimizer": {"type": "FusedAdam",
                                   "params": {"lr": 1e-4, "weight_decay": 0.01}}}, {}),
        "FusedLion, weight decay 0.01": (
            {**base, "optimizer": {"type": "FusedLion",
                                   "params": {"lr": 1e-5, "weight_decay": 0.01}}}, {}),
        "Adam, ce_chunk_tokens 96, recompute, gas 2, legacy API": (
            {**base, "gradient_accumulation_steps": 2,
             "activation_checkpointing": {"partition_activations": True}},
            {"ce_chunk_tokens": 96}),
    }
    for name, (cfg, model_kw) in cases.items():
        two_layers = dataclasses.replace(GPTNeoXConfig.pythia_160m(**model_kw), num_layers=2)
        engines = [dst.initialize(model=GPTNeoX(two_layers, device=d, seed=SEED),
                                  config=cfg, device=d)[0] for d in ("cuda", "cpu")]
        legacy = "legacy" in name
        rng = np.random.default_rng(SEED + 6)
        V = two_layers.vocab_size
        worst = 0.0
        for step in range(3):
            toks = rng.integers(0, V, (2, 129))
            batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
            losses = []
            for e in engines:
                if legacy:        # one row a microbatch, through forward/backward/step
                    micro = [float(e.backward(e.forward({k: v[i:i + 1] for k, v in
                                                         batch.items()})))
                             for i in range(2)]
                    e.step()
                    losses.append(sum(micro) / 2)
                else:
                    losses.append(float(e.train_batch(batch=batch)))
            lg, lc = losses
            rel = abs(lg - lc) / abs(lc)
            worst = max(worst, rel)
            if not (math.isfinite(lg) and rel <= tol):
                raise AssertionError(f"{name}, step {step}: card loss {lg} vs CPU {lc}")
        msg = ""
        if legacy:
            card = engines[0]
            dev_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
            with torch.no_grad():
                chunked = float(card._loss_fn(card.module, dev_batch, None))
                card.module.replace_config(ce_chunk_tokens=0)
                whole = float(card.module.loss_fn()(card.module, dev_batch, None))
                card.module.replace_config(ce_chunk_tokens=96)
            if abs(chunked - whole) > 1e-5 * abs(whole):
                raise AssertionError(f"chunked loss {chunked} vs monolithic {whole}")
            msg = (f"; on the card the chunked loss {chunked:.7f} vs monolithic "
                   f"{whole:.7f} ({abs(chunked - whole) / abs(whole):.2e} relative, tol 1e-5)")
        print(f"[fused-checked] Pythia-160M width, 2 layers, fp32, B 2 x S 128, {name}: "
              f"3 steps, losses card vs CPU within {worst:.2e} relative (tol {tol}); "
              f"last loss {lg:.6f}{msg}", flush=True)
        del engines
        torch.cuda.empty_cache()


def _fused_flops_share(cfg, n_params, tokens_per_s):
    """Phase 9's model-FLOPs share: 6 N (input embedding excluded) + the
    attention term, over 989 TFLOP/s."""
    flops_per_token = 6 * (n_params - cfg.vocab_size * cfg.hidden_size) \
        + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ
    return flops_per_token * tokens_per_s / PEAK_OPS_PER_S["bfloat16"]


def phase_fused_trained(torch, np, launches):
    """Phase 11: the slice's main path at full size, timed; counts kernel
    launches.  Returns the FusedAdam run's counts and the FusedLion run's."""
    import deeperspeed_tpu_torch as dst

    model = fused_trained_model()
    data = fused_training_data(np, model.config.vocab_size)
    engine = dst.initialize(model=model, config=FUSED_TRAIN_CONFIG, training_data=data)[0]
    cfg = engine.module.config
    if not cfg.remat:
        raise AssertionError("activation_checkpointing did not turn block recompute on")
    for _ in range(2):                                # warm-up
        loss = engine.train_batch()
    first = float(loss)
    torch.cuda.reset_peak_memory_stats()
    launches.clear()                                  # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        loss = engine.train_batch()
    loss = float(loss)                                # waits for the last step
    dt = time.perf_counter() - t0
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (math.isfinite(first) and math.isfinite(loss)):
        raise AssertionError(f"non-finite training loss: {first}, {loss}")
    if counts.get("fused_adam", 0) != TRAIN_STEPS:
        raise AssertionError(f"fused_adam launched {counts.get('fused_adam', 0)} times in "
                             f"{TRAIN_STEPS} steps: {counts}")
    for name in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"training never launched {name}: {counts}")
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / dt
    n_params = sum(p.numel() for p in engine.master_params.values())
    print(f"[fused-trained] Pythia-160M bf16, B {TRAIN_BATCH} x S {TRAIN_SEQ}, FusedAdam, "
          f"clip 1.0, ZeRO-0, training_data= ({FUSED_DATA_BATCHES} batches) and "
          f"train_batch(), ce_chunk_tokens {FUSED_CE_CHUNK}, block recompute: "
          f"{dt / TRAIN_STEPS * 1e3:.2f} ms/step over {TRAIN_STEPS} steps, "
          f"{tokens_per_s:.1f} tokens/s, model-FLOPs share "
          f"{_fused_flops_share(cfg, n_params, tokens_per_s):.4f} of 989 TFLOP/s; loss "
          f"{first:.4f} -> {loss:.4f}; peak memory {peak:.2f} GB", flush=True)
    print(f"[fused-trained] launches in the timed steps {counts}", flush=True)
    del engine
    torch.cuda.empty_cache()

    lion_cfg = {**FUSED_TRAIN_CONFIG,
                "optimizer": {"type": "FusedLion", "params": {"lr": 1e-5}}}
    engine = dst.initialize(model=fused_trained_model(), config=lion_cfg,
                            training_data=data)[0]
    launches.clear()                                  # the Lion run starts here
    losses = [float(engine.train_batch()) for _ in range(3)]
    lion = dict(launches)
    if lion.get("fused_lion", 0) != 3 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"FusedLion run: losses {losses}, launches {lion}")
    print(f"[fused-trained] FusedLion lr 1e-5, 3 steps: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches {lion}", flush=True)
    del engine, model
    torch.cuda.empty_cache()
    return counts, lion


def phase_dropout(torch, np, launches):
    """Phase 12: hidden and attention dropout 0.1 on the card, bf16."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig

    def two_layers(rate):
        return dataclasses.replace(
            GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16, hidden_dropout=rate,
                                      attention_dropout=rate), num_layers=2)

    cfg = {"train_batch_size": 4, "gradient_clipping": 1.0, "bf16": {"enabled": True},
           "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}}}
    engines = [dst.initialize(model=GPTNeoX(two_layers(0.1), seed=SEED), config=cfg)[0]
               for _ in range(2)]
    rng = np.random.default_rng(SEED + 7)
    V = engines[0].module.config.vocab_size
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    runs = []
    for step in range(3):
        toks = rng.integers(0, V, (4, 257))
        batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
        before = {k: launches.get(k, 0) for k in flash}
        runs.append([float(e.train_batch(batch=batch)) for e in engines])
        after = {k: launches.get(k, 0) for k in flash}
        if after != before:
            raise AssertionError(f"training with dropout launched flash: {before} -> {after}")
    if not all(math.isfinite(x) for r in runs for x in r) or any(a != b for a, b in runs):
        raise AssertionError(f"dropout runs from one seed differ or are not finite: {runs}")
    eval_batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    got = float(engines[0].eval_batch(batch=eval_batch))
    plain = dst.initialize(model=GPTNeoX(two_layers(0.0), seed=SEED), config=cfg,
                           model_parameters={n: t.clone() for n, t in
                                             engines[0].master_params.items()})[0]
    want = float(plain.eval_batch(batch=eval_batch))
    if got != want:
        raise AssertionError(f"eval_batch with dropout configured {got} != without {want}")
    print(f"[dropout] Pythia-160M width, 2 layers, bf16, hidden and attention dropout "
          f"0.1, B 4 x S 256, 3 FusedAdam steps: losses "
          f"{', '.join(f'{r[0]:.6f}' for r in runs)}, equal in two engines from one seed; "
          f"flash counters flat while training; eval_batch {got:.6f} equals the same "
          f"weights without dropout", flush=True)
    del engines, plain
    torch.cuda.empty_cache()


def _engine_record(torch, eng, losses, b5):
    """What a data-parallel run reports of its engine: losses, the first
    grad norm, the elements it holds, B5's launches a step."""
    from deeperspeed_tpu_torch.utils.tree import tree_leaves

    return {"losses": losses, "grad_norm0": None, "b5": b5,
            "master_numel": sum(t.numel() for t in eng.master_params.values()),
            "opt_numel": sum(t.numel() for t in tree_leaves(eng.opt_state)
                             if isinstance(t, torch.Tensor)),
            "shard_numel": sum(g.shard.numel() for *_, g in eng._compute if g is not None)}


def dp_worker(rank, rendezvous, out_path):
    """One of the two processes of phases 13 and 14 (``--dp-worker``): joins
    the gloo group, runs every data-parallel configuration, and writes what
    it saw to ``out_path`` as JSON.  The parent checks it."""
    import numpy as np
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=DP_WORLD, timeout=600)
    results = {}
    batches = None
    for name, cfg in DP_CHECK_RUNS.items():              # phase 13
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        eng = dst.initialize(model=dp_check_model(), config=cfg)[0]
        batches = batches or dp_check_batches(np, eng.module.config.vocab_size)
        losses, b5, norm0 = [], [], None
        for step, b in enumerate(batches):
            LAUNCHES.clear()
            losses.append(float(eng.train_batch(batch=b)))
            b5.append(LAUNCHES["dequant_reduce"])
            norm0 = eng.get_global_grad_norm() if step == 0 else norm0
        rec = _engine_record(torch, eng, losses, b5)
        rec.update(grad_norm0=norm0, allocated=torch.cuda.memory_allocated() - base)
        results[name] = rec
        del eng
        torch.cuda.empty_cache()
    for name, cfg in DP_FULL_RUNS.items():               # phase 14
        model = trained_model()
        eng = dst.initialize(model=model, config=cfg)[0]
        batch = {k: v.cuda() for k, v in trained_batch(model).items()}
        first = float(eng.train_batch(batch=batch))      # warm-up
        torch.cuda.reset_peak_memory_stats()
        comm.STAGED.clear()
        comm.STAGED_SECONDS.clear()
        LAUNCHES.clear()                                  # main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(eng.train_batch(batch=batch)) for _ in range(DP_FULL_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = _engine_record(torch, eng, [first] + losses,
                             LAUNCHES["dequant_reduce"] / DP_FULL_STEPS)
        rec.update(ms_per_step=dt / DP_FULL_STEPS * 1e3, launches=dict(LAUNCHES),
                   staged_bytes_per_step=sum(comm.STAGED.values()) / DP_FULL_STEPS,
                   staged_ms_per_step={op: t / DP_FULL_STEPS * 1e3
                                       for op, t in comm.STAGED_SECONDS.items()},
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        results[f"full-{name}"] = rec
        del eng, model
        torch.cuda.empty_cache()
    # phase 19: phase 13's stage-2 run saved at world 2, for the parent to
    # load at world 1
    eng = dst.initialize(model=dp_check_model(),
                         config={**DP_CHECK_CONFIG, "zero_optimization": {"stage": 2}})[0]
    for b in batches:
        eng.train_batch(batch=b)
    ckpt_dir = Path(out_path).parent / "checkpoint"
    t0 = time.perf_counter()
    eng.save_checkpoint(str(ckpt_dir))
    results["ckpt-stage2"] = {"dir": str(ckpt_dir), "save_s": time.perf_counter() - t0,
                              "digest": _ckpt_digest(torch, eng),
                              "step_count": eng.step_count}
    del eng
    torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(results, f)
    comm.destroy()
    return 0


def _spawn_dp_workers(workdir):
    """Start the two ``--dp-worker`` processes; returns them with their log
    and result paths."""
    procs = []
    for rank in range(DP_WORLD):
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", str(rank),
             str(workdir / "rendezvous"), str(workdir / f"rank{rank}.json")],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log,
            workdir / f"rank{rank}.log", workdir / f"rank{rank}.json"))
    return procs


def _join_dp_workers(procs, timeout=900):
    """Wait for every worker; if one fails or the time runs out, stop the
    others and raise with the failed ones' log tails."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, *_ in procs):
            if any(p.poll() not in (None, 0) for p, *_ in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log, *_ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    failed = [(rank, p.returncode, path.read_text()[-4000:])
              for rank, (p, _, path, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError("data-parallel worker failed: " + "; ".join(
            f"rank {r} exit {rc}:\n{tail}" for r, rc, tail in failed))
    return [json.loads(out.read_text()) for *_, out in procs]


def phase_dp(torch, np):
    """Phases 13 and 14: the one process of phase 13 on the card, then the
    two workers (spawned once, after the build), then the checks.  Returns
    rank 0's launch counts of phase 14's stage-2 and qgZ runs, and what rank
    0 recorded of its stage-2 checkpoint (phase 19)."""
    import deeperspeed_tpu_torch as dst

    # phase 13's reference: one process on the card, same weights and batches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ref = dst.initialize(model=dp_check_model(), config=DP_CHECK_CONFIG)[0]
    batches = dp_check_batches(np, ref.module.config.vocab_size)
    ref_losses = []
    for step, b in enumerate(batches):
        ref_losses.append(float(ref.train_batch(batch=b)))
        if step == 0:
            ref_norm = ref.get_global_grad_norm()
    ref_alloc = torch.cuda.memory_allocated() - base
    total = sum(t.numel() for t in ref.master_params.values())
    partitioned = sum(p.numel() for p in ref.module.parameters()
                      if p.dim() >= 2 and p.numel() >= 100_000)
    n_big = sum(p.numel() >= 128 * DP_WORLD for p in ref.module.parameters())
    del ref
    torch.cuda.empty_cache()

    build = ROOT / ".build"
    build.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    r0, r1 = _join_dp_workers(_spawn_dp_workers(Path(tempfile.mkdtemp(dir=build))))
    print(f"[dp] two workers on the card over gloo: {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_dp_checked(r0, r1, ref_losses, ref_norm, ref_alloc, total, partitioned, n_big)
    return phase_dp_full(r0, r1), r0["ckpt-stage2"]


def phase_dp_checked(r0, r1, ref_losses, ref_norm, ref_alloc, total, partitioned, n_big):
    """Phase 13's checks.  qgZ tolerances: losses within 1e-3 relative from
    the second on (the first comes before any update, within 1e-4): on the
    CPU the quantized reduction moves tiny()'s losses by at most 1.1e-4
    relative from the exact one after two Adam steps at lr 1e-3
    (tests/test_torch_zero.py); here lr is 1e-4.  The first grad norm,
    which is of the quantized gradient itself, within 1e-2: fp8 e5m2 keeps
    3 significant bits (each value within 6.25%), int8 7 (a group's values
    within 0.4% of its largest); on tiny() on the CPU the norm moved 2.5e-3
    under e5m2."""
    tol = 1e-4      # phase 8's: summation order over the products and the CE
    for name in DP_CHECK_RUNS:
        a, b = r0[name], r1[name]
        if a["losses"] != b["losses"]:
            raise AssertionError(f"{name}: ranks report different losses "
                                 f"{a['losses']} / {b['losses']}")
        rels = [abs(x - y) / abs(y) for x, y in zip(a["losses"], ref_losses)]
        qgz = name.startswith("qgz")
        limit = [tol] + [DP_QGZ_TOL if qgz else tol] * (len(rels) - 1)
        if any(r > lim for r, lim in zip(rels, limit)):
            raise AssertionError(f"{name}: losses {a['losses']} vs one process "
                                 f"{ref_losses} (relative {rels})")
        if abs(a["grad_norm0"] - ref_norm) > (DP_QGZ_NORM_TOL if qgz else tol) * ref_norm:
            raise AssertionError(f"{name}: first grad norm {a['grad_norm0']} vs {ref_norm}")
        want_b5 = [n_big] * DP_CHECK_STEPS if qgz else [0] * DP_CHECK_STEPS
        if a["b5"] != want_b5 or b["b5"] != want_b5:
            raise AssertionError(f"{name}: B5 launches a step {a['b5']} / {b['b5']}, "
                                 f"expected {want_b5}")
        held = [a["master_numel"], b["master_numel"]]
        stage = int(name[-1]) if name.startswith("stage") else 0
        if stage >= 1 and (sum(held) != total or max(held) > math.ceil(total / 2)):
            raise AssertionError(f"{name}: masters held {held} of {total}")
        if stage == 0 and held != [total, total]:
            raise AssertionError(f"{name}: masters held {held} of {total}")
        if a["opt_numel"] != 2 * held[0] or b["opt_numel"] != 2 * held[1]:
            raise AssertionError(f"{name}: Adam moments {a['opt_numel']} / "
                                 f"{b['opt_numel']} for masters {held}")
        if stage == 3:
            shards = [a["shard_numel"], b["shard_numel"]]
            if not all(partitioned / 2 <= x <= partitioned / 2 + 8 for x in shards):
                raise AssertionError(f"stage 3: compute partitions {shards} of "
                                     f"{partitioned}")
            if not max(a["allocated"], b["allocated"]) < ref_alloc:
                raise AssertionError(f"stage 3: {a['allocated']} / {b['allocated']} bytes "
                                     f"allocated, one process {ref_alloc}")
        print(f"[dp-checked] {name}: losses {', '.join(f'{x:.6f}' for x in a['losses'])} "
              f"on both ranks (one process {', '.join(f'{x:.6f}' for x in ref_losses)}; "
              f"max relative {max(rels):.2e}); grad norm {a['grad_norm0']:.6f} vs "
              f"{ref_norm:.6f}; masters held {held} of {total}; B5 a step {a['b5']}; "
              f"allocated {a['allocated'] / 1e9:.3f} GB (one process "
              f"{ref_alloc / 1e9:.3f} GB)", flush=True)


def phase_dp_full(r0, r1):
    """Phase 14's checks and readings."""
    from deeperspeed_tpu_torch.models import GPTNeoXConfig

    n_big = sum(math.prod(s) >= 128 * DP_WORLD
                for s in param_shapes(GPTNeoXConfig.pythia_160m()))
    counts = {}
    for name in DP_FULL_RUNS:
        a, b = r0[f"full-{name}"], r1[f"full-{name}"]
        if a["losses"] != b["losses"] or not all(map(math.isfinite, a["losses"])):
            raise AssertionError(f"full {name}: losses {a['losses']} / {b['losses']}")
        want = n_big if name.startswith("qgz") else 0
        if a["b5"] != want or b["b5"] != want:
            raise AssertionError(f"full {name}: B5 launches a step {a['b5']} / "
                                 f"{b['b5']}, expected {want}")
        for kernel in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                       "flash_bwd_dkv"):
            if a["launches"].get(kernel, 0) < 1:
                raise AssertionError(f"full {name}: {kernel} never launched")
        tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (max(a["ms_per_step"], b["ms_per_step"])
                                                  / 1e3)
        print(f"[dp-full] Pythia-160M bf16, global B {TRAIN_BATCH} x S {TRAIN_SEQ} "
              f"({TRAIN_BATCH // DP_WORLD} rows a rank), Adam, clip 1.0, {name}, gloo via "
              f"host, two ranks on one card: {a['ms_per_step']:.2f} / "
              f"{b['ms_per_step']:.2f} ms/step (rank 0 / 1) over {DP_FULL_STEPS} steps, "
              f"{tokens_per_s:.1f} tokens/s; losses "
              f"{', '.join(f'{x:.4f}' for x in a['losses'])} on both ranks; B5 "
              f"{a['b5']:.0f} a step; staged through host "
              f"{a['staged_bytes_per_step'] / 1e9:.3f} GB a step; peak memory "
              f"{a['peak_gb']:.2f} / {b['peak_gb']:.2f} GB", flush=True)
        staged = a["staged_ms_per_step"]
        print(f"[dp-full] {name} rank 0: collectives staged through host (gloo, host "
              f"clock, copies included) {sum(staged.values()):.2f} of "
              f"{a['ms_per_step']:.2f} ms a step: "
              + ", ".join(f"{op} {ms:.2f}" for op, ms in sorted(staged.items())),
              flush=True)
        print(f"[dp-full] {name} rank 0 launches in the timed steps {a['launches']}",
              flush=True)
        counts[name] = a["launches"]
    return counts


# The legacy layer at full size (phase 16): the config's default widths
# (hidden 768, 12 heads, FFN 3072: Pythia-160M's and BERT-base's), 12
# layers, 16 x 512 tokens, Adam lr 1e-4.
LEGACY_LAYERS = 12
LEGACY_BATCH, LEGACY_SEQ = 16, 512
LEGACY_STEPS = 5
LEGACY_CONFIG = {"train_batch_size": LEGACY_BATCH,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}


def _legacy_batch(np, rows, seq, hidden, seed, masked=False):
    """Seeded hidden states and target; with ``masked``, a key-padding mask
    keeping a seeded prefix of each row (at least half)."""
    rng = np.random.default_rng(seed)
    b = {"x": rng.standard_normal((rows, seq, hidden)).astype(np.float32),
         "y": rng.standard_normal((rows, seq, hidden)).astype(np.float32)}
    if masked:
        keep = rng.integers(seq // 2, seq + 1, rows)
        b["mask"] = (np.arange(seq)[None] < keep[:, None]).astype(np.int32)
    return b


def phase_legacy_checked(torch, np):
    """Phase 15: two legacy layers at full width in fp32, 2 x 128 tokens,
    3 Adam steps on the card and on the CPU from the same seeded weights and
    batches: pre- and post-LN, without a mask (flash on the card) and with a
    key-padding mask (the dense path)."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.ops.transformer.transformer import \
        DeeperSpeedTransformerConfig

    # TF32 stays off (phase 4): fp32 products in full fp32
    tol = 1e-4     # phase 8's: summation order over 768-3072-wide products
    config = {"train_batch_size": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
    worst = {}
    for pre_ln in (True, False):
        for masked in (False, True):
            cfg = DeeperSpeedTransformerConfig(pre_layer_norm=pre_ln, attn_dropout_ratio=0.0,
                                               hidden_dropout_ratio=0.0)
            engines = [dst.initialize(model=legacy_stack(torch, cfg, 2, d), config=config,
                                      loss_fn=legacy_loss, device=d)[0]
                       for d in ("cuda", "cpu")]
            name = f"{'pre' if pre_ln else 'post'}-LN {'mask' if masked else 'no mask'}"
            worst[name] = 0.0
            for step in range(3):
                b = _legacy_batch(np, 2, 128, cfg.hidden_size, SEED + 50 + step, masked)
                lg, lc = (float(e.train_batch(batch=b)) for e in engines)
                rel = abs(lg - lc) / abs(lc)
                worst[name] = max(worst[name], rel)
                if rel > tol:
                    raise AssertionError(f"legacy {name} step {step}: card loss {lg} vs "
                                         f"CPU {lc}")
            del engines
    print(f"[legacy-checked] 2 legacy layers (768/12/3072) fp32, B 2 x S 128, 3 Adam steps: "
          f"losses card vs CPU within {', '.join(f'{k} {v:.2e}' for k, v in worst.items())} "
          f"relative (tol {tol})", flush=True)
    torch.cuda.empty_cache()


def phase_legacy(torch, np, launches):
    """Phase 16: 12 legacy layers at full width, 16 x 512 tokens, Adam, in
    fp32 without dropout (flash K5-K7, K1/K8, B9) and with ``fp16=True``
    and dropout 0.1 (the dense attention, K1/K8, B9).  Returns the counts of
    the timed steps of both runs, summed."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.ops.transformer.transformer import \
        DeeperSpeedTransformerConfig

    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    total = {}
    for fp16, rate in ((False, 0.0), (True, 0.1)):
        cfg = DeeperSpeedTransformerConfig(fp16=fp16, attn_dropout_ratio=rate,
                                           hidden_dropout_ratio=rate,
                                           num_hidden_layers=LEGACY_LAYERS)
        engine = dst.initialize(model=legacy_stack(torch, cfg, LEGACY_LAYERS), loss_fn=legacy_loss,
                                config=LEGACY_CONFIG)[0]
        batch = {k: torch.from_numpy(v).cuda() for k, v in _legacy_batch(
            np, LEGACY_BATCH, LEGACY_SEQ, cfg.hidden_size, SEED + 60).items()}
        for _ in range(2):                                # warm-up
            loss = engine.train_batch(batch=batch)
        first = float(loss)
        torch.cuda.reset_peak_memory_stats()
        launches.clear()                                  # main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LEGACY_STEPS):
            loss = engine.train_batch(batch=batch)
        loss = float(loss)                                # waits for the last step
        dt = time.perf_counter() - t0
        counts = dict(launches)
        name = "fp16, dropout 0.1" if fp16 else "fp32, no dropout"
        if not (math.isfinite(first) and math.isfinite(loss)):
            raise AssertionError(f"legacy {name}: non-finite loss {first}, {loss}")
        per_step = LEGACY_LAYERS * LEGACY_STEPS
        for k in ("gelu_fwd", "gelu_bwd"):
            if counts.get(k, 0) != per_step:
                raise AssertionError(f"legacy {name}: {k} launched {counts.get(k, 0)} times "
                                     f"in {LEGACY_STEPS} steps, not {per_step}")
        for k in ("layer_norm", "layer_norm_bwd"):
            if counts.get(k, 0) < 1:
                raise AssertionError(f"legacy {name} never launched {k}: {counts}")
        flash_counts = [counts.get(k, 0) for k in flash]
        if fp16 and any(flash_counts):
            raise AssertionError(f"legacy {name} launched flash: {flash_counts}")
        if not fp16 and min(flash_counts) < per_step:
            raise AssertionError(f"legacy {name}: flash launched {flash_counts}")
        tokens_per_s = LEGACY_BATCH * LEGACY_SEQ * LEGACY_STEPS / dt
        print(f"[legacy] {LEGACY_LAYERS} legacy layers (768/12/3072, pre-LN) {name}, "
              f"B {LEGACY_BATCH} x S {LEGACY_SEQ}, Adam lr 1e-4: "
              f"{dt / LEGACY_STEPS * 1e3:.2f} ms/step over {LEGACY_STEPS} steps, "
              f"{tokens_per_s:.1f} tokens/s; loss {first:.6f} -> {loss:.6f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        print(f"[legacy] {name} launches in the timed steps {counts}", flush=True)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        del engine, batch
        torch.cuda.empty_cache()
    return total


SPARSE_CONFIGS = {
    "Fixed": ("FixedSparsityConfig", SPARSE_FIXED, True),
    "BSLongformer": ("BSLongformerSparsityConfig", {
        "num_sliding_window_blocks": 3, "global_block_indices": [0],
        "attention": "unidirectional"}, True),
    "BigBird": ("BigBirdSparsityConfig", {
        "num_random_blocks": 1, "num_sliding_window_blocks": 3, "num_global_blocks": 1,
        "attention": "bidirectional", "seed": 0}, False),
    "Variable": ("VariableSparsityConfig", {
        "local_window_blocks": [4], "global_block_indices": [0], "num_random_blocks": 1,
        "attention": "bidirectional"}, False),
    "Fixed per head": ("FixedSparsityConfig", {
        **SPARSE_FIXED, "different_layout_per_head": True,
        "num_different_global_patterns": 4}, True),
}


def phase_sparse(torch, np, launches):
    """Phase 17: ``SparseSelfAttention`` checked card against CPU in fp32 at
    [2, 512, 2, 16] for every config, the Dense layout against flash
    K5-K7, then each config at SPARSE_SHAPE in bf16, forward and backward
    through autograd, against the plain version on the card: on the same
    bf16 operands (fp32 arithmetic, P and dS rounded to bf16 where the
    kernel rounds them) within FLASH_TOL, and on fp32 copies (no rounding
    at all) within FLASH_TOL's per-head bound.  Returns the counts of the
    full-size runs."""
    import deeperspeed_tpu_torch.ops.sparse_attention as sa
    from deeperspeed_tpu_torch.ops.attention import flash

    sparse = sys.modules[sa.sparse_attention.__module__]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 70)

    def run(attn, qkv, do):
        leaves = [t.detach().clone().requires_grad_() for t in qkv]
        out = attn(*leaves)
        return (out, *torch.autograd.grad(out, leaves, do))

    # checked: fp32, card against CPU, the JAX tests' tolerances
    qkv = [torch.randn(2, 512, 2, 16, generator=gen) for _ in range(3)]
    do = torch.randn(2, 512, 2, 16, generator=gen)
    worst = 0.0
    for name, (cls, kw, causal) in {"Dense": ("DenseSparsityConfig", {}, True),
                                    **SPARSE_CONFIGS}.items():
        attn = sa.SparseSelfAttention(getattr(sa, cls)(num_heads=2, block=128, **kw),
                                      causal=causal)
        got = run(attn, [t.to(dev) for t in qkv], do.to(dev))
        want = run(attn, qkv, do)
        for g, w, tol in zip(got, want, (2e-5, 2e-4, 2e-4, 2e-4)):
            worst = max(worst, _close(torch, g.cpu(), w, tol, tol,
                                      f"sparse {name} card vs CPU"))
    print(f"[sparse-checked] SparseSelfAttention fp32 [2, 512, 2, 16] block 128, Dense and "
          f"the five configs: card vs CPU max abs err {worst:.3e} (tol 2e-5 output, 2e-4 "
          f"grads)", flush=True)

    # the Dense layout against flash K5-K7 at SPARSE_SHAPE in bf16
    B, S, N, D = SPARSE_SHAPE
    bf16 = torch.bfloat16
    qkv = [torch.randn(*SPARSE_SHAPE, generator=gen).to(dev, bf16) for _ in range(3)]
    do = torch.randn(*SPARSE_SHAPE, generator=gen).to(dev, bf16)
    dense = sa.SparseSelfAttention(sa.DenseSparsityConfig(num_heads=N, block=SPARSE_BLOCK))
    got = run(dense, qkv, do)
    want = run(lambda q, k, v: flash.mha(q, k, v, causal=True), qkv, do)
    errs = [flash_close(torch, g, w, f"sparse Dense vs flash {n}")
            for g, w, n in zip(got, want, ("O", "dq", "dk", "dv"))]
    print(f"[sparse] Dense layout vs flash K5-K7 at {list(SPARSE_SHAPE)} bf16 causal: max abs "
          f"err / share of FLASH_TOL used, O/dq/dk/dv "
          f"{', '.join(f'{e:.3e} / {x:.3f}' for e, x in errs)}", flush=True)
    del got, want

    def plain(args, grad_out, layout, causal):
        o, lse = sparse._fwd_reference(*args, layout, causal, D ** -0.5)
        delta = (grad_out.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S)
        return (o, *sparse._bwd_reference(*args, grad_out, lse, delta.contiguous(), layout,
                                          causal, D ** -0.5))

    # full size: each config in bf16 against the plain version
    ref_args = [t.float() for t in qkv]
    kernels = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
    launches.clear()                                      # main path starts here
    for name, (cls, kw, causal) in SPARSE_CONFIGS.items():
        attn = sa.SparseSelfAttention(getattr(sa, cls)(num_heads=N, block=SPARSE_BLOCK, **kw),
                                      causal=causal)
        before = [launches.get(k, 0) for k in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(attn, qkv, do)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = [launches.get(k, 0) for k in kernels]
        if [a - b for a, b in zip(after, before)] != [1, 1, 1]:
            raise AssertionError(f"sparse {name}: B10 launches {before} -> {after}")
        layout = attn.device_layout(S, qkv[0].device)
        want = plain(qkv, do, layout, causal)
        shares = [flash_close(torch, g, w, f"sparse {name} {n} vs plain")[1]
                  for g, w, n in zip(got, want, ("O", "dq", "dk", "dv"))]
        exact = plain(ref_args, do.float(), layout, causal)
        heads = [flash_shares(torch, g, w)[2] for g, w in zip(got, exact)]
        if max(heads) > 1.0:
            raise AssertionError(f"sparse {name}: per-head error against the fp32 plain "
                                 f"version beyond FLASH_TOL's head bound: {heads}")
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"sparse {name}: non-finite output or gradient")
        density = _live_pairs(np, layout.cpu().numpy(), SPARSE_BLOCK, causal) / (
            N * (S * (S + 1) // 2 if causal else S * S))
        print(f"[sparse] {name} ({'causal' if causal else 'full'}, live share "
              f"{density:.4f}) {list(SPARSE_SHAPE)} bf16 block {SPARSE_BLOCK}: forward + "
              f"backward {ms:.2f} ms (host clock, first call of this layout); share of "
              f"FLASH_TOL used O/dq/dk/dv vs the plain version on the bf16 operands "
              f"{', '.join(f'{x:.3f}' for x in shares)}, of its head bound vs the fp32 "
              f"plain version {', '.join(f'{x:.3f}' for x in heads)}", flush=True)
        del got, want, exact
    counts = dict(launches)
    # device time a pass (forward and backward through autograd, as above),
    # by kernel (torch.profiler over 3 passes)
    for name, (cls, kw, causal) in SPARSE_CONFIGS.items():
        attn = sa.SparseSelfAttention(getattr(sa, cls)(num_heads=N, block=SPARSE_BLOCK, **kw),
                                      causal=causal)
        got = _sparse_pass_ms(torch, lambda: run(attn, qkv, do))
        if got is None:
            print(f"[sparse] {name} device time a pass: not measured (three traces lacked "
                  f"one of B10's kernels)", flush=True)
            continue
        total, b10, rest = got
        print(f"[sparse] {name} device time a pass {total:.4f} ms: "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in sorted(b10.items()))
              + f", the rest {rest:.4f}", flush=True)
    del qkv, do, ref_args
    torch.cuda.empty_cache()
    return counts


def phase_softmax(torch, launches):
    """Phase 18: ``fused_softmax`` forward and backward through autograd at
    phase 3's bf16 shape; B8's counters must rise."""
    from deeperspeed_tpu_torch.ops.transformer import fused_softmax

    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    x = (4 * torch.randn(16, 12, 1024, 1024, generator=gen, device="cuda")).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    x.requires_grad_()
    launches.clear()                                      # main path starts here
    y = fused_softmax(x, 0.125)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    counts = dict(launches)
    if [counts.get(k, 0) for k in ("softmax_fwd", "softmax_bwd")] != [1, 1]:
        raise AssertionError(f"fused_softmax launched {counts}")
    sums = y.float().sum(-1)
    if not (torch.isfinite(dx.float()).all() and (sums - 1).abs().max() < 0.05):
        raise AssertionError("fused_softmax: rows do not sum to 1 or dx is not finite")
    print(f"[softmax] fused_softmax [16, 12, 1024, 1024] bf16 scale 0.125 through autograd: "
          f"rows sum to 1 within {(sums - 1).abs().max().item():.2e}; launches {counts}",
          flush=True)
    del x, dy, y, dx
    torch.cuda.empty_cache()
    return counts


# Checkpoints on the card (phase 19): phase 9's step saved after 2 steps and
# resumed; 2 full-width layers for FusedAdam, fp16 and dropout; 4 prompts x
# 16 tokens served from the checkpoint.
CKPT_STEPS = 2                       # before the save, and after it
CKPT_ROWS, CKPT_SEQ = 4, 256         # the 2-layer runs' batches
CKPT_SERVED, CKPT_NEW_TOKENS = 4, 16


def _ckpt_digest(torch, eng):
    """sha256 over an engine's whole fp32 masters and optimizer state as its
    checkpoint names them (a collective over several processes)."""
    import hashlib

    import numpy as np

    from deeperspeed_tpu_torch.runtime import checkpointing as ck

    h = hashlib.sha256()

    def walk(node):
        for key in sorted(node):
            h.update(key.encode())
            v = node[key]
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                h.update(v.detach().contiguous().reshape(-1).view(torch.uint8)
                         .cpu().numpy().tobytes())
            else:
                h.update(np.asarray(v).tobytes())

    walk({"masters": ck.reference_masters(eng), "opt_state": ck.reference_opt_state(eng)})
    return h.hexdigest()


def _ckpt_resume(torch, make_engine, batches, workdir, launches=None):
    """Train ``CKPT_STEPS`` steps, save, train ``CKPT_STEPS`` more; then a
    fresh engine loads and trains the same steps.  Raises unless the losses,
    the masters and optimizer state (digests), the loss scale, the counters
    and the generator are equal bit for bit.  Returns the readings, with
    ``counts``, the launches of the resumed steps."""
    import numpy as np

    first = make_engine()
    for b in batches[:CKPT_STEPS]:
        first.train_batch(batch=b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first.save_checkpoint(str(workdir))
    save_s = time.perf_counter() - t0
    tag = f"global_step{first.global_steps}"
    info = dict(first.checkpoint_engine.commit_info)
    live = first.full_master_params()
    want = [float(first.train_batch(batch=b)) for b in batches[CKPT_STEPS:]]

    def state(eng):
        ls = eng.loss_scale_state
        return {"digest": _ckpt_digest(torch, eng),
                "loss_scale": [float(ls.scale), int(ls.growth_tracker), int(ls.hysteresis),
                               bool(ls.found_overflow)],
                "counters": [eng.step_count, eng.global_steps, eng.global_samples,
                             eng.micro_steps, eng.skipped_steps],
                "rng": eng._rng.get_state().tolist()}

    want_state = state(first)
    del first
    torch.cuda.empty_cache()
    second = make_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second.load_checkpoint(str(workdir))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if launches is not None:
        launches.clear()                              # the resumed steps start here
    got = [float(second.train_batch(batch=b)) for b in batches[CKPT_STEPS:]]
    counts = dict(launches) if launches is not None else {}
    got_state = state(second)
    del second
    torch.cuda.empty_cache()
    if not np.array_equal(got, want, equal_nan=True):     # the skipped step's is NaN
        raise AssertionError(f"resumed losses {got} != uninterrupted {want}")
    for key in want_state:
        if got_state[key] != want_state[key]:
            raise AssertionError(f"resumed {key} {got_state[key]} != uninterrupted "
                                 f"{want_state[key]}")
    files = {p.name: p.stat().st_size for p in sorted((workdir / tag).iterdir())}
    return {"losses": got, "save_s": save_s, "verify_s": info.get("verify_seconds"),
            "load_s": load_s, "files": files, "tag": tag, "live": live,
            "counts": counts, "state": got_state}


def phase_checkpointed(torch, np, launches, card, dp_ckpt):
    """Phase 19: checkpoints on the card.  Returns the launches of the
    resumed full-size steps."""
    import shutil

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
    from deeperspeed_tpu_torch.runtime.checkpointing import load_module_params

    root = Path(tempfile.mkdtemp(dir=ROOT / ".build"))
    try:
        # ---- phase 9's step at full size: bf16 Pythia-160M, B 16 x S 1024
        models = [trained_model()]
        batch = {k: v.cuda() for k, v in trained_batch(models[0]).items()}
        full = _ckpt_resume(
            torch, lambda: dst.initialize(model=models.pop() if models else trained_model(),
                                          config=TRAIN_CONFIG)[0],
            [batch] * (2 * CKPT_STEPS), root / "full", launches)
        for name in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                     "flash_bwd_dkv"):
            if full["counts"].get(name, 0) < 1:
                raise AssertionError(f"resumed steps never launched {name}: {full['counts']}")
        total = sum(full["files"].values())
        print(f"[checkpointed] {card}: Pythia-160M bf16, B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
              f"Adam, clip 1.0, ZeRO-0: {CKPT_STEPS} steps, save, {CKPT_STEPS} steps; a "
              f"fresh engine loads and takes the same {CKPT_STEPS}: losses "
              f"{', '.join(f'{x:.6f}' for x in full['losses'])} and the digest of masters "
              f"and moments {full['state']['digest'][:16]} equal bit for bit", flush=True)
        print(f"[checkpointed] {card}: files "
              + ", ".join(f"{k} {v}" for k, v in full["files"].items())
              + f" bytes ({total / 1e9:.3f} GB); save {full['save_s']:.3f} s "
              f"({total / full['save_s'] / 1e9:.3f} GB/s, verify {full['verify_s']:.3f} s "
              f"of it), load {full['load_s']:.3f} s ({total / full['load_s'] / 1e9:.3f} "
              f"GB/s)", flush=True)
        print(f"[checkpointed] launches in the resumed steps {full['counts']}", flush=True)

        # ---- 2 full-width layers: FusedAdam (B6's flat buffers), fp16 with
        # an overflow just after the save, dropout (the generator)
        rng = np.random.default_rng(SEED + 19)
        V = GPTNeoXConfig.pythia_160m().vocab_size
        batches = []
        for i in range(2 * CKPT_STEPS):
            toks = rng.integers(0, V, (CKPT_ROWS, CKPT_SEQ + 1))
            mask = np.ones((CKPT_ROWS, CKPT_SEQ), np.float32)
            if i == CKPT_STEPS:
                mask[1, 7] = np.inf           # a non-finite loss: fp16 skips this step
            batches.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:],
                            "loss_mask": mask})
        clean = [{**b, "loss_mask": np.ones_like(b["loss_mask"])} for b in batches]

        def two_layers(dtype, **kw):
            return GPTNeoX(dataclasses.replace(GPTNeoXConfig.pythia_160m(dtype=dtype, **kw),
                                               num_layers=2), seed=SEED)

        base = {"train_batch_size": CKPT_ROWS, "gradient_clipping": 1.0}
        fused_adam = {"type": "FusedAdam", "params": {"lr": 1e-4}}
        runs = {
            "FusedAdam bf16": (lambda: dst.initialize(model=two_layers(torch.bfloat16), config={
                **base, "bf16": {"enabled": True}, "optimizer": fused_adam})[0], clean),
            "fp16, overflow after the save": (lambda: dst.initialize(
                model=two_layers(torch.float16), config={
                    **base, "fp16": {"enabled": True, "initial_scale_power": 12,
                                     "hysteresis": 1},
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}})[0], batches),
            "dropout 0.1 bf16": (lambda: dst.initialize(
                model=two_layers(torch.bfloat16, hidden_dropout=0.1, attention_dropout=0.1),
                config={**base, "bf16": {"enabled": True},
                        "optimizer": fused_adam})[0], clean),
        }
        for i, (name, (make, data)) in enumerate(runs.items()):
            launches.clear()
            r = _ckpt_resume(torch, make, data, root / f"two{i}")
            if name.startswith("FusedAdam") and launches.get("fused_adam", 0) != 3 * CKPT_STEPS:
                raise AssertionError(f"{name}: fused_adam launched "
                                     f"{launches.get('fused_adam', 0)} times")
            if name.startswith("fp16") and r["state"]["counters"][4] != 1:
                raise AssertionError(f"{name}: counters {r['state']['counters']}")
            print(f"[checkpointed] 2 full-width layers, {name}, B {CKPT_ROWS} x S {CKPT_SEQ}: "
                  f"resumed losses {', '.join(f'{x:.6f}' for x in r['losses'])}, loss scale "
                  f"{r['state']['loss_scale']}, step_count / global_steps / skipped "
                  f"{r['state']['counters'][0]} / {r['state']['counters'][1]} / "
                  f"{r['state']['counters'][4]}, generator and digest "
                  f"{r['state']['digest'][:16]} equal bit for bit", flush=True)
            shutil.rmtree(root / f"two{i}", ignore_errors=True)

        # ---- the world-2 stage-2 save of phase 13's workers, loaded at world 1
        one = dst.initialize(model=dp_check_model(), config=DP_CHECK_CONFIG)[0]
        one.load_checkpoint(dp_ckpt["dir"])
        digest = _ckpt_digest(torch, one)
        if digest != dp_ckpt["digest"] or one.step_count != dp_ckpt["step_count"]:
            raise AssertionError(f"world 1 load of the world-2 stage-2 save: digest "
                                 f"{digest[:16]} != {dp_ckpt['digest'][:16]}")
        print(f"[checkpointed] phase 13's 2 full-width layers saved at world 2, ZeRO "
              f"stage 2 (save {dp_ckpt['save_s']:.3f} s on rank 0) and loaded at world 1: "
              f"masters and moments (digest {digest[:16]}) equal the workers' gathered "
              f"ones bit for bit", flush=True)
        del one
        shutil.rmtree(dp_ckpt["dir"], ignore_errors=True)

        # ---- serving from the checkpoint against the live masters
        ecfg = {"dtype": "bfloat16", "kv_cache": {"num_blocks": 256, "block_size": 16},
                "state_manager": {"max_context": 1024, "max_ragged_batch_size": 2048,
                                  "max_ragged_sequence_count": CKPT_SERVED,
                                  "max_decode_batch": CKPT_SERVED},
                "sampling": {"temperature": 1.0, "top_k": 1, "seed": SEED}}
        prompts = [np.asarray(p) for p in served_prompts(np, V, CKPT_SERVED)]
        weights = {"checkpoint": params_from_jax(load_module_params(
                       str(root / "full"), full["tag"])),
                   "live": full["live"]}
        served = {}
        for source, sd in weights.items():
            model = served_model()
            model.load_state_dict(sd)
            launches.clear()
            outs = InferenceEngineV2(model, ecfg).generate(prompts,
                                                           max_new_tokens=CKPT_NEW_TOKENS)
            served[source] = [o[len(p):].tolist() for p, o in zip(prompts, outs)]
            counts = dict(launches)
            for name in ("layer_norm", "paged_decode", "sorted_topk"):
                if counts.get(name, 0) < 1:
                    raise AssertionError(f"serving from {source} never launched {name}")
            del model
        if served["checkpoint"] != served["live"] or \
                any(len(t) != CKPT_NEW_TOKENS for t in served["live"]):
            raise AssertionError(f"tokens served from the checkpoint {served['checkpoint']} "
                                 f"!= from the live masters {served['live']}")
        print(f"[checkpointed] served {CKPT_SERVED} prompts x {CKPT_NEW_TOKENS} greedy "
              f"tokens (top-k 1 through K4) from the checkpoint's model file: equal to "
              f"those from the live engine's masters; launches {counts}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return full["counts"]


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
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
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
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        ptxas = f", {len(regs)} kernels, {min(regs)}-{max(regs)} registers, " \
            f"{spill} spill bytes (ptxas)" if regs else ""
        print(f"[build] {name}.cu: {secs:.1f} s{ptxas}", flush=True)
        print(log, file=sys.stderr)
    print(f"[build] all kernels in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)", flush=True)

    rows = phase_legacy_kernels(torch, np, phase_quantizer_kernel(torch, phase_optimizer_kernels(
        torch, phase_training_kernels(torch, phase_kernels(torch)))))
    phase_checked(torch, np)
    # each main path's counts, read right after its own run
    paths = {"serving": phase_served(torch, np, cuda_utils.LAUNCHES)}
    phase_scheduled_checked(torch, np)
    paths["scheduled"] = phase_scheduled(torch, np, cuda_utils.LAUNCHES)
    phase_trained_checked(torch, np)
    paths["training"] = phase_trained(torch, cuda_utils.LAUNCHES)
    phase_fused_checked(torch, np)
    paths["training_fused"], paths["training_fused_lion"] = phase_fused_trained(
        torch, np, cuda_utils.LAUNCHES)
    phase_dropout(torch, np, cuda_utils.LAUNCHES)
    dp, dp_ckpt = phase_dp(torch, np)
    paths["dp_stage2"], paths["dp_qgz"] = dp["stage2"], dp["qgz-int8"]
    phase_legacy_checked(torch, np)
    paths["legacy_layer"] = phase_legacy(torch, np, cuda_utils.LAUNCHES)
    paths["sparse_attention"] = phase_sparse(torch, np, cuda_utils.LAUNCHES)
    paths["softmax"] = phase_softmax(torch, cuda_utils.LAUNCHES)
    paths["training_resumed"] = phase_checkpointed(torch, np, cuda_utils.LAUNCHES, card,
                                                   dp_ckpt)

    sources = {
        "layer_norm": ("deeperspeed_tpu_torch/csrc/layer_norm.cu",
                       "deeperspeed_tpu/ops/transformer/normalize.py:33"),
        "paged_decode": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                         "deeperspeed_tpu/ops/attention/paged.py:36"),
        "paged_spec_decode": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                              "deeperspeed_tpu/ops/attention/paged.py:89"),
        # the quantized=True forms of the two bodies (fused dequant at :61 and :116)
        "paged_decode_q": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                           "deeperspeed_tpu/ops/attention/paged.py:61"),
        "paged_spec_decode_q": ("deeperspeed_tpu_torch/csrc/paged_attention.cu",
                                "deeperspeed_tpu/ops/attention/paged.py:116"),
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
        "fused_adam": ("deeperspeed_tpu_torch/csrc/fused_optimizers.cu",
                       "deeperspeed_tpu/ops/adam/pallas_adam.py:23"),
        "fused_lion": ("deeperspeed_tpu_torch/csrc/fused_optimizers.cu",
                       "deeperspeed_tpu/ops/lion/fused_lion.py:32"),
        "dequant_reduce": ("deeperspeed_tpu_torch/csrc/dequant_reduce.cu",
                           "deeperspeed_tpu/ops/quantizer/fused.py:52"),
        "gelu_fwd": ("deeperspeed_tpu_torch/csrc/activations.cu",
                     "deeperspeed_tpu/ops/transformer/activations.py:35"),
        "gelu_bwd": ("deeperspeed_tpu_torch/csrc/activations.cu",
                     "deeperspeed_tpu/ops/transformer/activations.py:39"),
        "softmax_fwd": ("deeperspeed_tpu_torch/csrc/softmax.cu",
                        "deeperspeed_tpu/ops/transformer/softmax.py:23"),
        "softmax_bwd": ("deeperspeed_tpu_torch/csrc/softmax.cu",
                        "deeperspeed_tpu/ops/transformer/softmax.py:30"),
        "sparse_fwd": ("deeperspeed_tpu_torch/csrc/sparse_attention.cu",
                       "deeperspeed_tpu/ops/sparse_attention/sparse_attention.py:27"),
        "sparse_bwd_dq": ("deeperspeed_tpu_torch/csrc/sparse_attention.cu",
                          "deeperspeed_tpu/ops/sparse_attention/sparse_attention.py:64"),
        "sparse_bwd_dkv": ("deeperspeed_tpu_torch/csrc/sparse_attention.cu",
                           "deeperspeed_tpu/ops/sparse_attention/sparse_attention.py:93"),
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
        if "device_ms" in e:
            kernels[-1]["device_ms"] = e["device_ms"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
