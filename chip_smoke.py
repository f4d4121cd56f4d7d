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
    with 2 layers in fp32, 2 steps on the card and on the CPU from the same
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
    fp32, global batch 4 x 128 (2 rows a rank), 2 Adam steps with clip 1.0,
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
    int8; 1 warm-up step and 1 timed one: losses finite and equal on both
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
    ``params_from_jax``) equal to those served from the live masters;
20. the wire: (a) four ``--wire-worker`` processes share the card over gloo
    as a world of 2 x 2 (``comm.new_two_level_groups``); each runs the
    two-level qgZ all-reduce and reduce-scatter, int8 and fp8, on
    Pythia-160M's input-embedding gradient shape ([50304, 768] fp32 from a
    seed), held bit for bit against the same schedule on CPU copies (B5's
    plain version) and within the quantization error of the exact sum; B5
    must launch once a hop; the analytic wire bytes the step record holds
    and the bytes staged through host memory are printed.  (b) phase 13's
    two workers run phase 13's model at gas 2 at stages 2 and 3 under
    ``comm.overlap`` with ``bucket_mb`` 0 and 4, held against the
    per-microbatch schedule (losses and each step's grad norm within 1e-4
    relative, the bucketed losses equal to the unbucketed ones; the
    gradient-reduction bytes staged a step against the per-microbatch
    schedule's); OneBitAdam with ``freeze_step`` 1 over 2 steps (losses
    finite and equal on both ranks; the loss after the exact-mean warm-up
    step within 1e-6 relative of phase 13's Adam at stage 0; the first
    sign-compressed reduction of a parameter of at least 2^20 elements
    held against ``onebit_all_reduce`` on CPU copies of the same gradient
    and error, mean and new error within 1e-5 of their largest value, as
    ``mean|c|`` sums in another order); stage 3 with qwZ
    (gather bytes staged against stage 3 without it, losses within 0.05);
    and one ``comm.log_summary(show_straggler=True)`` table.  (c) phase 14's
    step with gas 2 at world 2, stage 2, per microbatch and then deferred:
    1 warm-up and 1 timed step, ms/step and bytes staged a step.
21. the layout: four ``--layout-worker`` processes share the card over
    gloo.  (a) phase 9's step (Pythia-160M at full width and depth, bf16,
    global batch 16 x 1024, Adam, clip 1.0, stage 2) at tp 2 x dp 2, 1
    warm-up and 1 timed step, held against phase 14's run of the same
    seed at tp 1 x dp 2: losses within 1e-2 relative (bf16: the row-
    parallel products sum two bf16 halves), grad norms within 1e-2; K1,
    K5-K8 must launch (K5-K7 on 6 heads a rank); (b) MiCS (dp 2 x zshard 2,
    stage 2) and hpZ (stage 3) and (a)'s layout, each at phase 13's 2
    full-width fp32 layers for 2 of its steps, card against the same run
    on the CPU inside the workers (losses within 1e-4 relative, phase 13's
    tolerance); hpZ's gathers over the zshard group alone; (c) the engine's two-hop qgZ
    (``intra_axis: zshard``), int8 and fp8, at phase 13's model: each
    parameter's reduced gradient of the first step equal bit for bit to the
    same two-hop schedule on CPU copies of the card's per-rank gradients
    (as phase 20 (a)), B5 once a hop, losses against the CPU run within
    phase 13's qgZ tolerance; (d) in phase 13's two workers, (a)'s tp 1
    step from ``training_data=`` with ``prefetch_depth`` 2 and without:
    losses bit-equal.  Each part prints ms/step on the host clock (ending
    in a sync), the bytes staged through host a step by op (``tp_reduce``,
    ``grad_reduce``, ``stage3_gather``, ``hpz_refresh``), the analytic
    wire bytes and the elements each rank holds.
22. the Llama family: phase 3's kernel rows at its shapes (K1 and K8 as
    RMSNorm at H 4096; K2, K2q and K3q with GQA's query groups folded into
    the batch, 32 sequences x 4 query heads over 8 KV heads at D 128,
    beside SDPA at the KV heads; K5-K7 at N 32, D 128); (a) Mistral-7B-v0.2's
    shape (``LlamaConfig.mistral_7b(sliding_window=None, rope_theta=1e6)``,
    7.24 B parameters drawn on the card) in bf16 through
    ``InferenceEngineV2`` with a 4096 x 16 bf16 pool: 32 prompts of 512
    tokens prefilled, 32 decode rounds, 4 speculative rounds, a sampled
    run (top-k 50), then ``DSScheduler.generate`` with n-gram k 4 over an
    fp8 pool of the same bytes and plain decode rounds over it; K1, K2,
    K3, K2q, K3q and K4 must launch; (b) ``mistral_7b()`` (window 4096) at
    full width and 2 layers in fp32, one 5,000-token sequence: each
    round's last logits within 2e-3 of the dense forward, no K2 or K3
    launched; (c) ``init_inference`` on (a)'s model in bf16, int8 and int4
    weights, 8 left-padded prompts x 32 greedy tokens: ms a token, weight
    bytes, peak memory, and bf16's tokens against the v2 engine's on the
    unpadded rows (parting only at a top-2 margin below 0.125); (d)
    Llama-2-7B's width at 2 layers (4 x 1024) and OPT-125M (16 x 1024)
    trained 3 Adam steps in bf16 (K1/K8, K5-K7), then their tiny configs in
    fp32 card against CPU (losses within 1e-4 relative); (e) two
    ``--llama-worker`` processes run the v1 engine at tp 2 over gloo on
    (a)'s model at 2 layers in fp32: their tokens must equal this
    process's tp 1 run, which is held against the v2 engine's fp32 greedy
    tokens;
23. MoE, on Pythia-160M-MoE-8 (Pythia-160M at full width, 8 experts on
    every second block, top-1, capacity factor 1.0, min capacity 4, RTS,
    aux coefficient 0.01; 360,701,952 parameters): (a) ``tiny()`` with 4
    experts on both blocks in fp32, card against CPU from the same weights
    and batches, 3 Adam steps with losses within 1e-5 relative, for top-1,
    Residual-MoE and the int8 and fp8 transport, and top-2's evaluation
    losses (its training draws come from each device's generator); (b)
    phase 9's step on Pythia-160M-MoE-8 (bf16, B 16 x S 1024, Adam, clip
    1.0, ZeRO-0): ms/step, tokens/s, peak memory, each MoE layer's
    ``exp_counts``, dropped share and ``l_aux``; K1, K8 and K5-K7 must
    launch; then top-2 for 3 steps; (c) two ``--moe-worker`` processes at
    ep 2 over gloo on the card (2 full-width blocks, both MoE, fp32, phase
    13's batches) at stages 0 and 2 against one process at ep 1 (losses
    within 1e-5 relative), with the int8 and fp8 transport (within 1e-4),
    and at tp 2 with the experts split by their feature dims (within
    1e-4), the bytes the all-to-all and the routing records stage a step,
    and the ep-2 checkpoint loaded at ep 1 (digest equal); (d) the model in bf16
    with no-drop gating through ``InferenceEngineV2`` at phase 5's batch
    and pool: ms/round and TTFT (K1, K2, K3, K4 must launch), then the v1
    engine's greedy tokens against the v2 engine's in fp32 at 2 layers;
24. offload, at Pythia-1.4B (1,414,647,808 parameters, drawn on the card)
    in bf16 at batch 8 x 1024, Adam, clip 1.0, ZeRO-0, after asserting the
    host memory and disk it needs: (a) the host update (the native CPU
    Adam of ``csrc/host/cpu_adam.cpp`` over pinned host masters and
    moments) against the device update on the same weights, 3 steps: the
    first loss equal, the masters after step 1 within rtol 2e-5, atol
    1e-6, the losses within 1e-3; an engine built with ``wire_dtype:
    "bf16"`` takes step 1 from the same weights, half the gradients' bytes
    to the host, its masters within 1e-2 lr of the fp32 wire's; per step
    the forward and backward, the gradients' D2H, the host Adam, the host
    bf16 cast and the H2D, and each engine's peak memory; (b) the
    pinned-host tier (FusedAdam: B6 on the card once a step), losses within
    1e-3 of (a)'s device run, the state's H2D and D2H; (c) the NVMe tier
    at 1.4B's width and 4 layers, 3 steps with ``pipeline_write: false``
    and 2 with ``true``, losses equal to the run without it, swap-out and
    swap-in GB/s and the share of the swap-in hidden under the gradients,
    the swap directory gone after ``destroy()``; (d) ZeRO-Infinity on
    the same 4 layers in 4 chunks, 2 steps, against the host update on the
    same weights (within 1e-3), device parameter residency below the
    model's, ``swap_stats``; (e) Pythia-160M's checkpoint through the
    synchronous writer and the async one (the aio pool), files byte-equal
    (equal manifests of their sha256), GB/s each;
    (f) (in phase 13's workers) phase 14's stage-2 step on the pinned-host
    tier at world 2, losses equal to phase 14's.  K1/K8 and K5-K7 must
    launch on every offload path.  Each phase prints a ``[time]`` line.
25. the planners: (a) ``measure_h2d_bandwidth`` over 256 MiB of pinned
    memory, within 2x of ``telemetry/wire.py``'s host-link figure for the
    card, and a calibration (phase 24 (d)'s forward, backward and clip time,
    the measured rate) saved and read back equal through
    ``DST_TUNER_CACHE`` in a scratch directory; (b) phase 24 (d)'s stream
    (1.4B's width, 4 layers in 4 chunks, its weights) under
    ``memory_schedule: "auto"`` with that calibration at 300 MiB (which the
    static schedule refuses at construction: its peak is 393.0 MiB; 1
    step), 700 MiB (2 steps) and 1 GiB (1 step): the engine's plan equal to
    ``plan_chunk_stream`` on its unit bytes, the losses equal to (d)'s
    static ones bit for bit, the device ledger within the plan's peak, the
    plan's ``describe()``, s/step against static and ``swap_stats``; (c)
    (in phase 13's workers, before phase 20 (c)) phase 14's step at gas 2
    and stage 2 under ``schedule.mode: "auto"``: the plan, the collectives
    issued from gradient hooks, losses and each step's grad norm equal bit
    for bit to phase 20 (c)'s manual deferred run, which takes the plan's
    ``bucket_mb``, and ms a step against it; (d) stage 3 at phase 13's
    model: ``memory: "static"`` with half its static peak as the budget
    refused at construction, ``"auto"`` one step and its movement plan,
    whose peak is the stage-3 ledger's.  K1/K8 and K5-K7 must launch on (b)
    and (c).
26. pipelines: two ``--pipe-worker`` stage processes (pp 2, gloo via host)
    and four ``--pipe-dp-worker`` processes (pp 2 x dp 2), released under
    phase 19: (a) Pythia-160M at pp 2 under ``1f1b``, bf16, Adam, clip 1.0,
    16 x 1024 in 4 microbatches, 3 steps: losses and grad norms against the
    flat engine's on the same weights (within 1e-2 relative), each stage's
    ms/step split into compute, P2P transfer (the bytes at a measured
    message's rate), bubble (the rest of the P2P wait) and the rest, its
    peak memory; (b) the same under ``gpipe``, losses equal to (a)'s, and
    both at gas 8: each stage's peak memory of the forward and backward and
    ``peak_live_inputs``, 1f1b's the lower (on the first stage, whose
    inputs are token ids, no higher); (c) Llama-2-7B's width (H 4096) at 4 layers, pp 2, 1 step at
    gas 2, against the flat ``Llama``; (d) the interpreted engine on a
    PipelineModule of 4 Pythia-160M-width GPT-NeoX blocks with a tied
    embedding and head at pp 2 x dp 2, ZeRO-2, FusedAdam, 3 steps against
    the flat engine on the same layers, a checkpoint saved before step 3
    and reloaded at pp 1, where step 3 gives the same loss.  K1/K8 and
    K5-K7 must launch on every stage, B6 in (d).
27. pipelines, part b: four ``--pipe-tp-worker`` processes (pp 2 x tp 2,
    gloo via host for the P2P messages and the tp reductions), started in
    phase 24 after its (b): (a) Pythia-160M under ``1f1b``, bf16, FusedAdam, clip
    1.0, 16 x 1024 in 4 microbatches, 3 steps: losses and grad norms within
    1e-2 relative of phase 26 (a)'s pp 2 run on the same weights, each
    rank's parameter bytes about half of its pp 2 stage's, its ms/step
    split, ``pipe_stats``, the bytes ``tp_reduce`` staged a step and its
    peak (stage 0's inputs are token ids); (b) Llama-2-7B's width at 4
    layers, pp 2 x tp 2, 1 step at gas 2 (waiting for phase 27): loss and
    norm within 1e-2 of 26 (c), each rank's peak at most 0.7 of its pp 2
    stage's; (c) Pythia-160M at pp 2 with ``offload_optimizer.host_update``
    (run by phase 26's processes): losses within 2e-5 relative of 26 (a)'s
    device update, the host Adam's seconds a stage; (d) ZeRO-Infinity over
    ``GPTNeoXPipe(pythia_160m, num_stages=4)`` in this process, 2 steps:
    losses and every unit's masters equal bit for bit to the flat stream at
    ``num_chunks=4`` on the same weights.  K1/K8 and K5-K7 must launch on
    every rank of (a)-(c) and in (d), B6 on every rank of (a) and not in (c).
28. sequence parallelism: two ``--sp-worker`` processes (sp 2, gloo via
    host for every exchange), held with the others and released when
    phases 13-14 start (the main process only waits for their workers
    there): (a) Pythia-160M at seq 2048, bf16, FusedAdam, clip 1.0, 4 rows
    at gas 2, 2 steps, at sp 2 under ``ulysses`` and then ``ring``,
    against the engine at sp 1 (dp 2) on the same weights and batch: losses
    within ``SP_LOSS_TOL`` (1e-4 relative) and grad norms within
    ``SP_NORM_TOL`` (5e-3), each run's ms a step, the bytes its
    all-to-alls, ring transfers and gathers staged a step and its peak
    memory a rank; under Ulysses K5-K7 must launch, at 6 heads a rank; (b)
    Llama-2-7B's width (N 32, D 128) at 2 layers, mode None (the keys and
    values gathered over sp, the local queries padded to their length), one
    step at sp 2 against sp 1: loss and grad norm within the same limits,
    ms, staged bytes, peak memory; K5-K7 must launch on both ranks.  K1/K8
    must launch on both ranks of every run, B6 in (a).

The worker processes of phases 13-14, 20, 21, 22 (e), 23 (c), 26 and 28
start right after the build, make their CUDA context and wait until their
phase (``[workers]`` line); those of 28 run under phases 13-14, whose main
process waits for its workers, those of 21, 22 (e), 23 (c) and 26 under
phase 19, which waits on the disk, and those of 27 (started unheld) under
phase 24 (c)-(e) and phase 25, which wait on the disk too; their phases join
them (their ms are read with those phases running beside them).  Each phase
prints a ``[time]`` line.

The second-to-last line is the JSON summary of the kernels (a kernel's
``launches`` sums its counts on the main paths, serving in phase 5,
scheduled serving in phase 7, training in phase 9, the rest of training
in phase 11 (FusedAdam, then FusedLion), data-parallel training in
phase 14 (rank 0's counts, stage 2, then qgZ), the legacy layer in phase
16 (fp32, then fp16), sparse attention in phase 17, the fused softmax in
phase 18, the resumed steps of phase 19, and in phase 20 the two-level
schedule's B5 launches (rank 0) and the deferred full-size steps (rank 0),
in phase 21 the tp 2 x dp 2 full-size steps (rank 0), and in phase 22
(a)'s serving, (c)'s three v1 runs, (b)'s windowed rounds, (d)'s two
full-width trainings and (e)'s tp 2 run (rank 0), in phase 23 (b)'s top-1
training, (c)'s stage-0 run (rank 0) and (d)'s bf16 serving, in phase 24
(a)'s host-update steps, (b)'s pinned-tier steps, (c)'s NVMe-tier steps and
(d)'s streamed steps, in phase 25 (b)'s 700 MiB planned stream and (c)'s
hook-issued steps (rank 0), in phase 26 (a)'s steps summed over both stages
(``pipe-trained``) and (d)'s over its four processes (``pipe-interpreted``),
in phase 27 (a)'s and (b)'s steps summed over their four processes
(``pipe-tp``, ``pipe-tp-llama``), (c)'s over both stages (``pipe-host``)
and (d)'s streamed steps over the stage model (``infinity-pipe``), in phase
28 (a)'s sp 2 steps under ``ulysses`` and ``ring`` and (b)'s, each summed
over both ranks (``sp-ulysses``, ``sp-ring``, ``sp-llama``),
each read right after its own run and listed in
``launches_by_path``), the
last ``{"ok": true,
"device": {...}}``.  Any
failure, of a phase or of a worker, raises and exits non-zero; without a
CUDA device, or outside a checkout, it exits 2 and prints no result.
"""

import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
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
    """Pythia-160M at full width and depth in bf16, random weights from
    ``SEED``, drawn on the card unless ``device`` is given."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16, max_seq_len=TRAIN_SEQ,
                                             **config),
                   device=device, seed=SEED, draw_on_device=device is None)


def trained_batch(model):
    """bench.py's batch: one fixed batch of random tokens, reused each step."""
    return model.example_batch(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)


# The rest of single-card training (phase 11), shared with
# tools/torch_train_profile.py --fused: phase 9's step with FusedAdam, the
# loader over training_data=, the chunked loss and block recompute.
FUSED_CE_CHUNK, FUSED_DATA_BATCHES = 4096, 12
FUSED_CHECK_STEPS = 2               # phase 10's steps, card against CPU
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
DP_CHECK_STEPS, DP_CHECK_ROWS, DP_CHECK_SEQ = 2, 4, 128
DP_CHECK_CONFIG = {"train_batch_size": DP_CHECK_ROWS, "gradient_clipping": 1.0,
                   "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
DP_CHECK_RUNS = {
    **{f"stage{s}": {**DP_CHECK_CONFIG, "zero_optimization": {"stage": s}}
       for s in range(4)},
    **{f"qgz-{w}": {**DP_CHECK_CONFIG, "comm": {"quantized": {"enabled": True,
                                                            "wire_dtype": w}}}
       for w in ("int8", "fp8")}}
DP_QGZ_TOL, DP_QGZ_NORM_TOL = 1e-3, 1e-2   # see phase_dp_checked
DP_FULL_STEPS = 1
DP_FULL_RUNS = {
    "stage2": {**TRAIN_CONFIG, "zero_optimization": {"stage": 2}},
    "qgz-int8": {**TRAIN_CONFIG, "comm": {"quantized": {"enabled": True}}}}
# phase 24 (f): phase 14's stage-2 step with the pinned-host tier
OFFLOAD_DP_RUNS = {"offload-stage2": {**TRAIN_CONFIG, "zero_optimization": {
    "stage": 2, "offload_optimizer": {"device": "cpu"}}}}


# The wire (phase 20): phase 13's model at gas 2 under the gradient
# reduction's schedules, with qwZ, and 1-bit Adam at phase 13's gas 1;
# phase 14's step at gas 2 per microbatch and deferred; the two-level qgZ
# schedule over a world of 2 x 2 on Pythia-160M's input-embedding gradient.
WIRE_GAS = 2
WIRE_CHECK_CONFIG = {**DP_CHECK_CONFIG, "gradient_accumulation_steps": WIRE_GAS}
WIRE_CHECK_RUNS = {
    **{f"pmb-s{s}": {**WIRE_CHECK_CONFIG, "zero_optimization": {"stage": s}} for s in (2, 3)},
    **{f"def-s{s}-b{b}": {**WIRE_CHECK_CONFIG, "zero_optimization": {"stage": s},
                          "comm": {"overlap": {"enabled": True, "bucket_mb": b}}}
       for s in (2, 3) for b in (0, 4)},
    "qwz-s3": {**WIRE_CHECK_CONFIG,
               "zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
    "onebit": {**DP_CHECK_CONFIG, "optimizer": {"type": "OneBitAdam",
                                                "params": {"lr": 1e-4, "freeze_step": 1}}},
}
WIRE_LOGGED = "def-s2-b4"          # run with comms_logger on; its table is printed
WIRE_FULL_RUNS = {
    "per-microbatch": {**TRAIN_CONFIG, "gradient_accumulation_steps": WIRE_GAS,
                       "zero_optimization": {"stage": 2}},
    "deferred": {**TRAIN_CONFIG, "gradient_accumulation_steps": WIRE_GAS,
                 "zero_optimization": {"stage": 2}, "comm": {"overlap": {"enabled": True}}}}
WIRE_INTER, WIRE_INTRA = 2, 2
WIRE_SHAPE = (50304, 768)


# The layout (phase 21): four processes as tp 2 x dp 2 or dp 2 x zshard 2
# (rank r = (i_dp * 2 + i_zshard) * tp + i_tp); phase 13's model, card
# against the CPU, and phase 14's step at tp 2; in phase 13's workers,
# phase 14's step from training_data= with and without the prefetcher.
LAYOUT_WORLD = 4
LAYOUT_BF16_TOL = 1e-2
LAYOUT_DEVICES = ("cuda", "cpu")      # (b), (c): each run on the card, then the CPU
LAYOUT_CHECK_STEPS = 2                # of phase 13's batches, for (b) and (c)
LAYOUT_CHECK_RUNS = {
    "tp-s2": ({**DP_CHECK_CONFIG, "zero_optimization": {"stage": 2}}, {"tp": 2}),
    "mics-s2": ({**DP_CHECK_CONFIG, "zero_optimization": {"stage": 2, "mics_shard_size": 2}},
                {"zshard": 2}),
    "hpz-s3": ({**DP_CHECK_CONFIG,
                "zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
               {"zshard": 2}),
    **{f"qgz-{w}": ({**DP_CHECK_CONFIG, "comm": {"quantized": {
        "enabled": True, "wire_dtype": w, "intra_axis": "zshard"}}}, {"zshard": 2})
       for w in ("int8", "fp8")}}
LAYOUT_FULL_CONFIG = {**TRAIN_CONFIG, "zero_optimization": {"stage": 2}}
LAYOUT_PREFETCH_RUNS = {
    f"prefetch-{d}": {**LAYOUT_FULL_CONFIG, **({"comm": {"overlap": {
        "enabled": True, "prefetch_depth": d, "deferred_reduction": False}}} if d else {})}
    for d in (0, 2)}


def dp_check_model(device=None):
    """Phase 8's model: Pythia-160M at full width with 2 layers, fp32; drawn
    on the card unless ``device`` is given (the card-against-CPU checks
    name both devices and take the CPU's draw on each)."""
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(dataclasses.replace(GPTNeoXConfig.pythia_160m(), num_layers=2),
                   device=device, seed=SEED, draw_on_device=device is None)


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


def _flash_case(torch, gen, report, B, S, N, D, causal):
    """K5, K7 and K6 at one bf16 shape against their plain versions, each
    timed beside its bound and the library's attention (phase 3 and phase
    22's Llama shape)."""
    import torch.nn.functional as F

    from deeperspeed_tpu_torch.ops.attention import flash

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
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
        _flash_case(torch, gen, report, B, S, N, D, causal)

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
        for step in range(FUSED_CHECK_STEPS):
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
              f"{FUSED_CHECK_STEPS} steps, losses card vs CPU within {worst:.2e} relative "
              f"(tol {tol}); "
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
        norms = [eng.get_global_grad_norm()]
        torch.cuda.reset_peak_memory_stats()
        comm.STAGED.clear()
        comm.STAGED_SECONDS.clear()
        LAUNCHES.clear()                                  # main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for _ in range(DP_FULL_STEPS):
            losses.append(float(eng.train_batch(batch=batch)))
            norms.append(eng.get_global_grad_norm())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = _engine_record(torch, eng, [first] + losses,
                             LAUNCHES["dequant_reduce"] / DP_FULL_STEPS)
        rec.update(grad_norms=norms)
        rec.update(ms_per_step=dt / DP_FULL_STEPS * 1e3, launches=dict(LAUNCHES),
                   staged_bytes_per_step=sum(comm.STAGED.values()) / DP_FULL_STEPS,
                   staged_ms_per_step={op: t / DP_FULL_STEPS * 1e3
                                       for op, t in comm.STAGED_SECONDS.items()},
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        results[f"full-{name}"] = rec
        del eng, model
        torch.cuda.empty_cache()
    for name, cfg in OFFLOAD_DP_RUNS.items():           # phase 24 (f)
        model = trained_model()
        eng = dst.initialize(model=model, config=cfg)[0]
        batch = {k: v.cuda() for k, v in trained_batch(model).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(eng.train_batch(batch=batch)) for _ in range(OFFLOAD_DP_STEPS)]
        torch.cuda.synchronize()
        results[name] = {"losses": losses,
                         "ms_per_step": (time.perf_counter() - t0) / OFFLOAD_DP_STEPS * 1e3,
                         "h2d_gb": eng.offload_stats["h2d_bytes"] / 1e9,
                         "d2h_gb": eng.offload_stats["d2h_bytes"] / 1e9}
        del eng, model
        torch.cuda.empty_cache()
    for name, cfg in WIRE_CHECK_RUNS.items():           # phase 20 (b)
        if name == WIRE_LOGGED:
            cfg = {**cfg, "comms_logger": {"enabled": True}}
        eng = dst.initialize(model=dp_check_model(), config=cfg)[0]
        rec = {"losses": [], "staged": [], "b5": [], "grad_norms": []}
        unwatch = _watch_onebit(torch, rec) if name == "onebit" else None
        for b in batches:
            comm.STAGED.clear()
            LAUNCHES.clear()
            rec["losses"].append(float(eng.train_batch(batch=b)))
            rec["staged"].append(dict(comm.STAGED))
            rec["b5"].append(LAUNCHES["dequant_reduce"])
            rec["grad_norms"].append(eng.get_global_grad_norm())
        if unwatch:
            unwatch()
        rec["footprint"] = eng.comm_footprint
        if name == WIRE_LOGGED:
            rec["comms_rows"] = comm.log_summary(show_straggler=True)
            comm.comms_logger.enabled = False
        results[f"wire-{name}"] = rec
        del eng
        torch.cuda.empty_cache()
    plan = None
    # phase 25 (c), the cost-model schedule, then phase 20 (c): its deferred
    # run at the plan's bucket_mb
    for name, cfg in {"auto": PLAN_AUTO_RUN, **WIRE_FULL_RUNS}.items():
        if name == "deferred":
            cfg = {**cfg, "comm": {"overlap": {"enabled": True,
                                               "bucket_mb": plan["bucket_mb"]}}}
        model = trained_model()
        eng = dst.initialize(model=model, config=cfg)[0]
        batch = {k: v.cuda() for k, v in trained_batch(model).items()}
        first = float(eng.train_batch(batch=batch))      # warm-up
        norms = [eng.get_global_grad_norm()]
        comm.STAGED.clear()
        comm.STAGED_SECONDS.clear()
        LAUNCHES.clear()                                  # main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for _ in range(DP_FULL_STEPS):
            losses.append(float(eng.train_batch(batch=batch)))
            norms.append(eng.get_global_grad_norm())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {"losses": [first] + losses, "grad_norms": norms,
               "ms_per_step": dt / DP_FULL_STEPS * 1e3,
               "launches": dict(LAUNCHES), "footprint": eng.comm_footprint,
               "staged_bytes_per_step": sum(comm.STAGED.values()) / DP_FULL_STEPS,
               "grad_bytes_per_step": comm.STAGED["grad_reduce"] / DP_FULL_STEPS,
               "grad_ms_per_step": comm.STAGED_SECONDS["grad_reduce"] / DP_FULL_STEPS * 1e3}
        if name == "auto":
            step = eng.scheduled_step
            plan = {"describe": eng._sched_plan.describe(), "tag": eng._sched_plan.tag,
                    "bucket_mb": eng._sched_plan.bucket_mb,
                    "grad_schedule": eng._sched_plan.grad_schedule,
                    "n_hoisted": step.n_hoisted, "n_collectives": step.n_collectives,
                    "buckets": len(eng._buckets)}
            rec["plan"] = plan
            results["plan-auto"] = rec
        else:
            rec["bucket_mb"] = cfg.get("comm", {}).get("overlap", {}).get("bucket_mb", 0.0)
            results[f"wire-full-{name}"] = rec
        del eng, model
        torch.cuda.empty_cache()
    for name, cfg in LAYOUT_PREFETCH_RUNS.items():      # phase 21 (d)
        model = trained_model()
        eng = dst.initialize(model=model, config=cfg,
                             training_data=fused_training_data(np, model.config.vocab_size))[0]
        first = float(eng.train_batch())                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(eng.train_batch()) for _ in range(DP_FULL_STEPS)]
        torch.cuda.synchronize()
        results[name] = {"losses": [first] + losses,
                         "ms_per_step": (time.perf_counter() - t0) / DP_FULL_STEPS * 1e3,
                         "prefetcher": type(eng._prefetcher).__name__}
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


def _watch_onebit(torch, rec):
    """Wrap ``comm/compressed.py`` ``onebit_all_reduce`` so that its first
    call on a parameter of at least 2^20 elements also runs on CPU copies
    of the same gradient and error (every rank makes the same call, so the
    gloo collectives pair up); ``rec["cpu_check"]`` gets the largest
    differences of the mean and the new error, each over its largest value.
    Returns the function that restores the original."""
    from deeperspeed_tpu_torch.comm import compressed

    plain = compressed.onebit_all_reduce

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))

    def watched(x, group, error=None):
        mean, err = plain(x, group, error)
        if "cpu_check" not in rec and x.numel() >= 1 << 20:
            m, e = plain(x.detach().cpu(), group,
                         None if error is None else error.detach().cpu())
            rec["cpu_check"] = {"numel": x.numel(), "on_cuda": x.is_cuda,
                                "mean_rel": rel(mean, m), "error_rel": rel(err, e),
                                "finite": bool(torch.isfinite(mean).all())}
        return mean, err

    compressed.onebit_all_reduce = watched
    return lambda: setattr(compressed, "onebit_all_reduce", plain)


def _spawn_dp_workers(workdir, flag="--dp-worker", world=DP_WORLD, go=None):
    """Start the ``world`` worker processes (``flag``: ``--dp-worker`` or
    ``--wire-worker``); returns them with their log and result paths.  With
    ``go`` (a path) they start, make their CUDA context and then wait for
    that file before they run."""
    env = dict(os.environ, DST_SMOKE_GO=str(go)) if go is not None else None
    procs = []
    for rank in range(world):
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(rank),
             str(workdir / "rendezvous"), str(workdir / f"rank{rank}.json")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log,
            workdir / f"rank{rank}.log", workdir / f"rank{rank}.json"))
    return procs


# The worker groups, started right after the build and held at a go file
# until their phase, so that their start (the interpreter, torch, a CUDA
# context) overlaps the phases before them; ``_workers`` releases a held
# group, or starts one (the tools that run one phase alone).
# ``release_early`` lets a group run ahead under an earlier phase that waits
# on the disk (phase 19) or on its own workers (phases 13-14); its phase
# then joins it.
_HELD = {}
_RELEASED = {}


def _scratch_dir():
    build = ROOT / ".build"
    build.mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(dir=build))


def hold_workers():
    for flag, world in (("--dp-worker", DP_WORLD), ("--wire-worker", WIRE_INTER * WIRE_INTRA),
                        ("--layout-worker", LAYOUT_WORLD),
                        ("--llama-worker", LLAMA_TP_WORLD), ("--moe-worker", MOE_EP_WORLD),
                        ("--pipe-worker", PIPE_WORLD), ("--pipe-dp-worker", PIPE_DP_WORLD),
                        ("--sp-worker", SP_WORLD)):
        workdir = _scratch_dir()
        _HELD[flag] = (workdir, _spawn_dp_workers(workdir, flag, world, go=workdir / "go"))
    # the phases start once every held worker has its context, so that no
    # context is made while they time the card
    t0, deadline = time.perf_counter(), time.monotonic() + 180
    for workdir, procs in _HELD.values():
        for rank, (p, *_) in enumerate(procs):
            while not (workdir / f"ready{rank}").exists() and p.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
    print(f"[workers] {sum(len(p) for _, p in _HELD.values())} worker processes started "
          f"and held in {time.perf_counter() - t0:.1f} s", flush=True)


def release_early(flag):
    """Let the held group ``flag`` run now; :func:`_workers` returns it at
    its phase."""
    if flag in _HELD:
        workdir, procs = _RELEASED[flag] = _HELD.pop(flag)
        (workdir / "go").touch()


def start_early(flag, world):
    """Start the group ``flag`` now, unheld (it makes its CUDA context while
    the phase that starts it runs); :func:`_workers` returns it at its
    phase."""
    workdir = _scratch_dir()
    _RELEASED[flag] = (workdir, _spawn_dp_workers(workdir, flag, world))


def _workers(flag, world):
    """``(workdir, processes)`` of the ``world`` workers of ``flag``, running."""
    if flag in _RELEASED:
        return _RELEASED.pop(flag)
    if flag in _HELD:
        workdir, procs = _HELD.pop(flag)
        (workdir / "go").touch()
        return workdir, procs
    workdir = _scratch_dir()
    return workdir, _spawn_dp_workers(workdir, flag, world)


def stop_held_workers():
    """Stop the groups a failed run never released or never joined."""
    for _, procs in [*_HELD.values(), *_RELEASED.values()]:
        for p, log, *_ in procs:
            p.kill()
            p.wait()
            log.close()
    _HELD.clear()
    _RELEASED.clear()


def _wait_to_run(go):
    """A held worker: make the CUDA context and import the port, say so with
    ``ready<rank>`` beside the go file, then wait for the go file (False if
    the parent is gone)."""
    import torch

    import deeperspeed_tpu_torch  # noqa: F401

    torch.zeros(1, device="cuda")
    (Path(go).parent / f"ready{sys.argv[2]}").touch()
    parent = os.getppid()
    while not os.path.exists(go):
        if os.getppid() != parent:
            return False
        time.sleep(0.05)
    return True


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

    t0 = time.perf_counter()
    r0, r1 = _join_dp_workers(_workers("--dp-worker", DP_WORLD)[1])
    print(f"[dp] two workers on the card over gloo: {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_dp_checked(r0, r1, ref_losses, ref_norm, ref_alloc, total, partitioned, n_big)
    return phase_dp_full(r0, r1), r0["ckpt-stage2"], (r0, r1)


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


def wire_worker(rank, rendezvous, out_path):
    """One of the four processes of phase 20 (a) (``--wire-worker``): the
    two-level qgZ all-reduce and reduce-scatter on the card and on CPU
    copies, over the groups of a world of 2 x 2; writes what it saw to
    ``out_path`` as JSON."""
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    torch.set_num_threads(2)
    world = WIRE_INTER * WIRE_INTRA
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=world, timeout=600)
    intra, inter = comm.new_two_level_groups(WIRE_INTER, WIRE_INTRA)

    def grad(r):
        g = torch.Generator().manual_seed(SEED + 60 + r)
        return torch.randn(WIRE_SHAPE, generator=g) * (1.0 + r)

    x = grad(rank)
    exact = sum(grad(r) for r in range(world))
    # participant (i_intra, i_inter) holds global chunk i_intra * n_inter + i_inter
    i_inter, i_intra = divmod(rank, WIRE_INTRA)
    chunk = exact.chunk(world)[i_intra * WIRE_INTER + i_inter]
    xc = x.cuda()
    results = {}
    for wire in ("int8", "fp8"):
        for op, fn, want in (("all_reduce", comm.all_reduce_quantized, exact),
                             ("reduce_scatter", comm.reduce_scatter_quantized, chunk)):
            torch.cuda.synchronize()
            LAUNCHES.clear()
            comm.STAGED.clear()
            comm.comms_logger.begin_step()
            t0 = time.perf_counter()
            y = fn(xc, intra_group=intra, inter_group=inter, wire_dtype=wire)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            footprint = comm.comms_logger.end_step()
            launches, staged = dict(LAUNCHES), sum(comm.STAGED.values())
            plain = fn(x, intra_group=intra, inter_group=inter, wire_dtype=wire)
            got = y.cpu()
            results[f"{op}-{wire}"] = {
                "launches": launches, "ms": ms, "staged_bytes": staged,
                "footprint": footprint, "numel": y.numel(),
                "bit_equal": bool(torch.equal(got.view(torch.int32),
                                              plain.view(torch.int32))),
                "max_abs_err": float((got - plain).abs().max()),
                "rel_to_exact": float((got - want).abs().max() / want.abs().max())}
    with open(out_path, "w") as f:
        json.dump(results, f)
    comm.destroy()
    return 0


def phase_wire(card, r0, r1):
    """Phase 20, the wire: (b) and (c) from phase 13's two workers' results,
    then (a) the four two-level workers.  Returns rank 0's launch counts of
    the two-level collectives and of the deferred full-size steps."""
    from deeperspeed_tpu_torch.telemetry import wire

    # ---- (b) the schedules on phase 13's model, gas 2
    for a, b in zip(*[[r[f"wire-{name}"] for name in WIRE_CHECK_RUNS] for r in (r0, r1)]):
        if a["losses"] != b["losses"] or not all(map(math.isfinite, a["losses"])):
            raise AssertionError(f"wire: losses {a['losses']} / {b['losses']}")
    for stage in (2, 3):
        base = r0[f"wire-pmb-s{stage}"]
        grad_pmb = base["staged"][-1].get("grad_reduce", 0)
        for bucket in (0, 4):
            rec = r0[f"wire-def-s{stage}-b{bucket}"]
            rels = [abs(x - y) / abs(y) for x, y in zip(rec["losses"], base["losses"])]
            if max(rels) > 1e-4:
                raise AssertionError(f"wire stage {stage} bucket {bucket}: losses "
                                     f"{rec['losses']} vs per microbatch {base['losses']}")
            # the norm is taken before clipping: it sees a wrong division by
            # gas x world that Adam's scale-free update hides from the losses
            nrels = [abs(x - y) / abs(y) for x, y in zip(rec["grad_norms"],
                                                         base["grad_norms"])]
            if max(nrels) > 1e-4:
                raise AssertionError(f"wire stage {stage} bucket {bucket}: grad norms "
                                     f"{rec['grad_norms']} vs per microbatch "
                                     f"{base['grad_norms']}")
            if bucket and rec["losses"] != r0[f"wire-def-s{stage}-b0"]["losses"]:
                raise AssertionError(f"wire stage {stage}: bucketed losses {rec['losses']} "
                                     f"differ from the unbucketed")
            grad = rec["staged"][-1].get("grad_reduce", 0)
            foot, = rec["footprint"]
            print(f"[wire] {card}: 2 full-width layers fp32, gas {WIRE_GAS}, world "
                  f"{DP_WORLD}, stage {stage}, deferred, bucket_mb {bucket}: losses "
                  f"{', '.join(f'{x:.6f}' for x in rec['losses'])} on both ranks (per "
                  f"microbatch {', '.join(f'{x:.6f}' for x in base['losses'])}; max "
                  f"relative {max(rels):.2e}); grad norms "
                  f"{', '.join(f'{x:.6f}' for x in rec['grad_norms'])} (per microbatch "
                  f"{', '.join(f'{x:.6f}' for x in base['grad_norms'])}; max relative "
                  f"{max(nrels):.2e}); {foot['count']} collectives a step; gradient "
                  f"reduction staged through host {grad / 1e6:.3f} MB a step (per microbatch "
                  f"{grad_pmb / 1e6:.3f} MB, {grad / max(grad_pmb, 1):.3f}x); analytic wire "
                  f"bytes {foot['bytes'] / 1e6:.3f} MB ({foot['schedule']}; per microbatch "
                  f"{base['footprint'][0]['bytes'] / 1e6:.3f} MB)", flush=True)
    ob, adam = r0["wire-onebit"], r0["stage0"]["losses"]
    # freeze_step 1: step 0 is exact Adam on the exact mean, so the loss
    # after it is Adam's; step 1 is sign-compressed
    warm = abs(ob["losses"][1] - adam[1]) / abs(adam[1])
    if ob["losses"][0] != adam[0] or warm > 1e-6:
        raise AssertionError(f"OneBitAdam losses {ob['losses'][:2]} vs Adam's {adam[:2]}")
    checks = [r["wire-onebit"].get("cpu_check") for r in (r0, r1)]
    for c in checks:
        if (not c or not c["on_cuda"] or not c["finite"] or c["mean_rel"] > 1e-5
                or c["error_rel"] > 1e-5):
            raise AssertionError(f"OneBitAdam compressed reduction vs CPU copies: {checks}")
    c = checks[0]
    print(f"[wire] {card}: OneBitAdam freeze_step 1, {DP_CHECK_STEPS} steps at world "
          f"{DP_WORLD}: losses "
          f"{', '.join(f'{x:.6f}' for x in ob['losses'])} on both ranks (Adam "
          f"{', '.join(f'{x:.6f}' for x in adam)}; after the warm-up step relative "
          f"{warm:.2e}); first compressed reduction of a {c['numel']}-element parameter "
          f"against CPU copies: mean {max(x['mean_rel'] for x in checks):.2e}, error "
          f"{max(x['error_rel'] for x in checks):.2e} of their largest value; last "
          f"step's record {ob['footprint'][0]['op']} "
          f"{ob['footprint'][0]['bytes'] / 1e6:.3f} MB analytic", flush=True)
    q, s3 = r0["wire-qwz-s3"], r0["wire-pmb-s3"]
    if max(abs(x - y) for x, y in zip(q["losses"], s3["losses"])) > 0.05:
        raise AssertionError(f"qwZ losses {q['losses']} vs stage 3 {s3['losses']}")
    gq, gp = (q["staged"][-1].get("stage3_gather_qwz", 0),
              s3["staged"][-1].get("stage3_gather", 0))
    if not 0 < gq < gp:
        raise AssertionError(f"qwZ gathers staged {gq} bytes a step, stage 3 {gp}")
    print(f"[wire] {card}: stage 3 with qwZ: losses {', '.join(f'{x:.6f}' for x in q['losses'])}"
          f" (without {', '.join(f'{x:.6f}' for x in s3['losses'])}); parameter gathers "
          f"staged through host {gq / 1e6:.3f} MB a step against {gp / 1e6:.3f} MB "
          f"({gq / gp:.3f}x)", flush=True)
    print(f"[wire] comm.log_summary(show_straggler=True), rank 0, {WIRE_LOGGED}:", flush=True)
    print(f"[wire] {'Comm Op':<20}{'Msg Size':<12}{'Count':<8}{'Avg Lat(ms)':<14}"
          f"{'algbw GB/s':<12}{'busbw GB/s':<12}{'Min(ms)':<10}{'Max(ms)':<10}"
          f"{'Straggler(ms)':<14}", flush=True)
    for r in r0[f"wire-{WIRE_LOGGED}"]["comms_rows"]:
        print(f"[wire] {r[0]:<20}{r[1]:<12}{r[2]:<8}{r[3]:<14.3f}{r[4]:<12.3f}{r[5]:<12.3f}"
              f"{r[6]:<10.3f}{r[7]:<10.3f}{r[8]:<14.3f}", flush=True)

    # ---- (c) phase 14's step at gas 2, per microbatch and deferred
    for name in WIRE_FULL_RUNS:
        a, b = r0[f"wire-full-{name}"], r1[f"wire-full-{name}"]
        if a["losses"] != b["losses"] or not all(map(math.isfinite, a["losses"])):
            raise AssertionError(f"wire full {name}: losses {a['losses']} / {b['losses']}")
        for kernel in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                       "flash_bwd_dkv"):
            if a["launches"].get(kernel, 0) < 1:
                raise AssertionError(f"wire full {name}: {kernel} never launched")
        foot, = a["footprint"]
        bucket = (f" (bucket_mb {a['bucket_mb']:g}, phase 25 (c)'s plan's)"
                  if name == "deferred" else "")
        print(f"[wire-full] {card}: Pythia-160M bf16, global B {TRAIN_BATCH} x S "
              f"{TRAIN_SEQ}, gas {WIRE_GAS}, world {DP_WORLD}, stage 2, {name}{bucket}: "
              f"{a['ms_per_step']:.2f} / {b['ms_per_step']:.2f} ms/step (rank 0 / 1) over "
              f"{DP_FULL_STEPS} steps; losses {', '.join(f'{x:.4f}' for x in a['losses'])} "
              f"on both ranks; staged through host {a['staged_bytes_per_step'] / 1e9:.3f} GB "
              f"a step, of it the gradient reduction {a['grad_bytes_per_step'] / 1e9:.3f} GB "
              f"in {a['grad_ms_per_step']:.2f} ms; analytic wire bytes "
              f"{foot['bytes'] / 1e9:.3f} GB in {foot['count']} collectives", flush=True)
    pmb, dfr = r0["wire-full-per-microbatch"], r0["wire-full-deferred"]
    if pmb["losses"][0] != dfr["losses"][0]:
        raise AssertionError(f"wire full: first losses {pmb['losses'][0]} / "
                             f"{dfr['losses'][0]}")
    print(f"[wire-full] deferred / per microbatch: {dfr['ms_per_step'] / pmb['ms_per_step']:.3f}x "
          f"ms/step, {dfr['grad_bytes_per_step'] / pmb['grad_bytes_per_step']:.3f}x gradient "
          f"bytes staged", flush=True)

    # ---- (a) the two-level qgZ schedule at world 4
    t0 = time.perf_counter()
    world = WIRE_INTER * WIRE_INTRA
    ranks = _join_dp_workers(_workers("--wire-worker", world)[1])
    print(f"[wire-2level] four workers on the card over gloo: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_elems = math.prod(WIRE_SHAPE)
    for key in ranks[0]:
        op, wire_dtype = key.split("-")
        for r, rec in enumerate(ranks):
            rec = rec[key]
            # four roundings (two hops, two gathers) of at most half a grid
            # step of a group's largest value: 1/254 in int8, 1/8 in e5m2
            tol = 0.5 if wire_dtype == "fp8" else 0.05
            if not rec["bit_equal"] or rec["launches"].get("dequant_reduce") != 2 \
                    or rec["rel_to_exact"] > tol:
                raise AssertionError(f"two-level {key} rank {r}: {rec}")
        rec = ranks[0][key]
        variant = wire.quantized_variant(WIRE_INTRA, WIRE_INTER, wire_dtype)
        want = wire.wire_bytes(op, variant, n_elems, WIRE_INTRA, WIRE_INTER, 128)
        foot, = rec["footprint"]
        if foot["bytes"] != want:
            raise AssertionError(f"two-level {key}: recorded {foot['bytes']} bytes, "
                                 f"wire_bytes {want}")
        print(f"[wire-2level] {card}: {op} {wire_dtype} of [{WIRE_SHAPE[0]}, "
              f"{WIRE_SHAPE[1]}] fp32 over {WIRE_INTER} x {WIRE_INTRA}: bit for bit the "
              f"plain schedule on the CPU on all {world} ranks, B5 twice (once a hop), "
              f"{rec['rel_to_exact']:.2e} of the exact sum's largest magnitude; "
              f"{rec['ms']:.2f} ms on rank 0 (host clock, gloo via host); analytic wire "
              f"bytes {foot['bytes'] / 1e6:.3f} MB a rank ({variant}; the flat schedule's "
              f"{wire.wire_bytes(op, variant.replace('two_level', 'flat'), n_elems, world, 1, 128) / 1e6:.3f} MB,"
              f" fp32 {wire.wire_bytes(op, 'fp32', n_elems, world, 1, 128) / 1e6:.3f} MB); "
              f"staged through host {rec['staged_bytes'] / 1e6:.3f} MB", flush=True)
    two_level = {"dequant_reduce": sum(rec["launches"].get("dequant_reduce", 0)
                                       for rec in ranks[0].values())}
    return two_level, dfr["launches"]


def _layout_record(torch, eng, comm, losses, norms, steps, dt):
    """What a phase-21 run reports: losses and grad norms, ms/step, the
    bytes staged through host a step by op, the elements held."""
    from deeperspeed_tpu_torch.utils.tree import tree_leaves

    return {"losses": losses, "grad_norms": norms, "ms_per_step": dt / steps * 1e3,
            "staged": {op: b / steps for op, b in comm.STAGED.items()},
            "staged_ms": {op: t / steps * 1e3 for op, t in comm.STAGED_SECONDS.items()},
            "footprint": eng.comm_footprint,
            "master_numel": sum(t.numel() for t in eng.master_params.values()),
            "opt_numel": sum(t.numel() for t in tree_leaves(eng.opt_state)
                             if isinstance(t, torch.Tensor)),
            "shard_numel": sum(g.shard.numel() for *_, g in eng._compute if g is not None),
            "tp_numel": sum(math.prod(shape) for r in eng.plan.regions for shape in r.shapes),
            "group_sizes": {op: sorted(n) for op, n in comm.comms_logger.group_sizes.items()}}


def layout_worker(rank, rendezvous, out_path):
    """One of the four processes of phase 21 (``--layout-worker``): (b) and
    (c) on the card and on the CPU, then (a) at full size on the card;
    writes what it saw to ``out_path`` as JSON."""
    import numpy as np
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES
    from deeperspeed_tpu_torch.parallel import MeshTopology

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=LAYOUT_WORLD, timeout=600)
    results = {}
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for name, (cfg, mesh) in LAYOUT_CHECK_RUNS.items():          # (b), (c)
        for device in LAYOUT_DEVICES:
            comm.comms_logger.configure(enabled=True)
            comm.comms_logger.comms_dict.clear()
            comm.comms_logger.group_sizes.clear()
            eng = dst.initialize(model=dp_check_model(device), config=cfg, device=device,
                                 mesh=MeshTopology(**mesh))[0]
            batches = dp_check_batches(np, eng.module.config.vocab_size)[:LAYOUT_CHECK_STEPS]
            captured = {}
            if name.startswith("qgz") and device != "cpu":
                reduce = eng._reduce

                def capture(divisor, eng=eng, reduce=reduce, captured=captured):
                    names = [n for r in eng.plan.regions for n in r.names]
                    views = dict(zip(names, eng._acc_views))
                    if not captured:
                        captured.update(pre={n: (v / divisor).clone()
                                             for n, v in views.items()})
                    reduce(divisor)
                    if "post" not in captured:
                        captured["post"] = {n: v.clone() for n, v in views.items()}

                eng._reduce = capture
            comm.STAGED.clear()
            comm.STAGED_SECONDS.clear()
            LAUNCHES.clear()
            sync()
            t0 = time.perf_counter()
            losses, norms, b5 = [], [], []
            for b in batches:
                LAUNCHES.clear()
                losses.append(float(eng.train_batch(batch=b)))
                norms.append(eng.get_global_grad_norm())
                b5.append(LAUNCHES["dequant_reduce"])
            rec = _layout_record(torch, eng, comm, losses, norms, len(batches),
                                 time.perf_counter() - t0)
            rec["b5"] = b5
            if captured:
                # the same two-hop schedule on CPU copies of the card's
                # per-rank gradients (every rank makes the same calls)
                wire = cfg["comm"]["quantized"]["wire_dtype"]
                big = [n for n, t in captured["pre"].items() if t.numel() >= 128 * eng.world]
                equal = []
                for n in big:
                    want = comm.all_reduce_quantized(
                        captured["pre"][n].cpu(), op=comm.ReduceOp.AVG, group=eng.group,
                        intra_group=eng._qgz_intra, wire_dtype=wire)
                    got = captured["post"][n].cpu()
                    equal.append(bool(torch.equal(got.view(torch.int32),
                                                  want.view(torch.int32))))
                rec.update(n_big=len(big), bit_equal=equal)
            results[f"{name}-{'cpu' if device == 'cpu' else 'cuda'}"] = rec
            comm.comms_logger.enabled = False
            del eng
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    # (a): phase 9's step at tp 2 x dp 2
    model = trained_model()
    eng = dst.initialize(model=model, config=LAYOUT_FULL_CONFIG,
                         mesh=MeshTopology(tp=2))[0]
    batch = {k: v.to(eng.device) for k, v in trained_batch(model).items()}
    first = float(eng.train_batch(batch=batch))                 # warm-up
    norms = [eng.get_global_grad_norm()]
    comm.STAGED.clear()
    comm.STAGED_SECONDS.clear()
    LAUNCHES.clear()                                              # main path starts here
    sync()
    t0 = time.perf_counter()
    losses = []
    for _ in range(DP_FULL_STEPS):
        losses.append(float(eng.train_batch(batch=batch)))
        norms.append(eng.get_global_grad_norm())
    sync()
    rec = _layout_record(torch, eng, comm, [first] + losses, norms, DP_FULL_STEPS,
                         time.perf_counter() - t0)
    rec.update(launches=dict(LAUNCHES), heads=eng.module.layers[0].attention
               .query_key_value.weight.shape[0] // (3 * eng.module.config.head_dim),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9
               if torch.cuda.is_available() else 0.0)
    results["full-tp2-dp2"] = rec
    del eng, model
    with open(out_path, "w") as f:
        json.dump(results, f)
    comm.destroy()
    return 0


def _staged_line(rec):
    return ", ".join(f"{op} {b / 1e6:.3f} MB" for op, b in sorted(rec["staged"].items()))


def phase_layout(card, r0, r1):
    """Phase 21, the layout: (d) from phase 13's two workers' results, then
    the four layout workers' (b), (c) and (a).  Returns rank 0's launch
    counts of (a)'s timed steps."""
    from deeperspeed_tpu_torch.models import GPTNeoXConfig
    from deeperspeed_tpu_torch.telemetry.wire import plain_wire_bytes

    # ---- (d) the prefetching loader at phase 14's step, world 2
    plain, ahead = r0["prefetch-0"], r0["prefetch-2"]
    if plain["losses"] != ahead["losses"] or r1["prefetch-0"]["losses"] != \
            r1["prefetch-2"]["losses"] or ahead["prefetcher"] != "DevicePrefetchingLoader":
        raise AssertionError(f"prefetch: losses {plain['losses']} / {ahead['losses']} "
                             f"({ahead['prefetcher']})")
    print(f"[layout-d] {card}: phase 14's step from training_data= at world 2, stage 2: "
          f"prefetch_depth 2 {ahead['ms_per_step']:.2f} ms/step, without "
          f"{plain['ms_per_step']:.2f} ms/step (rank 0, host clock, {DP_FULL_STEPS} steps); "
          f"losses {', '.join(f'{x:.4f}' for x in ahead['losses'])} bit-equal on both ranks",
          flush=True)

    t0 = time.perf_counter()
    ranks = _join_dp_workers(_workers("--layout-worker", LAYOUT_WORLD)[1])
    print(f"[layout] four workers on the card over gloo: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- (b), (c): phase 13's model, card against the CPU
    total = sum(math.prod(s) for s in param_shapes(
        dataclasses.replace(GPTNeoXConfig.pythia_160m(), num_layers=2)))
    for name in LAYOUT_CHECK_RUNS:
        cards = [r[f"{name}-cuda"] for r in ranks]
        cpus = [r[f"{name}-cpu"] for r in ranks]
        a, c = cards[0], cpus[0]
        if any(r["losses"] != a["losses"] for r in cards) or \
                not all(map(math.isfinite, a["losses"])):
            raise AssertionError(f"layout {name}: ranks' losses {[r['losses'] for r in cards]}")
        rels = [abs(x - y) / abs(y) for x, y in zip(a["losses"], c["losses"])]
        qgz = name.startswith("qgz")
        limit = [1e-4] + [DP_QGZ_TOL if qgz else 1e-4] * (len(rels) - 1)
        if any(r > lim for r, lim in zip(rels, limit)):
            raise AssertionError(f"layout {name}: card {a['losses']} vs CPU {c['losses']}")
        held = [r["master_numel"] for r in cards]
        extra = ""
        if name.startswith("mics") and not all(abs(h - total / 2) <= 4 for h in held):
            raise AssertionError(f"MiCS: masters held {held} of {total}")
        if name.startswith("hpz"):
            if not all(abs(h - total / 4) <= 16 for h in held):
                raise AssertionError(f"hpZ: masters held {held} of {total}")
            sizes = a["group_sizes"]
            if sizes.get("stage3_gather") != [2] or sizes.get("hpz_refresh") != [4]:
                raise AssertionError(f"hpZ: gathers over {sizes}")
            extra = f"; stage-3 gathers over {sizes['stage3_gather']} ranks"
        if name.startswith("tp"):
            tp = [r["tp_numel"] for r in cards]
            if not all(abs(t - total / 2) <= total * 0.01 for t in tp):
                raise AssertionError(f"tp: slices of {tp} elements of {total}")
            extra = f"; tp slice {tp[0]} elements"
        if qgz:
            for r in cards:
                if not r["bit_equal"] or not all(r["bit_equal"]) \
                        or r["b5"] != [2 * r["n_big"]] * LAYOUT_CHECK_STEPS:
                    raise AssertionError(f"layout {name}: {r['n_big']} parameters, bit-equal "
                                         f"{r['bit_equal']}, B5 a step {r['b5']}")
            extra = (f"; {a['n_big']} reduced gradients bit for bit the CPU schedule's on "
                     f"all {LAYOUT_WORLD} ranks, B5 {a['b5'][0]} a step (twice a parameter)")
        foot = sum(f["bytes"] for f in a["footprint"])
        print(f"[layout-{'c' if qgz else 'b'}] {card}: {name}, 2 full-width layers fp32, "
              f"{DP_CHECK_ROWS} x {DP_CHECK_SEQ}: losses "
              f"{', '.join(f'{x:.6f}' for x in a['losses'])} on all ranks (CPU "
              f"{', '.join(f'{x:.6f}' for x in c['losses'])}; max relative {max(rels):.2e}); "
              f"{a['ms_per_step']:.2f} ms/step (rank 0, host clock); staged a step: "
              f"{_staged_line(a)}; analytic wire bytes {foot / 1e6:.3f} MB a rank; masters "
              f"held {held} of {total}{extra}", flush=True)

    # ---- (a) phase 9's step at tp 2 x dp 2 against phase 14's tp 1 x dp 2
    full = [r["full-tp2-dp2"] for r in ranks]
    a, ref = full[0], r0["full-stage2"]
    if any(r["losses"] != a["losses"] for r in full) or \
            not all(map(math.isfinite, a["losses"])):
        raise AssertionError(f"layout (a): losses {[r['losses'] for r in full]}")
    rels = [abs(x - y) / abs(y) for x, y in zip(a["losses"], ref["losses"])]
    nrels = [abs(x - y) / abs(y) for x, y in zip(a["grad_norms"], ref["grad_norms"])]
    if max(rels) > LAYOUT_BF16_TOL or max(nrels) > LAYOUT_BF16_TOL:
        raise AssertionError(f"layout (a): losses {a['losses']} / grad norms "
                             f"{a['grad_norms']} vs tp 1 {ref['losses']} / "
                             f"{ref['grad_norms']}")
    for kernel in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                   "flash_bwd_dkv"):
        if a["launches"].get(kernel, 0) < 1:
            raise AssertionError(f"layout (a): {kernel} never launched")
    if a["heads"] != 6:
        raise AssertionError(f"layout (a): {a['heads']} heads a rank")
    tp_wire = plain_wire_bytes("all_reduce", a["staged"].get("tp_reduce", 0) / 2, 2)
    grad_wire = sum(f["bytes"] for f in a["footprint"])
    print(f"[layout-a] {card}: Pythia-160M bf16, global B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
          f"stage 2, tp 2 x dp 2: {', '.join(f'{r['ms_per_step']:.2f}' for r in full)} "
          f"ms/step (ranks 0-3, host clock, {DP_FULL_STEPS} steps; tp 1 x dp 2 "
          f"{ref['ms_per_step']:.2f}); losses {', '.join(f'{x:.4f}' for x in a['losses'])} "
          f"(tp 1 {', '.join(f'{x:.4f}' for x in ref['losses'])}; max relative "
          f"{max(rels):.2e}); grad norms {', '.join(f'{x:.4f}' for x in a['grad_norms'])} "
          f"(max relative {max(nrels):.2e}); {a['heads']} heads a rank; staged a step: "
          f"{_staged_line(a)} (in {', '.join(f'{op} {t:.1f} ms' for op, t in sorted(a['staged_ms'].items()))}); "
          f"analytic wire bytes a rank: tp_reduce {tp_wire / 1e9:.3f} GB, gradient "
          f"reduction {grad_wire / 1e9:.3f} GB; held: tp slice {a['tp_numel']} elements, "
          f"masters {a['master_numel']}, moments {a['opt_numel']} (tp 1 x dp 2: masters "
          f"{ref['master_numel']}); peak {a['peak_gb']:.2f} GB", flush=True)
    return a["launches"]


# ---------------------------------------------------------------- phase 22
# The Llama family: Mistral-7B-v0.2's published shape, served and
# generated, Llama-2-7B's width and OPT-125M trained.
LLAMA_PROMPTS, LLAMA_PROMPT_LEN, LLAMA_DECODE_ROUNDS, LLAMA_SPEC_ROUNDS = 32, 512, 32, 4
LLAMA_ECFG = {"dtype": "bfloat16", "kv_cache": {"num_blocks": 4096, "block_size": 16},
              "state_manager": {"max_context": 1024, "max_ragged_batch_size": 4096,
                                "max_ragged_sequence_count": 64,
                                "max_decode_batch": LLAMA_PROMPTS}}
LLAMA_WINDOW_SEQ = 5000
V1_PROMPTS, V1_NEW, V1_PROMPT_LEN = 8, 32, 128
LLAMA_TP_WORLD, LLAMA_TP_NEW = 2, 16
# bf16 greedy tokens of two paths may part only where the reference's top-2
# logit margin is below this (one path's rounding decides a near tie)
BF16_MARGIN = 0.125
FP32_MARGIN = 1e-3
LLAMA_TRAIN_STEPS = 3
LLAMA_TRAIN = {"optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
               "bf16": {"enabled": True}, "gradient_clipping": 1.0,
               "steps_per_print": 1000000}
TRAIN_TOL = 1e-4                      # card vs CPU losses, relative (phase 8's)


def llama_served_config(**kw):
    """Mistral-7B-v0.2's shape: no window, rope theta 1e6, 8 KV heads."""
    from deeperspeed_tpu_torch.models import LlamaConfig

    return LlamaConfig.mistral_7b(sliding_window=None, rope_theta=1e6, **kw)


def v1_prompts(np, vocab):
    """``V1_PROMPTS`` prompts of 64-128 tokens left-padded to
    ``V1_PROMPT_LEN`` (every other row unpadded): ids and mask."""
    rng = np.random.default_rng(SEED + 22)
    ids = rng.integers(1, vocab, (V1_PROMPTS, V1_PROMPT_LEN)).astype(np.int64)
    mask = np.ones_like(ids)
    for row in range(1, V1_PROMPTS, 2):
        mask[row, :int(rng.integers(1, V1_PROMPT_LEN - 63))] = 0
    return ids * mask, mask


def _greedy_agree(np, got, want, margins, tol):
    """Rows of greedy tokens ``got`` against ``want`` [rows, new] whose
    reference top-2 margins are ``margins``: each row must agree up to its
    end or up to a step whose margin is below ``tol`` (where the two paths'
    roundings may pick apart, and the rows go on from different tokens).
    Returns the steps agreed a row."""
    agreed = []
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:
            first = int(diff[0])
            if margins[r, first] >= tol:
                raise AssertionError(f"row {r}: token {first} differs ({got[r, first]} vs "
                                     f"{want[r, first]}) at a top-2 margin of "
                                     f"{margins[r, first]:.4f} >= {tol}")
            agreed.append(first)
        else:
            agreed.append(want.shape[1])
    return agreed


def _v2_greedy(torch, np, eng, prompts, new):
    """``new`` greedy tokens a prompt through ``put_round`` (one prefill
    round, then decode rounds) and each step's top-2 margin."""
    uids = list(range(len(prompts)))
    toks, margins = [], []
    feed = [list(map(int, p)) for p in prompts]
    for _ in range(new):
        out = eng.put_round(uids, feed)
        top2 = torch.topk(out.logits[:len(uids)], 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        toks.append(out.tokens[:, -1].copy())
        feed = [[int(t)] for t in out.tokens[:, -1]]
    for u in uids:
        eng.flush(u)
    return np.stack(toks, 1), np.stack(margins, 1)


def phase_llama_kernels(torch, rows_out):
    """Phase 22's kernel rows at the Llama family's shapes: K1 and K8 as
    RMSNorm at H 4096, K2 / K2q / K3q with GQA's query groups folded into
    the batch (Mistral-7B: 32 sequences x 4 query heads over 8 KV heads,
    D 128), beside SDPA at the KV heads (``enable_gqa``), and K5-K7 at
    N 32, D 128 (Llama-2-7B's width)."""
    import torch.nn.functional as F

    from deeperspeed_tpu_torch.ops.attention import paged
    from deeperspeed_tpu_torch.ops.quantizer import byte_view, dequantize_kv, quantize_kv
    from deeperspeed_tpu_torch.ops.transformer import normalize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    bf16 = torch.bfloat16
    report = _reporter(rows_out)

    # ---- K1 rms: a decode round's 64 rows at H 4096, the scale fp32 (the
    # served model keeps its norms fp32); the library's F.rms_norm takes a
    # weight of the input's type
    H, rows = 4096, 64
    x = torch.randn(rows, H, generator=gen, device=dev).to(bf16)
    g = 1 + 0.1 * torch.randn(H, generator=gen, device=dev)
    y = normalize.rms_norm(x, g)
    err = _close(torch, y, normalize._ln_ref(x, g, None, 1e-5, True), 1e-2, 1e-2,
                 "rms_norm rows=64")
    t, by = _bound(2 * rows * H * 2 + H * 4, 5 * rows * H, bf16)
    gb = g.to(bf16)
    report("layer_norm", f"K1 rms_norm rows={rows} H={H} bf16 (fp32 scale)", dict(
        max_abs_err=err,
        ms=_time_ms(torch, lambda: normalize.rms_norm(x, g), iters=200),
        plain_ms=_time_ms(torch, lambda: normalize._ln_ref(x, g, None, 1e-5, True)),
        library_ms=_time_ms(torch, lambda: F.rms_norm(x, (H,), gb, 1e-5), iters=200),
        bound_ms=t, bound_by=by,
        device_ms=_graph_ms(torch, lambda: normalize._ln_cuda(x, g, None, 1e-5, True)),
        library_device_ms=_graph_ms(torch, lambda: F.rms_norm(x, (H,), gb, 1e-5))))

    # ---- K8 rms at Llama-2's training rows (4 x 1024), bf16 scale
    rows = 4 * 1024
    x = (2 * torch.randn(rows, H, generator=gen, device=dev) + 0.5).to(bf16)
    dy = torch.randn(rows, H, generator=gen, device=dev).to(bf16)
    g = (1 + 0.1 * torch.randn(H, generator=gen, device=dev)).to(bf16)
    dx, dg, _ = normalize._ln_bwd_cuda(x, g, dy, 1e-5, True)
    rdx, rdg, _ = normalize._ln_bwd_ref(x, g, dy, 1e-5, True)
    err = max(_close(torch, dx, rdx, 1e-2, 1e-2, "rms_norm_bwd dx"),
              _close(torch, dg, rdg, 1e-5 * rdg.abs().max().item(), 1e-4,
                     "rms_norm_bwd dgamma"))
    xl, gl = (a.clone().requires_grad_() for a in (x, g))
    yl = F.rms_norm(xl, (H,), gl, 1e-5)
    t, by = _bound(3 * rows * H * 2 + 2 * H * 4, 15 * rows * H, torch.float32)
    report("layer_norm_bwd", f"K8 rms_norm_bwd rows={rows} H={H} bf16", dict(
        max_abs_err=err,
        ms=_time_ms(torch, lambda: normalize._ln_bwd_cuda(x, g, dy, 1e-5, True)),
        plain_ms=_time_ms(torch, lambda: normalize._ln_bwd_ref(x, g, dy, 1e-5, True)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            yl, (xl, gl), dy, retain_graph=True)),
        bound_ms=t, bound_by=by,
        device_ms=_graph_ms(torch, lambda: normalize._ln_bwd_cuda(x, g, dy, 1e-5, True))))
    del x, dy, dx, rdx, xl, yl

    # ---- K2 / K2q / K3q, GQA folded: 32 sequences at (a)'s context, each
    # KV head's 4 query heads in the batch (128 rows), the tables repeated
    B, rep, KV, D, ctx, bs = LLAMA_PROMPTS, 4, 8, 128, 512, 16
    P = B * ctx // bs
    pk = torch.randn(P, bs, KV, D, generator=gen, device=dev).to(bf16)
    pv = torch.randn(P, bs, KV, D, generator=gen, device=dev).to(bf16)
    base = torch.randperm(P, generator=gen, device=dev).view(B, ctx // bs).to(torch.int32)
    tables = base.repeat_interleave(rep, 0).contiguous()
    lens = torch.full((B * rep,), ctx, dtype=torch.int32, device=dev)
    q = torch.randn(B, KV * rep, D, generator=gen, device=dev).to(bf16)
    # the fold: [B, KV, rep, D] -> [B * rep, KV, D]
    qf = q.view(B, KV, rep, D).transpose(1, 2).reshape(B * rep, KV, D).contiguous()
    idx = base.long()

    def gathered(pool, scales=None):
        """A pool's blocks by the (unrepeated) tables, at the KV heads:
        [B, KV, ctx, D] in bf16, dequantized from a quantized pool."""
        t = byte_view(pool)[idx].view(pool.dtype).reshape(B, ctx, KV, D)
        if scales is not None:
            t = dequantize_kv(t, scales[idx].reshape(B, ctx, KV), bf16)
        return t.transpose(1, 2)

    K, V = gathered(pk), gathered(pv)
    sdpa = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], K, V, enable_gqa=True))
    scale = D ** -0.5
    for kv_dtype in (None, "fp8", "int8"):
        sk = sv = None
        qk, qv = pk, pv
        if kv_dtype is not None:
            (qk, sk), (qv, sv) = quantize_kv(pk, kv_dtype), quantize_kv(pv, kv_dtype)
        scales = {} if sk is None else {"k_scale": sk, "v_scale": sv}
        tag = "" if sk is None else "q"
        pool = "" if sk is None else f"{kv_dtype} pool "

        def decode():
            return paged.paged_decode_attention(qf, qk, qv, tables, lens, **scales)

        def plain():
            return paged._decode_reference(qf, qk, qv, tables, lens, scale, sk, sv)

        err = _close(torch, decode(), plain(), ATTN_ATOL, ATTN_RTOL,
                     f"paged_decode{tag} GQA-folded {pool}")
        # the work: each sequence's K and V once a KV head (the fold reads
        # them rep times), q and the output
        per = 2 * D if sk is None else D + 4
        nbytes = 2 * B * ctx * KV * per + 2 * B * KV * rep * D * 2 + base.numel() * 4
        t, by = _bound(nbytes, 4 * B * KV * rep * ctx * D, bf16)
        # the library: one SDPA call at the KV heads on the gathered K/V, a
        # quantized pool's gathered and dequantized inside the timed call
        lib = sdpa if sk is None else _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], gathered(qk, sk), gathered(qv, sv), enable_gqa=True))
        ms = _time_ms(torch, decode)
        report(f"paged_decode{'_q' if tag else ''}",
               f"K2{tag} paged_decode {pool}GQA-folded B*rep={B * rep} (B={B} x rep={rep}) "
               f"N_kv={KV} D={D} bs={bs} ctx={ctx} bf16",
               dict(max_abs_err=err, ms=ms,
                    plain_ms=_time_ms(torch, plain, iters=5), library_ms=lib,
                    bound_ms=t, bound_by=by, device_ms=_graph_ms(torch, decode)))
        if sk is None:
            print(f"[kernels] GQA gap: K2 folded {ms:.4f} ms vs SDPA at the KV heads "
                  f"(enable_gqa, on the gathered K/V) {sdpa:.4f} ms = {ms / sdpa:.3f}x; the "
                  f"fold reads each KV block {rep} times", flush=True)
            continue
        S = 8                                  # (a)'s speculative rounds: 1 + 4 drafts, s_pad 8
        qs = torch.randn(B, S, KV * rep, D, generator=gen, device=dev).to(bf16)
        qsf = qs.view(B, S, KV, rep, D).permute(0, 3, 1, 2, 4).reshape(
            B * rep, S, KV, D).contiguous()
        pos = (ctx - S + torch.arange(S, device=dev, dtype=torch.int32))[None] \
            .repeat(B * rep, 1).contiguous()

        def spec():
            return paged.paged_spec_decode_attention(qsf, qk, qv, tables, pos, **scales)

        err = _close(torch, spec(), paged._spec_decode_reference(
            qsf, qk, qv, tables, pos, scale, sk, sv), ATTN_ATOL, ATTN_RTOL,
            f"paged_spec_decode_q GQA-folded {pool}")
        t, by = _bound(nbytes + (S - 1) * 2 * B * KV * rep * D * 2,
                       4 * B * KV * rep * S * ctx * D + 2 * B * KV * ctx * D, bf16)
        mask = (torch.arange(ctx, device=dev)[None, :] <= pos[:B, :, None])[:, None]
        report("paged_spec_decode_q",
               f"K3q paged_spec_decode {pool}GQA-folded B*rep={B * rep} S={S} N_kv={KV} "
               f"D={D} bs={bs} ctx={ctx} bf16",
               dict(max_abs_err=err, ms=_time_ms(torch, spec),
                    plain_ms=_time_ms(torch, lambda: paged._spec_decode_reference(
                        qsf, qk, qv, tables, pos, scale, sk, sv), iters=5),
                    library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qs.transpose(1, 2), gathered(qk, sk), gathered(qv, sv),
                        attn_mask=mask, enable_gqa=True)),
                    bound_ms=t, bound_by=by, device_ms=_graph_ms(torch, spec)))
    del pk, pv, K, V
    torch.cuda.empty_cache()

    # ---- K5-K7 at Llama-2-7B's width (training: 4 x 1024 tokens)
    _flash_case(torch, gen, report, 4, 1024, 32, 128, True)
    return rows_out


def phase_llama_served(torch, np, launches, card):
    """Phase 22 (a) and (c): Mistral-7B-v0.2's shape at full depth in bf16,
    served by ``InferenceEngineV2`` (a bf16 pool: prefill, decode, a few
    speculative rounds, a sampled run), by ``DSScheduler.generate`` over an
    fp8 pool of the same bytes with n-gram k 4, and generated by the v1
    engine (``init_inference``) in bf16, int8 and int4.  Returns the launch
    counts of (a) and of (c)."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.inference.v2 import DSScheduler, InferenceEngineV2
    from deeperspeed_tpu_torch.models import Llama

    cfg = llama_served_config()
    t0 = time.perf_counter()
    model = Llama(cfg, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != model.num_params():
        raise AssertionError(f"Mistral-7B: {n_params} parameters, {model.num_params()} counted")
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(0, V, LLAMA_PROMPT_LEN).astype(np.int32)
               for _ in range(LLAMA_PROMPTS)]
    eng = InferenceEngineV2(model, LLAMA_ECFG)
    print(f"[llama-a] {card}: Mistral-7B-v0.2 shape (H {cfg.hidden_size}, {cfg.num_layers} "
          f"layers, {cfg.num_heads} q / {cfg.num_kv_heads} KV heads, D {cfg.head_dim}, F "
          f"{cfg.intermediate_size}, V {V}): {n_params / 1e9:.3f} B parameters drawn on the card "
          f"in {build_s:.1f} s, {sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} "
          f"GB in bf16; KV pools {eng.kv_pool_bytes / 1e9:.2f} GB", flush=True)
    uids = list(range(LLAMA_PROMPTS))
    torch.cuda.reset_peak_memory_stats()

    launches.clear()                                  # (a)'s main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, nxt = [], {}
    for lo in range(0, LLAMA_PROMPTS, 8):
        out = eng.put_round(uids[lo:lo + 8], prompts[lo:lo + 8])
        ttft.extend([time.perf_counter() - t0] * 8)
        if not out.finite.all():
            raise AssertionError("llama (a): non-finite logits in a prefill round")
        for i, u in enumerate(uids[lo:lo + 8]):
            nxt[u] = int(out.tokens[i, -1])
    t_dec = time.perf_counter()
    for _ in range(LLAMA_DECODE_ROUNDS):
        out = eng.put_round(uids, [[nxt[u]] for u in uids])
        if not out.finite.all():
            raise AssertionError("llama (a): non-finite logits in a decode round")
        nxt = {u: int(out.tokens[i, -1]) for i, u in enumerate(uids)}
    dec = time.perf_counter() - t_dec
    t_spec = time.perf_counter()
    accepted = 0
    for _ in range(LLAMA_SPEC_ROUNDS):
        drafts = [rng.integers(0, V, SCHEDULED_SPEC_K).tolist() for _ in uids]
        out = eng.put_round(uids, [[nxt[u]] for u in uids], drafts)
        if not out.finite.all():
            raise AssertionError("llama (a): non-finite logits in a speculative round")
        accepted += int(out.accepted.sum())
        nxt = {u: int(out.emitted(i)[-1]) for i, u in enumerate(uids)}
    spec = time.perf_counter() - t_spec
    for u in uids:
        eng.flush(u)
    del eng
    torch.cuda.empty_cache()
    sampled = InferenceEngineV2(model, {**LLAMA_ECFG, "kv_cache": {"num_blocks": 512,
                                                                  "block_size": 16},
                                        "sampling": {"temperature": 0.8, "top_k": 50,
                                                     "seed": SEED}})
    outs = sampled.generate([p[:128] for p in prompts[:8]], max_new_tokens=8)
    if any(len(o) != 136 or o.min() < 0 or o.max() >= V for o in outs):
        raise AssertionError("llama (a): the sampled run gave bad tokens")
    del sampled
    torch.cuda.empty_cache()

    # n-gram k 4 over an fp8 pool of the bf16 pool's bytes, then plain
    # decode rounds over it (K2q)
    fp8_cfg = scheduled_ecfg(cfg.head_dim, "fp8", True)
    fp8_cfg["state_manager"]["max_decode_batch"] = LLAMA_PROMPTS
    eng = InferenceEngineV2(model, fp8_cfg)
    sched_prompts = scheduled_prompts(np, V, LLAMA_PROMPTS)
    t1 = time.perf_counter()
    outs = DSScheduler(eng).generate(sched_prompts, max_new_tokens=LLAMA_DECODE_ROUNDS)
    sched_s = time.perf_counter() - t1
    if any(len(o) != len(p) + LLAMA_DECODE_ROUNDS for o, p in zip(outs, sched_prompts)):
        raise AssertionError("llama (a): the scheduler returned short sequences")
    _pool_clean(eng)
    eng.generate([p[:64] for p in sched_prompts[:8]], max_new_tokens=4)
    fp8_bytes = eng.kv_pool_bytes
    del eng
    torch.cuda.empty_cache()
    counts = dict(launches)
    for name in ("layer_norm", "paged_decode", "paged_spec_decode", "paged_decode_q",
                 "paged_spec_decode_q", "sorted_topk"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"llama (a) never launched {name}: {counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[llama-a] {card}: InferenceEngineV2, bf16 pool 4096 x 16: decode "
          f"{dec / LLAMA_DECODE_ROUNDS * 1e3:.2f} ms/round at batch {LLAMA_PROMPTS} "
          f"({LLAMA_PROMPTS * LLAMA_DECODE_ROUNDS / dec:.1f} tokens/s); TTFT median "
          f"{np.median(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f} ms (4 prefill rounds of "
          f"8 x {LLAMA_PROMPT_LEN} tokens); {LLAMA_SPEC_ROUNDS} speculative rounds of "
          f"{SCHEDULED_SPEC_K} random drafts {spec / LLAMA_SPEC_ROUNDS * 1e3:.2f} ms/round "
          f"({accepted} accepted); DSScheduler.generate over an fp8 pool of "
          f"{fp8_bytes / 1e9:.2f} GB with n-gram k {SCHEDULED_SPEC_K}: "
          f"{LLAMA_PROMPTS} x {LLAMA_DECODE_ROUNDS} tokens in {sched_s:.2f} s "
          f"({LLAMA_PROMPTS * LLAMA_DECODE_ROUNDS / sched_s:.1f} tokens/s); peak "
          f"{peak:.2f} GB; launches {counts}", flush=True)

    # ---- (c) the v1 engine: bf16, int8, int4 weights
    ids, mask = v1_prompts(np, V)
    full_rows = [r for r in range(V1_PROMPTS) if mask[r].all()]
    ref = InferenceEngineV2(model, {**LLAMA_ECFG, "kv_cache": {"num_blocks": 512,
                                                              "block_size": 16}})
    want, margins = _v2_greedy(torch, np, ref, ids[full_rows], V1_NEW)
    del ref
    torch.cuda.empty_cache()
    results, v1_counts = {}, {}
    for bits in (None, 8, 4):
        m = model if bits != 8 else copy.deepcopy(model)
        conf = {"dtype": "bf16", "max_tokens": V1_NEW}
        if bits:
            conf["quant"] = {"enabled": True, "bits": bits, "group_size": 64}
        torch.cuda.reset_peak_memory_stats()
        eng = dst.init_inference(m, conf)
        launches.clear()                              # (c)'s path, one config
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(ids, attention_mask=mask, max_new_tokens=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = eng.generate(ids, attention_mask=mask).cpu().numpy()
        t2 = time.perf_counter()
        run = dict(launches)
        for k, v in run.items():
            v1_counts[k] = v1_counts.get(k, 0) + v
        new = got[:, V1_PROMPT_LEN:]
        if new.shape != (V1_PROMPTS, V1_NEW) or new.min() < 0 or new.max() >= V:
            raise AssertionError(f"llama (c) wq {bits}: bad tokens")
        name = "bf16" if bits is None else f"int{bits}"
        results[name] = dict(tokens=new, bytes=eng.weight_bytes,
                             ms=((t2 - t1) - (t1 - t0)) / (V1_NEW - 1) * 1e3,
                             prefill_ms=(t1 - t0) * 1e3, launches=run,
                             peak=torch.cuda.max_memory_allocated() / 1e9)
        if bits is None:
            agreed = _greedy_agree(np, new[full_rows], want, margins, BF16_MARGIN)
            results[name]["agreed"] = agreed
        del eng
        if bits == 8:
            del m
        torch.cuda.empty_cache()
    if v1_counts.get("layer_norm", 0) < 1:
        raise AssertionError(f"llama (c): RMSNorm never launched K1: {v1_counts}")
    bf = results["bf16"]
    for name, r in results.items():
        same = (r["tokens"] == bf["tokens"]).mean()
        extra = (f"; greedy tokens equal the v2 engine's on the {len(full_rows)} unpadded "
                 f"rows for {r['agreed']} of {V1_NEW} steps (a row may part only at a "
                 f"top-2 margin below {BF16_MARGIN})" if name == "bf16" else
                 f"; {same:.3f} of its tokens equal bf16's")
        print(f"[llama-c] {card}: init_inference {name}, {V1_PROMPTS} left-padded prompts of "
              f"{V1_PROMPT_LEN} x {V1_NEW} new tokens: {r['ms']:.2f} ms/token, prefill "
              f"{r['prefill_ms']:.1f} ms; weights {r['bytes'] / 1e9:.3f} GB "
              f"({r['bytes'] / bf['bytes']:.3f} of bf16); peak {r['peak']:.2f} GB{extra}; "
              f"launches (both generate calls) {r['launches']}", flush=True)
    del model
    torch.cuda.empty_cache()
    return counts, v1_counts


def phase_llama_window(torch, np, launches, card):
    """Phase 22 (b): ``mistral_7b()`` with its window of 4096 at full width
    and 2 layers in fp32, one 5,000-token sequence served by the paged
    engine (two 2,500-token prefill rounds, decode rounds and a 4-token
    extend): the last logits of each round against the dense forward over
    the whole sequence, and no K2 or K3 launched (the JAX routing sends
    every windowed row to the dense path).  Returns the launch counts."""
    from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deeperspeed_tpu_torch.models import Llama, LlamaConfig

    cfg = LlamaConfig.mistral_7b(num_layers=2)
    model = Llama(cfg, seed=SEED)
    dense = copy.deepcopy(model)
    eng = InferenceEngineV2(model, {"dtype": "float32",
                                    "kv_cache": {"num_blocks": 384, "block_size": 16},
                                    "state_manager": {"max_context": 6144,
                                                      "max_ragged_batch_size": 2600}})
    rng = np.random.default_rng(SEED + 24)
    seq = rng.integers(0, cfg.vocab_size, LLAMA_WINDOW_SEQ).astype(np.int32)
    feeds = [seq[:2500], seq[2500:]]
    launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worst, checked = 0.0, []
    fed = np.zeros(0, np.int32)
    for step in range(6):
        feed = feeds[step] if step < 2 else (
            np.array([nxt], np.int32) if step < 5
            else np.concatenate([[nxt], rng.integers(0, cfg.vocab_size, 3)]).astype(np.int32))
        out = eng.put_round([0], [feed])
        fed = np.concatenate([fed, feed])
        nxt = int(out.tokens[0, -1])
        if step in (1, 3, 5):
            with torch.no_grad():
                want = dense(torch.from_numpy(fed[None]).long().cuda())[0, -1].float()
            got = out.logits[0]
            worst = max(worst, _close(torch, got, want, 2e-3, 2e-3,
                                      f"llama (b) round {step} vs the dense forward"))
            checked.append(len(fed))
    dt = time.perf_counter() - t0
    counts = dict(launches)
    if counts.get("paged_decode", 0) or counts.get("paged_spec_decode", 0):
        raise AssertionError(f"llama (b): windowed rounds launched K2/K3: {counts}")
    if counts.get("layer_norm", 0) < 1:
        raise AssertionError(f"llama (b): RMSNorm never launched K1: {counts}")
    print(f"[llama-b] {card}: mistral_7b() window 4096, full width, 2 layers, fp32: one "
          f"{LLAMA_WINDOW_SEQ}-token sequence (2 prefill rounds of 2500, 3 decode rounds, a "
          f"4-token extend) in {dt:.2f} s; last logits at {checked} tokens within "
          f"{worst:.3e} of the dense forward (limit 2e-3 + 2e-3 |ref|); K2/K3 launches 0 "
          f"(the dense path, as the JAX routing); launches {counts}", flush=True)
    del eng, model, dense
    torch.cuda.empty_cache()
    return counts


def phase_llama_trained(torch, np, launches, card):
    """Phase 22 (d): Llama-2-7B's width at 2 layers (4 x 1024 tokens) and
    OPT-125M whole (16 x 1024), bf16, Adam, clip 1.0, 3 steps each; then
    their tiny configs in fp32, card against CPU.  Returns the launch
    counts of the full-width steps."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import Llama, LlamaConfig

    counts = {}
    for name, cfg, rows, heads in (
            ("Llama-2-7B width, 2 layers", LlamaConfig.llama2_7b(
                num_layers=2, dtype=torch.bfloat16), 4, "N 32 / D 128"),
            ("OPT-125M", LlamaConfig.opt_125m(dtype=torch.bfloat16), 16, "N 12 / D 64")):
        torch.cuda.reset_peak_memory_stats()
        model = Llama(cfg, seed=SEED)
        eng, *_ = dst.initialize(model=model, config={**LLAMA_TRAIN, "train_batch_size": rows})
        batch = model.example_batch(batch_size=rows, seq_len=1024, seed=SEED)
        launches.clear()
        losses, times = [], []
        for _ in range(LLAMA_TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(eng.train_batch(batch=batch)))
            times.append(time.perf_counter() - t)
        run = dict(launches)
        for k in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                  "flash_bwd_dkv"):
            if run.get(k, 0) < 1:
                raise AssertionError(f"llama (d) {name}: {k} never launched: {run}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"llama (d) {name}: losses {losses}")
        for k, v in run.items():
            counts[k] = counts.get(k, 0) + v
        print(f"[llama-d] {card}: {name} bf16 ({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
              f"parameters), {rows} x 1024 tokens, Adam, clip 1.0: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; {np.mean(times[1:]) * 1e3:.1f} ms/step "
              f"(steps 2-{LLAMA_TRAIN_STEPS}, host clock, ending in the loss's sync); K5-K7 at "
              f"{heads}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {run}",
              flush=True)
        del eng, model
        torch.cuda.empty_cache()

    # tiny widths in fp32, card against CPU from the same CPU-drawn weights
    for preset in ("tiny", "tiny_opt"):
        cfg = getattr(LlamaConfig, preset)()
        start = Llama(cfg, device="cpu", seed=SEED).state_dict()
        got = {}
        for device in ("cuda", "cpu"):
            m = Llama(cfg, device="cpu" if device == "cpu" else None, seed=SEED + 1)
            eng, *_ = dst.initialize(model=m, config={
                "train_batch_size": 8, "gradient_clipping": 1.0,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
                model_parameters=start, device=device)
            batch = m.example_batch(batch_size=8, seq_len=32, seed=SEED)
            got[device] = [float(eng.train_batch(batch=batch)) for _ in range(3)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["cuda"], got["cpu"]))
        if rel > TRAIN_TOL:
            raise AssertionError(f"llama (d) {preset}: card {got['cuda']} vs CPU {got['cpu']}")
        print(f"[llama-d] {preset} fp32, 8 x 32 tokens, 3 Adam steps: card "
              f"{', '.join(f'{x:.6f}' for x in got['cuda'])} vs CPU (max relative "
              f"{rel:.2e}, limit {TRAIN_TOL})", flush=True)
    return counts


def llama_tp_config(**kw):
    """(e)'s model: (a)'s at 2 layers, fp32."""
    return llama_served_config(num_layers=2, **kw)


def llama_worker(rank, rendezvous, out_path):
    """One of the two processes of phase 22 (e) (``--llama-worker``): the
    v1 engine at tp 2 over gloo on (a)'s model at 2 layers in fp32, greedy
    on (c)'s prompts; writes its tokens, time and launches as JSON."""
    import numpy as np
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.models import Llama
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=LLAMA_TP_WORLD, timeout=600)
    model = Llama(llama_tp_config(), seed=SEED)
    eng = dst.init_inference(model, {"dtype": "fp32", "tensor_parallel": {"tp_size": 2}})
    ids, mask = v1_prompts(np, model.config.vocab_size)
    eng.generate(ids, attention_mask=mask, max_new_tokens=2)
    LAUNCHES.clear()
    comm.STAGED.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate(ids, attention_mask=mask, max_new_tokens=LLAMA_TP_NEW).cpu().numpy()
    dt = time.perf_counter() - t0
    out = {"tokens": toks[:, V1_PROMPT_LEN:].tolist(), "ms": dt / LLAMA_TP_NEW * 1e3,
           "launches": dict(LAUNCHES), "staged": dict(comm.STAGED),
           "heads": model.layers[0].attention.q_proj.weight.shape[0] // model.config.head_dim,
           "bytes": eng.weight_bytes}
    Path(out_path).write_text(json.dumps(out))
    comm.destroy()
    return 0


def phase_llama_tp(torch, np, card):
    """Phase 22 (e): two ``--llama-worker`` processes at tp 2 against the
    same model's tp 1 run in this process, and that run against the v2
    engine's greedy tokens in fp32.  Returns rank 0's launches."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deeperspeed_tpu_torch.models import Llama

    ranks = _join_dp_workers(_workers("--llama-worker", LLAMA_TP_WORLD)[1])
    model = Llama(llama_tp_config(), seed=SEED)
    eng = dst.init_inference(model, {"dtype": "fp32"})
    ids, mask = v1_prompts(np, model.config.vocab_size)
    t0 = time.perf_counter()
    want = eng.generate(ids, attention_mask=mask,
                        max_new_tokens=LLAMA_TP_NEW).cpu().numpy()[:, V1_PROMPT_LEN:]
    dt = time.perf_counter() - t0
    for r, rec in enumerate(ranks):
        if not np.array_equal(np.array(rec["tokens"]), want):
            raise AssertionError(f"llama (e): rank {r}'s tp 2 tokens differ from tp 1's")
    # the v1 engine against the v2 engine in fp32 on the unpadded rows (the
    # bf16 comparison of (c) parts at near ties)
    rows = [r for r in range(V1_PROMPTS) if mask[r].all()]
    v2 = InferenceEngineV2(model, {**LLAMA_ECFG, "dtype": "float32",
                                   "kv_cache": {"num_blocks": 512, "block_size": 16}})
    v2_toks, margins = _v2_greedy(torch, np, v2, ids[rows], LLAMA_TP_NEW)
    agreed = _greedy_agree(np, want[rows], v2_toks, margins, FP32_MARGIN)
    del v2
    a = ranks[0]
    if a["heads"] != 16 or a["launches"].get("layer_norm", 0) < 1:
        raise AssertionError(f"llama (e): {a['heads']} heads a rank, launches {a['launches']}")
    print(f"[llama-e] {card}: init_inference at tp 2 (two processes, gloo via host), (a)'s "
          f"model at 2 layers fp32, {V1_PROMPTS} left-padded prompts x {LLAMA_TP_NEW} greedy "
          f"tokens: equal to tp 1's on both ranks; tp 1's equal the v2 engine's (fp32) on the "
          f"{len(rows)} unpadded rows for {agreed} of {LLAMA_TP_NEW} steps (parting only at a "
          f"top-2 margin below {FP32_MARGIN}); {a['ms']:.2f} ms/token at tp 2 vs "
          f"{dt / LLAMA_TP_NEW * 1e3:.2f} at tp 1 (host clock); {a['heads']} heads and "
          f"{a['bytes'] / 1e9:.3f} GB of weights a rank; staged a run: "
          f"{', '.join(f'{k} {v / 1e6:.3f} MB' for k, v in sorted(a['staged'].items()))}; "
          f"launches (rank 0) {a['launches']}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return a["launches"]


# MoE (phase 23): Pythia-160M-MoE-8, Pythia-160M at full width with 8
# experts on every second block (6 MoE layers), top-1, capacity factor 1.0,
# min capacity 4, Random Token Selection, aux coefficient 0.01, weights
# from SEED; 360,701,952 parameters (the JAX package's count).
MOE_KW = {"moe_num_experts": 8, "moe_expert_interval": 2, "moe_top_k": 1,
          "moe_capacity_factor": 1.0, "moe_min_capacity": 4, "moe_use_rts": True,
          "moe_aux_loss_coef": 0.01}
MOE_PARAMS = 360_701_952
MOE_STEPS, MOE_TOP2_STEPS = 5, 3
# (a): tiny() with 4 experts on both blocks, card against CPU; no draws
# (each device's generator draws its own), so top-2 is held in evaluation
MOE_TINY_KW = {"moe_num_experts": 4, "moe_expert_interval": 1, "moe_use_rts": False,
               "moe_capacity_factor": 0.75, "moe_aux_loss_coef": 0.5}
MOE_TINY_CONFIG = {"train_batch_size": 8, "gradient_clipping": 1.0,
                   "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
MOE_CHECK_TOL = 1e-5


def _moe_transport(cfg, dtype):
    return {**cfg, "comm": {"quantized": {"moe_alltoall": True, "moe_alltoall_dtype": dtype}}}


MOE_TINY_RUNS = {"top1": ({}, MOE_TINY_CONFIG),
                 "top1-residual": ({"moe_use_residual": True}, MOE_TINY_CONFIG),
                 "int8": ({}, _moe_transport(MOE_TINY_CONFIG, "int8")),
                 "fp8": ({}, _moe_transport(MOE_TINY_CONFIG, "fp8")),
                 "top2": ({"moe_top_k": 2}, MOE_TINY_CONFIG)}
# (c): two processes at ep 2 on the card, 2 full-width blocks, both MoE,
# phase 13's batch shape, no draws (the one process draws its own); each
# run: config, mesh, tolerance against one process, the config that one
# process runs.  tp 2 splits the experts P("ep", None, "tp") and sums
# row-parallel halves: phase 21's card-against-CPU tolerance.
MOE_EP_WORLD = 2
MOE_EP_KW = {**MOE_KW, "moe_expert_interval": 1, "moe_use_rts": False}
_MOE_S0 = {**DP_CHECK_CONFIG, "zero_optimization": {"stage": 0}}
MOE_EP_RUNS = {"s0": (_MOE_S0, {"ep": 2}, MOE_CHECK_TOL),
               "s2": ({**DP_CHECK_CONFIG, "zero_optimization": {"stage": 2}}, {"ep": 2},
                      MOE_CHECK_TOL),
               "int8": (_moe_transport(DP_CHECK_CONFIG, "int8"), {"ep": 2}, 1e-4),
               "fp8": (_moe_transport(DP_CHECK_CONFIG, "fp8"), {"ep": 2}, 1e-4),
               "tp2": (_MOE_S0, {"tp": 2}, 1e-4)}
MOE_SERVED_ROUNDS = 32


def moe_model(device=None, dtype=None, **kw):
    """Pythia-160M-MoE-8 (``MOE_KW``, then ``kw``) from ``SEED``, drawn on the
    card unless ``device`` is given."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(GPTNeoXConfig.pythia_160m(dtype=dtype or torch.bfloat16,
                                             max_seq_len=TRAIN_SEQ, **{**MOE_KW, **kw}),
                   device=device, seed=SEED, draw_on_device=device is None)


def moe_ep_model(device=None):
    """(c)'s model: 2 full-width blocks, both MoE, fp32, drawn on the card
    unless ``device`` is given."""
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(dataclasses.replace(GPTNeoXConfig.pythia_160m(**MOE_EP_KW), num_layers=2),
                   device=device, seed=SEED, draw_on_device=device is None)


def _moe_routing(model):
    """Each MoE layer's last routing over its batch group's tokens:
    exp_counts, the share of the routed choices dropped, l_aux."""
    out = []
    for m in model.moe_layers():
        g = m.last_gate
        out.append({"exp_counts": g.exp_counts.tolist(),
                    "dropped": 1.0 - float(g.all_kept.sum()) / float(g.exp_counts.sum()),
                    "l_aux": float(g.l_aux)})
    return out


def phase_moe_checked(torch, np):
    """Phase 23 (a): tiny fp32 MoE trained 3 steps on the card and on the
    CPU from the same weights and batches, losses within 1e-5 relative:
    top-1, Residual-MoE, the int8 and fp8 transport; top-2's evaluation
    losses (its training draws come from each device's generator), then
    3 steps on the card."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig

    rng = np.random.default_rng(SEED + 23)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, 256, (8, 33))
        batches.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    worst = 0.0
    for name, (kw, cfg) in MOE_TINY_RUNS.items():
        engines = [dst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(**{**MOE_TINY_KW, **kw}),
                                                device=d, seed=SEED),
                                  config=cfg, device=d)[0] for d in ("cuda", "cpu")]
        if kw.get("moe_top_k") == 2:
            pairs = [[float(e.eval_batch(batch=b)) for e in engines] for b in batches]
            card = [float(engines[0].train_batch(batch=b)) for b in batches]
            if not all(math.isfinite(v) for v in card):
                raise AssertionError(f"moe (a) {name}: card losses {card}")
        else:
            pairs = [[float(e.train_batch(batch=b)) for e in engines] for b in batches]
        for step, (lg, lc) in enumerate(pairs):
            rel = abs(lg - lc) / abs(lc)
            worst = max(worst, rel)
            if rel > MOE_CHECK_TOL:
                raise AssertionError(f"moe (a) {name} step {step}: card {lg} vs CPU {lc}")
        kept = [int(m.last_gate.kept.sum()) for m in engines[0].module.moe_layers()]
        print(f"[moe-a] tiny MoE ({name}, 4 experts on both blocks, fp32): 3 "
              f"{'evaluation' if name == 'top2' else 'Adam'} losses card vs CPU within "
              f"{max(abs(a - b) / abs(b) for a, b in pairs):.2e} relative; last loss "
              f"{pairs[-1][0]:.6f}; kept tokens a layer {kept}", flush=True)
        del engines
    print(f"[moe-a] worst {worst:.2e} relative (tol {MOE_CHECK_TOL})", flush=True)


def _moe_steps(torch, engine, batch, steps):
    """``steps`` training steps after the warm-up ones: the last loss and
    the seconds they took (host clock, ending in a sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = engine.train_batch(batch=batch)
    loss = float(loss)
    return loss, time.perf_counter() - t0


def phase_moe_trained(torch, np, launches, card):
    """Phase 23 (b): Pythia-160M-MoE-8 in bf16 at phase 9's step (B 16 x S
    1024, Adam, clip 1.0, ZeRO-0, one process); 2 warm-up and
    ``MOE_STEPS`` timed steps, then top-2 for ``MOE_TOP2_STEPS``.  Returns
    the top-1 run's launches."""
    import deeperspeed_tpu_torch as dst

    model = moe_model()
    if model.num_params() != MOE_PARAMS or sum(p.numel() for p in model.parameters()) \
            != MOE_PARAMS:
        raise AssertionError(f"moe (b): {model.num_params()} parameters")
    engine = dst.initialize(model=model, config=TRAIN_CONFIG)[0]
    batch = {k: v.cuda() for k, v in trained_batch(model).items()}
    for _ in range(2):                                # warm-up
        first = float(engine.train_batch(batch=batch))
    torch.cuda.reset_peak_memory_stats()
    launches.clear()                                  # main path starts here
    loss, dt = _moe_steps(torch, engine, batch, MOE_STEPS)
    counts = dict(launches)
    if not (math.isfinite(first) and math.isfinite(loss)):
        raise AssertionError(f"moe (b): non-finite loss {first}, {loss}")
    for name in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"moe training never launched {name}: {counts}")
    routing = _moe_routing(model)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[moe-b] {card}: Pythia-160M-MoE-8 ({MOE_PARAMS:,} parameters, 6 MoE layers "
          f"of 8 experts, top-1, capacity factor 1.0, RTS) bf16, B {TRAIN_BATCH} x S "
          f"{TRAIN_SEQ}, Adam, clip 1.0, ZeRO-0: {dt / MOE_STEPS * 1e3:.2f} ms/step over "
          f"{MOE_STEPS} steps, {tokens * MOE_STEPS / dt:.1f} tokens/s; loss {first:.4f} -> "
          f"{loss:.4f}; peak memory {peak:.2f} GB", flush=True)
    for i, r in enumerate(routing):
        print(f"[moe-b] MoE layer {i}: exp_counts {r['exp_counts']}, dropped share "
              f"{r['dropped']:.4f}, l_aux {r['l_aux']:.4f}", flush=True)
    print(f"[moe-b] launches in the timed steps {counts}", flush=True)
    del engine, model
    torch.cuda.empty_cache()

    model = moe_model(moe_top_k=2)
    engine = dst.initialize(model=model, config=TRAIN_CONFIG)[0]
    torch.cuda.reset_peak_memory_stats()
    first = float(engine.train_batch(batch=batch))    # warm-up
    loss, dt = _moe_steps(torch, engine, batch, MOE_TOP2_STEPS)
    if not (math.isfinite(first) and math.isfinite(loss)):
        raise AssertionError(f"moe (b) top-2: non-finite loss {first}, {loss}")
    dropped = [round(r["dropped"], 4) for r in _moe_routing(model)]
    print(f"[moe-b] top-2 (capacity factor 1.0 a choice): {dt / MOE_TOP2_STEPS * 1e3:.2f} "
          f"ms/step over {MOE_TOP2_STEPS} steps, {tokens * MOE_TOP2_STEPS / dt:.1f} tokens/s; "
          f"loss {first:.4f} -> {loss:.4f}; dropped shares {dropped}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del engine, model
    torch.cuda.empty_cache()
    return counts


def moe_worker(rank, rendezvous, out_path):
    """One of the two processes of phase 23 (c) (``--moe-worker``): ep 2
    over gloo on the card, each run of ``MOE_EP_RUNS`` for the 2 steps of phase
    13's batches; the stage-0 run saves a checkpoint beside the rendezvous
    file.  Writes losses, bytes staged, launches and the checkpoint's
    digest as JSON."""
    import numpy as np
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES
    from deeperspeed_tpu_torch.parallel import MeshTopology

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=MOE_EP_WORLD, timeout=600)
    out = {}
    for name, (cfg, mesh, _) in MOE_EP_RUNS.items():
        model = moe_ep_model()
        eng = dst.initialize(model=model, config=cfg, mesh=MeshTopology(**mesh))[0]
        batches = dp_check_batches(np, model.config.vocab_size)
        LAUNCHES.clear()
        comm.STAGED.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(eng.train_batch(batch=b)) for b in batches]
        dt = time.perf_counter() - t0
        out[name] = {"losses": losses, "ms": dt / len(batches) * 1e3,
                     "staged": {k: v / len(batches) for k, v in comm.STAGED.items()},
                     "launches": dict(LAUNCHES),
                     "experts": model.moe_layers()[0].experts.num_local,
                     "ffn": model.moe_layers()[0].experts.dense_h_to_4h.weight.shape[1],
                     "routing": _moe_routing(model)}
        if name == "s0":
            eng.save_checkpoint(str(Path(rendezvous).parent / "moe_ckpt"))
            out[name]["digest"] = _ckpt_digest(torch, eng)
        del eng, model
        torch.cuda.empty_cache()
    Path(out_path).write_text(json.dumps(out))
    comm.destroy()
    return 0


def phase_moe_ep(torch, np, card):
    """Phase 23 (c): two ``--moe-worker`` processes at ep 2 against one
    process at ep 1 on the card (same weights and global batches): fp32
    losses within 1e-5 relative at stages 0 and 2, the int8 and fp8
    transport within 1e-4 of the same transport at ep 1, tp 2 (the experts
    split by their feature dims) within 1e-4; the ep-2 checkpoint loaded
    at ep 1 (digest equal).  Returns rank 0's launches of the stage-0 run."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import GPTNeoXConfig

    workdir, procs = _workers("--moe-worker", MOE_EP_WORLD)
    r0, r1 = _join_dp_workers(procs)
    wants = {}
    for name, (cfg, mesh, tol) in MOE_EP_RUNS.items():
        # the stage moves no number: the stages share one reference run
        key = json.dumps({k: v for k, v in cfg.items() if k != "zero_optimization"},
                         sort_keys=True)
        if key not in wants:
            eng = dst.initialize(model=moe_ep_model(), config=cfg)[0]
            wants[key] = [float(eng.train_batch(batch=b))
                          for b in dp_check_batches(np, eng.module.config.vocab_size)]
            del eng
            torch.cuda.empty_cache()
        want = wants[key]
        E, F = MOE_EP_KW["moe_num_experts"], 4 * GPTNeoXConfig.pythia_160m().hidden_size
        held = (E // mesh.get("ep", 1), F // mesh.get("tp", 1))
        for r, rec in enumerate((r0, r1)):
            rel = max(abs(a - b) / abs(b) for a, b in zip(rec[name]["losses"], want))
            if rel > tol or (rec[name]["experts"], rec[name]["ffn"]) != held:
                raise AssertionError(f"moe (c) {name} rank {r}: losses {rec[name]['losses']} "
                                     f"vs ep 1 {want} ({rel:.2e} > {tol}), experts x ffn "
                                     f"{rec[name]['experts']} x {rec[name]['ffn']} a rank")
        staged = r0[name]["staged"]
        layout = " x ".join(f"{a} {n}" for a, n in mesh.items())
        print(f"[moe-c] {card}: {layout} (two processes, gloo via host), 2 full-width blocks "
              f"of 8 experts, fp32, {name}: losses {r0[name]['losses'][-1]:.6f} within "
              f"{rel:.2e} of one process (tol {tol}); {held[0]} experts x {held[1]} ffn "
              f"columns a rank; {r0[name]['ms']:.1f} ms/step; staged a step: all-to-all "
              f"{staged.get('moe_all_to_all', 0) / 1e6:.3f} MB, routing records "
              f"{staged.get('moe_routing', 0) / 1e6:.3f} MB, "
              f"{', '.join(f'{k} {v / 1e6:.3f} MB' for k, v in sorted(staged.items()) if not k.startswith('moe'))}; "
              f"dropped shares {[round(x['dropped'], 4) for x in r0[name]['routing']]}",
              flush=True)
        if name == "s0":
            fresh = dst.initialize(model=moe_ep_model(), config=cfg)[0]
            fresh.load_checkpoint(str(workdir / "moe_ckpt"))
            digest = _ckpt_digest(torch, fresh)
            if not (digest == r0[name]["digest"] == r1[name]["digest"]):
                raise AssertionError("moe (c): the ep-2 checkpoint loads at ep 1 with "
                                     "another digest")
            print(f"[moe-c] the ep-2 checkpoint loads at ep 1: masters and moments "
                  f"digest {digest[:16]} equal", flush=True)
            del fresh
            torch.cuda.empty_cache()
            shutil.rmtree(workdir / "moe_ckpt")
    print(f"[moe-c] launches (rank 0, stage 0) {r0['s0']['launches']}", flush=True)
    return r0["s0"]["launches"]


def phase_moe_served(torch, np, launches, card):
    """Phase 23 (d): Pythia-160M-MoE-8 in bf16, no-drop gating, through
    ``InferenceEngineV2`` at phase 5's batch and pool: prefill rounds of 8,
    ``MOE_SERVED_ROUNDS`` decode rounds, a 4-token extend round and a
    sampled run (top-k 50); then the v1 engine's greedy tokens against the
    v2 engine's in fp32 at 2 layers.  Returns the bf16 runs' launches."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig

    model = moe_model(moe_drop_tokens=False)
    eng = InferenceEngineV2(model, SERVED_ECFG)
    V = model.config.vocab_size
    prompts = served_prompts(np, V, SERVED_BATCH)
    rng = np.random.default_rng(SEED + 24)
    uids = list(range(SERVED_BATCH))
    launches.clear()                                  # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, nxt = [], {}
    for lo in range(0, SERVED_BATCH, 8):
        out = eng.put_round(uids[lo:lo + 8], prompts[lo:lo + 8])
        done = time.perf_counter() - t0
        for i, u in enumerate(uids[lo:lo + 8]):
            ttft.append(done)
            nxt[u] = int(out.tokens[i, -1])
        if not out.finite.all():
            raise AssertionError("moe (d): non-finite logits in a prefill round")
    t_dec = time.perf_counter()
    for _ in range(MOE_SERVED_ROUNDS):
        out = eng.put_round(uids, [[nxt[u]] for u in uids])
        if not out.finite.all():
            raise AssertionError("moe (d): non-finite logits in a decode round")
        nxt = {u: int(out.tokens[i, -1]) for i, u in enumerate(uids)}
    dt = time.perf_counter() - t_dec
    out = eng.put_round(uids, [[nxt[u]] + rng.integers(0, V, 3).tolist() for u in uids])
    if not out.finite.all():
        raise AssertionError("moe (d): non-finite logits in the extend round")
    routing = _moe_routing(model)
    del eng
    torch.cuda.empty_cache()
    sampled = InferenceEngineV2(model, {**SERVED_ECFG, "sampling": {
        "temperature": 0.8, "top_k": 50, "seed": SEED}})
    outs = sampled.generate([np.asarray(p) for p in prompts[:8]], max_new_tokens=16)
    if any(len(o) != len(p) + 16 for p, o in zip(prompts[:8], outs)):
        raise AssertionError("moe (d): the sampled run gave bad lengths")
    counts = dict(launches)
    for name in ("layer_norm", "paged_decode", "paged_spec_decode", "sorted_topk"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"moe serving never launched {name}: {counts}")
    if any(r["dropped"] != 0.0 for r in routing):
        raise AssertionError(f"moe (d): no-drop gating dropped tokens: {routing}")
    print(f"[moe-d] {card}: Pythia-160M-MoE-8 bf16, no-drop gating, "
          f"InferenceEngineV2 at batch {SERVED_BATCH} (4096 x 16 pool): "
          f"{dt / MOE_SERVED_ROUNDS * 1e3:.2f} ms/round, "
          f"{SERVED_BATCH * MOE_SERVED_ROUNDS / dt:.1f} tokens/s; TTFT median "
          f"{np.median(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f} ms (4 prefill rounds "
          f"of 8 prompts); launches {counts}", flush=True)
    del sampled, model
    torch.cuda.empty_cache()

    two = GPTNeoX(dataclasses.replace(GPTNeoXConfig.pythia_160m(
        **{**MOE_KW, "moe_drop_tokens": False}), num_layers=2), seed=SEED)
    ids = np.random.default_rng(SEED + 25).integers(1, two.config.vocab_size, (4, 64))
    v1 = dst.init_inference(two, {"dtype": "fp32"})
    want = v1.generate(ids, max_new_tokens=16).cpu().numpy()[:, 64:]
    del v1
    v2 = InferenceEngineV2(two, {**SERVED_ECFG, "dtype": "float32"})
    got, margins = _v2_greedy(torch, np, v2, ids, 16)
    agreed = _greedy_agree(np, want, got, margins, FP32_MARGIN)
    print(f"[moe-d] fp32 at 2 layers: the v1 engine's greedy tokens equal the v2 engine's "
          f"for {agreed} of 16 steps a prompt (parting only at a top-2 margin below "
          f"{FP32_MARGIN})", flush=True)
    del v2, two
    torch.cuda.empty_cache()
    return counts


# Offload (phase 24): Pythia-1.4B (hidden 2048, 16 heads, 24 layers, vocab
# 50304; 1,414,647,808 parameters) in bf16 at batch 8 x 1024, Adam, ZeRO-0;
# its width at 4 layers (407,482,368) for the NVMe tier and ZeRO-Infinity
# (4 chunks); Pythia-160M for the async checkpoint writer; phase 14's step at
# world 2 (stage 2) on the pinned tier in phase 13's workers.
OFFLOAD_BATCH, OFFLOAD_SEQ, OFFLOAD_STEPS = 8, 1024, 3
OFFLOAD_PARAMS, OFFLOAD_SMALL_PARAMS = 1_414_647_808, 407_482_368
OFFLOAD_SMALL_LAYERS, OFFLOAD_CHUNKS, OFFLOAD_INF_STEPS = 4, 4, 2
OFFLOAD_PIPELINED_STEPS = 2           # (c)'s pipeline_write run: step 2 waits on 1's flush
OFFLOAD_CONFIG = {**TRAIN_CONFIG, "train_batch_size": OFFLOAD_BATCH}
OFFLOAD_FUSED = {"type": "FusedAdam", "params": {"lr": 1e-4}}
OFFLOAD_TOL = 1e-3                    # relative, losses across update paths
# (a): the bf16 wire's masters after step 1 against the fp32 wire's, in
# units of lr.  Adam's first update is lr * g / (|g| + eps): a gradient's
# bf16 rounding moves it only where |g| is near eps, by a few thousandths
# of lr; a skipped update is lr off nearly everywhere.
OFFLOAD_WIRE_TOL = 1e-2
# what (a)-(d) hold at their peak: (a)'s host engine pins masters, moments,
# the gradients' landing buffer and the bf16 staging (25.5 GB); (b)'s tier
# builds its 17 GB of state in plain memory and then pins it; (c) and (d)
# write 3.3 GB and 5.7 GB to the disk
OFFLOAD_HOST_GB, OFFLOAD_DISK_GB = 48, 16
OFFLOAD_DP_STEPS = 2                  # (f): phase 14's stage-2 step on the pinned tier


# The planners (phase 25): (a) the host link measured and a calibration
# saved in a scratch tuner cache; (b) phase 24 (d)'s stream under
# memory_schedule "auto" at three budgets (300 MiB is below the static
# peak, 393.0 MiB), 2 steps at 700 MiB (resident units refreshed by an
# update, the rest through the window) and 1 at the others; (c) in phase
# 13's workers, phase 14's step at gas 2 under schedule.mode "auto", before
# phase 20 (c)'s runs, whose deferred run takes the plan's bucket_mb; (d)
# stage 3 at phase 13's model under memory "static" with a budget below
# its static peak (refused) and "auto" (one step).
PLAN_H2D_BYTES = 256 << 20
PLAN_BUDGETS_MIB = {300: 1, 700: OFFLOAD_INF_STEPS, 1024: 1}
PLAN_AUTO_RUN = {**TRAIN_CONFIG, "gradient_accumulation_steps": WIRE_GAS,
                 "zero_optimization": {"stage": 2},
                 "comm": {"overlap": {"enabled": True, "schedule": {"mode": "auto"}}}}
PLAN_STAGE3_CONFIG = {**DP_CHECK_CONFIG, "zero_optimization": {"stage": 3}}


def offload_model(layers=None, device=None):
    """Pythia-1.4B in bf16 (``layers`` to cut its depth), drawn on the card
    from ``SEED``."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    cfg = GPTNeoXConfig.pythia_1_4b(dtype=torch.bfloat16, max_seq_len=OFFLOAD_SEQ)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return GPTNeoX(cfg, device=device, seed=SEED, draw_on_device=True)


def _host_available_gb():
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) / 2 ** 20


def _reset_params(model, weights):
    """Point ``model``'s parameters at fresh fp32 copies of ``weights``
    (name -> tensor), so that another engine starts from them."""
    for n, p in model.named_parameters():
        p.data = weights[n].clone()


def _release_host(torch):
    """Free the device's cached blocks and the cached pinned host blocks."""
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def _offload_steps(torch, eng, batch, steps, stats=False):
    """``steps`` steps: the losses, seconds a step (host clock, ending in a
    sync) and, with ``stats``, each step's ``offload_stats``."""
    losses, secs, recs = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch=batch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if stats:
            recs.append(dict(eng.offload_stats))
    return losses, secs, recs


def _rel(a, b):
    return abs(a - b) / abs(b)


def phase_offload_host(torch, np, launches, card):
    """Phase 24 (a): the host update at full size against the device
    update on the same weights.  Returns (the host path's launches, the
    initial weights, the model, the batch, the device run's losses)."""
    import deeperspeed_tpu_torch as dst

    t0 = time.perf_counter()
    model = offload_model()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != OFFLOAD_PARAMS:
        raise AssertionError(f"offload (a): {n_params} parameters")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: v.cuda() for k, v in model.example_batch(
        batch_size=OFFLOAD_BATCH, seq_len=OFFLOAD_SEQ, seed=SEED).items()}
    print(f"[offload-a] Pythia-1.4B ({n_params:,} parameters) drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    dev = dst.initialize(model=model, config=OFFLOAD_CONFIG)[0]
    masters0 = dev._master_flat.to("cpu", copy=True)
    dev_losses, dev_secs, _ = _offload_steps(torch, dev, batch, 1)
    masters1 = dev._master_flat.to("cpu", copy=True)
    more, secs, _ = _offload_steps(torch, dev, batch, OFFLOAD_STEPS - 1)
    dev_losses += more
    dev_secs += secs
    dev_peak = torch.cuda.max_memory_allocated() / 1e9
    del dev
    _release_host(torch)

    _reset_params(model, start)
    host_off = {"device": "cpu", "host_update": True}
    host_cfg = {**OFFLOAD_CONFIG, "zero_optimization": {"stage": 0,
                                                        "offload_optimizer": host_off}}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = dst.initialize(model=model, config=host_cfg)[0]
    init_s = time.perf_counter() - t0
    launches.clear()                                 # the host path starts here
    losses, host_secs, recs = _offload_steps(torch, eng, batch, 1, stats=True)
    host1 = eng._master_flat.clone()
    more, secs, rec = _offload_steps(torch, eng, batch, OFFLOAD_STEPS - 1, stats=True)
    counts = dict(launches)
    losses += more
    host_secs += secs
    recs += rec
    host_peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    gc.collect()             # the cached pinned blocks stay for the next engine
    torch.cuda.empty_cache()
    # the bf16 wire, from the configuration: one step from the same weights,
    # its masters held against the fp32 wire's after their first step
    _reset_params(model, start)
    wire_cfg = {**OFFLOAD_CONFIG, "zero_optimization": {
        "stage": 0, "offload_optimizer": {**host_off, "wire_dtype": "bf16"}}}
    t0 = time.perf_counter()
    eng = dst.initialize(model=model, config=wire_cfg)[0]
    wire_init_s = time.perf_counter() - t0
    _, wire_secs, wire = _offload_steps(torch, eng, batch, 1, stats=True)
    lr = OFFLOAD_CONFIG["optimizer"]["params"]["lr"]
    host1 = host1.cuda()
    wire_err = float((eng._master_flat.cuda() - host1).abs().max())
    moved = float((masters0.cuda() - host1).abs().max())
    if wire[0]["d2h_bytes"] * 2 != recs[0]["d2h_bytes"]:
        raise AssertionError(f"offload (a): the bf16 wire moved {wire[0]['d2h_bytes']} bytes "
                             f"against the fp32 wire's {recs[0]['d2h_bytes']}")
    if not wire_err <= OFFLOAD_WIRE_TOL * lr < moved:
        raise AssertionError(f"offload (a): bf16-wire masters after step 1 differ from the "
                             f"fp32 wire's by {wire_err:.3e} (limit {OFFLOAD_WIRE_TOL * lr:.1e}; "
                             f"the step moved them by {moved:.3e})")
    del eng, masters0
    _release_host(torch)
    if losses[0] != dev_losses[0]:
        raise AssertionError(f"offload (a): first loss {losses[0]} != device {dev_losses[0]}")
    masters1 = masters1.cuda()                          # the peaks are read
    if not torch.allclose(host1, masters1, rtol=2e-5, atol=1e-6):
        worst = ((host1 - masters1).abs() - 1e-6 - 2e-5 * masters1.abs()).max()
        raise AssertionError(f"offload (a): masters after step 1 differ (worst excess "
                             f"{float(worst):.3e})")
    rels = [_rel(a, b) for a, b in zip(losses, dev_losses)]
    if max(rels) > OFFLOAD_TOL:
        raise AssertionError(f"offload (a): losses {losses} vs device {dev_losses}")
    for name in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"offload (a) never launched {name}: {counts}")
    masters_err = float((host1 - masters1).abs().max())
    del host1, masters1
    print(f"[offload-a] {card}: Pythia-1.4B bf16, B {OFFLOAD_BATCH} x S {OFFLOAD_SEQ}, Adam, "
          f"clip 1.0, ZeRO-0: device update {', '.join(f'{s * 1e3:.1f}' for s in dev_secs)} "
          f"ms/step, peak {dev_peak:.2f} GB; host update (engine built in {init_s:.1f} s) "
          f"{', '.join(f'{s * 1e3:.1f}' for s in host_secs)} ms/step, peak {host_peak:.2f} "
          f"GB ({dev_peak - host_peak:.2f} GB less); losses "
          f"{', '.join(f'{x:.6f}' for x in losses)} vs device "
          f"{', '.join(f'{x:.6f}' for x in dev_losses)} (max relative {max(rels):.2e}, first "
          f"equal); masters after step 1 within {masters_err:.3e}", flush=True)
    print(f"[offload-a] wire_dtype bf16 (from the configuration; engine built in "
          f"{wire_init_s:.1f} s): {wire_secs[0] * 1e3:.1f} ms for step 1; its masters after it "
          f"within {wire_err:.3e} of the fp32 wire's (limit {OFFLOAD_WIRE_TOL * lr:.1e}; the "
          f"step moved them by up to {moved:.3e})", flush=True)
    n = recs[0]["adam_elements"]
    for i, (r, sec) in enumerate(zip(recs + wire, host_secs + wire_secs)):
        what = f"step {i + 1}" if i < len(recs) else "bf16 wire, step 1"
        host_s = r["d2h_s"] + r["adam_s"] + r["cast_s"] + r["h2d_s"]
        # the sweep reads and writes masters and moments (24 bytes) and
        # reads the gradient as it came down (4 or 2)
        per = 24 + r["d2h_bytes"] // n
        print(f"[offload-a] {what}: forward, backward and clip {(sec - host_s) * 1e3:.1f} ms "
              f"(the step less the update's parts); grads D2H {r['d2h_bytes'] / 1e9:.3f} GB in "
              f"{r['d2h_s'] * 1e3:.1f} ms ({r['d2h_bytes'] / r['d2h_s'] / 1e9:.2f} GB/s); host "
              f"Adam {r['adam_s']:.3f} s ({per * n / r['adam_s'] / 1e9:.2f} GB/s at {per} bytes "
              f"an element); bf16 cast on the host {r['cast_s'] * 1e3:.1f} ms; H2D "
              f"{r['h2d_bytes'] / 1e9:.3f} GB in {r['h2d_s'] * 1e3:.1f} ms "
              f"({r['h2d_bytes'] / r['h2d_s'] / 1e9:.2f} GB/s)", flush=True)
    print(f"[offload-a] launches in the host-update steps {counts}", flush=True)
    return counts, start, model, batch, dev_losses


def phase_offload_pinned(torch, launches, card, start, model, batch, dev_losses):
    """Phase 24 (b): the pinned-host tier at full size (FusedAdam: B6 on
    the card), against (a)'s device update."""
    import deeperspeed_tpu_torch as dst

    _reset_params(model, start)
    cfg = {**OFFLOAD_CONFIG, "optimizer": OFFLOAD_FUSED,
           "zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}}}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = dst.initialize(model=model, config=cfg)[0]
    init_s = time.perf_counter() - t0
    launches.clear()                                 # the pinned-tier path starts here
    losses, secs, recs = _offload_steps(torch, eng, batch, OFFLOAD_STEPS, stats=True)
    counts = dict(launches)
    rels = [_rel(a, b) for a, b in zip(losses, dev_losses)]
    if max(rels) > OFFLOAD_TOL:
        raise AssertionError(f"offload (b): losses {losses} vs device {dev_losses}")
    if counts.get("fused_adam", 0) != OFFLOAD_STEPS:
        raise AssertionError(f"offload (b): B6 launched {counts.get('fused_adam')} times")
    print(f"[offload-b] {card}: pinned-host tier, Pythia-1.4B bf16, FusedAdam (engine built in "
          f"{init_s:.1f} s): {', '.join(f'{s * 1e3:.1f}' for s in secs)} ms/step, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)} (relative to (a)'s device update "
          f"{max(rels):.2e})", flush=True)
    for i, r in enumerate(recs):
        print(f"[offload-b] step {i + 1}: state H2D {r['h2d_bytes'] / 1e9:.3f} GB in "
              f"{r['h2d_s'] * 1e3:.1f} ms ({r['h2d_bytes'] / r['h2d_s'] / 1e9:.2f} GB/s), "
              f"update {r['update_s'] * 1e3:.1f} ms, D2H {r['d2h_bytes'] / 1e9:.3f} GB in "
              f"{r['d2h_s'] * 1e3:.1f} ms ({r['d2h_bytes'] / r['d2h_s'] / 1e9:.2f} GB/s)",
              flush=True)
    del eng
    _release_host(torch)
    return counts


def _small_weights(start):
    """(a)'s weights cut to ``OFFLOAD_SMALL_LAYERS`` blocks."""
    return {n: t for n, t in start.items()
            if not n.startswith("layers.") or int(n.split(".")[1]) < OFFLOAD_SMALL_LAYERS}


def phase_offload_nvme(torch, launches, card, small, model, batch, swap_root):
    """Phase 24 (c): the NVMe tier at 1.4B's width and 4 layers, against the
    same run without the tier: ``pipeline_write: false`` (the state on disk
    between steps, read back while the card computes the grads), then the
    default ``true`` (the flush in flight until the next swap-in waits for
    it, the host copy kept)."""
    import deeperspeed_tpu_torch as dst

    base = {**OFFLOAD_CONFIG, "optimizer": OFFLOAD_FUSED}
    _reset_params(model, small)
    eng = dst.initialize(model=model, config=base)[0]
    want, _, _ = _offload_steps(torch, eng, batch, OFFLOAD_STEPS)
    del eng
    _release_host(torch)
    counts = None
    for pipelined, steps in ((False, OFFLOAD_STEPS), (True, OFFLOAD_PIPELINED_STEPS)):
        _reset_params(model, small)
        cfg = {**base, "zero_optimization": {"stage": 0, "offload_optimizer": {
            "device": "nvme", "nvme_path": str(swap_root), "pipeline_write": pipelined}}}
        eng = dst.initialize(model=model, config=cfg)[0]
        launches.clear()                             # the NVMe path starts here
        losses, secs, recs = _offload_steps(torch, eng, batch, steps, stats=True)
        counts = counts or dict(launches)
        label = f"pipeline_write {str(pipelined).lower()}"
        if losses != want[:steps]:
            raise AssertionError(f"offload (c), {label}: losses {losses} != without the tier "
                                 f"{want[:steps]}")
        swapper = eng._opt_swapper
        if swapper.stats["bytes_read"] != (0 if pipelined else
                                           (steps - 1) * swapper.stats["bytes_written"]
                                           // steps):
            raise AssertionError(f"offload (c), {label}: swap-in read "
                                 f"{swapper.stats['bytes_read']} bytes")
        swap_dir = swapper.dir
        t0 = time.perf_counter()
        eng.destroy()                                # waits for an in-flight flush
        destroy_s = time.perf_counter() - t0
        if Path(swap_dir).exists():
            raise AssertionError(f"offload (c), {label}: destroy() left the swap directory")
        st, nbytes = swapper.stats, eng._opt_home.numel() * 4
        print(f"[offload-c] {card}: NVMe tier, {label}, at 1.4B's width, "
              f"{OFFLOAD_SMALL_LAYERS} layers ({OFFLOAD_SMALL_PARAMS:,} parameters), FusedAdam: "
              f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms/step, destroy() "
              f"{destroy_s * 1e3:.1f} ms; losses equal to the run without the tier "
              f"({', '.join(f'{x:.6f}' for x in losses)}); a swap moves {nbytes / 1e9:.3f} GB",
              flush=True)
        if pipelined:
            print(f"[offload-c] {label}: {st['bytes_written'] / 1e9:.3f} GB written, "
                  f"{st['write_wait_s']:.3f} s waited at the swap-ins; nothing read back (the "
                  f"host copy kept)", flush=True)
        else:
            reads = steps - 1
            print(f"[offload-c] {label}: swap-out (fsync'd, waited) "
                  f"{st['bytes_written'] / 1e9:.3f} GB in {st['write_s']:.3f} s "
                  f"({st['bytes_written'] / st['write_s'] / 1e9:.2f} GB/s); swap-in "
                  f"{st['bytes_read'] / 1e9:.3f} GB over {reads} steps, reads in flight "
                  f"{st['read_s']:.3f} s ({st['bytes_read'] / st['read_s'] / 1e9:.2f} GB/s or "
                  f"more), {st['read_hidden_s']:.3f} s of them under the grads, "
                  f"{st['read_wait_s']:.3f} s waited "
                  f"({st['read_hidden_s'] / max(st['read_s'], 1e-9):.3f} hidden)", flush=True)
        for i, r in enumerate(recs):
            print(f"[offload-c] {label}, step {i + 1}: state H2D {r['h2d_s'] * 1e3:.1f} ms, "
                  f"update {r['update_s'] * 1e3:.1f} ms, D2H {r['d2h_s'] * 1e3:.1f} ms, "
                  f"swap-out {r['swap_out_s'] * 1e3:.1f} ms", flush=True)
        del eng, swapper
        _release_host(torch)
    return counts


def phase_offload_infinity(torch, launches, card, small, model, batch, swap_root):
    """Phase 24 (d): ZeRO-Infinity at 1.4B's width, 4 layers in 4 chunks,
    bf16, against the host-update engine on the same weights (no clipping:
    the chunk stream clips nothing, as in the JAX package)."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine

    _reset_params(model, small)
    cfg = {**OFFLOAD_CONFIG, "gradient_clipping": 0.0, "zero_optimization": {
        "stage": 0, "offload_optimizer": {"device": "cpu", "host_update": True}}}
    eng = dst.initialize(model=model, config=cfg)[0]
    want, ref_secs, recs = _offload_steps(torch, eng, batch, OFFLOAD_INF_STEPS, stats=True)
    del eng
    _release_host(torch)
    # phase 25's calibration: the last step's forward, backward and clip (the
    # step less its update's parts)
    r = recs[-1]
    compute_s = ref_secs[-1] - (r["d2h_s"] + r["adam_s"] + r["cast_s"] + r["h2d_s"])
    t0 = time.perf_counter()
    inf = ZeroInfinityEngine(model, str(swap_root), num_chunks=OFFLOAD_CHUNKS, lr=1e-4,
                             compute_dtype=model.config.dtype, params=small)
    init_s = time.perf_counter() - t0
    launches.clear()                                 # the chunk stream starts here
    losses, secs = [], []
    for _ in range(OFFLOAD_INF_STEPS):
        t0 = time.perf_counter()
        losses.append(inf.train_batch(batch))
        secs.append(time.perf_counter() - t0)
    counts = dict(launches)
    s = inf.swap_stats
    inf.close()
    rels = [_rel(a, b) for a, b in zip(losses, want)]
    if max(rels) > OFFLOAD_TOL:
        raise AssertionError(f"offload (d): losses {losses} vs the host update {want}")
    if not s["peak_device_param_bytes"] < s["total_param_bytes"]:
        raise AssertionError(f"offload (d): device residency not bounded: {s}")
    for name in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"offload (d) never launched {name}: {counts}")
    print(f"[offload-d] {card}: ZeRO-Infinity at 1.4B's width, {OFFLOAD_SMALL_LAYERS} layers in "
          f"{OFFLOAD_CHUNKS} chunks, bf16 (spilled in {init_s:.1f} s): "
          f"{', '.join(f'{x:.3f}' for x in secs)} s/step; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)} vs the host update "
          f"{', '.join(f'{x:.6f}' for x in want)} (max relative {max(rels):.2e}); "
          f"peak device parameter bytes {s['peak_device_param_bytes'] / 1e9:.3f} GB of "
          f"{s['total_param_bytes'] / 1e9:.3f} GB; swap_stats {s}", flush=True)
    print(f"[offload-d] launches in the streamed steps {counts}", flush=True)
    _release_host(torch)
    return counts, {"losses": losses, "secs": secs, "compute_s": compute_s,
                    "step_s": ref_secs[-1], "stats": s}


def phase_offload_ckpt(torch, card, root):
    """Phase 24 (e): Pythia-160M's checkpoint through the synchronous writer
    and through the async writer (the aio pool): files byte-equal (equal
    sha256 manifests, each the commit's read-back), GB/s each."""
    import filecmp

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.op_builder import CALLS
    from deeperspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
        AsyncCheckpointEngine, NativeCheckpointEngine)

    model = trained_model()
    eng = dst.initialize(model=model, config=TRAIN_CONFIG)[0]
    readings = {}
    for writer, make in (("native", NativeCheckpointEngine),
                         ("async (aio)", AsyncCheckpointEngine)):
        eng.checkpoint_engine = make()
        CALLS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.save_checkpoint(str(root / writer.split()[0]))
        readings[writer] = (time.perf_counter() - t0,
                            eng.checkpoint_engine.commit_info.get("verify_seconds", 0.0),
                            CALLS.get("aio_pwrite", 0))
    # the commit read every file back into its manifest's sha256: equal
    # manifests (and engine states) are byte-equal files
    tag = root / "native" / f"global_step{eng.global_steps}"
    names = sorted(p.name for p in tag.iterdir())
    small = [n for n in names if n.endswith(".json")]
    match, mismatch, errors = filecmp.cmpfiles(tag, root / "async" / tag.name, small,
                                               shallow=False)
    if mismatch or errors or len(match) != len(small) or "manifest.json" not in match:
        raise AssertionError(f"offload (e): files differ {mismatch} {errors}")
    if readings["native"][2] != 0 or readings["async (aio)"][2] < 1:
        raise AssertionError(f"offload (e): aio writes {readings}")
    total = sum((tag / n).stat().st_size for n in names)
    print(f"[offload-e] {card}: Pythia-160M bf16 + Adam checkpoint ({total / 1e9:.3f} GB, "
          f"{len(names)} files byte-equal by their sha256 manifests): "
          + "; ".join(f"{writer} {s:.3f} s ({total / s / 1e9:.3f} GB/s, verify {v:.3f} s of "
                      f"it, {n} aio writes)" for writer, (s, v, n) in readings.items()),
          flush=True)
    del eng, model
    torch.cuda.empty_cache()


def phase_offload_dp(r0, r1):
    """Phase 24 (f): phase 14's step at world 2, stage 2, on the pinned-host
    tier (phase 13's workers), against phase 14's stage-2 run."""
    a, b = r0["offload-stage2"], r1["offload-stage2"]
    want = r0["full-stage2"]["losses"][:OFFLOAD_DP_STEPS]
    if a["losses"] != b["losses"] or a["losses"] != want:
        raise AssertionError(f"offload (f): losses {a['losses']} / {b['losses']} vs "
                             f"without offload {want}")
    print(f"[offload-f] Pythia-160M bf16 at world 2 (gloo via host), stage 2, pinned-host "
          f"tier: losses {', '.join(f'{x:.6f}' for x in a['losses'])} on both ranks, equal to "
          f"phase 14's stage-2 run; {a['ms_per_step']:.1f} ms/step; state H2D / D2H "
          f"{a['h2d_gb']:.3f} / {a['d2h_gb']:.3f} GB a step on rank 0", flush=True)


def phase_offload(torch, np, launches, card, dp_ranks):
    """Phase 24: offload.  Asserts the host memory and disk it needs, then
    (a)-(e) here and (f)'s checks.  Returns each main path's launches, and
    (d)'s model, weights, batch and readings for phase 25."""
    swap_root = Path(tempfile.mkdtemp(dir=ROOT / ".build"))
    try:
        free_gb = _host_available_gb()
        disk_gb = shutil.disk_usage(swap_root).free / 2 ** 30
        print(f"[offload] host memory available {free_gb:.1f} GiB (needs "
              f"{OFFLOAD_HOST_GB}), disk free under {swap_root.parent} {disk_gb:.1f} GiB "
              f"(needs {OFFLOAD_DISK_GB}), {os.cpu_count()} host cores", flush=True)
        if free_gb < OFFLOAD_HOST_GB or disk_gb < OFFLOAD_DISK_GB:
            raise AssertionError(f"offload: {free_gb:.1f} GiB of host memory and "
                                 f"{disk_gb:.1f} GiB of disk; the phase needs "
                                 f"{OFFLOAD_HOST_GB} and {OFFLOAD_DISK_GB}")
        paths = {}
        t = time.perf_counter()
        paths["offload_host"], start, model, batch, dev_losses = phase_offload_host(
            torch, np, launches, card)
        print(f"[time] phase 24 (a): {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        paths["offload_pinned"] = phase_offload_pinned(torch, launches, card, start, model,
                                                       batch, dev_losses)
        print(f"[time] phase 24 (b): {time.perf_counter() - t:.1f} s", flush=True)
        del model
        small = _small_weights(start)
        del start
        model = offload_model(OFFLOAD_SMALL_LAYERS)
        n_small = sum(p.numel() for p in model.parameters())
        if n_small != OFFLOAD_SMALL_PARAMS or sum(t.numel() for t in small.values()) != n_small:
            raise AssertionError(f"offload (c), (d): {n_small} parameters")
        # phase 27's pp x tp group starts here, once (a) and (b) no longer
        # hold the card's memory: its steps run beside (c)-(e) and phase 25,
        # which wait on the disk
        start_early("--pipe-tp-worker", PIPE_TP_WORLD)
        t = time.perf_counter()
        paths["offload_nvme"] = phase_offload_nvme(torch, launches, card, small, model, batch,
                                                   swap_root / "nvme")
        print(f"[time] phase 24 (c): {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        paths["offload_infinity"], ref = phase_offload_infinity(
            torch, launches, card, small, model, batch, swap_root / "infinity")
        print(f"[time] phase 24 (d): {time.perf_counter() - t:.1f} s", flush=True)
        _release_host(torch)
        t = time.perf_counter()
        phase_offload_ckpt(torch, card, swap_root / "ckpt")
        print(f"[time] phase 24 (e): {time.perf_counter() - t:.1f} s", flush=True)
        if dp_ranks is not None:
            phase_offload_dp(*dp_ranks)
        # phase 25 (b) streams (d)'s model from (d)'s weights
        return paths, {**ref, "small": small, "model": model, "batch": batch}
    finally:
        shutil.rmtree(swap_root, ignore_errors=True)


def _plan_a(torch, card, inf):
    """Phase 25 (a): the host link measured against the device table, and a
    calibration (phase 24 (d)'s compute time, the measured rate) saved and
    read back through ``DST_TUNER_CACHE`` in a scratch directory (set for
    the rest of the phase).  Returns the calibration."""
    from deeperspeed_tpu_torch.comm import memplan
    from deeperspeed_tpu_torch.telemetry import wire

    kind = torch.cuda.get_device_name(0)
    rate = memplan.measure_h2d_bandwidth(PLAN_H2D_BYTES, iters=5)
    table = wire.host_link_bandwidth(kind)
    if not table / 2 <= rate <= 2 * table:
        raise AssertionError(f"planners (a): measured {rate / 1e9:.2f} GB/s host to card, "
                             f"the table holds {table / 1e9:.2f} GB/s for {kind}")
    cache = _scratch_dir() / "tuner"
    os.environ[memplan.CALIBRATION_ENV] = str(cache)
    fields = {"compute_s": inf["compute_s"], "h2d_gbps": rate / 1e9, "device_kind": kind,
              "step_time_s": inf["step_s"]}
    path = memplan.save_calibration(str(cache), **fields)
    cal = memplan.load_calibration()
    if cal is None or any(getattr(cal, k) != v for k, v in fields.items()):
        raise AssertionError(f"planners (a): calibration read back {cal} != {fields}")
    print(f"[plan-a] {card}: host to card {rate / 1e9:.2f} GB/s ({PLAN_H2D_BYTES >> 20} MiB "
          f"pinned, 5 copies; telemetry/wire.py's figure {table / 1e9:.2f} GB/s, "
          f"{rate / table:.3f}x); calibration {path} through {memplan.CALIBRATION_ENV}: "
          f"compute_s {cal.compute_s * 1e3:.1f} ms (phase 24 (d)'s host-update step less "
          f"its update), read back equal", flush=True)
    return cal


def _plan_b(torch, launches, card, inf, cal, swap_root):
    """Phase 25 (b): phase 24 (d)'s stream under ``memory_schedule`` "auto"
    at each budget of :data:`PLAN_BUDGETS_MIB`: the plan the engine made
    equal to ``plan_chunk_stream`` on its unit bytes and the calibration;
    its losses equal to (d)'s static ones bit for bit; the device ledger
    within the plan's peak; K1, K8 and K5-K7 launched.  The first budget,
    below the static peak, is refused by the static schedule.  Returns the
    middle budget's launch counts."""
    from deeperspeed_tpu_torch.comm import memplan
    from deeperspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine

    model, small, batch = inf["model"], inf["small"], inf["batch"]
    kind = torch.cuda.get_device_name(0)
    kw = dict(num_chunks=OFFLOAD_CHUNKS, lr=1e-4, compute_dtype=model.config.dtype,
              params=small)
    counts = None
    for i, (mib, steps) in enumerate(PLAN_BUDGETS_MIB.items()):
        budget = mib << 20
        _reset_params(model, small)
        if i == 0:
            try:
                ZeroInfinityEngine(model, str(swap_root / "static"), hbm_budget_bytes=budget,
                                   **kw)
            except memplan.HBMBudgetError as e:
                print(f"[plan-b] {mib} MiB under static: HBMBudgetError at construction "
                      f"({e})", flush=True)
            else:
                raise AssertionError(f"planners (b): static took a {mib} MiB budget")
        t0 = time.perf_counter()
        eng = ZeroInfinityEngine(model, str(swap_root / f"auto{mib}"), memory_schedule="auto",
                                 hbm_budget_bytes=budget, **kw)
        init_s = time.perf_counter() - t0
        want = memplan.plan_chunk_stream(
            eng._unit_bytes, hbm_budget_bytes=budget,
            compute_s_per_chunk=cal.compute_s / len(eng._unit_bytes),
            h2d_bytes_per_s=cal.h2d_bytes_per_s, device_kind=kind)
        if dataclasses.asdict(eng.mem_plan) != dataclasses.asdict(want):
            raise AssertionError(f"planners (b) {mib} MiB: {eng.mem_plan} != {want}")
        launches.clear()
        losses, secs = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(batch))
            secs.append(time.perf_counter() - t0)
        got = dict(launches)
        s = eng.swap_stats
        plan = eng.mem_plan
        eng.close()
        if losses != inf["losses"][:steps]:
            raise AssertionError(f"planners (b) {mib} MiB: losses {losses} != static "
                                 f"{inf['losses'][:steps]}")
        if not s["peak_device_param_bytes"] <= plan.peak_bytes:
            raise AssertionError(f"planners (b) {mib} MiB: ledger {s} over {plan.describe()}")
        for name in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                     "flash_bwd_dkv"):
            if got.get(name, 0) < 1:
                raise AssertionError(f"planners (b) {mib} MiB never launched {name}: {got}")
        if i == 1:
            counts = got
        print(f"[plan-b] {card}: {mib} MiB, {plan.describe()}", flush=True)
        print(f"[plan-b] {mib} MiB: {', '.join(f'{x:.3f}' for x in secs)} s/step against "
              f"static {', '.join(f'{x:.3f}' for x in inf['secs'][:steps])} (phase 24 (d)); "
              f"built in {init_s:.1f} s; losses {', '.join(f'{x:.6f}' for x in losses)} equal "
              f"to static's; peak device parameter bytes {s['peak_device_param_bytes'] / 2**20:.1f}"
              f" MiB (plan {plan.peak_bytes / 2**20:.1f} MiB; static "
              f"{inf['stats']['peak_device_param_bytes'] / 2**20:.1f}); swap_stats {s}",
              flush=True)
        _release_host(torch)
    return counts


def _plan_c(r0, r1):
    """Phase 25 (c): phase 14's step at gas 2 under the cost-model schedule
    in phase 13's workers, against phase 20 (c)'s manual deferred run at the
    plan's bucket_mb: losses and each step's grad norm equal bit for bit,
    collectives issued from gradient hooks, ms a step against issuing after
    the backward."""
    a, b = r0["plan-auto"], r1["plan-auto"]
    ref = r0["wire-full-deferred"]
    plan = a["plan"]
    if a["losses"] != b["losses"] or a["losses"] != ref["losses"] \
            or a["grad_norms"] != ref["grad_norms"]:
        raise AssertionError(f"planners (c): auto {a['losses']} {a['grad_norms']} vs manual "
                             f"{ref['losses']} {ref['grad_norms']}")
    if plan["grad_schedule"] != "deferred" or ref["bucket_mb"] != plan["bucket_mb"] \
            or not plan["n_hoisted"] > 0:
        raise AssertionError(f"planners (c): {plan}")
    for kernel in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                   "flash_bwd_dkv"):
        if a["launches"].get(kernel, 0) < 1:
            raise AssertionError(f"planners (c): {kernel} never launched")
    foot, = a["footprint"]
    print(f"[plan-c] Pythia-160M bf16, gas {WIRE_GAS}, world {DP_WORLD} (gloo via host), "
          f"stage 2, schedule.mode auto: {plan['describe']}", flush=True)
    print(f"[plan-c] {plan['buckets']} buckets, {plan['n_hoisted']} of the first step's "
          f"{plan['n_collectives']} collective calls issued from gradient hooks; losses "
          f"{', '.join(f'{x:.4f}' for x in a['losses'])} and grad norms "
          f"{', '.join(f'{x:.6f}' for x in a['grad_norms'])} equal bit for bit to phase 20 "
          f"(c)'s manual deferred run at bucket_mb {ref['bucket_mb']:g}; hook-issued "
          f"{a['ms_per_step']:.2f} / {b['ms_per_step']:.2f} ms/step (rank 0 / 1) against "
          f"after the backward {ref['ms_per_step']:.2f} ms/step (rank 0; "
          f"{a['ms_per_step'] / ref['ms_per_step']:.3f}x); gradient reduction staged "
          f"{a['grad_bytes_per_step'] / 1e9:.3f} GB a step, the caller blocked in it "
          f"{a['grad_ms_per_step']:.2f} ms (issue and wait; after the backward "
          f"{ref['grad_ms_per_step']:.2f} ms); footprint "
          f"{foot['schedule']} {foot['count']} collectives", flush=True)
    return a["launches"]


def _plan_d(torch, np, card):
    """Phase 25 (d): stage 3 at phase 13's model on one process: ``memory:
    static`` with a budget below ``stage3_static_peak_bytes`` raises at
    construction; ``auto`` takes one step and publishes the movement plan,
    whose peak is the gathered bytes the ledger saw live."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.comm import memplan
    from deeperspeed_tpu_torch.runtime.zero.sharding import stage3_static_peak_bytes

    model = dp_check_model()
    peak = stage3_static_peak_bytes((p.shape, p.dtype) for p in model.parameters())
    budget = peak // 2

    def config(memory, mode):
        return {**PLAN_STAGE3_CONFIG, "comm": {"overlap": {"enabled": True, "schedule": {
            "mode": mode, "memory": memory, "hbm_budget_bytes": budget}}}}

    try:
        dst.initialize(model=model, config=config("static", "manual"))
    except memplan.HBMBudgetError as e:
        refused = str(e)
    else:
        raise AssertionError("planners (d): static stage 3 took half its static peak")
    eng = dst.initialize(model=dp_check_model(), config=config("auto", "auto"))[0]
    batch = dp_check_batches(np, eng.module.config.vocab_size)[0]
    loss = float(eng.train_batch(batch=batch))
    summ = memplan.movement_summary(eng.memory_plan)
    ledger = eng._gather_ledger
    if not math.isfinite(loss) or summ["peak_live_bytes"] != ledger.peak_bytes \
            or not summ["n_sites"] > 0:
        raise AssertionError(f"planners (d): loss {loss}, {summ}, ledger peak "
                             f"{ledger.peak_bytes}")
    print(f"[plan-d] {card}: stage 3, 2 full-width layers fp32, static peak "
          f"{peak / 2**20:.1f} MiB: static at a {budget / 2**20:.1f} MiB budget refused "
          f"({refused}); auto: loss {loss:.6f}, movement_summary {summ} (the ledger's peak "
          f"{ledger.peak_bytes / 2**20:.1f} MiB)", flush=True)
    del eng
    torch.cuda.empty_cache()


def phase_planners(torch, np, launches, card, dp_ranks, inf):
    """Phase 25: the planners, (a)-(d) (see :data:`PLAN_BUDGETS_MIB`).
    Returns the launches of (b)'s 700 MiB run and (c)'s auto run (rank 0)."""
    from deeperspeed_tpu_torch.comm import memplan

    swap_root = Path(tempfile.mkdtemp(dir=ROOT / ".build"))
    saved = os.environ.get(memplan.CALIBRATION_ENV)
    paths = {}
    try:
        t = time.perf_counter()
        cal = _plan_a(torch, card, inf)
        print(f"[time] phase 25 (a): {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        paths["planned_infinity"] = _plan_b(torch, launches, card, inf, cal, swap_root)
        print(f"[time] phase 25 (b): {time.perf_counter() - t:.1f} s", flush=True)
        if dp_ranks is not None:
            paths["auto_schedule"] = _plan_c(*dp_ranks)
        t = time.perf_counter()
        _plan_d(torch, np, card)
        print(f"[time] phase 25 (d): {time.perf_counter() - t:.1f} s", flush=True)
        return paths
    finally:
        if saved is None:
            os.environ.pop(memplan.CALIBRATION_ENV, None)
        else:
            os.environ[memplan.CALIBRATION_ENV] = saved
        shutil.rmtree(swap_root, ignore_errors=True)


# Pipelines (phase 26): the stage processes share the card over gloo (NCCL
# refuses two ranks on one device), each activation and its gradient staged
# through host memory.  (a) Pythia-160M at pp 2 under 1f1b, (b) under gpipe,
# and both at gas 8 for their memory, (c) Llama-2-7B's width at 4 layers
# (the depth cut: the whole model does not fit one card with Adam's state),
# all in the two ``--pipe-worker`` processes; (d) the interpreted engine at
# pp 2 x dp 2 (four ``--pipe-dp-worker`` processes) on a PipelineModule of
# GPT-NeoX layers at Pythia-160M's width with a tied embedding and head.
# Both groups run under phase 19's disk waits, but for (c), which waits for
# phase 26 itself; phase 26 holds them against flat runs on the same weights
# in this process and reloads (d)'s checkpoint at pp 1.
PIPE_WORLD, PIPE_DP_WORLD = 2, 4
PIPE_GAS, PIPE_STEPS, PIPE_MEM_GAS = 4, 3, 8
PIPE_CONFIG = {**TRAIN_CONFIG, "gradient_accumulation_steps": PIPE_GAS,
               "mesh": {"pipe_parallel_size": PIPE_WORLD}}
PIPE_LLAMA_LAYERS, PIPE_LLAMA_ROWS, PIPE_LLAMA_GAS = 4, 4, 2
PIPE_LLAMA_CONFIG = {**LLAMA_TRAIN, "train_batch_size": PIPE_LLAMA_ROWS,
                     "gradient_accumulation_steps": PIPE_LLAMA_GAS}
PIPE_INTERP_LAYERS, PIPE_INTERP_STEPS, PIPE_INTERP_SAVE = 4, 3, 2
PIPE_INTERP_CONFIG = {**TRAIN_CONFIG, "gradient_accumulation_steps": PIPE_GAS,
                      "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}},
                      "zero_optimization": {"stage": 2}}
PIPE_TOL = LAYOUT_BF16_TOL            # bf16 losses and grad norms, relative
# (d)'s limit, relative, for its losses and grad norms against the flat run:
# on the H100 they agree within 6e-6 and 3.0e-4; at a tiny width on the CPU
# a dropped tie reduction moves the norms by 3.5e-2 (the losses by 8.6e-4)
# and a dropped dp reduction by 0.34 (4.3e-3)
PIPE_INTERP_TOL = 1e-3

# Pipelines, part b (phase 27): four ``--pipe-tp-worker`` processes at pp 2 x
# tp 2 share the card over gloo (the P2P messages and the tp reductions
# staged through host memory): (a) Pythia-160M under 1f1b with FusedAdam, so
# that B6 runs on each tp-split stage, then (b) Llama-2-7B's width at 4
# layers, which waits for phase 27 as 26 (c) waits for 26; (c) the host
# update at pp 2 runs in phase 26's two processes; (d) ZeRO-Infinity over
# GPTNeoXPipe in this process, beside (b).
PIPE_TP = 2
PIPE_TP_WORLD = PIPE_WORLD * PIPE_TP
PIPE_TP_MESH = {"pipe_parallel_size": PIPE_WORLD, "model_parallel_size": PIPE_TP}
PIPE_TP_CONFIG = {**PIPE_CONFIG, "mesh": PIPE_TP_MESH,
                  "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}}}
PIPE_HOST_CONFIG = {**PIPE_CONFIG, "zero_optimization": {
    "stage": 0, "offload_optimizer": {"device": "cpu", "host_update": True}}}
PIPE_TP_TOL = 1e-2        # (a) and (b) against phase 26's pp 2 runs, relative
PIPE_HOST_TOL = 2e-5      # (c) against 26 (a), relative: the host update's limit
PIPE_INF_STAGES, PIPE_INF_STEPS = 4, 2


def pipe_model():
    """Pythia-160M (phase 9's model) cut into two stages: each stage draws
    its half of the model on the card from ``SEED``."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoXConfig
    from deeperspeed_tpu_torch.models.gpt_neox_pipe import GPTNeoXPipe
    return GPTNeoXPipe(GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16, max_seq_len=TRAIN_SEQ),
                       PIPE_WORLD, seed=SEED, draw_on_device=True)


def pipe_llama_config():
    import torch

    from deeperspeed_tpu_torch.models import LlamaConfig
    return LlamaConfig.llama2_7b(num_layers=PIPE_LLAMA_LAYERS, dtype=torch.bfloat16)


def pipe_interp_module(num_stages):
    """(d)'s PipelineModule: a tied embedding, 4 Pythia-160M-width blocks,
    the final LayerNorm and the embedding as the head, cut by blocks."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoXConfig
    from deeperspeed_tpu_torch.models.gpt_neox import ModelLayerNorm
    from deeperspeed_tpu_torch.models.gpt_neox_pipe import BlockLayer, EmbedLayer, tied_head
    from deeperspeed_tpu_torch.models.pipe_base import loss_from_logits
    from deeperspeed_tpu_torch.runtime.pipe.module import (LayerSpec, PipelineModule,
                                                           TiedLayerSpec)

    cfg = dataclasses.replace(GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16,
                                                        max_seq_len=TRAIN_SEQ),
                              num_layers=PIPE_INTERP_LAYERS)
    specs = ([TiedLayerSpec("embed", EmbedLayer, cfg)]
             + [LayerSpec(BlockLayer, cfg) for _ in range(PIPE_INTERP_LAYERS)]
             + [LayerSpec(ModelLayerNorm, cfg.hidden_size, cfg.layernorm_eps, cfg.dtype),
                TiedLayerSpec("embed", EmbedLayer, cfg, forward_fn=tied_head)])
    return PipelineModule(specs, num_stages=num_stages, loss_fn=loss_from_logits,
                          partition_method="type:blocklayer", base_seed=SEED)


def pipe_interp_batch(np):
    toks = np.random.default_rng(SEED + 26).integers(0, 50304, (TRAIN_BATCH, TRAIN_SEQ + 1))
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


def _pipe_run(torch, dst, model, config, batch, steps, save=None):
    """Train ``steps`` steps of a pipeline engine on ``batch``, timing each
    (host clock, ending in the loss's broadcast, which syncs) and splitting
    it (``pipe_stats``, the card synchronized after each compute
    instruction); ``save`` = (step, dir) saves before that step.  Records
    the bytes each op staged through host memory over the steps, the
    stage's parameter bytes and the host update's split."""
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    t = time.perf_counter()
    eng = dst.initialize(model=model, config=config)[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    eng.pipe_timing = True
    torch.cuda.reset_peak_memory_stats()
    comm.STAGED.clear()
    LAUNCHES.clear()                                  # main path starts here
    losses, norms, ms, stats, save_s = [], [], [], [], None
    for step in range(steps):
        if save is not None and step == save[0]:
            t = time.perf_counter()
            eng.save_checkpoint(save[1])
            save_s = time.perf_counter() - t
        t = time.perf_counter()
        losses.append(float(eng.train_batch(batch=batch)))
        ms.append((time.perf_counter() - t) * 1e3)
        norms.append(eng.get_global_grad_norm())
        stats.append(dict(eng.pipe_stats))
    rec = {"losses": losses, "norms": norms, "ms": ms, "stats": stats,
           "launches": dict(LAUNCHES), "stage": eng.stage_id, "init_s": init_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_live": eng.peak_live_inputs(), "save_s": save_s,
           "params": sum(t.numel() for t in eng.module.parameters()),
           "param_bytes": sum(t.numel() * t.element_size() for t in eng.module.parameters()),
           "staged": dict(comm.STAGED), "offload": dict(eng.offload_stats)}
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _pipe_build_bytes(torch, spec, stage_id):
    """The card's peak bytes while ``spec`` builds stage ``stage_id``, the
    stage's own parameter bytes and the whole model's (fp32)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stage = spec.build_stage(stage_id)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    mine = sum(t.numel() * t.element_size() for t in stage.parameters())
    whole = sum(t.numel() * t.element_size()
                for t in spec.FLAT(spec.config, device="meta").parameters())
    del stage
    torch.cuda.empty_cache()
    return {"peak": peak, "mine": mine, "whole": whole}


def _pipe_transfer_ms(torch, comm, rank, iters=10):
    """One activation message's one-way time between the two stage
    processes (gloo via host): a ping-pong of [4, 1024, 768] bf16 with both
    sides waiting, so no time is the other stage's compute."""
    world = comm.get_world_group()
    x = torch.zeros((PIPE_GAS, TRAIN_SEQ, 768), dtype=torch.bfloat16, device="cuda")
    peer = 1 - rank

    def ping():
        if rank == 0:
            comm.send(x, peer, world)
            comm.recv(x, peer, world)
        else:
            comm.recv(x, peer, world)
            comm.send(x, peer, world)

    ping()
    comm.barrier(world)
    t = time.perf_counter()
    for _ in range(iters):
        ping()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / (2 * iters), x.numel() * x.element_size()


def pipe_worker(rank, rendezvous, out_path):
    """One of the two stage processes of phase 26 (``--pipe-worker``): the
    message time, (a) 1f1b and (b) gpipe on Pythia-160M at gas 4, both at
    gas 8 for their memory, phase 27 (c)'s host update, (c) Llama-2-7B's
    width at 4 layers once phase 26 has begun; each stage's peak while it
    is built; writes what it saw as JSON."""
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.models.llama_pipe import LlamaPipe

    torch.set_num_threads(2)
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=PIPE_WORLD, timeout=600)
    out = {}
    out["transfer_ms"], out["transfer_bytes"] = _pipe_transfer_ms(torch, comm, rank)
    out["build"] = {"pythia": _pipe_build_bytes(torch, pipe_model(), rank)}
    batch = trained_batch(pipe_model())
    for sched in ("1f1b", "gpipe"):
        out[sched] = _pipe_run(torch, dst, pipe_model(),
                               {**PIPE_CONFIG, "pipeline": {"schedule": sched}}, batch,
                               PIPE_STEPS)
    for sched in ("1f1b", "gpipe"):
        out[f"gas8-{sched}"] = _pipe_run(
            torch, dst, pipe_model(), {**PIPE_CONFIG, "gradient_accumulation_steps":
                                       PIPE_MEM_GAS, "pipeline": {"schedule": sched}},
            batch, 1)
    # phase 27 (c): (a)'s 1f1b run with each stage's update on the host
    out["host"] = _pipe_run(torch, dst, pipe_model(), PIPE_HOST_CONFIG, batch, PIPE_STEPS)
    # (c) holds ~14 GB a stage: it waits for phase 26 (``go-c``), so that
    # it never meets the device memory of the phases the group runs under
    go, parent = Path(rendezvous).parent / "go-c", os.getppid()
    while not go.exists():
        if os.getppid() != parent:
            return 3
        time.sleep(0.05)
    llama = LlamaPipe(pipe_llama_config(), PIPE_WORLD, seed=SEED)
    out["build"]["llama"] = _pipe_build_bytes(torch, llama, rank)
    out["llama"] = _pipe_run(
        torch, dst, llama, {**PIPE_LLAMA_CONFIG, "mesh": {"pipe_parallel_size": PIPE_WORLD}},
        llama.example_batch(batch_size=PIPE_LLAMA_ROWS, seq_len=TRAIN_SEQ, seed=SEED), 1)
    Path(out_path).write_text(json.dumps(out))
    comm.destroy()
    return 0


def pipe_dp_worker(rank, rendezvous, out_path):
    """One of the four processes of phase 26 (d) (``--pipe-dp-worker``):
    the interpreted engine at pp 2 x dp 2, ZeRO-2, FusedAdam; saves a
    checkpoint beside the rendezvous before step 3."""
    import numpy as np
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm

    torch.set_num_threads(2)
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=PIPE_DP_WORLD, timeout=600)
    rec = _pipe_run(torch, dst, pipe_interp_module(2),
                    {**PIPE_INTERP_CONFIG, "mesh": {"pipe_parallel_size": 2}},
                    pipe_interp_batch(np), PIPE_INTERP_STEPS,
                    save=(PIPE_INTERP_SAVE, str(Path(rendezvous).parent / "ckpt")))
    Path(out_path).write_text(json.dumps(rec))
    comm.destroy()
    return 0


def pipe_tp_worker(rank, rendezvous, out_path):
    """One of the four processes of phase 27 (``--pipe-tp-worker``), pp 2 x
    tp 2: (a) Pythia-160M under 1f1b at gas 4, then (b) Llama-2-7B's width
    at 4 layers once phase 27 has begun; writes what it saw as JSON."""
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.models.llama_pipe import LlamaPipe

    torch.set_num_threads(2)
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=PIPE_TP_WORLD, timeout=600)
    out = {"1f1b": _pipe_run(torch, dst, pipe_model(), PIPE_TP_CONFIG,
                             trained_batch(pipe_model()), PIPE_STEPS)}
    out["tp_rank"] = comm.get_model_parallel_group().rank()
    # (b) holds ~7 GB a rank: it waits for phase 27 (``go-b``)
    go, parent = Path(rendezvous).parent / "go-b", os.getppid()
    while not go.exists():
        if os.getppid() != parent:
            return 3
        time.sleep(0.05)
    llama = LlamaPipe(pipe_llama_config(), PIPE_WORLD, seed=SEED)
    out["llama"] = _pipe_run(
        torch, dst, llama, {**PIPE_LLAMA_CONFIG, "mesh": PIPE_TP_MESH},
        llama.example_batch(batch_size=PIPE_LLAMA_ROWS, seq_len=TRAIN_SEQ, seed=SEED), 1)
    Path(out_path).write_text(json.dumps(out))
    comm.destroy()
    return 0


def _flat_run(torch, dst, model, config, batch, steps, loss_fn=None):
    """A flat engine's losses and grad norms over ``steps`` steps."""
    eng = dst.initialize(model=model, config=config, loss_fn=loss_fn)[0]
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(eng.train_batch(batch=batch)))
        norms.append(eng.get_global_grad_norm())
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms


def _rel_max(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _pipe_split(rec, transfer_ms, transfer_bytes):
    """Steps 2-3's mean ms: the step, the stage's compute (its forward and
    backward instructions, the card synchronized after each), the time in
    sends and receives, of which the transfers (the P2P bytes at the rate
    of one message measured alone, one way: an upper bound, since a send's
    host copy and a receive's run on different processes) and the bubble
    (the rest: waiting on the other stage, a lower bound), and the rest of
    the step (the reductions, the optimizer, the loss's broadcast)."""
    n = len(rec["ms"]) - 1
    step = sum(rec["ms"][1:]) / n
    compute = sum(s["compute_s"] for s in rec["stats"][1:]) * 1e3 / n
    p2p = sum(s["p2p_s"] for s in rec["stats"][1:]) * 1e3 / n
    transfer = sum(s["p2p_bytes"] for s in rec["stats"][1:]) / n / transfer_bytes * transfer_ms
    return {"step": step, "compute": compute, "p2p": p2p, "transfer": min(transfer, p2p),
            "bubble": max(p2p - transfer, 0.0), "other": step - compute - p2p}


def phase_pipeline(torch, np, card):
    """Phase 26: the flat runs in this process, the two worker groups
    joined and held against them, (d)'s checkpoint reloaded at pp 1.
    Returns the launches of (a)'s 1f1b run and of (d), summed over their
    processes."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.accelerator import resolve_device
    from deeperspeed_tpu_torch.models import Llama
    from deeperspeed_tpu_torch.runtime.pipe.interpreted import InterpretedStage

    pipe_dir, pipe_procs = _workers("--pipe-worker", PIPE_WORLD)
    (pipe_dir / "go-c").touch()
    t = time.perf_counter()
    model = trained_model()
    flat_a = _flat_run(torch, dst, model, {**TRAIN_CONFIG, "gradient_accumulation_steps":
                                           PIPE_GAS}, trained_batch(model), PIPE_STEPS)
    llama = Llama(pipe_llama_config(), seed=SEED)
    flat_c = _flat_run(torch, dst, llama, {**PIPE_LLAMA_CONFIG},
                       llama.example_batch(batch_size=PIPE_LLAMA_ROWS, seq_len=TRAIN_SEQ,
                                           seed=SEED), 1)
    interp_batch = pipe_interp_batch(np)
    flat = InterpretedStage(pipe_interp_module(1), 0, resolve_device())
    flat_d = _flat_run(torch, dst, flat, {**PIPE_INTERP_CONFIG}, interp_batch,
                       PIPE_INTERP_STEPS,
                       loss_fn=lambda m, b, rng=None, **_: m.stage_loss(
                           m.forward_stage(b["input_ids"], b), b))
    flat_s = time.perf_counter() - t
    a, b = sorted(_join_dp_workers(pipe_procs),
                  key=lambda r: r["1f1b"]["stage"])
    workdir, procs = _workers("--pipe-dp-worker", PIPE_DP_WORLD)
    dranks = _join_dp_workers(procs)

    # (a), (b): losses and norms against the flat run, the split, memory
    for sched in ("1f1b", "gpipe"):
        for r in (a, b):
            rec = r[sched]
            if _rel_max(rec["losses"], flat_a[0]) > PIPE_TOL \
                    or _rel_max(rec["norms"], flat_a[1]) > PIPE_TOL:
                raise AssertionError(f"pipeline ({sched}) stage {rec['stage']}: losses "
                                     f"{rec['losses']} norms {rec['norms']} vs flat {flat_a}")
            for k in ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
                      "flash_bwd_dkv"):
                if rec["launches"].get(k, 0) < 1:
                    raise AssertionError(f"pipeline ({sched}) stage {rec['stage']} never "
                                         f"launched {k}: {rec['launches']}")
    if a["1f1b"]["losses"] != b["1f1b"]["losses"] or a["gpipe"]["losses"] != a["1f1b"]["losses"]:
        raise AssertionError(f"pipeline: 1f1b {a['1f1b']['losses']} / {b['1f1b']['losses']}, "
                             f"gpipe {a['gpipe']['losses']}")
    M, S = PIPE_GAS, PIPE_WORLD
    print(f"[pipe-a] {card}: Pythia-160M bf16 at pp {S} (two stage processes, gloo via "
          f"host), {TRAIN_BATCH} x {TRAIN_SEQ} in {M} microbatches, Adam, clip 1.0, 1f1b: "
          f"losses {', '.join(f'{x:.4f}' for x in a['1f1b']['losses'])} and grad norms "
          f"{', '.join(f'{x:.4f}' for x in a['1f1b']['norms'])} against the flat engine's "
          f"{', '.join(f'{x:.4f}' for x in flat_a[0])} / "
          f"{', '.join(f'{x:.4f}' for x in flat_a[1])} (limit {PIPE_TOL} relative); one "
          f"{a['transfer_bytes'] / 2**20:.1f} MiB message {a['transfer_ms']:.2f} ms one way",
          flush=True)
    # each stage draws only its own part: its peak while built is below the
    # whole model's bytes
    for fam in ("pythia", "llama"):
        for r in (a, b):
            got = r["build"][fam]
            if not got["mine"] <= got["peak"] < got["whole"]:
                raise AssertionError(f"pipeline: stage {r['1f1b']['stage']} of {fam} held "
                                     f"{got} while built")
        print(f"[pipe-a] built on the card, {fam}: "
              + "; ".join(f"stage {r['1f1b']['stage']} peak {r['build'][fam]['peak'] / 2**20:.1f}"
                          f" MiB (its own parameters {r['build'][fam]['mine'] / 2**20:.1f} MiB)"
                          for r in (a, b))
              + f"; the whole model {a['build'][fam]['whole'] / 2**20:.1f} MiB (fp32)",
              flush=True)
    for sched in ("1f1b", "gpipe"):
        for r in (a, b):
            rec = r[sched]
            sp = _pipe_split(rec, a["transfer_ms"], a["transfer_bytes"])
            print(f"[pipe-{'a' if sched == '1f1b' else 'b'}] {sched} stage {rec['stage']} "
                  f"({rec['params'] / 1e6:.1f}M parameters): {sp['step']:.1f} ms/step (steps "
                  f"2-{PIPE_STEPS}; step 1 {rec['ms'][0]:.1f}): compute {sp['compute']:.1f}, "
                  f"P2P {sp['p2p']:.1f} of which transfer {sp['transfer']:.1f} and bubble "
                  f"{sp['bubble']:.1f}, optimizer and the rest {sp['other']:.1f}; "
                  f"{rec['stats'][-1]['p2p_msgs']} messages "
                  f"{rec['stats'][-1]['p2p_bytes'] / 2**20:.1f} MiB a step; peak "
                  f"{rec['peak_gb']:.2f} GB; peak live inputs {rec['peak_live']}; launches "
                  f"{rec['launches']}", flush=True)
    print(f"[pipe-b] gpipe losses {', '.join(f'{x:.4f}' for x in a['gpipe']['losses'])} equal "
          f"1f1b's; the schedule's bubble share (S-1)/(M+S-1) = {(S - 1) / (M + S - 1):.3f}",
          flush=True)
    # 1f1b keeps fewer inputs live, and its peaks (of the forward and
    # backward, and of the whole step) are the lower: strictly on every
    # stage whose inputs are activations (the stages after the first), by
    # the received activations gpipe keeps; on the first, whose inputs are
    # token ids, never above gpipe's
    for r in (a, b):
        one, gp = r["gas8-1f1b"], r["gas8-gpipe"]
        p1, pg = (x["stats"][-1]["stream_peak_bytes"] / 2**20 for x in (one, gp))
        w1, wg = one["peak_gb"], gp["peak_gb"]
        lower = (p1 < pg and w1 < wg) if one["stage"] > 0 else (p1 <= pg and w1 <= wg)
        if not (one["peak_live"] < gp["peak_live"] and lower):
            raise AssertionError(f"pipeline (b) stage {one['stage']} at gas {PIPE_MEM_GAS}: "
                                 f"1f1b {p1} MiB (step {w1} GB) / {one['peak_live']} inputs, "
                                 f"gpipe {pg} MiB (step {wg} GB) / {gp['peak_live']}")
        print(f"[pipe-b] gas {PIPE_MEM_GAS}, stage {one['stage']}: peak memory of the "
              f"forward and backward 1f1b {p1:.2f} MiB, gpipe {pg:.2f} MiB ({pg - p1:.2f} MiB "
              f"more); of the whole step {one['peak_gb'] * 1e3:.1f} / "
              f"{gp['peak_gb'] * 1e3:.1f} MB; peak live inputs {one['peak_live']} / "
              f"{gp['peak_live']}; {one['ms'][0]:.1f} / {gp['ms'][0]:.1f} ms (one step)",
              flush=True)

    # (c): Llama-2-7B's width at 4 layers
    la, lb = a["llama"], b["llama"]
    if _rel_max(la["losses"], flat_c[0]) > PIPE_TOL or _rel_max(la["norms"], flat_c[1]) > PIPE_TOL:
        raise AssertionError(f"pipeline (c): {la['losses']} {la['norms']} vs flat {flat_c}")
    print(f"[pipe-c] Llama-2-7B width (H 4096, N 32 / D 128), {PIPE_LLAMA_LAYERS} layers, pp "
          f"{S}, {PIPE_LLAMA_ROWS} x {TRAIN_SEQ} in {PIPE_LLAMA_GAS} microbatches: loss "
          f"{la['losses'][0]:.4f}, grad norm {la['norms'][0]:.4f} against the flat Llama's "
          f"{flat_c[0][0]:.4f} / {flat_c[1][0]:.4f}; {la['ms'][0]:.1f} ms (one step, built in "
          f"{la['init_s']:.1f} / {lb['init_s']:.1f} s); peak {la['peak_gb']:.2f} / "
          f"{lb['peak_gb']:.2f} GB ({la['params'] / 1e6:.0f}M / {lb['params'] / 1e6:.0f}M "
          f"parameters a stage)", flush=True)

    # (d): the interpreted engine at pp 2 x dp 2, then its checkpoint at pp 1
    d0 = min(dranks, key=lambda r: r["stage"])
    d_err = [max(_rel_max(r["losses"], flat_d[0]) for r in dranks),
             max(_rel_max(r["norms"], flat_d[1]) for r in dranks)]
    for r in dranks:
        if _rel_max(r["losses"], flat_d[0]) > PIPE_INTERP_TOL \
                or _rel_max(r["norms"], flat_d[1]) > PIPE_INTERP_TOL:
            raise AssertionError(f"pipeline (d) stage {r['stage']}: {r['losses']} / "
                                 f"{r['norms']} vs flat {flat_d}")
        if r["launches"].get("fused_adam", 0) < 1:
            raise AssertionError(f"pipeline (d): fused_adam never launched: {r['launches']}")
    eng = dst.initialize(model=pipe_interp_module(1), config={
        **PIPE_INTERP_CONFIG, "mesh": {"pipe_parallel_size": 1}})[0]
    t = time.perf_counter()
    eng.load_checkpoint(str(workdir / "ckpt"))
    load_s = time.perf_counter() - t
    resumed = float(eng.train_batch(batch=interp_batch))
    want = d0["losses"][PIPE_INTERP_SAVE]
    if abs(resumed - want) > PIPE_INTERP_TOL * abs(want) \
            or eng.global_steps != PIPE_INTERP_SAVE + 1:
        raise AssertionError(f"pipeline (d): resumed at pp 1 {resumed} vs {want}")
    del eng
    torch.cuda.empty_cache()
    print(f"[pipe-d] interpreted, pp 2 x dp 2 (four processes), ZeRO-2, FusedAdam, "
          f"{PIPE_INTERP_LAYERS} Pythia-160M-width blocks with a tied embedding and head: "
          f"losses {', '.join(f'{x:.6f}' for x in d0['losses'])} and grad norms "
          f"{', '.join(f'{x:.6f}' for x in d0['norms'])} against the flat engine's "
          f"{', '.join(f'{x:.6f}' for x in flat_d[0])} / "
          f"{', '.join(f'{x:.6f}' for x in flat_d[1])} (relative {d_err[0]:.2e} / "
          f"{d_err[1]:.2e}, limit {PIPE_INTERP_TOL}); "
          f"{sum(d0['ms'][1:]) / (len(d0['ms']) - 1):.1f} ms/step; checkpoint saved in "
          f"{d0['save_s']:.2f} s, loaded at pp 1 in {load_s:.2f} s, step "
          f"{PIPE_INTERP_SAVE + 1} there {resumed:.4f} against {want:.4f}; flat runs "
          f"{flat_s:.1f} s", flush=True)

    def summed(recs):
        out = {}
        for rec in recs:
            for k, v in rec["launches"].items():
                out[k] = out.get(k, 0) + v
        return out

    return ({"pipe-trained": summed([a["1f1b"], b["1f1b"]]),
             "pipe-interpreted": summed(dranks)}, {"stages": (a, b), "flat_c": flat_c})


def _summed_launches(recs):
    out = {}
    for rec in recs:
        for k, v in rec["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _pipe_infinity(torch, swap_root):
    """Phase 27 (d): ZeRO-Infinity over ``GPTNeoXPipe(pythia_160m,
    num_stages=4)`` (a chunk a stage, in this process) and over
    the flat model at ``num_chunks=4``, on the same weights, bf16: their
    losses and every unit's masters."""
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.models.gpt_neox_pipe import GPTNeoXPipe
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES
    from deeperspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine

    cfg = GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16, max_seq_len=TRAIN_SEQ)
    flat = GPTNeoX(cfg, seed=SEED, draw_on_device=True)
    batch = trained_batch(flat)
    params = {n: t.detach().cpu() for n, t in flat.state_dict().items()}
    runs = {}
    for name, model, kw in (("pipe", GPTNeoXPipe(cfg, PIPE_INF_STAGES, seed=SEED,
                                                 draw_on_device=True), {}),
                            ("flat", flat, {"num_chunks": PIPE_INF_STAGES})):
        t = time.perf_counter()
        eng = ZeroInfinityEngine(model, str(swap_root / name), lr=1e-4,
                                 compute_dtype=torch.bfloat16, params=params, **kw)
        rec = {"init_s": time.perf_counter() - t, "losses": [], "secs": []}
        LAUNCHES.clear()                               # the streamed steps start here
        for _ in range(PIPE_INF_STEPS):
            t = time.perf_counter()
            rec["losses"].append(eng.train_batch(batch))
            rec["secs"].append(time.perf_counter() - t)
        rec["launches"] = dict(LAUNCHES)
        rec["stats"] = eng.swap_stats
        rec["chunks"] = eng.chunks
        rec["masters"] = {u: eng.master(u) for u in eng.units}
        eng.close()
        del eng
        runs[name] = rec
    del flat, params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def phase_pipe_tp(torch, np, card, p26):
    """Phase 27: pp x tp, the host update on each stage, and ZeRO-Infinity
    over a stage model, held against phase 26's runs (``p26``) and the flat
    stream.  Returns the launches of (a), (b) and (c), summed over their
    processes, and of (d)'s streamed steps."""
    workdir, procs = _workers("--pipe-tp-worker", PIPE_TP_WORLD)
    (workdir / "go-b").touch()
    swap_root = _scratch_dir()
    try:
        inf = _pipe_infinity(torch, swap_root)
    finally:
        shutil.rmtree(swap_root, ignore_errors=True)
    ranks = sorted(_join_dp_workers(procs), key=lambda r: (r["1f1b"]["stage"], r["tp_rank"]))
    a26, b26 = p26["stages"]
    by_stage = {0: a26, 1: b26}
    kernels = ("layer_norm", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    # (a): pp 2 x tp 2 against phase 26 (a)'s pp 2 run on the same weights
    def fmt(xs, digits=6):
        return ", ".join(f"{x:.{digits}f}" for x in xs)

    err = [0.0, 0.0]
    for r in ranks:
        rec, ref = r["1f1b"], by_stage[r["1f1b"]["stage"]]["1f1b"]
        e = (_rel_max(rec["losses"], ref["losses"]), _rel_max(rec["norms"], ref["norms"]))
        err = [max(err[0], e[0]), max(err[1], e[1])]
        if max(e) > PIPE_TP_TOL:
            raise AssertionError(f"pp x tp (a) stage {rec['stage']} tp {r['tp_rank']}: "
                                 f"{rec['losses']} / {rec['norms']} vs pp 2 "
                                 f"{ref['losses']} / {ref['norms']}")
        for k in kernels + ("fused_adam",):
            if rec["launches"].get(k, 0) < 1:
                raise AssertionError(f"pp x tp (a) stage {rec['stage']} tp {r['tp_rank']} "
                                     f"never launched {k}: {rec['launches']}")
        share = rec["param_bytes"] / ref["param_bytes"]
        if not 0.45 < share < 0.55 or rec["staged"].get("tp_reduce", 0) <= 0:
            raise AssertionError(f"pp x tp (a) stage {rec['stage']}: parameter bytes "
                                 f"{share:.3f} of the pp 2 stage's, staged {rec['staged']}")
    a0 = ranks[0]["1f1b"]
    print(f"[pipe-tp-a] {card}: Pythia-160M bf16 at pp {PIPE_WORLD} x tp {PIPE_TP} (four "
          f"processes, gloo via host), {TRAIN_BATCH} x {TRAIN_SEQ} in {PIPE_GAS} "
          f"microbatches, FusedAdam, clip 1.0, 1f1b: losses {fmt(a0['losses'])} and grad "
          f"norms {fmt(a0['norms'])} against pp 2's {fmt(a26['1f1b']['losses'])} / "
          f"{fmt(a26['1f1b']['norms'])} (relative {err[0]:.2e} / {err[1]:.2e}, limit "
          f"{PIPE_TP_TOL})", flush=True)
    for r in ranks:
        rec = r["1f1b"]
        ref = by_stage[rec["stage"]]["1f1b"]
        sp = _pipe_split(rec, a26["transfer_ms"], a26["transfer_bytes"])
        ref_ms = _pipe_split(ref, a26["transfer_ms"], a26["transfer_bytes"])["step"]
        tokens = " (its inputs are token ids)" if rec["stage"] == 0 else ""
        print(f"[pipe-tp-a] stage {rec['stage']} tp {r['tp_rank']}{tokens}: "
              f"{rec['param_bytes'] / 2**20:.1f} MiB of parameters "
              f"({rec['param_bytes'] / ref['param_bytes']:.3f} of the pp 2 stage's "
              f"{ref['param_bytes'] / 2**20:.1f}); {sp['step']:.1f} ms/step (steps "
              f"2-{PIPE_STEPS}; pp 2: {ref_ms:.1f}): compute {sp['compute']:.1f}, P2P "
              f"{sp['p2p']:.1f}, the rest {sp['other']:.1f}; pipe_stats {rec['stats'][-1]}; "
              f"tp_reduce staged {rec['staged'].get('tp_reduce', 0) / PIPE_STEPS / 2**20:.1f} "
              f"MiB a step (all ops {sum(rec['staged'].values()) / PIPE_STEPS / 2**20:.1f}); "
              f"peak {rec['peak_gb']:.2f} GB (pp 2: {ref['peak_gb']:.2f}); launches "
              f"{rec['launches']}", flush=True)

    # (b): Llama-2-7B's width at pp 2 x tp 2 against 26 (c)'s pp 2 step
    for r in ranks:
        rec, ref = r["llama"], by_stage[r["llama"]["stage"]]["llama"]
        ratio = rec["peak_gb"] / ref["peak_gb"]
        if _rel_max(rec["losses"], ref["losses"]) > PIPE_TP_TOL \
                or _rel_max(rec["norms"], ref["norms"]) > PIPE_TP_TOL or ratio > 0.7:
            raise AssertionError(f"pp x tp (b) stage {rec['stage']} tp {r['tp_rank']}: "
                                 f"{rec['losses']} / {rec['norms']}, peak {rec['peak_gb']} GB "
                                 f"vs pp 2 {ref['losses']} / {ref['norms']}, {ref['peak_gb']} GB")
        for k in kernels:
            if rec["launches"].get(k, 0) < 1:
                raise AssertionError(f"pp x tp (b) never launched {k}: {rec['launches']}")
    lb = ranks[0]["llama"]
    peaks = ", ".join(f"stage {r['llama']['stage']} tp {r['tp_rank']} "
                      f"{r['llama']['peak_gb']:.2f} GB" for r in ranks)
    mib = ", ".join(f"{r['llama']['param_bytes'] / 2**20:.0f}" for r in ranks)
    print(f"[pipe-tp-b] Llama-2-7B width (H 4096, 16 query heads a rank), "
          f"{PIPE_LLAMA_LAYERS} layers, pp {PIPE_WORLD} x tp {PIPE_TP}, {PIPE_LLAMA_ROWS} x "
          f"{TRAIN_SEQ} in {PIPE_LLAMA_GAS} microbatches: loss {lb['losses'][0]:.4f}, grad "
          f"norm {lb['norms'][0]:.4f} against pp 2's {a26['llama']['losses'][0]:.4f} / "
          f"{a26['llama']['norms'][0]:.4f}; {lb['ms'][0]:.1f} ms (one step); peaks {peaks} "
          f"against pp 2's {a26['llama']['peak_gb']:.2f} / {b26['llama']['peak_gb']:.2f} GB "
          f"({mib} MiB of parameters a rank)", flush=True)

    # (c): the host update at pp 2 against 26 (a)'s device update
    host_err = max(_rel_max(r["host"]["losses"], a26["1f1b"]["losses"]) for r in (a26, b26))
    for r in (a26, b26):
        rec = r["host"]
        if _rel_max(rec["losses"], a26["1f1b"]["losses"]) > PIPE_HOST_TOL:
            raise AssertionError(f"pipeline host update (c) stage {rec['stage']}: "
                                 f"{rec['losses']} vs the device update {a26['1f1b']['losses']}")
        for k in kernels:
            if rec["launches"].get(k, 0) < 1:
                raise AssertionError(f"pipeline host update (c) never launched {k}: "
                                     f"{rec['launches']}")
        if rec["launches"].get("fused_adam", 0) or not rec["offload"]:
            raise AssertionError(f"pipeline host update (c): {rec['launches']} "
                                 f"{rec['offload']}")
    splits = []
    for r in (a26, b26):
        off, ms = r["host"]["offload"], r["host"]["ms"]
        dev = r["1f1b"]["ms"]
        splits.append(f"stage {r['host']['stage']}: host Adam {off['adam_s']:.3f} s over "
                      f"{off['adam_elements'] / 1e6:.1f}M elements, D2H "
                      f"{off['d2h_s'] * 1e3:.1f} ms, H2D {off['h2d_s'] * 1e3:.1f} ms, "
                      f"{sum(ms[1:]) / (len(ms) - 1):.1f} ms/step (device update "
                      f"{sum(dev[1:]) / (len(dev) - 1):.1f})")
    print(f"[pipe-tp-c] Pythia-160M bf16 at pp {PIPE_WORLD}, host update (native CPU Adam "
          f"over each stage's host masters): losses {fmt(a26['host']['losses'])} against "
          f"the device update's {fmt(a26['1f1b']['losses'])} (relative {host_err:.2e}, limit "
          f"{PIPE_HOST_TOL}); " + "; ".join(splits), flush=True)

    # (d): the chunk stream over the stage model, bit for bit the flat one's
    pipe, flat = inf["pipe"], inf["flat"]
    same = pipe["losses"] == flat["losses"] and pipe["chunks"] == PIPE_INF_STAGES and all(
        len(pipe["masters"][u]) == len(flat["masters"][u])
        and all(torch.equal(x, y) for x, y in zip(pipe["masters"][u], flat["masters"][u]))
        for u in flat["masters"])
    if not same or set(pipe["masters"]) != set(flat["masters"]):
        raise AssertionError(f"ZeRO-Infinity over GPTNeoXPipe: {pipe['losses']} vs the flat "
                             f"stream's {flat['losses']}")
    for k in kernels:
        if pipe["launches"].get(k, 0) < 1:
            raise AssertionError(f"ZeRO-Infinity over GPTNeoXPipe never launched {k}: "
                                 f"{pipe['launches']}")
    s = pipe["stats"]
    print(f"[pipe-tp-d] ZeRO-Infinity over GPTNeoXPipe(Pythia-160M, {PIPE_INF_STAGES} stages), "
          f"bf16, a chunk a stage: losses {', '.join(f'{x:.6f}' for x in pipe['losses'])} "
          f"equal the flat stream's at num_chunks={PIPE_INF_STAGES} bit for bit, and every "
          f"unit's masters; {', '.join(f'{x:.3f}' for x in pipe['secs'])} s/step (flat "
          f"{', '.join(f'{x:.3f}' for x in flat['secs'])}; spilled in {pipe['init_s']:.1f} / "
          f"{flat['init_s']:.1f} s); peak device parameter bytes "
          f"{s['peak_device_param_bytes'] / 1e6:.1f} MB of {s['total_param_bytes'] / 1e6:.1f} MB; "
          f"{s['bytes_read'] / 1e9:.3f} GB read, {s['bytes_written'] / 1e9:.3f} GB written, "
          f"{s['io_wait_s']:.2f} s waited", flush=True)
    return {"pipe-tp": _summed_launches([r["1f1b"] for r in ranks]),
            "pipe-tp-llama": _summed_launches([r["llama"] for r in ranks]),
            "pipe-host": _summed_launches([a26["host"], b26["host"]]),
            "infinity-pipe": pipe["launches"]}


# Phase 28, sequence parallelism: two ``--sp-worker`` processes share the
# card over gloo (every exchange staged through host memory) at sp 2, each
# holding half of every sequence; the same weights and global batch through
# the engine at sp 1 (dp 2: each rank whole sequences of half the rows).
SP_WORLD = 2
SP_SEQ, SP_ROWS, SP_GAS, SP_STEPS = 2048, 4, 2, 2
SP_CONFIG = {**TRAIN_CONFIG, "train_batch_size": SP_ROWS,
             "gradient_accumulation_steps": SP_GAS,
             "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}}}
SP_LLAMA_LAYERS, SP_LLAMA_ROWS = 2, 2
# one step: its loss and grad norm (SGD keeps the state small on a card
# that phase 27's workers share)
SP_LLAMA_CONFIG = {**LLAMA_TRAIN, "train_batch_size": SP_LLAMA_ROWS,
                   "optimizer": {"type": "SGD", "params": {"lr": 1e-4}}}
SP_MESHES = {"sp1": {"dp": SP_WORLD}, "sp2": {"sp": SP_WORLD}}
# sp 2 against sp 1, relative, in bf16 (the sum orders of the exchanges
# and, under ring, its fp32 blocks against the flash kernels, round apart):
# sound runs read up to 1.36e-05 on losses and 1.21e-03 on grad norms;
# planted faults read 8.79e-04 (local positions, Llama), 2.03e-03 (keys not
# gathered) and 3.06e-03 / 9.34e-02 (a ring block skipped) (PERF.md, PR 24)
SP_LOSS_TOL, SP_NORM_TOL = 1e-4, 5e-3
SP_OPS = ("sp_all_to_all", "sp_ring", "sp_all_gather", "sp_reduce_scatter")


def sp_model(mode=None):
    """Pythia-160M at seq 2048 in bf16 under ``mode``, drawn on the card
    from ``SEED`` (the same weights in every run and process)."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    return GPTNeoX(GPTNeoXConfig.pythia_160m(dtype=torch.bfloat16, max_seq_len=SP_SEQ,
                                             seq_parallel_mode=mode),
                   seed=SEED, draw_on_device=True)


def sp_llama_model():
    """Llama-2-7B's width (N 32, D 128) at 2 layers, bf16, drawn on the card."""
    import torch

    from deeperspeed_tpu_torch.models import Llama, LlamaConfig
    return Llama(LlamaConfig.llama2_7b(num_layers=SP_LLAMA_LAYERS, dtype=torch.bfloat16),
                 seed=SEED)


def _sp_run(torch, dst, model, config, mesh, batch, steps):
    """``steps`` steps of the flat engine at ``mesh``: losses, grad norms,
    host ms a step (ending in the loss's all-reduce), the bytes each op
    staged a step, the peak memory and the launches, and the head counts
    the flash forward saw."""
    from deeperspeed_tpu_torch import comm
    from deeperspeed_tpu_torch.ops.attention import core
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES
    from deeperspeed_tpu_torch.parallel import MeshTopology

    heads, flash = set(), core.flash_attention

    def seen(q, *args, **kwargs):
        heads.add(q.shape[2])
        return flash(q, *args, **kwargs)

    eng = dst.initialize(model=model, config=config, mesh=MeshTopology(**mesh))[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.STAGED.clear()
    LAUNCHES.clear()                                  # main path starts here
    core.flash_attention = seen
    losses, norms, ms = [], [], []
    try:
        for _ in range(steps):
            t = time.perf_counter()
            losses.append(float(eng.train_batch(batch=batch)))
            ms.append((time.perf_counter() - t) * 1e3)
            norms.append(eng.get_global_grad_norm())
    finally:
        core.flash_attention = flash
    rec = {"losses": losses, "norms": norms, "ms": ms, "launches": dict(LAUNCHES),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "staged": {k: v / steps for k, v in comm.STAGED.items()},
           "flash_heads": sorted(heads)}
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sp_worker(rank, rendezvous, out_path):
    """One of the two processes of phase 28 (``--sp-worker``): (a)
    Pythia-160M at seq 2048 at sp 1 (dp 2), then at sp 2 under ``ulysses``
    and ``ring``; (b) Llama-2-7B's width at 2 layers at sp 2 (mode None)
    and at sp 1; writes what it saw as JSON."""
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import comm

    torch.set_num_threads(2)
    dst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                         world_size=SP_WORLD, timeout=600)
    batch = sp_model().example_batch(batch_size=SP_ROWS, seq_len=SP_SEQ, seed=SEED)
    out = {"rank": rank}
    for name, mode, mesh in (("sp1", None, "sp1"), ("ulysses", "ulysses", "sp2"),
                             ("ring", "ring", "sp2")):
        out[name] = _sp_run(torch, dst, sp_model(mode), SP_CONFIG, SP_MESHES[mesh], batch,
                            SP_STEPS)
    lbatch = sp_llama_model().example_batch(batch_size=SP_LLAMA_ROWS, seq_len=SP_SEQ,
                                            seed=SEED)
    for name, mesh in (("llama-sp2", "sp2"), ("llama-sp1", "sp1")):
        out[name] = _sp_run(torch, dst, sp_llama_model(), SP_LLAMA_CONFIG, SP_MESHES[mesh],
                            lbatch, 1)
    Path(out_path).write_text(json.dumps(out))
    comm.destroy()
    return 0


def phase_sequence(torch, np, card):
    """Phase 28: the two ``--sp-worker`` processes (released under phases
    13-14, run beside them): (a) Pythia-160M at seq 2048, bf16, FusedAdam,
    clip 1.0, 4 rows at gas 2, 2 steps, at sp 2 under ``ulysses`` and
    ``ring`` against sp 1 on the same weights and batch (losses within
    ``SP_LOSS_TOL``, grad norms within ``SP_NORM_TOL``; under Ulysses K5-K7
    launch at 6 heads a rank); (b) Llama-2-7B's width at 2 layers (mode
    None: the keys and values gathered, the queries padded to their length,
    K5-K7 on both ranks) at sp 2 against sp 1, one step.  Prints each
    run's ms a step, the bytes its exchanges staged a step and its peak
    memory a rank.  Returns the paths' launches, summed over both ranks."""
    ranks = sorted(_join_dp_workers(_workers("--sp-worker", SP_WORLD)[1]),
                   key=lambda r: r["rank"])
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    norms = ("layer_norm", "layer_norm_bwd")

    def fmt(xs):
        return ", ".join(f"{x:.6f}" for x in xs)

    def held(name, ref):
        r0 = ranks[0]
        for r in ranks[1:]:
            if r[name]["losses"] != r0[name]["losses"]:
                raise AssertionError(f"sp {name}: ranks disagree {r[name]['losses']} vs "
                                     f"{r0[name]['losses']}")
        e = (_rel_max(r0[name]["losses"], r0[ref]["losses"]),
             _rel_max(r0[name]["norms"], r0[ref]["norms"]))
        if e[0] > SP_LOSS_TOL or e[1] > SP_NORM_TOL \
                or not all(math.isfinite(x) for x in r0[name]["losses"]):
            raise AssertionError(f"sp {name}: {r0[name]['losses']} / {r0[name]['norms']} vs "
                                 f"{ref} {r0[ref]['losses']} / {r0[ref]['norms']} (relative "
                                 f"{e[0]:.2e} / {e[1]:.2e}, limits {SP_LOSS_TOL} / "
                                 f"{SP_NORM_TOL})")
        return e

    def line(name, rec, e):
        ms = rec["ms"][1:] or rec["ms"]
        staged = ", ".join(f"{op} {rec['staged'][op] / 1e6:.3f} MB"
                           for op in SP_OPS if rec["staged"].get(op))
        grads = rec["staged"].get("grad_reduce", 0) / 1e6
        return (f"{name}: losses {fmt(rec['losses'])}, grad norms {fmt(rec['norms'])} "
                f"(relative to sp 1 {e[0]:.2e} / {e[1]:.2e}, limits {SP_LOSS_TOL} / "
                f"{SP_NORM_TOL}); "
                f"{sum(ms) / len(ms):.1f} ms/step; staged a step {staged or 'none'}, "
                f"grad_reduce {grads:.3f} MB; peak {rec['peak_gb']:.2f} GB a rank")

    ref = ranks[0]["sp1"]
    print(f"[sp-a] Pythia-160M bf16 at seq {SP_SEQ}, {SP_ROWS} rows, gas {SP_GAS}, "
          f"{SP_WORLD} ranks sharing the card (gloo via host), {card}: sp 1 (dp 2) "
          f"losses {fmt(ref['losses'])}, grad norms {fmt(ref['norms'])}, "
          f"{sum(ref['ms'][1:]) / (len(ref['ms']) - 1):.1f} ms/step, peak "
          f"{ref['peak_gb']:.2f} GB a rank", flush=True)
    for name in ("ulysses", "ring"):
        e = held(name, "sp1")
        for r in ranks:
            need = flash + norms if name == "ulysses" else norms
            missing = [k for k in need + ("fused_adam",) if r[name]["launches"].get(k, 0) < 1]
            if missing:
                raise AssertionError(f"sp {name} rank {r['rank']} never launched {missing}: "
                                     f"{r[name]['launches']}")
        heads = ranks[0][name]["flash_heads"]
        if name == "ulysses" and heads != [6]:
            raise AssertionError(f"sp ulysses: the flash forward saw {heads} heads, not 6")
        print(f"[sp-a] {line(name, ranks[0][name], e)}; flash at {heads or 'no'} heads a "
              f"rank ({card})", flush=True)
    e = held("llama-sp2", "llama-sp1")
    for r in ranks:
        missing = [k for k in flash + ("layer_norm",) if r["llama-sp2"]["launches"].get(k, 0) < 1]
        if missing:
            raise AssertionError(f"sp llama rank {r['rank']} never launched {missing}: "
                                 f"{r['llama-sp2']['launches']}")
    lref = ranks[0]["llama-sp1"]
    print(f"[sp-b] Llama-2-7B width (N 32, D 128) at {SP_LLAMA_LAYERS} layers, bf16, seq "
          f"{SP_SEQ}, {SP_LLAMA_ROWS} rows, one step, mode None: "
          f"{line('sp 2', ranks[0]['llama-sp2'], e)}; sp 1 (dp 2) {lref['ms'][0]:.1f} ms, "
          f"peak {lref['peak_gb']:.2f} GB a rank ({card})", flush=True)
    return {"sp-ulysses": _summed_launches([r["ulysses"] for r in ranks]),
            "sp-ring": _summed_launches([r["ring"] for r in ranks]),
            "sp-llama": _summed_launches([r["llama-sp2"] for r in ranks])}


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
    go = os.environ.get("DST_SMOKE_GO")
    if go and sys.argv[1:2] and sys.argv[1].endswith("-worker") and not _wait_to_run(go):
        return 3
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--wire-worker"]:
        return wire_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--layout-worker"]:
        return layout_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--llama-worker"]:
        return llama_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--moe-worker"]:
        return moe_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--pipe-worker"]:
        return pipe_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--pipe-dp-worker"]:
        return pipe_dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--pipe-tp-worker"]:
        return pipe_tp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--sp-worker"]:
        return sp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    import numpy as np

    from deeperspeed_tpu_torch.ops import cuda_utils

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    import threading

    from deeperspeed_tpu_torch import op_builder

    t0 = time.perf_counter()
    host = {}

    def build_host():       # the host libraries (g++), beside the nvcc processes
        try:
            for builder in (op_builder.CPUAdamBuilder(), op_builder.AsyncIOBuilder()):
                t = time.perf_counter()
                builder.build()
                host[builder.NAME] = time.perf_counter() - t
        except Exception as e:
            host["error"] = e

    thread = threading.Thread(target=build_host)
    thread.start()
    logs = cuda_utils.build()
    thread.join()
    if "error" in host:
        raise host["error"]
    for name, secs in host.items():
        print(f"[build] host {name}: {secs:.1f} s (g++ {' '.join(op_builder.builder.CXX_FLAGS)})",
              flush=True)
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
    hold_workers()
    try:
        return _phases(torch, np, cuda_utils, card, t_start)
    finally:
        stop_held_workers()


def _phases(torch, np, cuda_utils, card, t_start):
    """Phases 3-28 and the summary lines, after the build."""

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[time] {label}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    rows = timed("phase 3", lambda: phase_legacy_kernels(torch, np, phase_quantizer_kernel(
        torch, phase_optimizer_kernels(torch, phase_training_kernels(
            torch, phase_kernels(torch))))))
    timed("phase 22 kernels", phase_llama_kernels, torch, rows)
    timed("phase 4", phase_checked, torch, np)
    L = cuda_utils.LAUNCHES
    # each main path's counts, read right after its own run
    paths = {"serving": timed("phase 5", phase_served, torch, np, L)}
    timed("phase 6", phase_scheduled_checked, torch, np)
    paths["scheduled"] = timed("phase 7", phase_scheduled, torch, np, L)
    timed("phase 8", phase_trained_checked, torch, np)
    paths["training"] = timed("phase 9", phase_trained, torch, L)
    timed("phase 10", phase_fused_checked, torch, np)
    paths["training_fused"], paths["training_fused_lion"] = timed(
        "phase 11", phase_fused_trained, torch, np, L)
    timed("phase 12", phase_dropout, torch, np, L)
    # phase 28's group runs while phases 13-14 wait for their workers
    release_early("--sp-worker")
    dp, dp_ckpt, dp_ranks = timed("phases 13-14", phase_dp, torch, np)
    paths["dp_stage2"], paths["dp_qgz"] = dp["stage2"], dp["qgz-int8"]
    timed("phase 15", phase_legacy_checked, torch, np)
    paths["legacy_layer"] = timed("phase 16", phase_legacy, torch, np, L)
    paths["sparse_attention"] = timed("phase 17", phase_sparse, torch, np, L)
    paths["softmax"] = timed("phase 18", phase_softmax, torch, L)
    # the worker groups of phases 21, 22 (e) and 23 (c) run while phase 19
    # waits on the disk
    release_early("--layout-worker")
    release_early("--llama-worker")
    release_early("--moe-worker")
    release_early("--pipe-worker")
    release_early("--pipe-dp-worker")
    paths["training_resumed"] = timed("phase 19", phase_checkpointed, torch, np, L, card,
                                      dp_ckpt)
    paths["wire_two_level"], paths["wire_deferred"] = timed("phase 20", phase_wire, card,
                                                            *dp_ranks)
    paths["layout_tp"] = timed("phase 21", phase_layout, card, *dp_ranks)
    paths["llama_serving"], paths["llama_v1"] = timed(
        "phase 22 (a), (c)", phase_llama_served, torch, np, L, card)
    paths["llama_window"] = timed("phase 22 (b)", phase_llama_window, torch, np, L, card)
    paths["llama_training"] = timed("phase 22 (d)", phase_llama_trained, torch, np, L, card)
    paths["llama_v1_tp"] = timed("phase 22 (e)", phase_llama_tp, torch, np, card)
    t23 = time.perf_counter()
    timed("phase 23 (a)", phase_moe_checked, torch, np)
    paths["moe_training"] = timed("phase 23 (b)", phase_moe_trained, torch, np, L, card)
    paths["moe_ep"] = timed("phase 23 (c)", phase_moe_ep, torch, np, card)
    paths["moe_serving"] = timed("phase 23 (d)", phase_moe_served, torch, np, L, card)
    print(f"[moe] phase 23 in {time.perf_counter() - t23:.1f} s", flush=True)
    offload, inf = timed("phase 24", phase_offload, torch, np, L, card, dp_ranks)
    paths.update(offload)
    paths.update(timed("phase 25", phase_planners, torch, np, L, card, dp_ranks, inf))
    del inf
    pipe_paths, p26 = timed("phase 26", phase_pipeline, torch, np, card)
    paths.update(pipe_paths)
    paths.update(timed("phase 27", phase_pipe_tp, torch, np, card, p26))
    paths.update(timed("phase 28", phase_sequence, torch, np, card))

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
