"""Ragged inference (FastGen analog) configuration.

Mirrors the reference's ``RaggedInferenceEngineConfig`` /
``DSStateManagerConfig`` key families (``inference/v2/ragged/manager_configs.py``):
tracked-sequence limits, ragged batch budget, and KV-cache geometry.
"""

from typing import Dict

from pydantic import Field

from ...runtime.config_utils import DeeperSpeedConfigModel


class KVCacheConfig(DeeperSpeedConfigModel):
    num_blocks: int = 256
    block_size: int = 64
    # KV pool storage: "" follows the engine dtype; "int8" or "fp8" (e4m3)
    # stores the pool as 1-byte block-scaled values + per-(block-slot, head)
    # fp32 scales (quantize-on-write in the model's scatter, fused dequant
    # inside the decode kernel's online-softmax block walk) -- ~1.9x
    # live-sequence KV capacity per HBM byte vs bf16 (~3.7x vs fp32) at
    # head_dim 64-128; fp8 trades the int8 grid for per-block dynamic range
    dtype: str = ""
    # hash-chained block identity + copy-on-write sharing: identical prompt
    # prefixes (and preempted-then-resumed sequences) reuse physical KV
    # blocks instead of re-prefilling; refcount-0 cached blocks are evicted
    # LRU before any MemoryError
    prefix_cache: bool = True

    @property
    def quantized(self) -> bool:
        return bool(self.dtype)


class SLOClassConfig(DeeperSpeedConfigModel):
    """One service class of the serving front end.  ``deadline_s`` is the
    default end-to-end budget stamped on requests submitted under this
    class; TTFT/TPOT targets drive the lateness-aware admission priority
    (smaller targets sort earlier) and the goodput accounting."""

    ttft_target_s: float = 1.0     # time-to-first-token target
    tpot_target_s: float = 0.2     # time-per-output-token target
    deadline_s: float = 30.0       # default end-to-end deadline


class ResilienceConfig(DeeperSpeedConfigModel):
    """Serving-side robustness policy (front end + scheduler).

    The training-side ``resilience`` block (preemption saves, loss
    sentinel) protects a *run*; this block protects live *traffic*:
    deadlines, overload shedding, a graceful-degradation ladder, and a
    step-failure circuit breaker.  All thresholds are evaluated at
    admission or between rounds -- never mid-decode.
    """

    enabled: bool = True
    # --- deadlines / SLO classes ------------------------------------------
    slo_classes: Dict[str, SLOClassConfig] = {
        "interactive": {"ttft_target_s": 0.5, "tpot_target_s": 0.1,
                        "deadline_s": 10.0},
        "standard": {"ttft_target_s": 2.0, "tpot_target_s": 0.25,
                     "deadline_s": 30.0},
        "batch": {"ttft_target_s": 30.0, "tpot_target_s": 2.0,
                  "deadline_s": 600.0},
    }
    # --- overload shedding (admission-time only) --------------------------
    # reject new work when the queue-delay EWMA crosses this many seconds
    shed_queue_delay_s: float = 5.0
    # ... or when the KV reserve (this fraction of the pool) would be
    # eaten either by current usage (free+evictable below it) or by the
    # worst-case prompt+token-cap footprint of admitted work (growth-
    # aware: sequences decoding toward their cap can't oversubscribe the
    # pool after admission).  <= 0 disables the headroom gate.
    shed_headroom_frac: float = 0.05
    # EWMA smoothing for the queue-delay signal
    queue_delay_alpha: float = 0.3
    # capped-exponential retry-after handed back with a shed response
    retry_after_base_s: float = 0.5
    retry_after_cap_s: float = 30.0
    # uniform +/- fraction of jitter applied to retry-after hints so a
    # burst of shed clients doesn't retry as a thundering herd; the stream
    # is seeded (below) so hint sequences stay reproducible.  0 disables.
    retry_after_jitter_frac: float = 0.25
    retry_after_jitter_seed: int = 0
    # --- degradation ladder ------------------------------------------------
    # stage 1 trigger: allocator pressure (1 - headroom fraction) above this
    degrade_pressure_hi: float = 0.90
    # recovery threshold (hysteresis): step DOWN only below this
    degrade_pressure_lo: float = 0.75
    # stall signal: seconds since the last completed round / heartbeat
    degrade_stall_s: float = 10.0
    # SLO burn pressure (slo.SLOBurnEvaluator signal, >= 1.0 while an
    # alert is active) at or above this escalates the ladder one stage,
    # exactly like allocator pressure / stall; recovery requires it calm
    # (below half).  <= 0 disables the coupling.
    degrade_slo_pressure: float = 1.0
    # consecutive calm evaluations before stepping down one stage
    degrade_recover_rounds: int = 2
    # stage 1 action: prefill chunk shrinks to base // this
    degrade_chunk_divisor: int = 4
    # stage 2 action: evict up to this many cache-only prefix blocks/round
    degrade_evict_blocks: int = 8
    # --- step-failure circuit breaker --------------------------------------
    # requeues (NaN logits / MemoryError inside a round) before quarantine
    max_retries: int = 2
    # bounded requeue backoff between retries of a failed request
    retry_backoff_base_s: float = 0.05
    retry_backoff_cap_s: float = 2.0
    # preemption-requeue cap: beyond this, a livelocked request is loudly
    # surfaced in telemetry (`infer/requeue_cap_exceeded`)
    max_requeues: int = 8


class ReplicaPoolConfig(DeeperSpeedConfigModel):
    """Multi-replica serving pool policy (``replica.RoutingFrontend``).

    One engine's ``ServingFrontend`` survives bad rounds; the pool layer
    survives the *replica*: prefix-affinity routing, a per-replica health
    breaker (healthy -> degraded -> ejected, with probing re-admission),
    transparent in-flight failover, and graceful drain.
    """

    # --- routing -----------------------------------------------------------
    # "affinity": route to the replica whose prefix cache holds the longest
    #   hash-chain match for the prompt, least-loaded on a miss/tie.
    # "least_loaded": ignore caches, balance on committed KV blocks.
    # "random": seeded uniform choice (the bench's control arm).
    routing: str = "affinity"
    routing_seed: int = 0
    # --- health breaker ----------------------------------------------------
    # EWMA smoothing for the per-replica error/slow-round rates
    error_ewma_alpha: float = 0.5
    # degraded (deprioritised for routing) above this error-or-slow rate
    degrade_error_rate: float = 0.25
    # ejected (not routed, in-flight failed over) above this error rate
    eject_error_rate: float = 0.75
    # a round slower than this counts against health as a "slow" round
    slow_round_s: float = 5.0
    # eject a replica whose last successful round is older than this while
    # it still has work (a wedged loop that neither fails nor finishes)
    heartbeat_timeout_s: float = 30.0
    # consecutive clean rounds before a degraded replica recovers
    recover_rounds: int = 4
    # ... or this long idle without new incidents (a degraded replica that
    # is routed around would otherwise never earn its clean rounds)
    recover_idle_s: float = 10.0
    # --- probing re-admission ---------------------------------------------
    # cooldown before probing an ejected replica; grows capped-exponentially
    # with failed probes (and across quick re-ejections: flap damping)
    probe_cooldown_s: float = 1.0
    probe_cooldown_cap_s: float = 30.0
    probe_deadline_s: float = 10.0
    # a re-ejection within this window of re-admission keeps the grown
    # probe backoff instead of resetting it (anti-flap)
    flap_window_s: float = 5.0
    # --- graceful drain ----------------------------------------------------
    # default grace for drain(): in-flight requests that outlive it are
    # migrated to healthy replicas instead of waited on
    drain_grace_s: float = 30.0


class DisaggConfig(DeeperSpeedConfigModel):
    """Disaggregated prefill/decode serving (``disagg.DisaggregatedFrontend``).

    Prefill is compute-bound and decode is KV-bound; this block configures
    the split: a prefill-role engine runs prompts, a ``KVMigrator`` ships
    each finished KV block to the decode-role engine's pool as soon as the
    block FILLS (early issue, so the hop overlaps remaining prefill
    compute), and the decode scheduler's admission is gated until the
    migration lands.  A dropped/corrupt/late migration falls back to
    recomputing the prompt on the decode engine -- correctness never
    depends on the hop.
    """

    enabled: bool = False
    # seconds a gated decode admission waits on in-flight KV transfers
    # before writing the migration off and recomputing the prompt
    migrate_timeout_s: float = 30.0
    # reuse blocks the decode-side prefix cache already holds for the
    # prompt's chain keys instead of importing duplicates
    decode_prefix_reuse: bool = True


class KVTierConfig(DeeperSpeedConfigModel):
    """Host-RAM KV tier below HBM (``kv_tier.HostKVTier``).

    Cache-only prefix blocks that LRU eviction would simply drop are
    spilled to host buffers instead, and swapped back asynchronously
    (issue-ahead ``device_put``, the ``DevicePrefetchingLoader`` idiom) on
    the next ``match_prefix`` that wants them -- multiplying effective
    prefix-cache capacity by ``capacity_blocks / num_blocks`` for long-tail
    shared prefixes.
    """

    enabled: bool = False
    # host-side block budget; the ~10x default of the HBM pool default
    capacity_blocks: int = 2560
    # host-side BYTE budget (0 = unbounded, fall back to capacity_blocks
    # alone).  Accounted in *wire* bytes -- the quantized payload (int8/fp8
    # values + fp32 scales, ``BlockScaledTensor.wire_nbytes``), never an
    # fp32-equivalent -- so an fp8 pool really fits ~4x the blocks in the
    # same host RAM
    capacity_bytes: int = 0
    # blake2b identity check on every restored block; a mismatch (host
    # memory corruption, torn spill) is treated as a cache miss
    verify_digests: bool = True
    # host->device transfers issued ahead of the restore walk (double
    # buffering: block k+1's H2D overlaps block k's pool write)
    prefetch_depth: int = 2


class LongContextConfig(DeeperSpeedConfigModel):
    """Long-context serving (``longctx.LongContextSession``).

    Past the HBM working set, a sequence's *cold* middle KV blocks --
    distant from BOTH the prompt prefix (attention-sink blocks) and the
    decode head (recency window) -- spill to the :class:`HostKVTier` and
    stream back per layer as bounded segments during the block walk, with
    issue-ahead ``device_put`` (``kv_tier.prefetch_depth``) hiding the
    restore under the previous segment's partial-attention compute.  HBM
    stays pinned at ``(hot_prefix + hot_recent + chunk) * block_size``
    tokens while context grows.
    """

    enabled: bool = False
    # full blocks at the start of the sequence that never spill (the
    # attention-sink prefix every decode step re-reads)
    hot_prefix_blocks: int = 2
    # trailing blocks kept resident behind the decode head (the recency
    # window; the block leaving it is the next spill victim)
    hot_recent_blocks: int = 4
    # spilled blocks streamed per partial-attention pass (the segment
    # granularity of the per-layer block walk)
    segment_blocks: int = 4
    # tokens per layerwise chunked-prefill pass (rounded to block_size)
    prefill_chunk_tokens: int = 256


class FabricConfig(DeeperSpeedConfigModel):
    """Cross-host serving fabric (``fabric.py`` over ``wire_proto.py``).

    The transport seam that lets the replica pool and the disaggregated
    prefill/decode pair span real process boundaries: control plane
    (submit/stream/cancel), KV migration frames and peer weight fetches
    all travel as version-tagged checksummed frames.  Health is a
    heartbeat/gossip protocol -- a peer not heard from within
    ``staleness_s`` is ejected and its in-flight work replays from the
    client-side tickets, which survive the dead process.
    """

    enabled: bool = False
    # "loopback": deterministic in-process channel pair (tier-1 tests and
    # benches exercise the FULL encode/decode path through it);
    # "socket": length-prefixed frames over real sockets
    transport: str = "loopback"
    # seconds between heartbeat frames a replica host emits while pumped
    heartbeat_interval_s: float = 0.05
    # gossip staleness window: a peer silent for this long is presumed
    # dead -- ejected (cause "gossip_stale"), in-flight work failed over
    staleness_s: float = 2.0
    # seconds between gossip last-seen-map broadcasts from the router
    gossip_interval_s: float = 0.5
    # peer weight fetch / audit RPC budget
    rpc_timeout_s: float = 30.0
    # piggyback the host's telemetry-registry snapshot on heartbeats (an
    # optional control-frame key -- no wire version change) so the pool
    # aggregator can fold a pool-global metrics view
    metrics_in_heartbeat: bool = True
    # minimum seconds between successive snapshots from one host (0.0:
    # every heartbeat carries one)
    metrics_interval_s: float = 0.0


class TenantClassConfig(DeeperSpeedConfigModel):
    """One tenant class of the multi-tenant admission layer.

    ``weight`` drives start-time fair queuing (a tenant with weight 4 is
    admitted 4x the virtual-time share of a weight-1 tenant), the token
    bucket meters admission cost (prompt + decode-cap tokens) per wall
    second, and ``tier`` picks the preemption role: ``latency`` tenants may
    trigger preemption near their deadline, ``best_effort`` decodes are the
    eviction victims (rolled back through the COW path), ``standard`` is
    neither.
    """

    weight: float = 1.0
    # sustained admission rate in tokens/s; <= 0 means unmetered
    rate_tokens_per_s: float = 0.0
    # bucket depth in tokens (burst allowance); a single request costing
    # more than the burst is admitted only from a FULL bucket (overdraft)
    # so oversize requests are delayed, never starved forever
    burst_tokens: float = 0.0
    tier: str = "standard"     # "latency" | "standard" | "best_effort"


class TenantsConfig(DeeperSpeedConfigModel):
    """Multi-tenant admission: per-tenant token-bucket quotas + weighted
    fair-share ordering layered on the EDF queue (``elastic.TenantAdmission``
    wired through ``frontend.ServingFrontend``).

    Requests carry a ``tenant`` label; unknown labels (and ``None``) map to
    ``default_tenant`` with an implicit unmetered weight-1 class, so probes
    and single-tenant callers are never throttled by accident.
    """

    enabled: bool = False
    classes: Dict[str, TenantClassConfig] = {}
    default_tenant: str = "default"
    # a waiting latency-tier request whose deadline is closer than this
    # margin (and which no longer fits in free KV) triggers preemption of
    # live best-effort decodes
    preempt_margin_s: float = 1.0
    # eviction budget per scheduling round (bounds rollback churn)
    max_preemptions_per_round: int = 1


class AutoscaleConfig(DeeperSpeedConfigModel):
    """Elastic pool sizing (``elastic.AutoscalingPool``).

    The controller watches a per-replica pressure signal (queue depth plus
    shed-rate, the Poisson-bench load signals) each pump round; sustained
    breach of the high watermark scales OUT (warm bring-up: peer weight
    fetch, workload-bucket ``warmup``, only then ROUTABLE) and sustained
    calm below the low watermark scales IN via graceful ``drain``.  The
    hysteresis (breach/calm round counts, cooldown, flap window) reuses the
    pool's flap-damping math so the controller cannot oscillate: a
    direction reversal inside ``flap_window_s`` is suppressed and counted,
    never executed.
    """

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    # pressure = (queue depth + shed_pressure * shed-rate EWMA) / routable
    high_watermark: float = 4.0
    low_watermark: float = 0.5
    shed_pressure: float = 1.0
    # EWMA smoothing for the per-round shed count: sheds arrive in bursts
    # at admission time, and an unsmoothed spike can never sustain a
    # breach streak across the rounds between bursts
    pressure_alpha: float = 0.3
    # consecutive breach/calm observations required before acting
    breach_rounds: int = 3
    calm_rounds: int = 10
    # minimum seconds between any two scaling actions
    cooldown_s: float = 5.0
    # a direction reversal within this window of the last action is a flap:
    # suppressed (and the triggering streak reset), never executed
    flap_window_s: float = 10.0
    # weight of the SLO burn-rate pressure signal (slo.SLOBurnEvaluator,
    # surfaced by the fabric frontend) added on top of queue pressure --
    # a pool burning its latency budget scales out even when the queue
    # alone would not breach the watermark.  0 disables the coupling.
    slo_pressure_weight: float = 1.0


class DeployConfig(DeeperSpeedConfigModel):
    """Zero-downtime rolling weight hot-swap (``deploy.RollingUpdater``).

    A rotation walks the pool one replica at a time: graceful ``drain``,
    digest-verified weight stream from a donor holding the target
    :class:`~.deploy.WeightVersion` (transactional -- a torn or tampered
    stream leaves the serving weights untouched), workload-bucket
    ``warmup``, a shadow-traffic canary (recently recorded live requests
    replayed greedily against the updated replica AND a current-version
    reference, outputs diffed), and only then ``readmit``.  Divergence
    beyond ``divergence_budget`` rolls the replica back bit-exactly to the
    old version, streamed from an old-version peer, and aborts the
    rotation.

    Opt-in like ``fabric``/``autoscale``: the updater is constructed
    explicitly; this block carries its policy.
    """

    enabled: bool = False
    # grace handed to drain() before in-flight work migrates off the
    # replica being rotated
    drain_grace_s: float = 30.0
    # capped-exponential backoff between retries of a TRANSIENT stream
    # failure (donor death, closed channel); a digest rejection is
    # tampering, not a transient, and aborts immediately
    stream_retry_base_s: float = 0.2
    stream_retry_cap_s: float = 5.0
    max_stream_attempts: int = 4
    # shadow canary: how many recently recorded requests to replay (the
    # newest closed root "request" spans from the trace recorder), and the
    # per-request decode budget cap for the replay
    canary_requests: int = 4
    canary_max_new_tokens: int = 8
    canary_deadline_s: float = 60.0
    # fraction of canary replays whose greedy outputs may differ from the
    # current-version reference before the updater rolls back.  0.0 is the
    # bit-exact default (same-weights redeploys, config-only rotations);
    # a genuinely new checkpoint states its tolerated divergence here.
    divergence_budget: float = 0.0


class SLOBurnConfig(DeeperSpeedConfigModel):
    """Multi-window SLO burn-rate alerting (``telemetry/slo.py``).

    The pool aggregator windows per-host latency-histogram deltas; the
    evaluator compares each window's violating fraction against the error
    budget ``1 - objective`` and alerts when the budget burns
    ``fast_burn``x too fast over the fast window (the slow window then
    confirms or the alert clears with hysteresis).

    Opt-in (like ``fabric`` / ``autoscale``): the objective below must be
    stated against the deployment's real latency floor -- a default-on
    evaluator would page every cold-start CPU test run.
    """

    enabled: bool = False
    # latency channel the objective is stated over
    metric: str = "infer/ttft_s"
    # "``objective`` of requests finish ``metric`` under ``target_s``"
    target_s: float = 0.5
    objective: float = 0.95
    # SRE window pairing: fast window pages, slow window confirms
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 6.0
    slow_burn: float = 3.0
    # consecutive calm evaluations (burn under half threshold) to clear
    clear_rounds: int = 3
    # cap on the slo_pressure signal handed to autoscaler / shed ladder
    max_pressure: float = 4.0


class SamplingConfig(DeeperSpeedConfigModel):
    """On-device token selection, executed INSIDE the compiled ragged step.

    These knobs are static -- they pick a jit variant of the step, they are
    not traced data -- while the PRNG stream advances as traced data each
    round (no recompiles).  ``temperature <= 0`` is greedy argmax, the
    parity-critical default: speculative decoding is asserted bit-exact
    against non-speculative decoding under it.
    """

    temperature: float = 0.0
    top_k: int = 0        # <= 0 disables the top-k filter
    top_p: float = 1.0    # >= 1 disables nucleus filtering
    seed: int = 0         # base of the per-round PRNG stream

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class SpeculativeConfig(DeeperSpeedConfigModel):
    """Speculative decoding: >1 token per one-dispatch scheduling round.

    ``method: "ngram"`` is self-speculation -- a host-side prompt-lookup
    drafter (no draft model) proposes up to ``k`` tokens per sequence per
    round; the drafts ride as a length-(k+1) row of the SAME fused ragged
    step, so verifying all k costs one dispatch.  ``method: "draft"``
    plugs an external draft callable into the same verify/accept machinery
    (see ``speculative.CallableDrafter``).  Rollback is the COW block fork:
    rejected draft-tail blocks drop to refcount 0 and are freed, no KV
    rewind.
    """

    method: str = ""           # "" (off) | "ngram" | "draft"
    k: int = 4                 # max drafted tokens per sequence per round
    # prompt-lookup window: match the longest suffix n-gram of length
    # ngram_max down to ngram_min against the sequence's own history
    ngram_max: int = 3
    ngram_min: int = 1
    # governor: EMA accept rate below the floor for `floor_patience`
    # consecutive speculative rounds degrades to k=0 (plain decoding) with
    # a rank-0 warning; after `floor_cooldown` rounds speculation re-probes
    accept_rate_floor: float = 0.1
    floor_patience: int = 8
    floor_cooldown: int = 64
    accept_rate_alpha: float = 0.2   # EMA smoothing of the accept rate

    @property
    def enabled(self) -> bool:
        return self.method in ("ngram", "draft") and self.k > 0


class DSStateManagerConfig(DeeperSpeedConfigModel):
    max_tracked_sequences: int = 2048
    max_ragged_batch_size: int = 768
    max_ragged_sequence_count: int = 512
    max_context: int = 8192
    # decode sequences the scheduler packs per round (policy knob; since the
    # one-dispatch engine runs decodes as length-1 rows of the shared ragged
    # step, this no longer pins a separate compiled width)
    max_decode_batch: int = 64


class RaggedInferenceEngineConfig(DeeperSpeedConfigModel):
    state_manager: DSStateManagerConfig = Field(default_factory=DSStateManagerConfig)
    kv_cache: KVCacheConfig = Field(default_factory=KVCacheConfig)
    resilience: ResilienceConfig = Field(default_factory=ResilienceConfig)
    speculative: SpeculativeConfig = Field(default_factory=SpeculativeConfig)
    sampling: SamplingConfig = Field(default_factory=SamplingConfig)
    replica_pool: ReplicaPoolConfig = Field(default_factory=ReplicaPoolConfig)
    disagg: DisaggConfig = Field(default_factory=DisaggConfig)
    kv_tier: KVTierConfig = Field(default_factory=KVTierConfig)
    longctx: LongContextConfig = Field(default_factory=LongContextConfig)
    fabric: FabricConfig = Field(default_factory=FabricConfig)
    tenants: TenantsConfig = Field(default_factory=TenantsConfig)
    autoscale: AutoscaleConfig = Field(default_factory=AutoscaleConfig)
    slo_burn: SLOBurnConfig = Field(default_factory=SLOBurnConfig)
    deploy: DeployConfig = Field(default_factory=DeployConfig)
    dtype: str = "bfloat16"
    tp_size: int = 1

    @property
    def torch_dtype(self):
        import torch

        aliases = {"half": "float16", "fp16": "float16", "bf16": "bfloat16",
                   "float": "float32", "fp32": "float32"}
        name = str(self.dtype).replace("torch.", "")
        name = aliases.get(name, name)
        if name not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unsupported engine dtype {self.dtype!r}")
        return getattr(torch, name)
