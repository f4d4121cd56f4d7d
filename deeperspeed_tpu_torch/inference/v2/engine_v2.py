"""InferenceEngineV2: continuous batching over a paged KV cache (counterpart
of ``deeperspeed_tpu/inference/v2/engine_v2.py``).

``put_round(uids, tokens)`` runs one scheduling round: new sequences
prefill, live ones decode, all as rows of one ragged ``[n_pad, s_pad]``
batch through the model's paged forward (any model with the paged
protocol: ``models.GPTNeoX``, with MoE blocks too, ``models.Llama`` and
its Mistral and OPT presets), and the next token of every row is chosen on
the device.  An MoE block routes every token of the ragged batch, padding
included, with its evaluation capacity; serve it with no-drop gating
(``moe_drop_tokens=False``), as the JAX package's test does, since the
capacity follows the batch's shape.  The host computes only block tables
(``DSStateManager`` + ``BlockedAllocator``).

* The KV pools are one [num_blocks, block_size, N_kv, D] pair per layer
  (N_kv the model's ``num_kv_heads``, its ``num_heads`` without one),
  owned by the engine and updated in place by the model; with
  ``kv_cache.dtype`` "int8" or "fp8" they hold 1-byte payload and each has
  an fp32 scale pool [num_blocks, block_size, N] beside it.
* Rows are padded to power-of-two buckets exactly as in the JAX package
  (``_round_buckets``): the bucket ``s_pad``, not a row's real length,
  picks the attention route, so the same rounds take the same kernels.
* Copy-on-write prefix sharing: the state manager queues (src, dst) block
  copies when a write would touch a shared block; the round applies them
  to every pool before the forward writes any KV.

Not ported yet: tensor parallelism, the host KV tier, KV block
export/import and long-context serving.
"""

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.gpt_neox import SPEC_DECODE_WINDOW
from ...ops.quantizer import byte_view
from ...ops.sampling import sample_tokens, verify_draft
from ...quantization import canonical_dtype, wire_dtype
from ...telemetry import get_registry
from ...telemetry import serving as serving_events
from ...telemetry.registry import LATENCY_BUCKETS_S
from ...telemetry.trace import get_tracer
from ...utils.logging import log_dist
from .config import RaggedInferenceEngineConfig
from .ragged_manager import DSStateManager

def _pow2_bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class RoundOutputs:
    """Everything a scheduling round produced, sampled on the device.

    ``tokens[row]`` holds the model's chosen token at each of the R scored
    trailing positions; with dk drafts right-aligned at offset
    ``offs = R - 1 - dk``, the row's NEW tokens are
    ``tokens[row, offs : offs + accepted + 1]``, which ``emitted(row)``
    slices.  ``finite`` flags rows whose logits are all finite.  ``logits``
    is the last position's logits, a device tensor [n_pad, vocab] fp32 that
    only ``put()`` and tests bring to the host.
    """

    uids: List
    tokens: np.ndarray       # [n, R] int32
    accepted: np.ndarray     # [n] int32, accepted-draft count per row
    draft_lens: np.ndarray   # [n] int32
    finite: np.ndarray       # [n] bool
    R: int
    logits: object = None    # device [n_pad, vocab] f32

    def emitted(self, row: int) -> np.ndarray:
        dk = int(self.draft_lens[row])
        a = min(int(self.accepted[row]), dk)
        offs = self.R - 1 - dk
        return self.tokens[row, offs:offs + a + 1]


def _round_seam(batch_uids, outputs):
    """Fault-injection seam on the scheduling round: a test or a fault
    harness patches this module attribute to simulate a slow step,
    non-finite logits, forced draft rejection, or an out-of-memory error
    inside a round.  Receives and returns :class:`RoundOutputs`; the
    production path is an identity passthrough."""
    return outputs


class InferenceEngineV2:
    """Paged continuous-batching engine over a model with the paged
    protocol (:class:`GPTNeoX`, :class:`Llama`): ``forward(input_ids,
    positions=, paged_state=, logits_positions=)``, ``set_dtype`` and a
    ``config`` with ``num_layers``, ``num_heads`` (``num_kv_heads``) and
    ``head_dim``.

    ``model`` is taken over: moved to ``device`` (CUDA unless the caller
    passes ``device="cpu"``) and cast to the config's dtype.  ``params``, a
    state dict such as the model family's ``params_from_jax`` returns,
    replaces its weights when given.  Sampling noise comes from a
    ``torch.Generator`` seeded with ``config.sampling.seed``.
    """

    def __init__(self, model, config=None, params=None, device=None):
        if config is None:
            config = RaggedInferenceEngineConfig()
        elif isinstance(config, dict):
            config = RaggedInferenceEngineConfig(**config)
        self.config = config
        if config.tp_size > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp_size > 1) is not ported yet")
        if config.kv_tier.enabled:
            raise NotImplementedError("the host KV tier is not ported yet")
        if config.kv_cache.quantized and canonical_dtype(
                config.kv_cache.dtype) not in ("int8", "fp8_e4m3"):
            raise NotImplementedError(
                f"kv_cache.dtype {config.kv_cache.dtype!r}: the paged "
                "attention kernels take int8 and fp8 (e4m3) pools; e5m2 "
                "pools are not ported")
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params)
        self.module = model.to(self.device).set_dtype(config.torch_dtype)
        self.module.eval()

        self.state_manager = DSStateManager(config)
        self._max_blocks = self.state_manager.max_blocks_per_seq
        self.kv_cache = self._init_cache()
        self._sample_gen = torch.Generator(device=self.device).manual_seed(
            config.sampling.seed)
        self.dispatch_count = 0
        self.redundant_flush_count = 0
        self._kv_bytes_recorded = False

        n = sum(p.numel() for p in self.module.parameters())
        log_dist(
            f"InferenceEngineV2: {n/1e6:.1f}M params | blocks="
            f"{config.kv_cache.num_blocks}x{config.kv_cache.block_size}"
            f"{' ' + config.kv_cache.dtype if config.kv_cache.quantized else ''}"
            f" | {self.device}", ranks=[0])

    def _init_cache(self):
        mc = self.module.config
        # pools at the KV heads: grouped-query attention stores num_kv_heads
        shape = (self.config.kv_cache.num_blocks, self.config.kv_cache.block_size,
                 getattr(mc, "num_kv_heads", mc.num_heads), mc.head_dim)
        kvc = self.config.kv_cache

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if not kvc.quantized:
            return [(zeros(shape, mc.dtype), zeros(shape, mc.dtype))
                    for _ in range(mc.num_layers)]
        # 1-byte payload pools + per-(slot, head) fp32 scale pools
        pool = wire_dtype(kvc.dtype)
        return [(zeros(shape, pool), zeros(shape, pool),
                 zeros(shape[:3], torch.float32),
                 zeros(shape[:3], torch.float32))
                for _ in range(mc.num_layers)]

    # --------------------------------------------------------------- the step
    @torch.no_grad()
    def _step(self, tokens, starts, lengths, tables, copies, draft_tokens,
              draft_lens, r_pad):
        """One forward for a whole scheduling round -- prefills, extends,
        decodes (length-1 rows) and speculative rows together -- followed
        by token choice and draft verification on the device."""
        if copies:
            # copy-on-write block copies first; sources are read before any
            # destination is written (index_select makes the copy); payload
            # and scale pools alike
            src = torch.tensor([s for s, _ in copies], device=self.device)
            dst = torch.tensor([d for _, d in copies], device=self.device)
            for pool in (byte_view(p) for layer in self.kv_cache for p in layer):
                pool.index_copy_(0, dst, pool.index_select(0, src))
        s_pad = tokens.shape[1]
        cols = torch.arange(s_pad, dtype=torch.int32, device=self.device)
        positions = starts[:, None] + cols[None]                    # [n, S]
        write_mask = cols[None] < lengths[:, None]                  # [n, S]
        # ragged logits gather: the head projects only each row's r_pad
        # trailing real tokens
        last = (lengths - 1).clamp(min=0)
        gather = (last[:, None] - (r_pad - 1)
                  + torch.arange(r_pad, device=self.device)[None]).clamp(min=0)
        logits = self.module(
            tokens, positions=positions,
            paged_state={"kv_cache": self.kv_cache, "block_tables": tables,
                         "write_mask": write_mask},
            logits_positions=gather).to(torch.float32)              # [n, R, V]
        finite = torch.isfinite(logits).all(dim=2).all(dim=1)
        sc = self.config.sampling
        chosen = sample_tokens(logits, self._sample_gen,
                               temperature=sc.temperature, top_k=sc.top_k,
                               top_p=sc.top_p)
        accepted = verify_draft(chosen, draft_tokens, draft_lens)
        return chosen, accepted, finite, logits[:, -1]

    def _round_buckets(self, n_seqs: int, max_len: int,
                       max_draft: int = 0) -> Tuple[int, int, int]:
        """A pure-decode round buckets to s_pad == 1 (the paged-decode
        kernel); rounds of short rows to pow-2 lengths <= SPEC_DECODE_WINDOW
        (the speculative-decode kernel); prefill rounds pad length to a
        pow-2 >= 16.  r_pad is the verify width: pow2(max drafts + 1)."""
        n_pad = _pow2_bucket(n_seqs, lo=1)
        if max_len == 1:
            s_pad = 1
        elif max_len <= SPEC_DECODE_WINDOW:
            s_pad = _pow2_bucket(max_len, lo=2)
        else:
            s_pad = _pow2_bucket(max_len)
        r_pad = _pow2_bucket(max_draft + 1, lo=1)
        return n_pad, s_pad, r_pad

    def warmup(self, buckets: Optional[Sequence[Tuple]] = None):
        """Validate and return the pow-2 buckets of ``buckets``
        ((sequence-count, max-chunk-length[, max-drafts]) tuples); the
        default is the pure-decode round at full decode width and a
        full-budget prefill round.  PyTorch runs eagerly, so there is
        nothing to precompile."""
        smc = self.config.state_manager
        if buckets is None:
            buckets = [
                (smc.max_decode_batch, 1, 0),
                (min(smc.max_ragged_sequence_count, smc.max_decode_batch),
                 smc.max_ragged_batch_size, 0),
            ]
        seen = []
        for b in buckets:
            n, s, dk = b if len(b) == 3 else (b[0], b[1], 0)
            if int(n) < 1 or int(s) < 1 or int(dk) < 0:
                raise ValueError(f"invalid warmup bucket {b}")
            key = self._round_buckets(int(n), int(s), int(dk))
            if key not in seen:
                seen.append(key)
        return seen

    # ------------------------------------------------------------- public API
    def put_round(self, batch_uids: List, batch_tokens: List,
                  batch_drafts: Optional[List] = None) -> RoundOutputs:
        """Schedule a ragged batch: one forward for the whole round, with
        token choice and draft verification on the device.

        ``batch_tokens[i]`` are the tokens to feed for uid i (a prompt
        chunk, or the single last-accepted token of a decode);
        ``batch_drafts[i]`` (optional) appends up to k speculated
        continuation tokens to that row.  The engine commits exactly the
        fed tokens whose KV is valid (``fed - dk + accepted``) and releases
        the never-committed draft tail blocks.  Row i of the returned
        :class:`RoundOutputs` corresponds to input i.
        """
        if len(batch_uids) != len(batch_tokens):
            raise ValueError("batch_uids and batch_tokens differ in length")
        t_start = time.perf_counter()
        sm = self.state_manager
        smc = self.config.state_manager
        if batch_drafts is None:
            batch_drafts = [None] * len(batch_uids)
        if len(batch_drafts) != len(batch_uids):
            raise ValueError("batch_drafts and batch_uids differ in length")

        ops, n_decodes, total_tokens, max_len, max_dk = [], 0, 0, 1, 0
        for uid, toks, draft in zip(batch_uids, batch_tokens, batch_drafts):
            toks = np.asarray(toks, np.int32).reshape(-1)
            if toks.size == 0:
                raise ValueError(f"empty token list for uid {uid}")
            draft = (np.asarray(draft, np.int32).reshape(-1)
                     if draft is not None else np.zeros((0,), np.int32))
            dk = int(draft.size)
            if dk:
                # drafts ride as ordinary fed tokens of the same row
                toks = np.concatenate([toks, draft])
            total_tokens += toks.size
            max_len = max(max_len, toks.size)
            max_dk = max(max_dk, dk)
            # a decode is a row whose sequence already has KV landed
            if sm.known(uid) and toks.size - dk == 1 \
                    and sm.get_sequence(uid).seen_tokens > 0:
                n_decodes += 1
            ops.append((uid, toks, dk))

        # validate the whole batch BEFORE mutating any sequence state, so a
        # rejected put can be retried without corrupting seen_tokens/blocks
        if len(batch_uids) > smc.max_ragged_sequence_count:
            raise ValueError(
                f"{len(batch_uids)} sequences exceed max_ragged_sequence_count="
                f"{smc.max_ragged_sequence_count}")
        if total_tokens > smc.max_ragged_batch_size:
            raise ValueError(
                f"{total_tokens} tokens exceed max_ragged_batch_size="
                f"{smc.max_ragged_batch_size}")
        sm.validate_batch([(uid, toks.size) for uid, toks, _ in ops])

        n_pad, s_pad, r_pad = self._round_buckets(len(ops), max_len, max_dk)
        tokens = np.zeros((n_pad, s_pad), np.int64)
        starts = np.zeros((n_pad,), np.int32)
        lengths = np.zeros((n_pad,), np.int32)
        tables = np.zeros((n_pad, self._max_blocks), np.int32)
        draft_tokens = np.zeros((n_pad, r_pad - 1), np.int32)
        draft_lens = np.zeros((n_pad,), np.int32)
        for row, (uid, toks, dk) in enumerate(ops):
            seq = sm.extend(uid, toks.size)
            tokens[row, :toks.size] = toks
            starts[row] = seq.seen_tokens
            lengths[row] = toks.size
            tables[row] = sm.block_table(uid, pad_to=self._max_blocks)
            if dk:
                # right-aligned so the verifier's cumulative-prefix trick
                # works on ragged draft counts (left pad = vacuous match)
                draft_tokens[row, r_pad - 1 - dk:r_pad - 1] = toks[-dk:]
                draft_lens[row] = dk
        copies = sm.take_pending_copies()
        if len(copies) > n_pad:
            raise RuntimeError(
                f"{len(copies)} pending COW copies exceed the round's "
                f"{n_pad} rows")

        dev = self.device
        chosen, accepted, finite, last_logits = self._step(
            torch.from_numpy(tokens).to(dev), torch.from_numpy(starts).to(dev),
            torch.from_numpy(lengths).to(dev), torch.from_numpy(tables).to(dev),
            copies, torch.from_numpy(draft_tokens).to(dev),
            torch.from_numpy(draft_lens).to(dev), r_pad)
        self.dispatch_count += 1
        outputs = RoundOutputs(
            uids=list(batch_uids),
            tokens=chosen.cpu().numpy()[:len(ops)],
            accepted=accepted.cpu().numpy()[:len(ops)],
            draft_lens=draft_lens[:len(ops)].copy(),
            finite=finite.cpu().numpy()[:len(ops)],
            R=r_pad,
            logits=last_logits)
        # fault seam (identity in production): may delay, corrupt, or raise
        # -- before commit_tokens, so an injected round failure leaves
        # sequence bookkeeping exactly as a real device fault would
        outputs = _round_seam(batch_uids, outputs)

        drafted_total, accepted_total, emitted_total = 0, 0, 0
        for row, (uid, toks, dk) in enumerate(ops):
            a = min(int(outputs.accepted[row]), dk)
            # fed tokens whose KV is valid: everything up to the last
            # accepted draft; rejected drafts' tokens are not committed
            sm.commit_tokens(uid, toks[:toks.size - dk + a])
            if dk:
                # rejection = drop the forked tail: blocks wholly beyond
                # the committed range free at refcount 0
                sm.rollback_draft_tail(uid)
                drafted_total += dk
                accepted_total += a
            emitted_total += a + 1

        reg = get_registry()
        tracer = get_tracer()
        if tracer.enabled:
            # engine-side round span: one record per ragged round, on the
            # engine's own lane (requests' per-round spans live with the
            # scheduler, which knows their TraceContexts)
            tracer.record_span(
                "engine_round", "engine",
                dur_s=time.perf_counter() - t_start,
                n_seqs=len(ops), n_tokens=int(total_tokens),
                decodes=n_decodes, dispatch=self.dispatch_count - 1)
        if reg.enabled:
            # .cpu() above already waited for the round, so the wall time
            # covers it all
            dt = time.perf_counter() - t_start
            reg.counter("inference/tokens_total").inc(total_tokens)
            reg.scalar("inference/tokens_per_sec").record(
                total_tokens / max(dt, 1e-9))
            reg.histogram("inference/put_latency_s",
                          buckets=LATENCY_BUCKETS_S).observe(
                dt, extends=len(ops) - n_decodes, decodes=n_decodes)
            reg.counter("infer/dispatches").inc()
            serving_events.emit_speculation(drafted_total, accepted_total,
                                            emitted_total, len(ops))
            alloc = sm.allocator
            reg.scalar("infer/cache_util").record(
                alloc.allocated_blocks / alloc.total_blocks)
            if not self._kv_bytes_recorded:
                self._kv_bytes_recorded = True
                reg.scalar("infer/kv_bytes").record(
                    float(self.kv_pool_bytes),
                    dtype=self.config.kv_cache.dtype or self.config.dtype)
        return outputs

    def put(self, batch_uids: List, batch_tokens: List) -> np.ndarray:
        """Schedule a ragged batch; returns next-token logits [n, vocab]
        (fp32, on the host) in input order.  Compat wrapper over
        :meth:`put_round`, whose tokens avoid the logits round trip."""
        out = self.put_round(batch_uids, batch_tokens)
        return out.logits[:len(batch_uids)].cpu().numpy()

    @property
    def kv_pool_bytes(self) -> int:
        """Total bytes of the KV pools (payload + scales, all layers)."""
        return sum(p.numel() * p.element_size()
                   for layer in self.kv_cache for p in layer)

    def flush(self, uid) -> bool:
        """Free a finished sequence.  Idempotent: an unknown or already
        flushed uid is a counted no-op.  Returns whether a tracked sequence
        was released."""
        if not self.state_manager.known(uid):
            self.redundant_flush_count += 1
            reg = get_registry()
            if reg.enabled:
                reg.counter("infer/redundant_flush").inc(uid=str(uid))
            return False
        self.state_manager.flush_sequence(uid)
        return True

    @property
    def free_blocks(self) -> int:
        return self.state_manager.allocator.free_blocks

    # ------------------------------------------------------------ convenience
    def generate(self, prompts: List[np.ndarray], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 drafter=None) -> List[np.ndarray]:
        """Continuous-batching loop over ``put_round``: all prompts prefill
        in one round, then every live sequence decodes one token a round
        (more with a ``drafter`` proposing speculative tokens)."""
        spec_k = self.config.speculative.k if drafter is not None else 0
        uids = list(range(len(prompts)))
        outs = [list(int(t) for t in np.asarray(p).reshape(-1))
                for p in prompts]
        live = set(uids)
        out = self.put_round(uids, prompts)
        nxt = {}
        for i, u in enumerate(uids):
            tok = int(out.tokens[i, -1])
            outs[u].append(tok)
            nxt[u] = tok
            if eos_token_id is not None and tok == eos_token_id:
                live.discard(u)
        done = {u: len(outs[u]) - len(np.asarray(prompts[u]).reshape(-1))
                for u in uids}
        while live and any(done[u] < max_new_tokens for u in live):
            batch = sorted(live)
            drafts = [drafter.propose(outs[u], spec_k) if drafter else None
                      for u in batch]
            out = self.put_round(batch, [[nxt[u]] for u in batch], drafts)
            for i, u in enumerate(batch):
                for tok in (int(t) for t in out.emitted(i)):
                    outs[u].append(tok)
                    nxt[u] = tok
                    done[u] += 1
                    if (eos_token_id is not None and tok == eos_token_id) \
                            or done[u] >= max_new_tokens:
                        live.discard(u)
                        break
        for u in uids:
            self.flush(u)
        return [np.asarray(o, np.int32) for o in outs]
