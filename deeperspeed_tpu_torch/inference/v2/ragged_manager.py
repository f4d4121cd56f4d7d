"""Sequence state tracking for continuous batching, with prefix caching.

Equivalent of reference ``inference/v2/ragged/ragged_manager.py:19``
(``DSStateManager``) + ``sequence_descriptor.py``: tracks each live sequence's
uid, token count, and KV-block allocation, and hands out block tables for the
compiled steps.

Prefix caching (vLLM-style hash-chained block identity): every FULL block of
a sequence's committed token history has a content key -- the rolling hash of
(parent block key, this block's token ids) -- so identical prompt prefixes
map to identical key chains regardless of which sequence computed them.
Published blocks live in :class:`PrefixCache` (key -> physical block id, LRU
ordered) holding one reference each; ``match_prefix`` walks a new prompt's
key chain and attaches every already-resident block to the new sequence
(incref, no prefill compute), and refcount-1 (cache-only) blocks are evicted
LRU-first when the allocator would otherwise raise ``MemoryError``.

Copy-on-write: a sequence never writes KV into a block another owner can
see.  ``extend`` detects writes that would land in a shared block (refcount
> 1 -- e.g. the recompute token of a fully-matched prompt, whose last block
is shared), allocates a private replacement, and queues a ``(src, dst)``
device copy that the engine's next compiled step applies to every KV pool
before its scatter.
"""

import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ...telemetry import get_registry
from .blocked_allocator import BlockedAllocator


def chain_key(parent_key: bytes, tokens) -> bytes:
    """Rolling content key of one KV block: hash(parent chain, token ids).

    Position dependence is implicit -- the chain length IS the block index,
    so the same tokens at a different depth hash differently."""
    h = hashlib.blake2b(parent_key, digest_size=16)
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


class PrefixCache:
    """Content-keyed index of resident full KV blocks (LRU ordered).

    The cache itself holds ONE reference on every published block, so a
    block outlives the sequence that computed it: after ``flush_sequence``
    its refcount drops to the cache's 1 and it becomes evictable, but its
    KV stays valid for future ``match_prefix`` hits (the preempt-resume
    path) until LRU eviction reclaims it."""

    def __init__(self, allocator: BlockedAllocator):
        self.allocator = allocator
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  # key->block
        self.hits = 0
        self.evictions = 0
        # host-tier spill hook, called as spill_hook(key, block) just
        # before an evicted cache-only entry drops -- the block is still
        # allocated and its KV still resident at call time.  Best effort: a
        # raising hook is swallowed (counted) so eviction ALWAYS reclaims.
        self.spill_hook = None
        self.spill_errors = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: bytes) -> Optional[int]:
        """Block id for ``key`` (refreshes LRU recency), or None."""
        block = self._entries.get(key)
        if block is not None:
            self._entries.move_to_end(key)
        return block

    def match_chain_len(self, keys) -> int:
        """How many leading chain keys are resident.  A read-only probe for
        routing decisions: unlike :meth:`lookup` it does NOT refresh LRU
        recency -- asking "who has this prefix?" across a pool must not
        distort any replica's eviction order."""
        n = 0
        for key in keys:
            if key not in self._entries:
                break
            n += 1
        return n

    def publish(self, key: bytes, block: int) -> bool:
        """Register a full block under its content key.  First publication
        wins: an existing entry for the same key keeps its block (the two
        blocks hold identical KV; dedup-after-the-fact is not worth a device
        copy).  The cache takes one reference on newly published blocks."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self.allocator.incref(block)
        self._entries[key] = block
        return True

    def adopt(self, key: bytes, block: int) -> bool:
        """Register ``block`` under ``key`` taking over ONE reference the
        caller already holds (no incref) -- the insertion half of a
        host-tier restore or a migration import, where the block was
        freshly allocated FOR the cache rather than published by a live
        sequence.  Returns False (caller keeps its reference) if the key is
        already present."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self._entries[key] = block
        return True

    def evictable_blocks(self) -> int:
        """Blocks that eviction could reclaim right now (cache is the sole
        owner: refcount exactly 1)."""
        return sum(1 for b in self._entries.values()
                   if self.allocator.refcount(b) == 1)

    def drop_blocks(self, blocks) -> int:
        """Forget every entry backed by one of ``blocks`` (poison
        containment after a failed round: the publishing sequence no longer
        vouches for their content).  Unlike ``evict`` this drops entries
        regardless of refcount -- live sharers keep their references and
        their (already-read) KV, but no NEW sequence can attach them."""
        dropped = 0
        targets = set(blocks)
        for key in [k for k, b in self._entries.items() if b in targets]:
            block = self._entries.pop(key)
            self.allocator.decref(block)
            dropped += 1
        return dropped

    def evict(self, want: int, protect=()) -> int:
        """Free up to ``want`` cache-only blocks, least recently used first.
        Shared blocks (a live sequence also holds them) are skipped --
        dropping the cache entry would not reclaim memory, only forget a
        reusable prefix.  Blocks in ``protect`` are also skipped (the
        restore path evicts for capacity while still holding unreferenced
        matches from the same chain walk).  With a ``spill_hook`` wired,
        each victim's KV is offered to the host tier before the entry
        drops."""
        freed = 0
        protect = set(protect)
        for key in list(self._entries):
            if freed >= want:
                break
            block = self._entries[key]
            if block in protect or self.allocator.refcount(block) != 1:
                continue
            if self.spill_hook is not None:
                try:
                    self.spill_hook(key, block)
                except Exception:  # noqa: BLE001 -- spill is best effort;
                    # eviction must reclaim even when the tier misbehaves
                    self.spill_errors += 1
            del self._entries[key]
            self.allocator.decref(block)
            freed += 1
            self.evictions += 1
        return freed


class DSSequenceDescriptor:
    """Per-sequence bookkeeping (reference ``DSSequenceDescriptor``)."""

    def __init__(self, uid, block_size: int):
        self.uid = uid
        self._block_size = block_size
        self.seen_tokens = 0          # tokens whose KV is in the cache
        self.blocks: List[int] = []   # pool block ids, logical order
        self.token_ids: List[int] = []   # committed token history (== seen)
        self.block_keys: List[bytes] = []  # chain keys of published/matched
        #                                    full blocks (prefix of .blocks)

    @property
    def allocated_capacity(self) -> int:
        return len(self.blocks) * self._block_size

    def blocks_needed(self, new_tokens: int) -> int:
        total = self.seen_tokens + new_tokens
        return max(0, math.ceil(total / self._block_size) - len(self.blocks))


class DSStateManager:
    """Owns the allocator + live-sequence table (reference
    ``ragged_manager.py:19``)."""

    def __init__(self, config, allocator: Optional[BlockedAllocator] = None):
        self.config = config
        self.block_size = config.kv_cache.block_size
        self.allocator = allocator or BlockedAllocator(config.kv_cache.num_blocks)
        self._seqs: Dict[object, DSSequenceDescriptor] = {}
        self.max_blocks_per_seq = math.ceil(
            config.state_manager.max_context / self.block_size)
        self.prefix_cache = (PrefixCache(self.allocator)
                             if getattr(config.kv_cache, "prefix_cache", False)
                             else None)
        # (src, dst) block copies the engine must apply on-device BEFORE the
        # next step's KV scatter (copy-on-write of shared blocks)
        self.pending_copies: List[Tuple[int, int]] = []
        # optional HostKVTier (engine wires it via attach_host_tier):
        # evicted cache-only blocks spill there instead of vanishing, and
        # match_prefix consults it on a resident-cache miss
        self.host_tier = None

    @property
    def tracked_sequences(self) -> int:
        return len(self._seqs)

    def known(self, uid) -> bool:
        return uid in self._seqs

    def get_sequence(self, uid) -> DSSequenceDescriptor:
        return self._seqs[uid]

    def get_or_create_sequence(self, uid) -> DSSequenceDescriptor:
        if uid not in self._seqs:
            if len(self._seqs) >= self.config.state_manager.max_tracked_sequences:
                raise RuntimeError(
                    f"max_tracked_sequences "
                    f"({self.config.state_manager.max_tracked_sequences}) exceeded")
            self._seqs[uid] = DSSequenceDescriptor(uid, self.block_size)
        return self._seqs[uid]

    # ------------------------------------------------------------- allocation
    def _allocate(self, num_blocks: int) -> List[int]:
        """Allocate with LRU eviction of cache-only blocks as the fallback
        BEFORE ``MemoryError`` (tentpole: cached prefixes are a best-effort
        use of otherwise-free memory, never a reason to reject work)."""
        short = num_blocks - self.allocator.free_blocks
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        return self.allocator.allocate(num_blocks)

    def _cow_blocks(self, seq: DSSequenceDescriptor, new_tokens: int) -> List[int]:
        """Logical indices of already-attached blocks that writing
        ``new_tokens`` more tokens would touch while another owner can see
        them (refcount > 1) -- each needs a private copy first."""
        if new_tokens <= 0:
            return []
        bs = self.block_size
        first = seq.seen_tokens // bs
        last = (seq.seen_tokens + new_tokens - 1) // bs
        return [idx for idx in range(first, min(last + 1, len(seq.blocks)))
                if self.allocator.refcount(seq.blocks[idx]) > 1]

    def blocks_for_extend(self, uid, new_tokens: int) -> int:
        """Physical blocks an ``extend(uid, new_tokens)`` would consume:
        fresh capacity plus copy-on-write replacements.  Admission headroom
        math (scheduler) and ``validate_batch`` both use this."""
        if self.known(uid):
            seq = self._seqs[uid]
            return seq.blocks_needed(new_tokens) + len(
                self._cow_blocks(seq, new_tokens))
        return math.ceil(new_tokens / self.block_size)

    def free_blocks_with_evictable(self) -> int:
        """Free pool + what LRU eviction could reclaim on demand."""
        free = self.allocator.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_blocks()
        return free

    def validate_batch(self, ops) -> None:
        """Dry-run a batch of ``(uid, new_tokens)`` extends: raises the same
        errors ``extend``/``get_or_create_sequence`` would (block exhaustion,
        max_context, tracked-sequence overflow) but BEFORE any state mutation,
        so a rejected batch can be split and retried cleanly.  One op per
        uid (decode start positions are read once per batch)."""
        blocks_needed, new_uids, seen_uids = 0, set(), set()
        for uid, n in ops:
            if uid in seen_uids:
                raise ValueError(f"duplicate uid {uid} in one batch")
            seen_uids.add(uid)
            if self.known(uid):
                seq = self._seqs[uid]
                seen, nblocks = seq.seen_tokens, len(seq.blocks)
            else:
                seen, nblocks = 0, 0
                new_uids.add(uid)
            total = seen + n
            need_total = math.ceil(total / self.block_size)
            if need_total > self.max_blocks_per_seq:
                raise MemoryError(
                    f"sequence {uid} would exceed max_context "
                    f"{self.config.state_manager.max_context}")
            blocks_needed += self.blocks_for_extend(uid, n)
        if blocks_needed > self.free_blocks_with_evictable():
            raise MemoryError(
                f"batch needs {blocks_needed} KV blocks, only "
                f"{self.free_blocks_with_evictable()} free/evictable "
                f"(split the batch and retry)")
        if len(self._seqs) + len(new_uids) > \
                self.config.state_manager.max_tracked_sequences:
            raise RuntimeError(
                f"max_tracked_sequences "
                f"({self.config.state_manager.max_tracked_sequences}) exceeded")

    # ---------------------------------------------------------- host KV tier
    def attach_host_tier(self, tier) -> None:
        """Wire a :class:`~.kv_tier.HostKVTier` below the prefix cache:
        eviction victims spill into it, and ``match_prefix`` consults it
        when the resident cache misses."""
        self.host_tier = tier
        if self.prefix_cache is not None:
            self.prefix_cache.spill_hook = tier.spill

    def _restore_block(self, key: bytes, protect) -> Optional[int]:
        """Swap one spilled block back from the host tier into a freshly
        allocated device block and adopt it into the prefix cache (the
        cache owns the new block's single reference, exactly like a
        published block after its sequence flushed).  ``protect`` lists
        blocks the in-progress chain walk already matched -- the capacity
        eviction must not reclaim those (they carry no sequence reference
        yet).  Any failure -- no capacity, digest mismatch -- degrades to a
        cache miss."""
        tier = self.host_tier
        if tier is None or key not in tier:
            return None
        blocks = self.allocator.try_allocate(1)
        if blocks is None:
            # make room the same way _allocate would (which may itself
            # spill another LRU victim -- that is the tier churning, fine)
            if self.prefix_cache.evict(1, protect=protect) < 1:
                return None
            blocks = self.allocator.try_allocate(1)
            if blocks is None:
                return None
        block = blocks[0]
        if not tier.restore(key, block):
            self.allocator.free([block])
            return None
        self.prefix_cache.adopt(key, block)
        return block

    # ---------------------------------------------------------- prefix cache
    def match_prefix(self, uid, tokens) -> int:
        """Attach the longest cached chain of full blocks matching
        ``tokens`` to a NEW sequence ``uid``; returns how many prompt tokens
        the cache satisfied (their KV is already resident -- the engine must
        only be fed ``tokens[matched:]``).

        Always leaves >= 1 token to recompute, so the step that admits the
        sequence produces its logits: a fully-cached prompt matches up to
        ``len(tokens) - 1``, which lands the recompute token's KV write
        inside the last shared block -- the copy-on-write path in
        ``extend``.

        With a host tier attached, a resident-cache miss falls through to
        the spilled set: upcoming chain keys are prefetched (issue-ahead
        ``device_put``) and the missing block is restored into fresh
        capacity, so the chain keeps matching past what HBM alone held."""
        if self.prefix_cache is None or self.known(uid):
            return 0
        toks = [int(t) for t in tokens]
        bs = self.block_size
        keys: List[bytes] = []
        key = b""
        for idx in range(min(len(toks) // bs, self.max_blocks_per_seq)):
            key = chain_key(key, toks[idx * bs:(idx + 1) * bs])
            keys.append(key)
        matched: List[Tuple[bytes, int]] = []
        for idx, key in enumerate(keys):
            block = self.prefix_cache.lookup(key)
            if block is None and self.host_tier is not None:
                self.host_tier.prefetch(keys[idx:])
                block = self._restore_block(
                    key, protect=[b for _, b in matched])
            if block is None:
                break
            matched.append((key, block))
        if not matched:
            return 0
        matched_tokens = min(len(matched) * bs, len(toks) - 1)
        seq = self.get_or_create_sequence(uid)  # may raise max_tracked -- no
        #                                         refs taken yet
        for k, b in matched:
            self.allocator.incref(b)
            seq.blocks.append(b)
            seq.block_keys.append(k)
        seq.token_ids = toks[:matched_tokens]
        seq.seen_tokens = matched_tokens
        self.prefix_cache.hits += 1
        reg = get_registry()
        if reg.enabled:
            reg.counter("infer/prefix_hit_tokens").inc(matched_tokens)
        return matched_tokens

    def adopt_sequence(self, uid, token_ids, blocks,
                       block_keys) -> DSSequenceDescriptor:
        """Register a sequence whose KV arrived from OUTSIDE this engine's
        compute -- the decode-side landing of a prefill->decode migration.
        ``blocks`` must already be allocated with one reference held for
        this sequence (the migration import did that), and their KV already
        imported into the pool; ``block_keys`` covers the full-block prefix
        of ``blocks`` (chain keys match ``token_ids``).  After adoption the
        sequence is indistinguishable from one that prefilled here:
        ``extend``/``commit_tokens``/``flush_sequence`` all behave normally,
        and the COW machinery protects any block the prefix cache also
        holds."""
        seq = self.get_or_create_sequence(uid)
        if seq.blocks or seq.seen_tokens:
            raise ValueError(f"adopt_sequence: uid {uid} already has state")
        seq.token_ids = [int(t) for t in token_ids]
        seq.seen_tokens = len(seq.token_ids)
        seq.blocks = list(blocks)
        seq.block_keys = list(block_keys)
        return seq

    def commit_tokens(self, uid, tokens) -> None:
        """Record that ``tokens`` KV landed in the pool (the compiled step
        ran): advances ``seen_tokens`` and publishes every newly COMPLETED
        block under its chain key.  Partial tail blocks are never published
        -- their content is still mutating."""
        seq = self._seqs[uid]
        seq.token_ids.extend(int(t) for t in tokens)
        seq.seen_tokens += len(tokens)
        if self.prefix_cache is None:
            return
        bs = self.block_size
        while len(seq.block_keys) < seq.seen_tokens // bs:
            idx = len(seq.block_keys)
            parent = seq.block_keys[-1] if seq.block_keys else b""
            key = chain_key(parent, seq.token_ids[idx * bs:(idx + 1) * bs])
            self.prefix_cache.publish(key, seq.blocks[idx])
            seq.block_keys.append(key)

    def drop_cached_blocks(self, uid) -> int:
        """Poison containment: remove every prefix-cache entry backed by one
        of ``uid``'s blocks.  Called by the scheduler's step-failure
        recovery BEFORE flushing the sequence -- a round that produced
        non-finite logits may have published blocks whose KV is garbage,
        and the requeued prompt would otherwise re-attach its own poisoned
        prefix on re-admission."""
        if self.prefix_cache is None or not self.known(uid):
            return 0
        return self.prefix_cache.drop_blocks(self._seqs[uid].blocks)

    def take_pending_copies(self) -> List[Tuple[int, int]]:
        """Drain the queued copy-on-write block copies; the engine fuses
        them into its next compiled step (applied before any KV write)."""
        copies, self.pending_copies = self.pending_copies, []
        return copies

    # -------------------------------------------------------------- capacity
    def extend(self, uid, new_tokens: int) -> DSSequenceDescriptor:
        """Reserve cache capacity for ``new_tokens`` more tokens of ``uid``.
        Shared blocks the write range touches are copy-on-write replaced."""
        seq = self.get_or_create_sequence(uid)
        need = seq.blocks_needed(new_tokens)
        if len(seq.blocks) + need > self.max_blocks_per_seq:
            raise MemoryError(
                f"sequence {uid} would exceed max_context "
                f"{self.config.state_manager.max_context}")
        if need:
            seq.blocks.extend(self._allocate(need))
        for idx in self._cow_blocks(seq, new_tokens):
            shared = seq.blocks[idx]
            private = self._allocate(1)[0]
            self.pending_copies.append((shared, private))
            seq.blocks[idx] = private
            self.allocator.decref(shared)
            # the copy diverges from the published content once written:
            # this sequence no longer vouches for idx (or anything after)
            del seq.block_keys[idx:]
        return seq

    def rollback_draft_tail(self, uid) -> int:
        """Speculative-decoding rollback: release blocks past the committed
        token range.  The scheduler pre-reserved capacity for the round's
        worst case (all k drafts accepted); verification committed fewer,
        and any block wholly beyond ``seen_tokens`` was freshly allocated
        this round -- never published, never matched -- so its refcount is
        exactly 1 and rejection is refcount->0 + free, not a KV rewind
        (stale draft KV in kept partial blocks is masked by position and
        overwritten by the next extend).  Queued COW copies into a released
        block are cancelled: the destination may be reallocated before the
        next step applies them."""
        seq = self._seqs[uid]
        keep = math.ceil(seq.seen_tokens / self.block_size)
        tail = seq.blocks[keep:]
        if not tail:
            return 0
        del seq.blocks[keep:]
        del seq.block_keys[keep:]
        mine = set(tail)
        self.pending_copies = [
            (s, d) for s, d in self.pending_copies if d not in mine]
        self.allocator.free(tail)
        return len(tail)

    def flush_sequence(self, uid) -> None:
        """Free a finished sequence's blocks (reference ``flush_sequence``).
        With prefix caching, published blocks stay resident (the cache holds
        a reference) and only this sequence's references drop."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            return
        if seq.blocks:
            mine = set(seq.blocks)
            # a queued COW copy into a block this flush releases must not
            # run: the destination may be reallocated before the next step
            self.pending_copies = [
                (s, d) for s, d in self.pending_copies if d not in mine]
            self.allocator.free(seq.blocks)

    def block_table(self, uid, pad_to: Optional[int] = None) -> List[int]:
        seq = self._seqs[uid]
        table = list(seq.blocks)
        if pad_to is not None:
            table += [0] * (pad_to - len(table))
        return table
