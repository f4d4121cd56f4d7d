"""Refcounting block allocator for the paged KV cache.

Equivalent of reference ``inference/v2/ragged/blocked_allocator.py:11``
(``BlockedAllocator``): O(1) allocate/free over a fixed pool of KV blocks.
The reference keeps the free list in a pinned torch tensor so it can be
shipped to the device; here allocation is purely host-side (block *tables*
are what reaches the TPU), so a plain free list suffices.

Growth for prefix caching (vLLM-style block sharing): every allocated block
carries a refcount.  ``allocate`` hands out blocks at refcount 1;
``incref`` lets a second owner (another sequence sharing a cached prefix,
or the prefix cache itself) pin the block; ``free``/``decref`` drop one
reference and return the block to the free list only when the count hits
zero.  Allocated ids live in a persistent set, so double-free detection is
O(1) per block instead of the old O(free-list) ``set(self._free)`` rebuild
per call.
"""

from typing import Dict, List, Set


class BlockedAllocator:
    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._allocated: Set[int] = set()
        self._refcount: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    @property
    def allocated_blocks(self) -> int:
        return len(self._allocated)

    def refcount(self, block: int) -> int:
        """Current reference count (0 for unallocated blocks)."""
        return self._refcount.get(block, 0)

    def allocate(self, num_blocks: int) -> List[int]:
        if num_blocks > len(self._free):
            raise MemoryError(
                f"cannot allocate {num_blocks} blocks ({len(self._free)} free "
                f"of {self._num_blocks})")
        taken, self._free = self._free[:num_blocks], self._free[num_blocks:]
        for b in taken:
            self._allocated.add(b)
            self._refcount[b] = 1
        return taken

    def try_allocate(self, num_blocks: int):
        """``allocate`` that returns None instead of raising when the free
        list is short.  Best-effort paths -- restoring a host-tier spilled
        block, importing a migrated block -- use this so capacity pressure
        degrades to a cache miss / recompute, never an exception on a path
        where nothing reserved the capacity."""
        if num_blocks > len(self._free):
            return None
        return self.allocate(num_blocks)

    def incref(self, block: int) -> int:
        """Add an owner to an allocated block; returns the new refcount."""
        if block not in self._allocated:
            raise ValueError(f"incref of unallocated block {block}")
        self._refcount[block] += 1
        return self._refcount[block]

    def decref(self, block: int) -> int:
        """Drop one reference; frees the block at zero.  Returns the new
        refcount.  Raising on unallocated ids is the O(1) double-free
        detection (``self._allocated`` is persistent, never rebuilt)."""
        if not 0 <= block < self._num_blocks:
            raise ValueError(f"block id {block} out of range")
        if block not in self._allocated:
            raise ValueError(f"double free of block {block}")
        rc = self._refcount[block] - 1
        if rc == 0:
            self._allocated.discard(block)
            del self._refcount[block]
            self._free.append(block)
        else:
            self._refcount[block] = rc
        return rc

    def audit(self) -> Dict[str, int]:
        """Cross-check every allocator invariant; raises ValueError on the
        first violation, returns a summary dict when clean.  Tests run this
        after accept/reject/preempt/chaos sequences to prove zero leaked or
        double-freed KV blocks (a leaked block shows up as allocated with no
        owner able to free it; a corrupt free drops the conservation sum)."""
        if len(set(self._free)) != len(self._free):
            raise ValueError("free list contains duplicate block ids")
        free = set(self._free)
        both = free & self._allocated
        if both:
            raise ValueError(f"blocks both free and allocated: {sorted(both)}")
        if len(free) + len(self._allocated) != self._num_blocks:
            raise ValueError(
                f"block conservation violated: {len(free)} free + "
                f"{len(self._allocated)} allocated != {self._num_blocks}")
        if set(self._refcount) != self._allocated:
            raise ValueError("refcount table out of sync with allocated set")
        bad = sorted(b for b, rc in self._refcount.items() if rc < 1)
        if bad:
            raise ValueError(f"allocated blocks with refcount < 1: {bad}")
        return {"free": len(free), "allocated": len(self._allocated),
                "references": sum(self._refcount.values())}

    def free(self, blocks: List[int]) -> None:
        """Release one reference on each block (refcount-1 blocks return to
        the free list).  Validates the WHOLE call before mutating -- a bad id
        (out of range, unallocated, or more occurrences than references)
        raises ValueError with no partial frees committed."""
        occurrences: Dict[int, int] = {}
        for b in blocks:
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"block id {b} out of range")
            if b not in self._allocated:
                raise ValueError(f"double free of block {b}")
            occurrences[b] = occurrences.get(b, 0) + 1
            if occurrences[b] > self._refcount[b]:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self.decref(b)
