"""One launch over many tensors: the device table the fused optimizer
kernels B6 and B7 walk (``csrc/fused_optimizers.cu``).

A kernel takes groups of same-sized fp32 tensors (B6: gradient, first and
second moment; B7: gradient and moment) as a table of entries ``{pointers,
numel, first chunk}``.  When every list of the group tiles one buffer in
order (the engine's flat gradient and moment buffers, a view per
parameter), the whole group is one entry; otherwise each tensor group is an
entry of its own.  Non-contiguous tensors go through contiguous copies,
written back after the launch.  A caller that passes the same tensor
objects every step (the engine's views never move) gives :func:`prepare` a
cache dict and gets the table it built the first time.
"""

import weakref

import torch

# elements a kernel block takes at a time; csrc/fused_optimizers.cu CHUNK
CHUNK = 4096
ENTRY_FIELDS = 5      # pointers of g, m, v (0 where unused), numel, first chunk


def flat_span(tensors):
    """A 1-D view over ``tensors`` if they are contiguous, of one dtype, and
    lie back to back in one storage in list order; else None."""
    first = tensors[0]
    storage = first.untyped_storage().data_ptr()
    off = first.storage_offset()
    for t in tensors:
        if (not t.is_contiguous() or t.dtype != first.dtype
                or t.untyped_storage().data_ptr() != storage
                or t.storage_offset() != off):
            return None
        off += t.numel()
    return first.as_strided((off - first.storage_offset(),), (1,),
                            first.storage_offset())


def _same_tensors(refs, b):
    """``refs`` (weak references) name the very tensors of ``b``."""
    return len(refs) == len(b) and all(
        len(x) == len(y) and all(r() is t for r, t in zip(x, y)) for x, y in zip(refs, b))


def prepare(kernel, lists, cache=None):
    """Validate ``lists`` (each a list of tensors, one per parameter) and
    return ``(table, n_entries, n_chunks, write_back)``: the int64 device
    table, and the (original, contiguous copy) pairs to copy back after
    the launch.  With ``cache`` (a dict the caller keeps), a call with the
    same tensor objects as the cached one returns the cached table; a
    table that needs copies written back is not cached.  The cache holds
    the tensors weakly, so it keeps none of them alive (the offloaded
    optimizer state's device copies live for one update)."""
    if cache and _same_tensors(cache["lists"], lists):
        return cache["result"]
    result = _prepare(kernel, lists)
    if cache is not None and not result[3]:
        cache["lists"] = [[weakref.ref(t) for t in lst] for lst in lists]
        cache["result"] = result
    return result


def _prepare(kernel, lists):
    width = len(lists)
    if len({len(lst) for lst in lists}) != 1:
        raise ValueError(f"{kernel}: lists of different lengths")
    dev = lists[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {dev}, not on a CUDA device")
    for group in zip(*lists):
        for t in group:
            if t.device != dev:
                raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"{kernel}: every tensor must be float32, got {t.dtype}")
            if t.shape != group[0].shape:
                raise ValueError(f"{kernel}: shapes {tuple(t.shape)} and "
                                 f"{tuple(group[0].shape)} in one group")
    spans = [flat_span(lst) for lst in lists]
    write_back = []
    if all(s is not None for s in spans):
        groups = [spans]
    else:
        groups = []
        for group in zip(*lists):
            row = []
            for t in group:
                if not t.is_contiguous():
                    c = t.contiguous()
                    write_back.append((t, c))
                    t = c
                row.append(t)
            groups.append(row)
    rows, first = [], 0
    for group in groups:
        n = group[0].numel()
        if n == 0:
            continue
        ptrs = [t.data_ptr() for t in group] + [0] * (3 - width)
        rows.append(ptrs + [n, first])
        first += -(-n // CHUNK)
    if not rows:
        return None, 0, 0, write_back
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    return table, len(rows), first, write_back


def finish(write_back):
    """Copy the contiguous stand-ins back into the caller's tensors."""
    for orig, copy in write_back:
        orig.copy_(copy)
