"""Communication facade over ``torch.distributed`` (counterpart of
``deeperspeed_tpu/comm/comm.py``).

The JAX package's collectives are XLA ops over named mesh axes; here a
group is a ``torch.distributed`` process group (the world, for the one
axis ported: dp) and each collective is one eager call on it.  The
functions return their result, as the JAX ones do; ``all_reduce`` and
``broadcast`` also write it into their argument, as torch's do.

Backends.  ``init_distributed`` takes ``dist_backend`` from its caller:
``nccl`` between GPUs, ``gloo`` between CPU processes or between processes
that share one GPU (NCCL refuses two ranks on one device).  What each
(backend, device) pair does is decided here, once, not by trying:

* ``nccl``, and any backend on CPU tensors: the collective runs on the
  tensors as they are;
* ``gloo`` on CUDA tensors: every collective is staged through host
  memory -- its inputs are copied to the CPU, the collective runs there and
  the result is copied back.  gloo moves the bytes through host memory
  either way; doing the copies here gives one rule for every op.  The
  bytes staged, both ways, are counted in :data:`STAGED` by op, and the
  host-clock seconds each staged op took, copies included (they block),
  in :data:`STAGED_SECONDS`.

1-byte floats (fp8) travel as ``uint8`` views: the backends move bytes, and
not every one knows the fp8 types.  ``ReduceOp.AVG`` is a sum divided by
the group size, on every backend (gloo has no AVG).

The quantized collectives (:func:`all_reduce_quantized`,
:func:`reduce_scatter_quantized`) run the flat qgZ schedule of
``comm/compressed.py``.  The two-level schedule (``intra_group`` /
``inter_group``) raises ``NotImplementedError``: it needs a mesh of more
than one data-parallel axis.
"""

import datetime
import os
import time
from collections import Counter

import torch
import torch.distributed as dist

from ..accelerator.real_accelerator import local_cuda_index
from ..parallel import topology as topo

# bytes copied between the card and host memory to run a gloo collective,
# per op (device to host plus host to device), and the seconds those ops
# took; a caller resets them with clear()
STAGED = Counter()
STAGED_SECONDS = Counter()

_PART2 = "(ROADMAP Queue A, 'Multi-process training, part 2')"


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "prod"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


class CommGroup:
    """A communicator: the mesh ``axes`` it spans and the torch process
    group behind them (``None``: the default group, the world)."""

    def __init__(self, axes=(topo.DP_AXIS,), name=None, pg=None):
        if isinstance(axes, str):
            axes = (axes,)
        self.axes = tuple(axes)
        self.name = name or "+".join(self.axes)
        self.pg = pg

    def size(self):
        return dist.get_world_size(self.pg) if dist.is_initialized() else 1

    def rank(self):
        return dist.get_rank(self.pg) if dist.is_initialized() else 0

    def backend(self):
        return dist.get_backend(self.pg)

    def __repr__(self):
        return f"CommGroup({self.axes})"


def get_world_group():
    return CommGroup(topo.ALL_AXES, name="world")


def get_data_parallel_group():
    # ZeRO shards over dp x zshard x ep x sp; only dp is above 1 here
    return CommGroup((topo.DP_AXIS, topo.ZSHARD_AXIS, topo.EP_AXIS, topo.SP_AXIS),
                     name="dp")


def _resolve_group(group):
    if group is None:
        return get_world_group()
    if isinstance(group, CommGroup):
        return group
    return CommGroup(group)


# ---------------------------------------------------------------- lifecycle
def init_distributed(dist_backend=None, auto_mpi_discovery=False, timeout=None,
                     init_method=None, rank=-1, world_size=-1, **kwargs):
    """Join the process group (reference ``comm/comm.py:604``); idempotent.

    ``dist_backend``: ``"nccl"`` or ``"gloo"``, the caller's choice.
    ``init_method`` (``tcp://host:port``, ``file:///path``, or ``env://``
    by default), ``rank`` and ``world_size`` default to the ``RANK`` and
    ``WORLD_SIZE`` environment variables.  On ``nccl`` with ``LOCAL_RANK``
    set, the process first makes ``cuda:{LOCAL_RANK}`` its current card, so
    that ranks on one host take one card each.  A world of one process
    needs no group and starts none."""
    if dist.is_initialized():
        return
    if rank < 0:
        rank = int(os.environ.get("RANK", 0))
    if world_size < 0:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if world_size <= 1:
        return
    if dist_backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend {dist_backend!r}: name 'nccl' (one GPU a "
                         f"process) or 'gloo' (CPU, or processes sharing a GPU)")
    if dist_backend == "nccl":
        index = local_cuda_index()
        if index is not None:
            torch.cuda.set_device(index)
    dist.init_process_group(
        dist_backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout) if timeout else None)


def get_rank(group=None):
    return _resolve_group(group).rank()


def get_world_size(group=None):
    return _resolve_group(group).size()


def destroy():
    """Leave the process group (the reference's ``destroy_process_group``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- transport
def _wire(t):
    """``t`` as the backends move it: 1-byte floats as ``uint8``."""
    return t.view(torch.uint8) if t.is_floating_point() and t.element_size() == 1 else t


def _run(name, group, fn, out, *inputs):
    """``fn(out, *inputs)``, a torch collective writing ``out``, staged
    through host memory for gloo on CUDA tensors; returns ``out``."""
    if out.is_cuda and group.backend() == "gloo":
        t0 = time.perf_counter()
        host_out = torch.empty(out.shape, dtype=out.dtype)
        host_in = [t.cpu() for t in inputs]
        fn(host_out, *host_in)
        out.copy_(host_out)
        STAGED_SECONDS[name] += time.perf_counter() - t0
        STAGED[name] += sum(t.numel() * t.element_size() for t in inputs) \
            + out.numel() * out.element_size()
    else:
        fn(out, *inputs)
    return out


def _finish(out, op, n):
    return out.div_(n) if op == ReduceOp.AVG else out


# -------------------------------------------------------------- collectives
def all_reduce(tensor, op=ReduceOp.SUM, group=None,
               log_name="all_reduce"):
    """The group's reduction of ``tensor``, written into it and returned."""
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    group = _resolve_group(group)
    n = group.size()
    if n == 1:
        return tensor
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()

    def reduce(out, x):
        if out is not x:
            out.copy_(x)
        dist.all_reduce(out, op=_TORCH_OPS[op], group=group.pg)

    _run(log_name, group, reduce, buf, buf)
    _finish(buf, op, n)
    if buf is not tensor:
        tensor.copy_(buf)
    return tensor


def all_gather(tensor, group=None, axis=0, tiled=True, log_name="all_gather"):
    """Every rank's ``tensor`` concatenated along ``axis`` in rank order
    (``tiled``), or stacked on a new leading axis (not tiled)."""
    group = _resolve_group(group)
    n = group.size()
    if n == 1:
        return tensor if tiled else tensor[None]
    x = _wire((tensor.movedim(axis, 0) if tiled else tensor[None]).contiguous())
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(log_name, group,
         lambda o, i: dist.all_gather_into_tensor(o, i, group=group.pg), out, x)
    out = out.view(tensor.dtype)
    return out.movedim(0, axis) if tiled else out


def all_gather_into(out, tensor, group=None, log_name="all_gather"):
    """:func:`all_gather` (tiled along dim 0) into the preallocated ``out``
    of ``group.size() * tensor.numel()`` elements."""
    group = _resolve_group(group)
    if group.size() == 1:
        return out.copy_(tensor.reshape(out.shape))
    _run(log_name, group,
         lambda o, i: dist.all_gather_into_tensor(o, i, group=group.pg),
         _wire(out), _wire(tensor.contiguous()))
    return out


def reduce_scatter(tensor, group=None, axis=0, op=ReduceOp.SUM,
                   log_name="reduce_scatter"):
    """The group's sum of ``tensor``; each rank keeps its chunk along
    ``axis`` (``tensor.shape[axis]`` divisible by the group size)."""
    group = _resolve_group(group)
    n = group.size()
    if n == 1:
        return tensor
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter supports sum and avg, not {op}")
    x = tensor.movedim(axis, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim {axis} ({x.shape[0]}) not divisible by {n}")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(log_name, group,
         lambda o, i: dist.reduce_scatter_tensor(o, i, group=group.pg), out, x)
    return _finish(out, op, n).movedim(0, axis)


def all_to_all(tensor, group=None, split_axis=0, concat_axis=0, tiled=True,
               log_name="all_to_all"):
    """Split ``tensor`` along ``split_axis`` into one chunk per rank, send
    chunk j to rank j, and concatenate what arrives along ``concat_axis``
    in rank order (the reference's ``all_to_all_single``)."""
    if not tiled:
        raise NotImplementedError(f"all_to_all with tiled=False is not ported yet {_PART2}")
    group = _resolve_group(group)
    n = group.size()
    if n == 1:
        return tensor
    x = _wire(tensor.movedim(split_axis, 0).contiguous())
    if x.shape[0] % n:
        raise ValueError(f"dim {split_axis} ({x.shape[0]}) not divisible by {n}")
    out = torch.empty_like(x)
    _run(log_name, group,
         lambda o, i: dist.all_to_all_single(o, i, group=group.pg), out, x)
    chunks = out.view(tensor.dtype).chunk(n, 0)
    return torch.cat([c.movedim(0, split_axis) for c in chunks], dim=concat_axis)


def broadcast(tensor, src=0, group=None, log_name="broadcast"):
    """Rank ``src``'s ``tensor`` on every rank, written into it and returned."""
    group = _resolve_group(group)
    if group.size() == 1:
        return tensor
    buf = _wire(tensor if tensor.is_contiguous() else tensor.contiguous())

    def bcast(out, x):
        if out is not x:
            out.copy_(x)
        dist.broadcast(out, src=src, group=group.pg)

    _run(log_name, group, bcast, buf, buf)
    if buf.data_ptr() != tensor.data_ptr():
        tensor.copy_(buf.view(tensor.dtype))
    return tensor


# ------------------------------------------------- quantized collectives
def _gradient_wire_dtype(wire_dtype):
    """The config's ``fp8`` spelling for the gradient wire: e5m2 (range over
    precision: quantized partial sums overflow before they underflow).
    Activation surfaces (the KV pools) resolve ``fp8`` to e4m3."""
    return "fp8_e5m2" if str(wire_dtype).lower() == "fp8" else wire_dtype


def _flat_only(intra_group, inter_group):
    if intra_group is not None or inter_group is not None:
        raise NotImplementedError(
            f"the two-level (hierarchical) qgZ schedule is not ported yet {_PART2}")


def all_reduce_quantized(tensor, op=ReduceOp.SUM, group=None, intra_group=None,
                         inter_group=None, group_size=128, impl="auto",
                         wire_dtype="int8", log_name="all_reduce_quantized"):
    """All-reduce with a block-scaled wire format (the flat qgZ schedule):
    ``tensor`` flattened, zero-padded to a multiple of ``group size x
    group_size`` and seen as rows of ``group_size``; quantize, all-to-all,
    B5 dequant-reduce, requantize, all-gather, dequantize.  Returns a new
    tensor of ``tensor``'s shape and dtype."""
    from .compressed import quantized_all_reduce

    _flat_only(intra_group, inter_group)
    wire_dtype = _gradient_wire_dtype(wire_dtype)
    group = _resolve_group(group or get_data_parallel_group())
    n = group.size()
    if n == 1:
        return tensor
    flat = tensor.reshape(-1)
    pad = (-flat.numel()) % (n * group_size)
    rows = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, group_size)
    y = quantized_all_reduce(rows, group, group_size, impl=impl, wire_dtype=wire_dtype)
    y = y.reshape(-1)[:flat.numel()].reshape(tensor.shape).to(tensor.dtype)
    return y / n if op == ReduceOp.AVG else y


def reduce_scatter_quantized(tensor, group=None, intra_group=None, inter_group=None,
                             group_size=128, impl="auto", wire_dtype="int8",
                             log_name="reduce_scatter_quantized"):
    """Reduce-scatter along dim 0 with a block-scaled wire format: each rank
    receives its fp32 chunk of the group sum (``tensor.shape[0]`` divisible
    by the group size)."""
    from .compressed import quantized_reduce_scatter

    _flat_only(intra_group, inter_group)
    wire_dtype = _gradient_wire_dtype(wire_dtype)
    group = _resolve_group(group or get_data_parallel_group())
    if group.size() == 1:
        return tensor
    return quantized_reduce_scatter(tensor, group, group_size, impl=impl,
                                    wire_dtype=wire_dtype)
