"""Communication facade over ``torch.distributed`` (counterpart of
``deeperspeed_tpu/comm/comm.py``).

The JAX package's collectives are XLA ops over named mesh axes; here a
group is a ``torch.distributed`` process group over the ranks that differ
only along those axes of the mesh (``parallel/topology.py``), and each
collective is one eager call on it.  :func:`get_data_parallel_group` is
the ZeRO group (``dp x zshard x ep x sp``) of this rank's tensor-parallel slice,
:func:`get_zero_param_parallel_group` the MiCS / hpZ subgroup
(``zshard``), :func:`get_model_parallel_group` the tensor-parallel group
(``tp``), :func:`get_expert_parallel_group` the MoE experts' group
(``ep``), :func:`get_expert_data_parallel_group` the ZeRO axes less
``ep``, :func:`get_sequence_parallel_group` the ranks that hold one
sequence's slices (``sp``), :func:`get_batch_parallel_group` the ZeRO axes
less ``sp`` (the ranks that hold different rows) and
:func:`get_pipe_parallel_group` the pipeline stages (``pp``);
every process builds all of them together, in one order, the first time
one is asked for under a mesh.  The
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
  host-clock seconds its caller spent in each staged op, copies included
  (they block; an async op's issue and its wait), in
  :data:`STAGED_SECONDS`.

Point to point (the pipeline's transfers, the JAX package's ``ppermute``
over ``pp``): :func:`send` / :func:`recv` and their async forms
:func:`isend` / :func:`irecv` move one tensor between two ranks of a
group, staged through host memory on gloo as the collectives are;
:func:`ppermute`, :func:`send_next` and :func:`recv_prev` are the JAX
package's permutations built from them.

1-byte floats (fp8) travel as ``uint8`` views: the backends move bytes, and
not every one knows the fp8 types.  ``ReduceOp.AVG`` is a sum divided by
the group size, on every backend (gloo has no AVG).

The quantized collectives (:func:`all_reduce_quantized`,
:func:`reduce_scatter_quantized`) run the qgZ schedules of
``comm/compressed.py``: flat over one group, or two-level over an
``intra_group`` and an ``inter_group`` (:func:`new_two_level_groups`
gives the ``zshard`` and ``dp`` groups of a world of ``n_inter x n_intra``
processes in the JAX package's mesh order).  :func:`_hier_groups` makes
the one decision of flat or two-level for the facade and for ZeRO++'s
``qgz_*``, and :func:`_run_quantized` records the analytic wire bytes of
both.

Comms logging (``comms_logger`` config block, :func:`configure`,
:func:`log_summary`): every eager collective is timed on the host clock,
ending in ``torch.cuda.synchronize()`` for CUDA tensors, and logged by
:data:`comms_logger` when it is enabled; a collective called inside
another is timed as part of the outer one.  ``async_op=True`` on
:func:`all_reduce`, :func:`all_gather` and :func:`reduce_scatter` returns
an ``overlap.AsyncOpHandle`` under ``comm.overlap.eager_async`` (and the
value otherwise, as in the JAX package); ``async_op="always"`` returns one
whatever that option says (the engine's reductions issued from gradient
hooks).  An async op is not timed.  While ``comm/schedule.py``
``record_sites`` installs a recorder, every outermost collective call is
also handed to it (the collective sites of a planned step).
"""

import datetime
import functools
import inspect
import os
import time
from collections import Counter

import torch
import torch.distributed as dist

from ..accelerator.real_accelerator import local_cuda_index
from ..parallel import topology as topo
from .comms_logging import CommsLogger
from .overlap import AsyncOpHandle

# bytes copied between the card and host memory to run a gloo collective,
# per op name (device to host plus host to device: ``grad_reduce``,
# ``all_gather``, ``stage3_gather``, ``hpz_refresh``, ``tp_reduce``, ...),
# and the seconds those ops took; a caller resets them with clear()
STAGED = Counter()
STAGED_SECONDS = Counter()

comms_logger = CommsLogger()

# comm.overlap.eager_async: async_op=True returns an AsyncOpHandle
_eager_async = False
# depth of timed collectives in progress (an inner one is not logged)
_timed_depth = 0
# comm/schedule.py's SiteRecorder while one is installed, and the depth of
# recorded calls in progress (an inner one is not recorded)
_site_recorder = None
_recorded_depth = 0


def _is_async(async_op):
    """Whether a call with ``async_op`` returns a handle: ``"always"`` does,
    ``True`` under ``comm.overlap.eager_async``."""
    return async_op == "always" or bool(async_op and _eager_async)


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
    """A communicator: the mesh ``axes`` it spans, its global ``ranks`` in
    group order (``None``: the world) and the torch process group behind
    them (``None``: the default group, or no group for one process)."""

    def __init__(self, axes=(topo.DP_AXIS,), name=None, pg=None, complement=None,
                 ranks=None):
        if isinstance(axes, str):
            axes = (axes,)
        self.axes = tuple(axes)
        self.name = name or "+".join(self.axes)
        self.pg = pg
        self.ranks = ranks
        # the other hop of a two-level split (the rest of the ZeRO group's
        # axes, where they span more than one process)
        self.complement = complement

    def size(self):
        if self.ranks is not None:
            return len(self.ranks)
        return dist.get_world_size(self.pg) if dist.is_initialized() else 1

    def rank(self):
        if self.ranks is not None:
            return self.ranks.index(dist.get_rank() if dist.is_initialized() else 0)
        return dist.get_rank(self.pg) if dist.is_initialized() else 0

    def global_rank(self, index):
        """The world rank of the group's ``index``-th member."""
        return self.ranks[index] if self.ranks is not None else index

    def backend(self):
        return dist.get_backend(self.pg)

    def __repr__(self):
        return f"CommGroup({self.axes})"


def get_world_group():
    return CommGroup(topo.ALL_AXES, name="world")


# every process's groups, by mesh sizes and axes (built together, once)
_MESH_GROUPS = {}
# the groups every process builds, in this order
_GROUP_AXES = {"dp": topo.ZERO_AXES, "zshard": (topo.ZSHARD_AXIS,),
               "dp_replica": (topo.DP_AXIS,), "tp": (topo.TP_AXIS,),
               "ep": (topo.EP_AXIS,),
               "expert_dp": tuple(a for a in topo.ZERO_AXES if a != topo.EP_AXIS),
               "pp": (topo.PP_AXIS,), "sp": (topo.SP_AXIS,),
               "batch": tuple(a for a in topo.ZERO_AXES if a != topo.SP_AXIS)}


def _mesh_groups(mesh=None):
    """This rank's group for each entry of :data:`_GROUP_AXES` under
    ``mesh`` (the global mesh by default).  The first call for a mesh
    creates every group of every axis set on every process, in one order
    (``torch.distributed.new_group`` is collective); a group that is the
    whole world is the default group, and one of a single process has
    none."""
    mesh = mesh or topo.get_mesh()
    key = tuple(mesh.sizes[a] for a in topo.ALL_AXES)
    if key in _MESH_GROUPS:
        return _MESH_GROUPS[key]
    me = dist.get_rank() if dist.is_initialized() else 0
    mine = {}
    for name, axes in _GROUP_AXES.items():
        if (name, mesh.ep) == ("expert_dp", 1) or (name, mesh.sp) == ("batch", 1):
            mine[name] = mine["dp"]        # the same ranks: no second group
            continue
        for ranks in mesh.groups(axes):
            pg = None
            if 1 < len(ranks) < mesh.world:
                pg = dist.new_group(ranks)
            if me in ranks:
                mine[name] = CommGroup(axes, name=name, pg=pg, ranks=ranks)
    # a two-level split of the ZeRO group: each hop's other hop, where it
    # spans more than one process (the JAX package's ``_hier_axes``)
    z, d = mine["zshard"], mine["dp_replica"]
    z.complement = d if d.size() > 1 else None
    d.complement = z if z.size() > 1 else None
    _MESH_GROUPS[key] = mine
    return mine


def get_data_parallel_group():
    """The ZeRO group: ``dp x zshard x ep x sp`` of this rank's
    tensor-parallel slice, ranked by the data-parallel index."""
    return _mesh_groups()["dp"]


def get_zero_param_parallel_group():
    """The MiCS / hpZ subgroup (``zshard``)."""
    return _mesh_groups()["zshard"]


def get_data_parallel_replica_group():
    """The ``dp`` axis alone: the replicas of a MiCS partition."""
    return _mesh_groups()["dp_replica"]


def get_model_parallel_group():
    """The tensor-parallel group (``tp``)."""
    return _mesh_groups()["tp"]


def get_expert_parallel_group():
    """The expert-parallel group (``ep``): the ranks that hold one MoE
    layer's experts between them (the JAX package's ``comm.py:118``)."""
    return _mesh_groups()["ep"]


def get_expert_data_parallel_group():
    """The expert-data-parallel group: the ZeRO axes less ``ep``, the
    ranks that hold the same experts, over which their partitions are cut
    and their gradients reduced."""
    return _mesh_groups()["expert_dp"]


def get_sequence_parallel_group():
    """The sequence-parallel group (``sp``): the ranks that hold the slices
    of the same sequences, ranked by slice (the JAX package's
    ``comm.py:114``)."""
    return _mesh_groups()["sp"]


def get_batch_parallel_group():
    """The ZeRO axes less ``sp``: the ranks that hold different rows of a
    microbatch, ranked by their row slice (the group the JAX package's
    manual data-parallel loops, qgZ and 1-bit Adam, run over)."""
    return _mesh_groups()["batch"]


def get_pipe_parallel_group():
    """The pipeline group (``pp``): the stages of this rank's data-parallel
    replica and tensor-parallel slice, ranked by stage."""
    return _mesh_groups()["pp"]


def get_axis_group(axis):
    """This rank's group along one ZeRO axis (``dp`` or ``zshard``)."""
    if axis == topo.ZSHARD_AXIS:
        return get_zero_param_parallel_group()
    if axis == topo.DP_AXIS:
        return get_data_parallel_replica_group()
    raise ValueError(f"no group for mesh axis {axis!r} here: the quantized hops run "
                     f"over dp and zshard")


def _resolve_group(group):
    if group is None:
        return get_world_group()
    if isinstance(group, CommGroup):
        return group
    return CommGroup(group)


def new_two_level_groups(n_inter, n_intra):
    """This rank's ``(intra_group, inter_group)`` of a world of ``n_inter x
    n_intra`` processes: the ``zshard`` and ``dp`` groups of the mesh
    ``dp=n_inter, zshard=n_intra`` (the JAX package's order: rank ``r =
    i_inter * n_intra + i_intra``), each ranked by its index along its
    axis.  Every rank calls it, in the same order (the groups are built
    collectively the first time)."""
    world = get_world_size()
    if n_inter * n_intra != world:
        raise ValueError(f"{n_inter} x {n_intra} groups for a world of {world}")
    groups = _mesh_groups(topo.MeshTopology(dp=n_inter, zshard=n_intra))
    return groups["zshard"], groups["dp_replica"]


def configure(config=None, verbose=None, prof_all=None, debug=None, prof_ops=None):
    """Comms logging and ``eager_async`` from a ``DeeperSpeedConfig`` (its
    ``comms_logger`` and ``comm.overlap`` blocks), and the logger's knobs
    one by one (the JAX package's ``configure``)."""
    global _eager_async
    cl = getattr(config, "comms_config", None)
    if cl is not None and cl.enabled:
        comms_logger.configure(enabled=cl.enabled, verbose=cl.verbose,
                               prof_all=cl.prof_all, prof_ops=cl.prof_ops,
                               debug=cl.debug)
    ov = getattr(config, "comm_overlap", None)
    if ov is not None:
        _eager_async = bool(ov.enabled and ov.eager_async)
    if verbose is not None:
        comms_logger.verbose = verbose
    if prof_all is not None:
        comms_logger.prof_all = prof_all
    if prof_ops is not None:
        comms_logger.prof_ops = prof_ops
    if debug is not None:
        comms_logger.debug = debug


def log_summary(show_straggler=False):
    """The comms logger's table (logged) and its rows (returned)."""
    return comms_logger.log_all(show_straggler=show_straggler)


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


def _run(name, group, fn, out, *inputs, async_op=False, then=None):
    """``fn(out, *inputs, async_op=...)``, a torch collective writing
    ``out``, staged through host memory for gloo on CUDA tensors.  Returns
    ``then()`` (``out`` by default) once it is done, or with ``async_op``
    an :class:`AsyncOpHandle` that finishes it."""
    staged = out.is_cuda and group.backend() == "gloo"
    t0 = time.perf_counter()
    if staged:
        host_out = torch.empty(out.shape, dtype=out.dtype)
        work = fn(host_out, *[t.cpu() for t in inputs], async_op=async_op)
    else:
        work = fn(out, *inputs, async_op=async_op)
    issued = time.perf_counter() - t0

    def finish():
        t1 = time.perf_counter()
        if work is not None and async_op:
            work.wait()
        if staged:
            out.copy_(host_out)
            STAGED_SECONDS[name] += issued + time.perf_counter() - t1
            STAGED[name] += sum(t.numel() * t.element_size() for t in inputs) \
                + out.numel() * out.element_size()
        return then() if then is not None else out

    if async_op:
        return AsyncOpHandle(work, finish)
    return finish()


def _done(value, async_op):
    """A collective's result as its caller asked for it: a finished handle
    under ``async_op`` (a group of one moves nothing)."""
    return AsyncOpHandle(None, lambda: value) if async_op else value


def timed_op(fn=None, *, payload=0):
    """Time each eager call of the collective ``fn`` on the host clock (a
    CUDA payload ends in ``torch.cuda.synchronize()``) and log it with
    :data:`comms_logger` when that is enabled; ``payload`` is the position
    of the argument whose bytes are the message.  A call made inside
    another timed call, and an async one, is not logged."""
    if fn is None:
        return functools.partial(timed_op, payload=payload)

    sig = inspect.signature(fn)

    def recorded(*args, **kwargs):
        global _recorded_depth
        if _site_recorder is None or _recorded_depth:
            return fn(*args, **kwargs)
        call = sig.bind(*args, **kwargs)
        call.apply_defaults()
        group = _resolve_group(call.arguments.get("group"))
        if group.size() > 1:            # a group of one moves nothing
            _site_recorder(fn.__name__, args[payload], group.axes)
        _recorded_depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _recorded_depth -= 1

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _timed_depth
        if not comms_logger.enabled or _timed_depth or _is_async(kwargs.get("async_op")):
            return recorded(*args, **kwargs)
        call = sig.bind(*args, **kwargs)
        call.apply_defaults()
        tensor = args[payload]
        _timed_depth += 1
        try:
            t0 = time.perf_counter()
            result = recorded(*args, **kwargs)
            if tensor.is_cuda:
                torch.cuda.synchronize(tensor.device)
            latency = time.perf_counter() - t0
        finally:
            _timed_depth -= 1
        comms_logger.append(fn.__name__, call.arguments["log_name"], latency,
                            tensor.numel() * tensor.element_size(),
                            _resolve_group(call.arguments["group"]).size())
        return result

    return wrapper


def _finish(out, op, n):
    return out.div_(n) if op == ReduceOp.AVG else out


# -------------------------------------------------------------- collectives
@timed_op
def all_reduce(tensor, op=ReduceOp.SUM, group=None, async_op=False,
               log_name="all_reduce"):
    """The group's reduction of ``tensor``, written into it and returned
    (a handle under ``async_op="always"``, or ``async_op`` and
    ``comm.overlap.eager_async``)."""
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    group = _resolve_group(group)
    n = group.size()
    async_op = _is_async(async_op)
    if n == 1:
        return _done(tensor, async_op)
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()

    def reduce(out, x, async_op=False):
        if out is not x:
            out.copy_(x)
        return dist.all_reduce(out, op=_TORCH_OPS[op], group=group.pg, async_op=async_op)

    def then():
        _finish(buf, op, n)
        if buf is not tensor:
            tensor.copy_(buf)
        return tensor

    return _run(log_name, group, reduce, buf, buf, async_op=async_op, then=then)


@timed_op
def all_gather(tensor, group=None, axis=0, tiled=True, async_op=False,
               log_name="all_gather"):
    """Every rank's ``tensor`` concatenated along ``axis`` in rank order
    (``tiled``), or stacked on a new leading axis (not tiled)."""
    group = _resolve_group(group)
    n = group.size()
    async_op = _is_async(async_op)
    if n == 1:
        return _done(tensor if tiled else tensor[None], async_op)
    x = _wire((tensor.movedim(axis, 0) if tiled else tensor[None]).contiguous())
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)

    def then():
        y = out.view(tensor.dtype)
        return y.movedim(0, axis) if tiled else y

    return _run(log_name, group,
                lambda o, i, async_op=False: dist.all_gather_into_tensor(
                    o, i, group=group.pg, async_op=async_op),
                out, x, async_op=async_op, then=then)


@timed_op(payload=1)
def all_gather_into(out, tensor, group=None, log_name="all_gather"):
    """:func:`all_gather` (tiled along dim 0) into the preallocated ``out``
    of ``group.size() * tensor.numel()`` elements."""
    group = _resolve_group(group)
    if group.size() == 1:
        return out.copy_(tensor.reshape(out.shape))
    _run(log_name, group,
         lambda o, i, async_op=False: dist.all_gather_into_tensor(o, i, group=group.pg),
         _wire(out), _wire(tensor.contiguous()))
    return out


@timed_op
def reduce_scatter(tensor, group=None, axis=0, op=ReduceOp.SUM, async_op=False,
                   log_name="reduce_scatter"):
    """The group's sum of ``tensor``; each rank keeps its chunk along
    ``axis`` (``tensor.shape[axis]`` divisible by the group size)."""
    group = _resolve_group(group)
    n = group.size()
    async_op = _is_async(async_op)
    if n == 1:
        return _done(tensor, async_op)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter supports sum and avg, not {op}")
    x = tensor.movedim(axis, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim {axis} ({x.shape[0]}) not divisible by {n}")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _run(log_name, group,
                lambda o, i, async_op=False: dist.reduce_scatter_tensor(
                    o, i, group=group.pg, async_op=async_op),
                out, x, async_op=async_op,
                then=lambda: _finish(out, op, n).movedim(0, axis))


@timed_op
def all_to_all(tensor, group=None, split_axis=0, concat_axis=0, tiled=True,
               log_name="all_to_all"):
    """Split ``tensor`` along ``split_axis`` into one chunk per rank and send
    chunk j to rank j (the reference's ``all_to_all_single``).  ``tiled``:
    what arrives is concatenated along ``concat_axis`` in rank order.  Not
    tiled (``jax.lax.all_to_all``'s ``tiled=False``): ``split_axis`` has
    the group's size and is removed, and what arrives is stacked along a
    new axis at ``concat_axis`` of the result, in rank order."""
    group = _resolve_group(group)
    n = group.size()
    if not tiled and tensor.shape[split_axis] != n:
        raise ValueError(f"tiled=False: dim {split_axis} ({tensor.shape[split_axis]}) "
                         f"must equal the group size {n}")
    if n == 1:
        return tensor if tiled else tensor.movedim(split_axis, concat_axis)
    x = _wire(tensor.movedim(split_axis, 0).contiguous())
    if x.shape[0] % n:
        raise ValueError(f"dim {split_axis} ({x.shape[0]}) not divisible by {n}")
    out = torch.empty_like(x)
    _run(log_name, group,
         lambda o, i, async_op=False: dist.all_to_all_single(o, i, group=group.pg),
         out, x)
    out = out.view(tensor.dtype)
    if not tiled:
        return out.movedim(0, concat_axis)
    chunks = out.chunk(n, 0)
    return torch.cat([c.movedim(0, split_axis) for c in chunks], dim=concat_axis)


@timed_op
def all_to_all_v(tensor, send_counts, recv_counts, group=None, log_name="all_to_all"):
    """Rows of ``tensor`` (dim 0) in runs of ``send_counts[j]`` rows, the
    j-th run to the group's j-th rank; returns the ``recv_counts[j]`` rows
    from each rank j, concatenated in rank order (the reference's
    ``all_to_all_single`` with split sizes).  Every rank must know what it
    receives."""
    group = _resolve_group(group)
    if group.size() == 1:
        return tensor
    x = _wire(tensor.contiguous())
    out = torch.empty((sum(recv_counts),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(log_name, group,
         lambda o, i, async_op=False: dist.all_to_all_single(
             o, i, list(recv_counts), list(send_counts), group=group.pg),
         out, x)
    return out.view(tensor.dtype)


@timed_op
def broadcast(tensor, src=0, group=None, log_name="broadcast"):
    """The group's ``src``-th rank's ``tensor`` on every rank, written into
    it and returned."""
    group = _resolve_group(group)
    if group.size() == 1:
        return tensor
    buf = _wire(tensor if tensor.is_contiguous() else tensor.contiguous())

    def bcast(out, x, async_op=False):
        if out is not x:
            out.copy_(x)
        dist.broadcast(out, src=group.global_rank(src), group=group.pg)

    _run(log_name, group, bcast, buf, buf)
    if buf.data_ptr() != tensor.data_ptr():
        tensor.copy_(buf.view(tensor.dtype))
    return tensor


# ------------------------------------------------------------ point to point
class _P2PHandle:
    """An issued send or receive: :meth:`wait` finishes it (a receive
    returns its tensor, copied up from host memory when staged; a send
    None)."""

    def __init__(self, work, finish, name, staged):
        self._work, self._finish = work, finish
        self._name, self._staged = name, staged
        self._done, self._value = False, None

    def wait(self):
        if not self._done:
            t1 = time.perf_counter()
            if self._work is not None:
                self._work.wait()
            self._value = self._finish()
            self._done = True
            if self._staged:
                STAGED_SECONDS[self._name] += time.perf_counter() - t1
        return self._value


def _p2p(kind, tensor, peer, group, log_name, async_op):
    """One send (``kind`` "send") of ``tensor`` to, or receive into it from,
    the group's ``peer``-th rank; staged through host memory on gloo for a
    CUDA tensor (the host copy of a send is made before it is issued, so
    its buffer may be reused at once; unstaged, the send keeps ``tensor``
    until it completes)."""
    group = _resolve_group(group or get_pipe_parallel_group())
    if group.size() == 1:
        raise ValueError(f"{kind} needs a group of two or more ranks")
    buf = _wire(tensor if tensor.is_contiguous() else tensor.contiguous())
    staged = buf.is_cuda and group.backend() == "gloo"
    nbytes = buf.numel() * buf.element_size()
    t0 = time.perf_counter()
    dst_rank = group.global_rank(peer)
    if kind == "send":
        # the wire buffer lives until the send completes: the tensor itself,
        # or (staged) its host copy, so the device tensor may go at once
        wire = [buf.cpu() if staged else buf]
        work = dist.isend(wire[0], dst_rank, group=group.pg)

        def finish():
            wire.clear()
    else:
        wire = torch.empty(buf.shape, dtype=buf.dtype) if staged else buf
        work = dist.irecv(wire, dst_rank, group=group.pg)

        def finish():
            if staged:
                buf.copy_(wire)
            if buf.data_ptr() != tensor.data_ptr():
                tensor.copy_(buf.view(tensor.dtype))
            return tensor
    handle = _P2PHandle(work, finish, log_name, staged)
    if staged:
        STAGED[log_name] += nbytes
        STAGED_SECONDS[log_name] += time.perf_counter() - t0
    if async_op:
        return handle
    out = handle.wait()
    if comms_logger.enabled and not _timed_depth:
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        comms_logger.append(kind, log_name, time.perf_counter() - t0, nbytes, 2)
    return out


def send(tensor, dst, group=None, log_name="pipe_ppermute"):
    """Send ``tensor`` to the group's ``dst``-th rank (the pp group by
    default); returns once the transfer is done."""
    return _p2p("send", tensor, dst, group, log_name, False)


def recv(tensor, src, group=None, log_name="pipe_ppermute"):
    """Receive into ``tensor`` from the group's ``src``-th rank; returns it."""
    return _p2p("recv", tensor, src, group, log_name, False)


def isend(tensor, dst, group=None, log_name="pipe_ppermute"):
    """:func:`send` issued: returns a handle whose ``wait()`` finishes it."""
    return _p2p("send", tensor, dst, group, log_name, True)


def irecv(tensor, src, group=None, log_name="pipe_ppermute"):
    """:func:`recv` issued: ``wait()`` on the handle returns the tensor."""
    return _p2p("recv", tensor, src, group, log_name, True)


def ppermute(tensor, perm, group=None, log_name="pipe_ppermute"):
    """``jax.lax.ppermute`` over the group (the pp group by default):
    ``perm`` pairs ``(src, dst)`` of group ranks; each rank sends its
    ``tensor`` to its ``dst`` and returns what its ``src`` sent (zeros
    where no pair names it as a destination).  Every rank calls it with the
    same ``perm``."""
    group = _resolve_group(group or get_pipe_parallel_group())
    me = group.rank()
    out = torch.zeros_like(tensor)
    if group.size() == 1:
        return out.copy_(tensor) if (0, 0) in [tuple(p) for p in perm] else out
    handles = []
    for src, dst in perm:
        if dst == me and src != me:
            handles.append(irecv(out, src, group, log_name))
    for src, dst in perm:
        if src == me and dst != me:
            handles.append(isend(tensor, dst, group, log_name))
        elif src == me == dst:
            out.copy_(tensor)
    for h in handles:
        h.wait()
    return out


def send_next(tensor, group=None):
    """Shift values to the next rank along the pp ring (the last wraps to 0)."""
    group = _resolve_group(group or get_pipe_parallel_group())
    n = group.size()
    return ppermute(tensor, [(i, (i + 1) % n) for i in range(n)], group)


def recv_prev(tensor, group=None):
    """:func:`send_next` from the receiver's side."""
    return send_next(tensor, group)


def all_gather_object(obj, group=None):
    """Every rank's picklable ``obj``, in group rank order (the checkpoints'
    gathers of stage trees of unequal shapes)."""
    group = _resolve_group(group)
    if group.size() == 1:
        return [obj]
    out = [None] * group.size()
    dist.all_gather_object(out, obj, group=group.pg)
    return out


def barrier(group=None):
    """Wait until every rank of ``group`` reaches it."""
    group = _resolve_group(group)
    if group.size() > 1:
        dist.barrier(group=group.pg)


# ------------------------------------------------- quantized collectives
def _gradient_wire_dtype(wire_dtype):
    """The config's ``fp8`` spelling for the gradient wire: e5m2 (range over
    precision: quantized partial sums overflow before they underflow).
    Activation surfaces (the KV pools) resolve ``fp8`` to e4m3."""
    return "fp8_e5m2" if str(wire_dtype).lower() == "fp8" else wire_dtype


def _hier_groups(intra_group, inter_group, collapse=False):
    """The one decision of flat or two-level for a quantized collective:
    ``(intra, inter)``, two-level over both, or ``(group, None)``, flat over
    one.  Given only an intra hop, the inter hop is the rest of the ZeRO
    group (the intra group's ``complement``; none where that is one
    process), as the JAX package's ``_hier_axes`` takes the group's other
    active axes: an intra hop of one process still runs the two-level
    schedule, with a trivial hop.  ``collapse`` (ZeRO++'s ``qgz_*``, JAX
    ``qgz_reduce_scatter``): a hop of one process is dropped, so the
    schedule is flat over the other hop, ``(None, None)`` where neither
    spans more than one.  ``(None, None)`` without groups."""
    if intra_group is None and inter_group is None:
        return None, None
    if collapse:
        wide = [_resolve_group(g) for g in (intra_group, inter_group)
                if g is not None and _resolve_group(g).size() > 1]
        if len(wide) == 2:
            return tuple(wide)
        return (wide[0] if wide else None), None
    if intra_group is None:
        raise ValueError("a two-level quantized collective needs its intra_group")
    intra = _resolve_group(intra_group)
    inter = inter_group if inter_group is not None else intra.complement
    return intra, (_resolve_group(inter) if inter is not None else None)


def _run_quantized(collective, x, n_elems, intra, inter, group_size, impl, wire_dtype):
    """Run a quantized ``all_reduce`` or ``reduce_scatter`` of ``x``: two-level
    over ``intra`` then ``inter`` where ``inter`` is given, else flat over
    ``intra``; its analytic wire bytes over ``n_elems`` elements go to the
    step the engine records (``comms_logger.record``; no-op outside one).
    The facade and ZeRO++'s ``qgz_*`` wrappers pick the hops with
    :func:`_hier_groups` and run them here."""
    from . import compressed
    from ..telemetry import wire

    n1, n2 = intra.size(), (inter.size() if inter is not None else 1)
    if comms_logger._capturing and n1 * n2 > 1:
        variant = wire.quantized_variant(n1, n2, wire_dtype)
        comms_logger.record(collective,
                            wire.wire_bytes(collective, variant, n_elems, n1, n2, group_size),
                            n1 * n2, variant=variant)
    if inter is not None:
        fn = getattr(compressed, f"hierarchical_quantized_{collective}")
        return fn(x, intra, inter, group_size, impl=impl, wire_dtype=wire_dtype)
    fn = getattr(compressed, f"quantized_{collective}")
    return fn(x, intra, group_size, impl=impl, wire_dtype=wire_dtype)


@timed_op
def all_reduce_quantized(tensor, op=ReduceOp.SUM, group=None, intra_group=None,
                         inter_group=None, group_size=128, impl="auto",
                         wire_dtype="int8", log_name="all_reduce_quantized"):
    """All-reduce with a block-scaled wire format (qgZ): ``tensor``
    flattened, zero-padded to a multiple of ``group size x group_size`` and
    seen as rows of ``group_size``.  Flat over ``group``: quantize,
    all-to-all, B5 dequant-reduce, requantize, all-gather, dequantize.
    Two-level over ``intra_group`` and ``inter_group`` (the intra hop
    first): ``comm/compressed.py`` ``hierarchical_quantized_all_reduce``.
    Returns a new tensor of ``tensor``'s shape and dtype."""
    wire_dtype = _gradient_wire_dtype(wire_dtype)
    intra, inter = _hier_groups(intra_group, inter_group)
    group = _resolve_group(group or (intra if inter is None and intra is not None
                                     else get_data_parallel_group()))
    n = group.size()
    if n == 1:
        return tensor
    flat = tensor.reshape(-1)
    pad = (-flat.numel()) % (n * group_size)
    rows = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, group_size)
    y = _run_quantized("all_reduce", rows, flat.numel() + pad, intra or group, inter,
                       group_size, impl, wire_dtype)
    y = y.reshape(-1)[:flat.numel()].reshape(tensor.shape).to(tensor.dtype)
    return y / n if op == ReduceOp.AVG else y


@timed_op
def reduce_scatter_quantized(tensor, group=None, intra_group=None, inter_group=None,
                             group_size=128, impl="auto", wire_dtype="int8",
                             log_name="reduce_scatter_quantized"):
    """Reduce-scatter along dim 0 with a block-scaled wire format: each rank
    receives its fp32 chunk of the group sum (``tensor.shape[0]`` divisible
    by the group size).  Two-level over ``intra_group`` and
    ``inter_group``: participant ``(i_intra, i_inter)`` receives chunk
    ``i_intra * n_inter + i_inter`` (the matching quantized all-gathers of
    :func:`all_reduce_quantized` invert it)."""
    wire_dtype = _gradient_wire_dtype(wire_dtype)
    intra, inter = _hier_groups(intra_group, inter_group)
    group = _resolve_group(group or (intra if inter is None and intra is not None
                                     else get_data_parallel_group()))
    if group.size() == 1:
        return tensor
    return _run_quantized("reduce_scatter", tensor, tensor.numel(), intra or group, inter,
                          group_size, impl, wire_dtype)
