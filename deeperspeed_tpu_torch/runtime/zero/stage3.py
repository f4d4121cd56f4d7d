"""ZeRO stage 3: compute parameters gathered where they are used.

The JAX package leaves the gathers to XLA at each use site.  Here each
*unit* (``sharding.unit_of``: a transformer block, the embedding, the
head) that owns partitioned regions gets its ``forward`` wrapped:

* the wrapper runs the unit under recompute
  (``utils.recompute.checkpoint_replaying``, which replays the engine's
  dropout generator), so no activation of the unit -- and no gathered
  weight -- outlives its forward;
* inside, each region's partition (a leaf tensor of the compute dtype,
  ``shard``) is all-gathered into a whole flat buffer, and the unit's
  parameters are swapped for views of it for the duration of the call;
* the recompute in the backward pass gathers again; the gather's backward
  reduce-scatters the buffer's gradient (cast to the communication dtype)
  and adds this rank's part to the engine's accumulation buffer (``sink``),
  or, under the engine's deferred reduction, adds the whole local gradient
  to its whole-gradient buffer, to be reduced once a batch.

Under qwZ (``zero_quantized_weights``) the gather moves int8 values and
fp32 scales (``zero/quantized.py`` ``quantized_all_gather_partition``);
its backward is the plain gather's.

The gather runs over the region's ``group`` and its gradient goes through
the region's ``reduce``: over the ZeRO group by default; under MiCS the
gather runs over the ``zshard`` group from the subgroup partition and the
gradient is reduce-scattered over ``zshard`` then all-reduced over ``dp``;
under hpZ (ZeRO++) the gather runs over ``zshard`` from a secondary shard
(``1/zshard`` of the region, refreshed by the engine once a step after the
update) while the gradient is reduce-scattered over the whole ZeRO group
into the primary partition.  qwZ composes with both.

Outside a call the unit's partitioned parameters hold no data.

A :class:`GatherLedger` (one an engine) counts the gathered bytes live on
the device: a region's buffer is live from its gather to the end of the
unit's call in the forward, and in the backward from the recompute's
gather to the gather's backward, after which autograd frees it.  While it
records (``events``), it keeps the order of those gathers and releases,
from which ``comm/memplan.py`` ``plan_param_movement`` makes the stage-3
movement plan.
"""

import contextlib

import torch

from ...comm import all_gather_into, reduce_scatter
from ...utils.recompute import checkpoint_replaying
from .quantized import quantized_all_gather_partition


class _GatherRegion(torch.autograd.Function):
    """shard [part] -> the whole region [padded] (through int8 under qwZ);
    backward hands the gradient to the region's sink (reduce-scattered, or
    whole under the deferred reduction) and gives the shard none."""

    @staticmethod
    def forward(ctx, shard, gathered):
        ctx.gathered = gathered
        gathered.ledger.gather(gathered)
        if gathered.quantized:
            return quantized_all_gather_partition(shard, gathered.group)
        full = torch.empty(gathered.region.padded, dtype=shard.dtype, device=shard.device)
        return all_gather_into(full, shard, gathered.group, log_name="stage3_gather")

    @staticmethod
    def backward(ctx, grad_full):
        g = ctx.gathered
        g.ledger.release(g)             # the recompute's buffer: freed after this
        if g.deferred:
            g.sink(grad_full)
        else:
            g.sink(g.reduce(grad_full.to(g.comm_dtype).contiguous()))
        return None, None


class GatherLedger:
    """The gathered bytes live on the device (``live_bytes``) and their most
    (``peak_bytes``); with ``events`` a list, each gather and release is
    appended to it as ``(kind, label, nbytes)``."""

    def __init__(self):
        self.live_bytes = 0
        self.peak_bytes = 0
        self.events = None

    def gather(self, region):
        self.live_bytes += region.nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if self.events is not None:
            self.events.append(("gather", region.label, region.nbytes))

    def release(self, region):
        self.live_bytes -= region.nbytes
        if self.events is not None:
            self.events.append(("release", region.label, region.nbytes))


class GatheredRegion:
    """A partitioned region of compute parameters: its ``shard`` (this
    rank's part of the region in the gather ``group``, a leaf the
    recompute tracks) and where its gradient goes (``sink``: a callable
    taking this rank's reduced partition, made by ``reduce`` from the
    whole region's local gradient -- a reduce-scatter over ``group`` by
    default -- or with ``deferred`` the whole local gradient).
    ``quantized``: the gather moves int8 (qwZ).  ``ledger`` counts its
    gathered buffer (``nbytes``) under ``label``."""

    def __init__(self, region, shard, group, comm_dtype, sink, deferred=False,
                 quantized=False, reduce=None, ledger=None, label=""):
        self.region, self.shard, self.group = region, shard, group
        self.comm_dtype, self.sink = comm_dtype, sink
        self.deferred, self.quantized = deferred, quantized
        self.reduce = reduce or (lambda g: reduce_scatter(g, group, log_name="grad_reduce"))
        self.ledger = ledger or GatherLedger()
        self.label = label or region.unit
        self.nbytes = region.padded * shard.element_size()

    def views(self, full, prefix):
        """The region's parameters as views of the gathered buffer, by
        their names inside the unit (``prefix`` stripped)."""
        r = self.region
        return {n[len(prefix):]: full[off:off + _numel(shape)].view(shape)
                for n, shape, off in zip(r.names, r.shapes, r.offsets)}


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


@contextlib.contextmanager
def _swapped(module, tensors):
    """``module``'s parameters named in ``tensors`` replaced by those
    tensors for the duration of the block."""
    saved = []
    for name, t in tensors.items():
        owner_path, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_path) if owner_path else module
        saved.append((owner, attr, owner._parameters[attr]))
        owner._parameters[attr] = t
    try:
        yield
    finally:
        for owner, attr, p in saved:
            owner._parameters[attr] = p


def _generator(args, kwargs):
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, torch.Generator):
            return v
    return None


def install(module, prefix, regions):
    """Wrap ``module.forward`` (the unit at ``prefix``, e.g. ``layers.3.``)
    to gather ``regions`` (:class:`GatheredRegion`) around each call."""
    inner = module.forward

    def forward(*args, **kwargs):
        runs = [0]

        def run(*shards):
            runs[0] += 1
            tensors = {}
            for g, shard in zip(regions, shards):
                tensors.update(g.views(_GatherRegion.apply(shard, g), prefix))
            with _swapped(module, tensors):
                out = inner(*args, **kwargs)
            if runs[0] == 1:
                # the forward keeps no gathered buffer past the call (the
                # recompute's lives until the gather's backward)
                for g in regions:
                    g.ledger.release(g)
            return out

        return checkpoint_replaying(run, *[g.shard for g in regions],
                                    rng=_generator(args, kwargs))

    module.forward = forward
