"""ZeRO stages as a partition of the engine's flat buffers (counterpart of
``deeperspeed_tpu/runtime/zero/sharding.py``).

The stages mean what they mean in the JAX package (``sharding.py:1-25``):

* stage 0: fp32 masters, optimizer state and gradients replicated on every
  rank; the gradients all-reduced;
* stage 1: masters and optimizer state partitioned over the data-parallel
  ranks; each rank accumulates whole gradients and reduce-scatters them
  once a step, updates its partition, and the compute copy is all-gathered;
* stage 2: the gradients partitioned too: each microbatch's gradients are
  reduce-scattered into the rank's partition as they are made;
* stage 3: the compute parameters of two or more dimensions and at least
  ``param_persistence_threshold`` elements partitioned too, gathered where
  they are used (``stage3.py``); the others (vectors, small matrices) stay
  whole on every rank, as the JAX package keeps them replicated.

The JAX package decides a placement per leaf and lets XLA emit the
collectives.  Here the layout is upstream DeepSpeed's flat partition
(``stage_1_and_2.py``): parameters, in order, are laid back to back in a
*region* -- one flat buffer of one compute dtype -- padded to a multiple of
the world size and cut into ``world`` equal contiguous parts; rank r owns
part r.  A parameter may straddle two parts, so a rank's optimizer sees
*pieces*: the stretch of each parameter inside its part.

Regions: at stages 0-2, one per compute dtype (the cast parameters, then
those kept in fp32); at stage 3, one per (unit, compute dtype, persistent
or not), where a unit is the module whose forward gathers the parameters
(an element of a top-level ``ModuleList``, or a top-level child, or a
module that asks to be one: a ``TiledLinear`` tile).

The partitions are cut over the engine's partition group: the ZeRO group
(``dp x zshard x ep`` of the rank's tensor-parallel slice), or under MiCS
the ``zshard`` group alone (``world`` and ``rank`` here are that group's
size and this rank's place in it).  MoE expert parameters, whose leading
dim the ``ep`` axis splits, get regions of their own (``expert``), after
the others at stages 0-2 and after the others of their unit at stage 3:
they are cut over the expert-data-parallel group (the ZeRO axes less
``ep``; under MiCS still ``zshard``), as the JAX package's ZeRO plan leaves
``ep`` out of an expert leaf's free axes.  Each region carries the
partition this rank holds of it (``index``).
"""

import dataclasses
from typing import List

import torch


@dataclasses.dataclass
class Region:
    """Parameters laid back to back in one flat buffer of ``dtype`` (their
    compute type), cut into ``parts`` equal contiguous partitions."""

    names: List[str]
    shapes: List[tuple]
    offsets: List[int]      # where each parameter starts in the region
    dtype: torch.dtype
    parts: int              # 1 at stage 0 (nothing partitioned)
    unit: str = ""          # stage 3: the module that gathers it
    gathered: bool = False  # stage 3: compute parameters partitioned too
    expert: bool = False    # MoE expert parameters (cut over the expert group)
    index: int = 0          # the partition this rank holds

    @property
    def numel(self):
        return self.offsets[-1] + _size(self.shapes[-1]) if self.names else 0

    @property
    def part(self):
        """Elements of one partition."""
        return -(-self.numel // self.parts)

    @property
    def padded(self):
        return self.part * self.parts

    def span(self, rank):
        """[lo, hi) of the region that partition ``rank`` holds."""
        lo = min(rank * self.part, self.numel)
        return lo, min(lo + self.part, self.numel)

    def pieces(self, rank):
        """(name, shape, start, stop in the parameter, offset in the
        partition) for each parameter partition ``rank`` holds part of."""
        lo, hi = self.span(rank)
        for name, shape, off in zip(self.names, self.shapes, self.offsets):
            a, b = max(off, lo), min(off + _size(shape), hi)
            if a < b:
                yield name, shape, a - off, b - off, a - lo


def _size(shape):
    n = 1
    for d in shape:
        n *= d
    return n


@dataclasses.dataclass
class ZeroPartitionPlan:
    stage: int
    world: int
    index: int              # the partition this rank holds of a dense region
    regions: List[Region]

    @property
    def order(self):
        """Every parameter name, in region order."""
        return [n for r in self.regions for n in r.names]

    def bases(self):
        """Where each region's partition starts in the rank's flat buffers
        (masters, gradients), which hold one partition of every region."""
        out, off = [], 0
        for r in self.regions:
            out.append(off)
            off += r.part
        return out

    @property
    def local_numel(self):
        return sum(r.part for r in self.regions)


def unit_of(name, module):
    """The module path whose forward gathers parameter ``name`` at stage 3:
    the first module on its path that sets ``zero3_unit`` (a
    ``TiledLinear`` tile), else ``layers.3`` for an element of a top-level
    ``ModuleList``, else the top-level child (``embed_in``), or ``""`` for
    the root's own."""
    parts = name.split(".")
    mod = module
    for k in range(len(parts) - 1):
        mod = getattr(mod, parts[k])
        if getattr(mod, "zero3_unit", False):
            return ".".join(parts[:k + 1])
    if len(parts) == 1:
        return ""
    child = getattr(module, parts[0])
    if isinstance(child, torch.nn.ModuleList):
        return ".".join(parts[:2])
    return parts[0]


def _partitioned(shape, threshold):
    """Whether stage 3 partitions a compute parameter of ``shape``."""
    return len(shape) >= 2 and _size(shape) >= threshold


def _region(params, names, dtype, parts, index, unit="", gathered=False, expert=False):
    shapes = [tuple(params[n][0]) for n in names]
    offsets, off = [], 0
    for s in shapes:
        offsets.append(off)
        off += _size(s)
    return Region(list(names), shapes, offsets, dtype, parts, unit, gathered, expert,
                  index if parts > 1 else 0)


def build_partition_plan(params, stage, world, rank, persistence_threshold=100_000,
                         units=None, experts=(), expert_world=1, expert_rank=0):
    """The regions of ``params`` (an ordered dict name -> (shape, compute
    dtype)) at ``stage`` over ``world`` ranks (this one ``rank``); the
    ``experts`` names in regions of their own over ``expert_world`` ranks
    (this one ``expert_rank``).  ``units`` maps each name to its gathering
    module (stage 3)."""
    experts = set(experts)
    cut = {False: (world if stage >= 1 else 1, rank),
           True: (expert_world if stage >= 1 else 1, expert_rank)}
    cast = [n for n, (_, dt) in params.items() if dt != torch.float32]
    kept = [n for n, (_, dt) in params.items() if dt == torch.float32]
    regions = []

    def add(names, expert, unit="", gathered=False):
        if names:
            regions.append(_region(params, names, params[names[0]][1], *cut[expert],
                                   unit, gathered, expert))

    if stage < 3:
        for expert in (False, True):
            for names in (cast, kept):
                add([n for n in names if (n in experts) == expert], expert)
        return ZeroPartitionPlan(stage, world, rank if stage >= 1 and world > 1 else 0,
                                 regions)
    seen = []
    for n in params:
        if units[n] not in seen:
            seen.append(units[n])
    for unit in seen:
        for expert in (False, True):
            for names in (cast, kept):
                mine = [n for n in names if units[n] == unit and (n in experts) == expert]
                for gathered in (False, True):
                    add([n for n in mine if gathered == _partitioned(
                        params[n][0], persistence_threshold)], expert, unit, gathered)
    return ZeroPartitionPlan(stage, world, rank, regions)


def stage3_static_peak_bytes(params):
    """Device parameter residency of the STATIC stage-3 placement (the JAX
    package's ``sharding.py:323``): every compute parameter whole at once --
    the figure ``comm.memplan.assert_hbm_fit`` guards against a synthetic
    HBM budget.  ``params``: ``(shape, dtype)`` of each compute parameter
    (whole, before any partition)."""
    return sum(_size(shape) * torch.empty(0, dtype=dtype).element_size()
               for shape, dtype in params)
