"""Process topology (counterpart of ``deeperspeed_tpu/parallel/topology.py``).

* :class:`ProcessTopology` -- cartesian coordinate algebra over named axes
  (reference ``runtime/pipe/topology.py:12``), a plain copy of the JAX
  package's: no devices needed.
* :class:`MeshTopology` -- the process grid over the canonical axes
  ``('pp', 'dp', 'zshard', 'ep', 'sp', 'tp')``.  The JAX package binds them
  to a ``jax.sharding.Mesh`` over its devices reshaped
  ``(pp, dp, zshard, ep, sp, tp)`` row-major; here one process drives one
  device and the ``torch.distributed`` world takes the same order, so rank
  ``r`` is JAX device ``r``, the ``pp`` index outermost.
  ``pp`` (pipeline stages, one process each per data-parallel replica),
  ``dp``, ``zshard`` (the MiCS / hpZ subgroup), ``ep`` (MoE expert
  parallelism), ``sp`` (sequence parallelism: each rank holds a slice of
  every sequence, ``sequence/``) and ``tp`` (tensor parallelism), with
  ``sp`` just outside ``tp``: ``r = (((i_dp * zshard + i_zshard) * ep +
  i_ep) * sp + i_sp) * tp + i_tp`` within a stage.
* :class:`PipeModelDataParallelTopology` -- the reference's ``pipe x data x
  model`` process topology (``runtime/pipe/topology.py``).
"""

from collections import namedtuple
from itertools import product as cartesian

# Canonical mesh axis names.
PP_AXIS = "pp"
DP_AXIS = "dp"
ZSHARD_AXIS = "zshard"  # MiCS/hpZ secondary-partition subgroup (inner dp)
EP_AXIS = "ep"
SP_AXIS = "sp"
TP_AXIS = "tp"
ALL_AXES = (PP_AXIS, DP_AXIS, ZSHARD_AXIS, EP_AXIS, SP_AXIS, TP_AXIS)

# the axes ZeRO shards over (the JAX package's ``sharding.ZERO_AXES``)
ZERO_AXES = (DP_AXIS, ZSHARD_AXIS, EP_AXIS, SP_AXIS)


class ProcessTopology:
    """Cartesian product of named axes; maps ranks <-> coordinates.

    The rank of a coordinate is its index in row-major (C) order over
    ``dims``, with ``axes[0]`` the outermost axis.
    """

    def __init__(self, axes, dims):
        self.axes = list(axes)
        self.dims = list(dims)
        assert len(self.axes) == len(self.dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping = {}
        for coord in cartesian(*[range(d) for d in self.dims]):
            key = self.ProcessCoord(**{axis: coord[self.axes.index(axis)] for axis in self.axes})
            self.mapping[key] = len(self.mapping)

    def get_rank(self, **coord_kwargs):
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"get_rank() needs all axes {self.axes}, got {coord_kwargs}")
        key = self.ProcessCoord(**coord_kwargs)
        return self.mapping[key]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"), inner_sep="_", outer_sep="-"):
        omit_axes = list(omit_axes)
        axes = [a for a in self.get_axis_names() if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis):
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not found in topology")

    def get_axis_comm_lists(self, axis):
        """All rank-lists that vary only along ``axis`` (the axis "groups")."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for coord in cartesian(*[range(self.get_dim(a)) for a in other_axes]):
            other = dict(zip(other_axes, coord))
            ranks = [self.get_rank(**{axis: i}, **other) for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs):
        """Ranks whose coordinates match all given axis=value filters."""

        def _match(coord):
            return all(getattr(coord, k) == v for k, v in filter_kwargs.items())

        return sorted(idx for coord, idx in self.mapping.items() if _match(coord))

    def get_axis_list(self, axis, idx):
        return [r for coord, r in self.mapping.items() if getattr(coord, axis) == idx]

    def world_size(self):
        return len(self.mapping)

    def __str__(self):
        return str(self.mapping)


class PipeModelDataParallelTopology(ProcessTopology):
    """The reference's hybrid topology: axes ``pipe``, ``data``, ``model``
    (row-major, ``pipe`` outermost, as the mesh lays out ``pp``, ``dp``,
    ``tp``)."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


_GLOBAL_MESH = None


def _world_size():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class MeshTopology:
    """The process grid: ``pp * dp * zshard * ep * sp * tp`` processes, the
    ``torch.distributed`` world (1 without one).  ``dp`` defaults to what
    the world leaves after the other axes."""

    def __init__(self, pp=1, dp=None, zshard=1, ep=1, sp=1, tp=1):
        sizes = dict(zip(ALL_AXES, (pp, dp, zshard, ep, sp, tp)))
        world = _world_size()
        rest = pp * zshard * ep * sp * tp
        if dp is None:
            dp = world // rest if world % rest == 0 else 0
        if dp * rest != world:
            raise ValueError(f"mesh pp={pp} x dp={dp} x zshard={zshard} x ep={ep} x "
                             f"sp={sp} x tp={tp} must equal the torch.distributed "
                             f"world size {world}: one process drives one device")
        sizes[DP_AXIS] = dp
        self.sizes = sizes
        self.world = world

    def coords(self, rank):
        """Rank ``rank``'s index along each axis (row-major, ``pp`` outermost)."""
        out = {}
        for axis in reversed(ALL_AXES):
            rank, out[axis] = divmod(rank, self.sizes[axis])
        return {axis: out[axis] for axis in ALL_AXES}

    def groups(self, axes):
        """Every group of ranks that differ only along ``axes``, each in
        rank order (the group's ranks are numbered row-major over
        ``axes``), in an order every process computes alike."""
        out = {}
        for r in range(self.world):
            c = self.coords(r)
            key = tuple(c[a] for a in ALL_AXES if a not in axes)
            out.setdefault(key, []).append(r)
        return list(out.values())

    @property
    def pp(self):
        return self.sizes[PP_AXIS]

    @property
    def dp(self):
        return self.sizes[DP_AXIS]

    @property
    def zshard(self):
        return self.sizes[ZSHARD_AXIS]

    @property
    def ep(self):
        return self.sizes[EP_AXIS]

    @property
    def sp(self):
        return self.sizes[SP_AXIS]

    @property
    def tp(self):
        return self.sizes[TP_AXIS]

    @property
    def data_parallel_size(self):
        """Replication degree seen by the optimizer = dp * zshard * ep * sp
        (as in the JAX package: MiCS shards state within a zshard group
        and replicates it across dp)."""
        return self.dp * self.zshard * self.ep * self.sp


def set_mesh(mesh_topology):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh_topology
    return mesh_topology


def get_mesh():
    """The process-global MeshTopology (a pure data-parallel one over the
    world by default, rebuilt if the world changed since)."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None or _GLOBAL_MESH.world != _world_size():
        _GLOBAL_MESH = MeshTopology()
    return _GLOBAL_MESH


def axis_size(axis):
    return get_mesh().sizes[axis]
