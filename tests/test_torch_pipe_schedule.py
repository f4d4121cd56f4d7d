"""The pipeline's instruction streams and partitions in the PyTorch port
(``runtime/pipe/schedule.py``, ``runtime/pipe/module.py``) against the JAX
package's, on the CPU.

* ``TrainSchedule`` (1F1B), ``InferenceSchedule`` and
  ``DataParallelSchedule``: every step's instructions, names and buffer
  ids, equal over a grid of microbatches x stages x stage, and
  ``num_pipe_buffers``;
* the port's own ``GPipeSchedule``: every forward before every backward,
  each microbatch's transfers paired across neighbouring stages;
* ``PipelineModule``'s partitions (``uniform``, ``parameters``, ``type:``)
  and tied indices equal the JAX module's over the same specs, the layers
  on both sides holding the same parameter counts.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
from torch import nn

from deeperspeed_tpu.runtime.pipe import module as jmod
from deeperspeed_tpu.runtime.pipe import schedule as jsched
from deeperspeed_tpu_torch.runtime.pipe import module as tmod
from deeperspeed_tpu_torch.runtime.pipe import schedule as tsched
import torch_threads  # noqa: F401  (torch at one intra-op thread)

GRID = [(m, s, i) for m in (1, 2, 3, 4, 8) for s in (1, 2, 3, 4) for i in range(s)]


def _stream(schedule):
    return [[(c.name, tuple(sorted(c.kwargs.items()))) for c in step]
            for step in schedule.steps()]


@pytest.mark.parametrize("kind", ["TrainSchedule", "InferenceSchedule",
                                  "DataParallelSchedule"])
def test_streams_equal_the_jax_schedules(kind):
    for m, s, i in GRID:
        if kind == "DataParallelSchedule" and s > 1:
            continue
        mine, ref = getattr(tsched, kind)(m, s, i), getattr(jsched, kind)(m, s, i)
        assert _stream(mine) == _stream(ref), (m, s, i)
        assert mine.num_pipe_buffers() == ref.num_pipe_buffers(), (m, s, i)
        assert [len(x) for x in mine] == [len(x) for x in ref]


def test_gpipe_stream_forwards_first_and_pairs_transfers():
    for m, s, i in GRID:
        steps = [[c.name for c in step] for step in tsched.GPipeSchedule(m, s, i).steps()]
        names = [n for step in steps for n in step]
        last_fwd = max(k for k, n in enumerate(names) if n == "ForwardPass")
        first_bwd = min(k for k, n in enumerate(names) if n == "BackwardPass")
        assert last_fwd < first_bwd and names.count("ForwardPass") == m
        assert names.count("SendActivation") == (m if i < s - 1 else 0)
        assert names.count("RecvActivation") == (m if i > 0 else 0)
        assert names.count("SendGrad") == (m if i > 0 else 0)
        assert names.count("RecvGrad") == (m if i < s - 1 else 0)
        assert names[-3:] == ["ReduceTiedGrads", "ReduceGrads", "OptimizerStep"]
        assert tsched.GPipeSchedule(m, s, i).num_pipe_buffers() == m


# layers of known parameter counts on both sides: a Dense of WIDTH -> width
WIDTH = 4


def _flax_layer(width):
    class Layer(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(width)(x)

        def example_input(self):
            return jnp.zeros((1, WIDTH))

    Layer.__name__ = f"Dense{width}"
    return Layer


def _torch_layer(width):
    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = nn.Linear(WIDTH, width)

    Layer.__name__ = f"Dense{width}"
    return Layer


WIDTHS = [1, 8, 2, 30, 3, 12, 3, 5, 7, 1]
TIES = {0: "emb", 9: "emb", 4: "mid", 6: "mid"}


def _specs(pkg, layer):
    out = []
    for i, w in enumerate(WIDTHS):
        if i in TIES:
            out.append(pkg.TiedLayerSpec(TIES[i], layer(w)))
        else:
            out.append(pkg.LayerSpec(layer(w)))
    return out


@pytest.mark.parametrize("method", ["uniform", "parameters", "type:dense(1|3)",
                                    "type:^dense"])
def test_partitions_and_ties_equal_the_jax_module(method):
    for stages in (1, 2, 3, 4, 5):
        ref = jmod.PipelineModule(_specs(jmod, _flax_layer), num_stages=stages,
                                  partition_method=method)
        mine = tmod.PipelineModule(_specs(tmod, _torch_layer), num_stages=stages,
                                   partition_method=method)
        assert mine.parts == ref.parts, (method, stages)
        assert mine.tied_specs == ref.tied_specs
        for s in range(stages):
            assert [type(x).__name__ for x in mine.stage_layers(s)] == \
                [type(x).__name__ for x in ref.stage_layers(s)]
    if method == "parameters":
        counts = tmod.PipelineModule(_specs(tmod, _torch_layer), num_stages=2,
                                     partition_method=method)._count_layer_params()
        assert counts == [WIDTH * w + w for w in WIDTHS]


def test_partition_helpers_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    for n in range(1, 13):
        for parts in range(1, 7):
            assert tmod.partition_uniform(n, parts) == jmod.partition_uniform(n, parts)
            w = rng.integers(0, 50, n).tolist()
            if max(w) == 0:
                w[0] = 1
            assert tmod.partition_balanced(w, parts) == jmod.partition_balanced(w, parts)


def test_pipe_topology_equals_the_jax_one():
    from deeperspeed_tpu.parallel.topology import PipeModelDataParallelTopology as Jax
    from deeperspeed_tpu_torch.parallel import MeshTopology, PipeModelDataParallelTopology

    for pp, mp, dp in ((2, 1, 2), (3, 2, 2), (1, 2, 3)):
        mine, ref = PipeModelDataParallelTopology(pp, mp, dp), Jax(pp, mp, dp)
        assert mine.mapping == ref.mapping and mine.get_axis_names() == ref.get_axis_names()
        for axis in ("pipe", "data", "model"):
            assert mine.get_axis_comm_lists(axis) == ref.get_axis_comm_lists(axis)
        # the mesh lays ranks out alike: pp outermost, then dp, then tp
        mesh = MeshTopology.__new__(MeshTopology)
        mesh.sizes = dict(pp=pp, dp=dp, zshard=1, ep=1, sp=1, tp=mp)
        for r in range(pp * mp * dp):
            c, m = mine.get_coord(r), mesh.coords(r)
            assert (c.pipe, c.data, c.model) == (m["pp"], m["dp"], m["tp"])


def test_build_stage_draws_each_layer_alike_at_any_pp():
    """A layer's weights come from the seed and its global index: stage 1
    of 2 holds what the one stage of 1 holds at those indices; a tie's
    members share one module."""
    one = tmod.PipelineModule(_specs(tmod, _torch_layer), num_stages=1,
                              partition_method="uniform").build_stage(0)
    two = tmod.PipelineModule(_specs(tmod, _torch_layer), num_stages=2,
                              partition_method="uniform").build_stage(1)
    for layer in two:
        ref = one[layer.index].module.dense
        assert (layer.module.dense.weight == ref.weight).all()
    mid = [layer.module for layer in one if layer.tied_key == "mid"]
    assert len(mid) == 2 and mid[0] is mid[1]
