"""The quantized collectives of the PyTorch port at world 2 (two ``gloo``
processes on the CPU, ``torch_dp_worker.py``) against the JAX package's at
dp = 2 (``shard_map`` over two devices of the CPU mesh), on the same
per-rank inputs: ``comm.all_reduce_quantized`` (sum and mean, a length
that needs padding), ``comm.reduce_scatter_quantized`` (rows tiled by the
group, rows that are not, a 3-D input), the flat schedule's
``quantized_reduce_scatter`` and ZeRO++'s ``qgz_all_reduce`` /
``qgz_reduce_scatter`` over one group, over int8 and fp8 (e5m2 on the
gradient wire).  Every result must be the JAX package's bit for bit: both quantize
alike (``test_torch_block_scaled.py``), move the same bytes, and sum the
peers in peer order (B5's plain version, ``test_torch_dequant_reduce.py``).
The facade's plain collectives are checked on the way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu.comm as jdist
from deeperspeed_tpu.comm.compressed import quantized_reduce_scatter as jax_qrs
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu.runtime.zero import quantized as jquantized
from deeperspeed_tpu_torch import comm
from deeperspeed_tpu_torch.parallel import MeshTopology, ProcessTopology
from deeperspeed_tpu_torch.runtime.zero import quantized
from torch_dp_worker import spawn
import torch_threads  # noqa: F401  (torch at one intra-op thread)

# name: (op, wire, per-rank input shape, reduce op)
CASES = {
    "ar-int8-sum": ("all_reduce_quantized", "int8", (301,), "sum"),
    "ar-int8-avg": ("all_reduce_quantized", "int8", (64, 128), "avg"),
    "ar-fp8-sum": ("all_reduce_quantized", "fp8", (3, 200), "sum"),
    "rs-int8-tiled": ("reduce_scatter_quantized", "int8", (8, 256), None),
    "rs-fp8-tiled": ("reduce_scatter_quantized", "fp8", (8, 256), None),
    "rs-int8-row": ("reduce_scatter_quantized", "int8", (6, 96), None),
    "rs-int8-3d": ("reduce_scatter_quantized", "int8", (4, 2, 128), None),
    "qrs-e4m3": ("quantized_reduce_scatter", "fp8_e4m3", (4, 128), None),
    "qgz-ar-int8": ("qgz_all_reduce", "int8", (4, 256), None),
    "qgz-rs-fp8": ("qgz_reduce_scatter", "fp8_e5m2", (6, 128), None),
}


def _inputs():
    rng = np.random.default_rng(21)
    out = {}
    for name, (_, _, shape, _) in CASES.items():
        x = rng.standard_normal((2,) + shape).astype(np.float32)
        x[1] *= 3.0                                  # the ranks' scales differ
        out[name] = x
    return out


def _jax_results(inputs):
    saved = jtopo._GLOBAL_MESH
    mesh = jtopo.set_mesh(jtopo.MeshTopology(dp=2, devices=jax.devices()[:2]))
    results = {}
    try:
        for name, (op, wire, _, reduce) in CASES.items():
            def per_rank(x, op=op, wire=wire, reduce=reduce):
                x = x[0]
                if op == "all_reduce_quantized":
                    y = jdist.all_reduce_quantized(x, op=reduce, wire_dtype=wire)
                elif op == "reduce_scatter_quantized":
                    y = jdist.reduce_scatter_quantized(x, wire_dtype=wire)
                elif op.startswith("qgz_"):
                    y = getattr(jquantized, op)(x, intra_axis="dp", wire_dtype=wire)
                else:
                    y = jax_qrs(x, "dp", 128, wire_dtype=wire)
                return y[None]

            fn = jax.jit(jax.shard_map(per_rank, mesh=mesh.mesh, in_specs=P("dp"),
                                       out_specs=P("dp"), check_vma=False))
            results[name] = np.asarray(fn(jnp.asarray(inputs[name])))
    finally:
        jtopo.set_mesh(saved)
    return results


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    inputs = _inputs()
    arrays = {f"x/{name}/{r}": x[r] for name, x in inputs.items() for r in range(2)}
    spec = {"kind": "comm", "cases": [
        {"name": name, "op": op, "wire": wire, **({"reduce": red} if red else {})}
        for name, (op, wire, _, red) in CASES.items()]}
    ranks = spawn(spec, arrays, tmp_path_factory.mktemp("comm"))
    return _jax_results(inputs), ranks, inputs


@pytest.mark.parametrize("name", list(CASES))
def test_quantized_collective_matches_jax_bit_for_bit(both, name):
    jax_out, ranks, inputs = both
    for r in range(2):
        got = ranks[r][name]
        want = jax_out[name][r]
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (name, r)
    # and they reduce: within the quantization error of the exact sum
    exact = inputs[name].sum(0) / (2 if CASES[name][3] == "avg" else 1)
    got = (ranks[0][name] if CASES[name][0] in ("all_reduce_quantized", "qgz_all_reduce")
           else np.concatenate([ranks[0][name], ranks[1][name]]))
    tol = 0.15 if "fp8" in CASES[name][1] else 0.03
    assert np.abs(got - exact).max() <= tol * np.abs(exact).max()


def test_quantize_int8_matches_jax():
    x = np.random.default_rng(22).standard_normal((5, 256)).astype(np.float32)
    q, scale = quantized.quantize_int8(torch.from_numpy(x))
    jq, jscale = jquantized.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    got = quantized.dequantize_int8(q, scale, torch.float32).numpy()
    want = np.asarray(jquantized.dequantize_int8(jq, jscale, jnp.float32))
    assert np.array_equal(got, want)


def test_one_process_collectives_are_the_identity():
    """Without a process group every collective is the identity on one
    rank (the world is one process)."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert torch.equal(comm.all_reduce(x.clone(), comm.ReduceOp.AVG), x)
    assert torch.equal(comm.all_gather(x), x)
    assert torch.equal(comm.all_gather(x, tiled=False), x[None])
    assert torch.equal(comm.reduce_scatter(x), x)
    assert torch.equal(comm.all_to_all(x), x)
    assert torch.equal(comm.all_reduce_quantized(x), x)
    out = torch.empty(6)
    assert torch.equal(comm.all_gather_into(out, x.reshape(-1)), x.reshape(-1))


def test_topology():
    """ProcessTopology is the JAX package's; MeshTopology lays the world
    out as the JAX mesh does and names the ROADMAP item of every axis not
    ported (tp and zshard need a world that holds them)."""
    from deeperspeed_tpu.parallel.topology import ProcessTopology as JaxTopology

    ours, theirs = ProcessTopology(["pipe", "data"], [2, 3]), JaxTopology(["pipe", "data"],
                                                                          [2, 3])
    assert len(ours.mapping) == 6
    for rank in range(6):
        assert tuple(ours.get_coord(rank)) == tuple(theirs.get_coord(rank))
    assert ours.get_axis_comm_lists("data") == theirs.get_axis_comm_lists("data")
    mesh = MeshTopology()
    assert mesh.dp == mesh.data_parallel_size == 1
    for axis in ("pp", "tp", "zshard", "ep", "sp"):
        with pytest.raises(ValueError, match="world size"):
            MeshTopology(**{axis: 2})
    with pytest.raises(ValueError, match="world size"):
        MeshTopology(dp=2)
