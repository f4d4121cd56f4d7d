"""The two-level (hierarchical) qgZ schedule of the PyTorch port at world 4
against the JAX package's on ``MeshTopology(dp=2, zshard=2)``.

Four ``gloo`` processes on the CPU (``torch_dp_worker.py``) build their
intra and inter groups with ``comm.new_two_level_groups(2, 2)``: rank ``r =
i_inter * 2 + i_intra``, the intra hop the JAX mesh's ``zshard`` axis and
the inter hop its ``dp`` axis.  The JAX side traces the same functions
inside ``jax.shard_map`` over four devices of the CPU mesh, rank ``r`` the
block ``dp * 2 + zshard`` of the stacked per-rank inputs (seeded numpy
normals, each rank's at its own scale).  For int8 and fp8 (e5m2) the cases
are the facade's ``all_reduce_quantized`` (sum; mean over a length that
needs padding; the intra group alone, whose inter hop is the rest of the
world), ``reduce_scatter_quantized``, ``hierarchical_quantized_*`` and
``qgz_*`` with both groups.

Tolerances: every result equals the JAX package's **bit for bit** (the same
quantization, the same bytes on each hop, B5's plain version summing the
peers in peer order).  On the way each is within the quantization error of
the exact sum (3% of its largest magnitude for int8, 20% for e5m2's three
significant bits, over two requantizations), and the facade's step record
equals ``telemetry/wire.py`` ``wire_bytes`` of the JAX package for the
two-level variant.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu.comm as jdist
from deeperspeed_tpu.comm import compressed as jcompressed
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu.runtime.zero import quantized as jquantized
from deeperspeed_tpu.telemetry import wire as jwire
from torch_dp_worker import spawn
import torch_threads  # noqa: F401  (torch at one intra-op thread)

N_INTER, N_INTRA = 2, 2
WORLD = N_INTER * N_INTRA
# name stem: (op, per-rank input shape, reduce op, intra group alone)
OPS = {
    "ar-sum": ("all_reduce_quantized", (16, 128), "sum", False),
    "ar-avg-pad": ("all_reduce_quantized", (301,), "avg", False),
    "ar-intra-only": ("all_reduce_quantized", (3, 200), "sum", True),
    "rs": ("reduce_scatter_quantized", (8, 256), None, False),
    "hier-ar": ("hierarchical_quantized_all_reduce", (16, 128), None, False),
    "hier-rs": ("hierarchical_quantized_reduce_scatter", (8, 256), None, False),
    "qgz-ar": ("qgz_all_reduce", (8, 128), None, False),
    "qgz-rs": ("qgz_reduce_scatter", (12, 128), None, False),
}
WIRES = {"int8": "int8", "fp8": "fp8_e5m2"}
CASES = {f"{stem}-{w}": (op, WIRES[w], shape, red, intra_only)
         for stem, (op, shape, red, intra_only) in OPS.items() for w in WIRES}
REDUCES = ("all_reduce_quantized", "hierarchical_quantized_all_reduce", "qgz_all_reduce")


def _inputs():
    rng = np.random.default_rng(31)
    out = {}
    for name, (_, _, shape, _, _) in CASES.items():
        x = rng.standard_normal((WORLD,) + shape).astype(np.float32)
        x *= np.array([1.0, 3.0, 0.5, 2.0], np.float32).reshape((WORLD,) + (1,) * len(shape))
        out[name] = x
    return out


def _jax_fn(op, wire, reduce, intra_only):
    dp_zs = jdist.CommGroup(("dp", "zshard"))
    intra = jdist.CommGroup(("zshard",))
    inter = None if intra_only else jdist.CommGroup(("dp",))

    def per_rank(x):
        x = x[0]
        if op == "all_reduce_quantized":
            y = jdist.all_reduce_quantized(x, op=reduce, group=dp_zs, intra_group=intra,
                                           inter_group=inter, wire_dtype=wire)
        elif op == "reduce_scatter_quantized":
            y = jdist.reduce_scatter_quantized(x, group=dp_zs, intra_group=intra,
                                               inter_group=inter, wire_dtype=wire)
        elif op.startswith("hierarchical_"):
            y = getattr(jcompressed, op)(x, "zshard", "dp", wire_dtype=wire)
        else:
            y = getattr(jquantized, op)(x, intra_axis="zshard", inter_axis="dp",
                                        wire_dtype=wire)
        return y[None]

    return per_rank


def _jax_results(inputs):
    saved = jtopo._GLOBAL_MESH
    mesh = jtopo.set_mesh(jtopo.MeshTopology(dp=N_INTER, zshard=N_INTRA,
                                             devices=jax.devices()[:WORLD]))
    results = {}
    try:
        for name, (op, wire, _, reduce, intra_only) in CASES.items():
            fn = jax.jit(jax.shard_map(_jax_fn(op, wire, reduce, intra_only),
                                       mesh=mesh.mesh, in_specs=P(("dp", "zshard")),
                                       out_specs=P(("dp", "zshard")), check_vma=False))
            results[name] = np.asarray(fn(jnp.asarray(inputs[name])))
    finally:
        jtopo.set_mesh(saved)
    return results


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    inputs = _inputs()
    arrays = {f"x/{name}/{r}": x[r] for name, x in inputs.items() for r in range(WORLD)}
    spec = {"kind": "comm", "two_level": [N_INTER, N_INTRA], "cases": [
        {"name": name, "op": f"two_level_{op}", "wire": wire, "intra_only": intra_only,
         **({"reduce": red} if red else {})}
        for name, (op, wire, _, red, intra_only) in CASES.items()]}
    ranks = spawn(spec, arrays, tmp_path_factory.mktemp("two_level"), world=WORLD)
    return _jax_results(inputs), ranks, inputs


@pytest.mark.parametrize("name", list(CASES))
def test_two_level_matches_jax_bit_for_bit(both, name):
    jax_out, ranks, inputs = both
    op, wire, _, reduce, _ = CASES[name]
    for r in range(WORLD):
        got, want = ranks[r][name], jax_out[name][r]
        assert got.shape == want.shape and got.dtype == np.float32, (name, r)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (name, r)
    exact = inputs[name].sum(0) / (WORLD if reduce == "avg" else 1)
    if op in REDUCES:
        got = ranks[0][name]
    else:
        # participant (i_intra, i_inter) holds global chunk i_intra * n_inter + i_inter
        order = [i_intra * N_INTER + i_inter for i_inter in range(N_INTER)
                 for i_intra in range(N_INTRA)]
        chunks = [None] * WORLD
        for r, c in enumerate(order):
            chunks[c] = ranks[r][name]
        got = np.concatenate(chunks)
    tol = 0.2 if "fp8" in wire else 0.03
    assert np.abs(got - exact).max() <= tol * np.abs(exact).max(), name


@pytest.mark.parametrize("name", [n for n in CASES if not n.startswith("hier")])
def test_two_level_records_jax_wire_bytes(both, name):
    """The step record of the facade's and the qgZ wrappers' collectives:
    the JAX package's analytic bytes for the two-level variant."""
    _, ranks, inputs = both
    op, wire, shape, _, _ = CASES[name]
    rec, = json.loads(str(ranks[0][f"{name}/footprint"]))
    collective = "all_reduce" if op in REDUCES else "reduce_scatter"
    n_elems = int(np.prod(shape))
    if op == "all_reduce_quantized":
        n_elems += (-n_elems) % (WORLD * 128)          # the facade pads
    variant = jwire.quantized_variant(N_INTRA, N_INTER, wire)
    assert rec["op"] == collective and rec["variant"] == variant
    assert rec["n_ranks"] == WORLD and rec["count"] == 1
    assert rec["bytes"] == jwire.wire_bytes(collective, variant, n_elems, N_INTRA, N_INTER,
                                            128)
