"""MiCS, hpZ and the engine's two-hop qgZ of the PyTorch port at dp 2 x
zshard 2 (world 4) against the JAX engine on ``MeshTopology(dp=2,
zshard=2)`` over the first four CPU devices.

The port runs four ``gloo`` processes (``torch_dp_worker.py``), rank ``r =
i_dp * 2 + i_zshard``: MiCS (``mics_shard_size`` 2) at stages 1-3, hpZ
(``zero_hpz_partition_size`` 2) at stage 3, and qgZ with
``comm.quantized.intra_axis: zshard`` over int8 and fp8 (e5m2), fp32
GPT-NeoX ``tiny()``, Adam, clip 1.0, gas 2, 3 steps.  The JAX stages
differ only in where XLA places the state, so MiCS stages 1 and 3 are held
against the JAX MiCS run at stage 2.

Tolerances: MiCS and hpZ losses within 1e-5 relative and 1e-6 absolute
(``TestHierarchical``'s).  qgZ: each parameter's reduced gradient of the
first step equals, bit for bit, the JAX package's two-hop
``all_reduce_quantized`` of the same per-rank gradients (traced in
``jax.shard_map``, intra hop ``zshard``); the first loss within 1e-5; the
later ones within 1e-3, since the two packages quantize different groups
of 128 of a weight (flat [out, in] here, [in, out] there; see
``test_torch_zero.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu as jdst
import deeperspeed_tpu.comm as jdist
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu.telemetry import wire as jwire
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from torch_dp_worker import start as start_workers
from torch_layout_common import (BASE, STEPS, THRESHOLD, arrays_for, batches, by_run,
                                 config, jax_run)
import torch_threads  # noqa: F401  (torch at one intra-op thread)

MESH = {"dp": 2, "zshard": 2}
WORLD = 4
LOGGED = {"comms_logger": {"enabled": True}}


def _qgz(wire):
    return {**BASE, "comm": {"quantized": {"enabled": True, "wire_dtype": wire,
                                           "intra_axis": "zshard"}}}


PORT = {**{f"mics-s{s}": {**config(s, mics_shard_size=2), **LOGGED} for s in (1, 2, 3)},
        "hpz-s3": {**config(3, zero_hpz_partition_size=2), **LOGGED},
        "qgz-int8": _qgz("int8"), "qgz-fp8": _qgz("fp8")}
JAX = {"mics-s2": PORT["mics-s2"], "hpz-s3": PORT["hpz-s3"],
       "qgz-int8": PORT["qgz-int8"], "qgz-fp8": PORT["qgz-fp8"]}
HELD = {"mics-s1": "mics-s2", "mics-s3": "mics-s2"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch_list = batches()
    jax_out, start, wait = {}, None, None
    spec = {"kind": "train", "n_batches": STEPS, "runs": [
        {"name": name, "config": cfg, "dtype": "fp32", "steps": STEPS, "mesh": {"zshard": 2},
         "capture_grads": name.startswith("qgz")} for name, cfg in PORT.items()]}
    for name, cfg in JAX.items():
        *res, init = jax_run({k: v for k, v in cfg.items() if k != "comms_logger"}, MESH,
                             batch_list)
        if start is None:
            # the workers run while the other JAX engines train
            start = init
            wait = start_workers(spec, arrays_for(start, batch_list),
                                 tmp_path_factory.mktemp("mics"), world=WORLD)
        jax_out[name] = res
    ranks = wait()
    return {"jax": jax_out, "port": by_run(ranks, PORT), "start": start}


@pytest.mark.parametrize("name", ["mics-s1", "mics-s2", "mics-s3", "hpz-s3"])
def test_subgroup_layouts_match_jax(runs, name):
    jl = runs["jax"][HELD.get(name, name)][0]
    got = runs["port"][name]
    for r in got[1:]:
        np.testing.assert_array_equal(r["losses"], got[0]["losses"])
    np.testing.assert_allclose(got[0]["losses"], jl, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["mics-s1", "mics-s2", "mics-s3", "hpz-s3"])
def test_subgroup_layouts_hold_their_share(runs, name):
    """MiCS: each rank holds 1/zshard of the masters and moments (the
    zshard partition, replicated across dp); hpZ: 1/world of them, and
    1/zshard of each gathered region as its compute shard."""
    total = sum(t.numel() for t in runs["start"].values())
    gathered = sum(t.numel() for t in runs["start"].values()
                   if t.dim() >= 2 and t.numel() >= THRESHOLD)
    share = 2 if name.startswith("mics") else WORLD
    n_units = 2 + GPTNeoXConfig.tiny().num_layers
    for r in runs["port"][name]:
        masters = int(r["master_numel"])
        assert total / share <= masters <= total / share + 2 * share
        assert int(r["opt_numel"]) == 2 * masters
        if name.endswith("s3"):
            assert gathered / 2 <= int(r["shard_numel"]) <= gathered / 2 + 2 * n_units


def test_hpz_gathers_within_zshard(runs):
    """hpZ's stage-3 gathers run over the zshard group (2 ranks) only, the
    gradients over the whole ZeRO group (4), the secondary shards' refresh
    over the whole group once a step; MiCS reduces over zshard then dp."""
    hpz = json.loads(str(runs["port"]["hpz-s3"][0]["group_sizes"]))
    assert hpz["stage3_gather"] == [2]
    assert hpz["grad_reduce"] == [WORLD] and hpz["hpz_refresh"] == [WORLD]
    mics = json.loads(str(runs["port"]["mics-s3"][0]["group_sizes"]))
    assert mics["stage3_gather"] == [2] and mics["grad_reduce"] == [2]


def _jax_reduce(pre, wire):
    """The JAX package's two-hop ``all_reduce_quantized`` (mean, intra hop
    zshard) of each rank's ``pre`` [WORLD, ...] in ``jax.shard_map``."""
    saved = jtopo._GLOBAL_MESH
    mesh = jtopo.set_mesh(jtopo.MeshTopology(**MESH, devices=jax.devices()[:WORLD]))
    try:
        def per_rank(x):
            y = jdist.all_reduce_quantized(
                x[0], op="avg", group=jdist.CommGroup(("dp", "zshard")),
                intra_group=jdist.CommGroup(("zshard",)), wire_dtype=wire)
            return y[None]

        fn = jax.jit(jax.shard_map(per_rank, mesh=mesh.mesh, in_specs=P(("dp", "zshard")),
                                   out_specs=P(("dp", "zshard")), check_vma=False))
        return np.asarray(fn(jnp.asarray(pre)))
    finally:
        jtopo.set_mesh(saved)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_two_hop_qgz_matches_jax(runs, wire):
    """The engine's two-hop qgZ: every parameter of at least group_size x
    world elements reduces bit for bit as the JAX package's facade does on
    the same per-rank gradients; the losses track the JAX engine's."""
    name = f"qgz-{wire}"
    got = runs["port"][name]
    big = [k[4:] for k in got[0] if k.startswith("pre/")
           and got[0][k].size >= 128 * WORLD]
    assert len(big) >= 8
    for param in big:
        pre = np.stack([r[f"pre/{param}"] for r in got])
        want = _jax_reduce(pre, wire)
        for rank, r in enumerate(got):
            assert np.array_equal(r[f"post/{param}"].view(np.int32),
                                  want[rank].view(np.int32)), (param, rank)
    jl = runs["jax"][name][0]
    assert abs(got[0]["losses"][0] - jl[0]) <= 1e-5 * abs(jl[0])
    np.testing.assert_allclose(got[0]["losses"], jl, rtol=1e-3)
    rec = [f for f in json.loads(str(got[0]["footprints"]))[0] if f["op"] == "all_reduce"]
    assert rec and rec[0]["variant"] == jwire.quantized_variant(2, 2, "fp8_e5m2" if wire ==
                                                                "fp8" else wire)


def test_conflicting_subgroup_sizes_raise_the_jax_error():
    # 16 rows: the JAX engine's default mesh spans the 8 CPU devices
    cfg = {**BASE, "train_batch_size": 16,
           "zero_optimization": {"stage": 2, "mics_shard_size": 2,
                                 "zero_hpz_partition_size": 4}}
    with pytest.raises(ValueError) as theirs:
        jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=cfg)
    with pytest.raises(ValueError) as ours:
        tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=cfg,
                        device="cpu")
    assert str(ours.value) == str(theirs.value)
