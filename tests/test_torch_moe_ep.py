"""MoE over several processes: the PyTorch port at ``ep`` 2 (world 2) and
``ep`` 2 x ``dp`` 2 (world 4) against the JAX engine on ``MeshTopology(ep=2[,
dp=2], devices=jax.devices()[:n])``, and checkpoints across ``ep`` degrees
and packages.

The port runs ``gloo`` processes (``torch_dp_worker.py``'s ``moe`` and
``ckpt`` jobs, one spawn a world size, the jobs in turn), rank ``r =
(i_dp * ep + i_ep) * tp + i_tp``; at world 4 also ``ep`` 2 x ``tp`` 2, the
experts split ``P("ep", None, "tp")`` as the JAX rules split them.  GPT-NeoX ``tiny()`` with 4 experts on both blocks,
top-1 under capacity pressure (factor 0.75, no RTS, so both packages route
alike), fp32, Adam, clip 1.0, gas 2, 3 steps.  Routing is global over the
batch: at ``ep`` 2 each rank holds half of each microbatch's rows, and the
capacity, the kept set and ``l_aux`` are the whole microbatch's.  The JAX
stages differ only in where XLA places the state, so the port's stages are
held against the JAX run at stage 0 (``ep`` 2) and stage 1 (``ep`` 2 x
``dp`` 2).

Tolerances (``test_torch_moe.py``'s): losses and grad norms within 1e-5
relative, final masters within 1e-5 of their change; under the quantized
transport, whose gradient is rounded to bf16 on its way through the scales,
grad norms within 1e-3 and masters within 1e-2.
``aux`` weights ``l_aux`` by 10: its gradient reaches the gate through
each rank's own tokens only, and the masters still agree.  A checkpoint's
masters load bit for bit at another ``ep`` in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.runtime import checkpointing as ck
from torch_dp_worker import spawn, start as start_workers
from torch_layout_common import BASE, arrays_for, batches, by_run, jax_run, masters_agree
import torch_threads  # noqa: F401  (torch at one intra-op thread)

MOE = {"moe_num_experts": 4, "moe_expert_interval": 1, "moe_use_rts": False,
       "moe_capacity_factor": 0.75, "moe_aux_loss_coef": 0.5}
AUX = {**MOE, "moe_aux_loss_coef": 10.0}


def _cfg(stage=0, **extra):
    return {**BASE, "zero_optimization": {"stage": stage, "param_persistence_threshold": 1000},
            **extra}


def _transport(dtype):
    return _cfg(comm={"quantized": {"moe_alltoall": True, "moe_alltoall_dtype": dtype,
                                    "group_size": 32}})


EP2 = {"ep2-s0": (_cfg(0), MOE), "ep2-s2": (_cfg(2), MOE),
       "ep2-int8": (_transport("int8"), MOE), "ep2-fp8": (_transport("fp8"), MOE),
       "ep2-aux": (_cfg(0), AUX),
       "ep2-overlap": (_cfg(0, comm={"overlap": {"enabled": True}}), MOE)}
EP2DP2 = {"ep2dp2-s1": (_cfg(1), MOE), "ep2dp2-s3": (_cfg(3), MOE)}
TP2EP2 = {"tp2ep2-s1": (_cfg(1), MOE)}
# the JAX run each port run is held against
HELD = {"ep2-s2": "ep2-s0", "ep2-overlap": "ep2-s0", "ep2dp2-s3": "ep2dp2-s1"}
JAX = {name: EP2[name] for name in ("ep2-s0", "ep2-int8", "ep2-fp8", "ep2-aux")}
JAX_MESH = {"ep2dp2-s1": {"ep": 2, "dp": 2}, "tp2ep2-s1": {"ep": 2, "tp": 2}}
REFUSALS = [
    {"model": MOE, "mesh": {"ep": 2}, "config": {
        **BASE, "optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 2}}}},
    {"model": MOE, "mesh": {"ep": 2}, "config": _cfg(0, comm={"quantized": {"enabled": True}})},
]


def _run(name, cfg, kw, mesh):
    return {"name": name, "config": cfg, "dtype": "fp32", "steps": 3, "model": kw,
            "mesh": mesh}


def _jax_engine(ep, cfg):
    m = jtopo.MeshTopology(ep=ep, devices=jax.devices()[:ep])
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny(**MOE)), config=cfg, mesh=m)
    return jeng


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    blist = batches()
    jax_out, start, wait_two = {}, None, None
    root = tmp_path_factory.mktemp("moe_ep")
    (root / "w2").mkdir()
    (root / "w4").mkdir()
    for name, (cfg, kw) in {**JAX, "ep2dp2-s1": EP2DP2["ep2dp2-s1"], **TP2EP2}.items():
        *res, init = jax_run(cfg, JAX_MESH.get(name, {"ep": 2}), blist, model_kw=kw)
        if start is None:
            # the world-2 workers run while the other JAX engines train
            start = init
            wait_two = start_workers(
                {"kind": ["moe", "ckpt"], "n_batches": 3, "refusals": REFUSALS,
                 "moe_runs": [_run(n, c, k, {"ep": 2}) for n, (c, k) in EP2.items()],
                 "runs": [{"name": "save", "config": _cfg(0), "dtype": "fp32", "model": MOE,
                           "mesh": {"ep": 2}, "steps": [0, 1], "save": str(root / "port_ep2"),
                           "save_after": 2}]},
                arrays_for(start, blist), root / "w2", world=2)
        jax_out[name] = res
    saved = jtopo._GLOBAL_MESH
    try:
        jeng = _jax_engine(2, _cfg(0))
        for b in blist[:2]:
            jeng.train_batch(batch={k: jnp.asarray(v) for k, v in b.items()})
        jeng.save_checkpoint(str(root / "jax_ep2"))
        jax_saved = dict(_leaves(jax.device_get(jeng.state["master_params"])))
    finally:
        jtopo.set_mesh(saved)
    arrays = arrays_for(start, blist)
    two = wait_two()
    four = spawn({"kind": ["moe", "ckpt"], "n_batches": 3,
                  "moe_runs": [_run(n, c, k, {"ep": 2}) for n, (c, k) in EP2DP2.items()]
                  + [_run(n, c, k, {"ep": 2, "tp": 2}) for n, (c, k) in TP2EP2.items()],
                  "runs": [{"name": f"load-{src}", "config": _cfg(0), "dtype": "fp32",
                            "model": MOE, "mesh": {"ep": 4}, "steps": [],
                            "load": str(root / src)} for src in ("port_ep2", "jax_ep2")]},
                 arrays, root / "w4", world=4)
    return {"jax": jax_out, "start": start, "root": root, "jax_saved": jax_saved,
            "two": two, "four": four,
            "port": {**by_run(two, EP2), **by_run(four, {**EP2DP2, **TP2EP2})}}


@pytest.mark.parametrize("name", list(EP2) + list(EP2DP2) + list(TP2EP2))
def test_ep_layouts_match_jax(runs, name):
    jl, jn, jfinal = runs["jax"][HELD.get(name, name)]
    port = runs["port"][name]
    transport = name in ("ep2-int8", "ep2-fp8")
    for r in port:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], jn, rtol=1e-3 if transport else 1e-5)
    masters_agree(jfinal, port[0], runs["start"], tol=1e-2 if transport else 1e-5)


def test_ep2_refusals_and_deferred_fallback(runs):
    """1-bit Adam and qgZ refuse ep > 1 in the JAX engine's words; the
    deferred reduction warns and falls back to the per-microbatch
    schedule."""
    r0 = runs["two"][0]
    assert "onebitadam compresses over the dp axis; ep/zshard must be 1" in str(r0["refusal0"])
    assert "comm.quantized: ep must be 1" in str(r0["refusal1"])
    warnings = str(runs["port"]["ep2-overlap"][0]["warnings"])
    assert "deferred_reduction disabled: ep > 1" in warnings
    # the same mean gradient, its sum and division in another order
    np.testing.assert_allclose(runs["port"]["ep2-overlap"][0]["losses"],
                               runs["port"]["ep2-s0"][0]["losses"], rtol=1e-6)


def _port_saved(runs):
    r0 = runs["two"][0]
    return {k[len("save/saved/m/"):]: v for k, v in r0.items() if k.startswith("save/saved/m/")}


@pytest.mark.parametrize("case", ["port-ep4", "jax-to-port-ep4", "port-ep1", "jax-ep1",
                                  "jax-ep4"])
def test_checkpoint_loads_across_ep(runs, case):
    """A checkpoint saved at ep 2 loads at ep 4 and at ep 1, written and
    read by either package: the masters equal the saved ones bit for bit."""
    want = runs["jax_saved"] if case == "jax-to-port-ep4" else _port_saved(runs)
    assert any("experts" in k for k in want)
    src = runs["root"] / "port_ep2"
    if case in ("port-ep4", "jax-to-port-ep4"):
        run = "load-port_ep2" if case == "port-ep4" else "load-jax_ep2"
        r0 = runs["four"][0]
        got = {k[len(f"{run}/loaded/m/"):]: v for k, v in r0.items()
               if k.startswith(f"{run}/loaded/m/")}
    elif case == "port-ep1":
        eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(**MOE), device="cpu"),
                                  config=_cfg(0), device="cpu")
        eng.load_checkpoint(str(src))
        got = dict(_leaves(ck.reference_masters(eng)))
    else:
        saved = jtopo._GLOBAL_MESH
        try:
            jeng = _jax_engine(4 if case == "jax-ep4" else 1, _cfg(0))
            jeng.load_checkpoint(str(src))
            got = dict(_leaves(jax.device_get(jeng.state["master_params"])))
        finally:
            jtopo.set_mesh(saved)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
