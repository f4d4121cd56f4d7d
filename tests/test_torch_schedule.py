"""The cost-model schedule of the PyTorch port (``comm/schedule.py``,
``schedule.mode: auto``) against the JAX package:

* ``plan_schedule`` over a grid of gradient bytes, gas, ranks, deferral,
  ``bucket_mb``, qgZ and ``compute_s``, at a device kind neither package's
  table holds, equal to the JAX function's plan field for field (exactly:
  the same float arithmetic), but the ``reason`` of a per-microbatch or
  quantized plan, which names the port's issue (gradient hooks) where the
  JAX text names its jaxpr pass;
* at world 2 (two ``gloo`` processes on the CPU, ``torch_dp_worker.py``),
  GPT-NeoX ``tiny()`` in fp32, 3 Adam steps with clip 1.0: ``mode: auto``
  at stages 0-2 and gas 1 and 2 equal bit for bit (losses, grad norms,
  final masters) to ``manual`` with the plan's ``bucket_mb``, with
  ``n_hoisted`` > 0 (collectives issued from gradient hooks), and within the
  JAX engine's rtol 2e-4 of the JAX per-microbatch trajectory (as
  ``test_torch_wire_overlap.py``); the engine's plan equal to the JAX
  ``plan_schedule`` on the inputs the JAX engine gives it; the planned
  per-microbatch schedule (``deferred_reduction: false``) hook-issued and
  equal to the ``off`` schedule bit for bit; progressive layer drop
  (hook-issued: the dropped block's gradients are zeros) and block 0
  bypassed outright (no gradient, so its buckets are issued after the
  backward) equal to ``manual``;
* at tp 2 x dp 2 (four processes) the port plans the deferred reduction
  where the JAX engine, which blocks tp > 1, plans per microbatch: both
  plans shown, the port's auto run equal to its manual run;
* the hook machinery alone (``_HookedReduction``): planned issue order,
  parameters without gradients, and a failing collective raising out of
  the backward;
* stage 3: ``memory: static`` with ``hbm_budget_bytes`` raises
  ``HBMBudgetError`` exactly where the JAX ``stage3_static_peak_bytes`` and
  ``assert_hbm_fit`` raise on the same leaves; under ``memory: auto`` the
  movement plan's peak equals the gathered bytes the stage-3 ledger saw
  live in the first step.
"""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.comm import memplan as jmemplan
from deeperspeed_tpu.comm import schedule as jschedule
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu.runtime.zero.sharding import stage3_static_peak_bytes as jax_static_peak
from deeperspeed_tpu_torch.comm import memplan, schedule
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.runtime.zero.sharding import stage3_static_peak_bytes
from torch_dp_worker import spawn, start as start_workers
import torch_threads  # noqa: F401  (torch at one intra-op thread)

STEPS, ROWS, SEQ, WORLD = 3, 8, 16, 2
THRESHOLD = 1000            # stage 3 partitions tiny()'s matrices
BUCKET = 0.15               # MiB: tiny()'s 0.51 MiB of fp32 gradients in 4 buckets
KIND = "NVIDIA A100-SXM4-40GB"   # in neither package's device tables


def _config(gas=2, stage=0, overlap=None, **extra):
    cfg = {"train_batch_size": ROWS, "gradient_accumulation_steps": gas,
           "gradient_clipping": 1.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": stage, "param_persistence_threshold": THRESHOLD},
           **extra}
    if overlap is not None:
        cfg["comm"] = {"overlap": {"enabled": True, **overlap}}
    return cfg


def _auto(**kw):
    return {"bucket_mb": BUCKET, "schedule": {"mode": "auto"}, **kw}


PLD = {"progressive_layer_drop": {"enabled": True, "theta": 0.0, "gamma": 100.0}}
RUNS = {
    **{f"auto-s{s}-g{g}": _config(g, s, _auto()) for s in (0, 1, 2) for g in (1, 2)},
    **{f"man-s{s}-g{g}": _config(g, s, {"bucket_mb": BUCKET}) for s in (0, 1, 2)
       for g in (1, 2)},
    "auto-pmb-s2": _config(2, 2, _auto(deferred_reduction=False)),
    "off-s2": _config(2, 2, {"schedule": {"mode": "off"}}),
    "auto-pld": _config(2, 0, _auto(), **PLD),
    "man-pld": _config(2, 0, {"bucket_mb": BUCKET}, **PLD),
    "auto-bypass": _config(2, 0, _auto()),
    "man-bypass": _config(2, 0, {"bucket_mb": BUCKET}),
}
BYPASS = {"auto-bypass": [0], "man-bypass": [0]}
TP_RUNS = {"auto-tp": _config(2, 2, _auto(), mesh={"model_parallel_size": 2}),
           "man-tp": _config(2, 2, {"bucket_mb": BUCKET}, mesh={"model_parallel_size": 2})}
JAX_RUNS = {"base-g1": _config(1), "base-g2": _config(2)}


# ------------------------------------------------------------ the planner
def _plan_fields(plan, keep_reason):
    out = dataclasses.asdict(plan)
    if not keep_reason:
        out.pop("reason")
    return out


GRID = list(itertools.product(
    [0, 1000, 531456, 64 << 20, 1_300_000_000],     # grad bytes
    [1, 2, 4],                                      # gas
    [1, 2, 8],                                      # ranks
    [True, False],                                  # deferred allowed
    [0.0, BUCKET, 25.0],                            # bucket_mb
    [False, True],                                  # qgZ
    [None, 1e-3, 0.5]))                             # compute_s


def test_plan_schedule_matches_jax_on_the_grid():
    for grad, gas, ranks, deferred, bmb, qgz, compute in GRID:
        kw = dict(grad_bytes=grad, gas=gas, n_ranks=ranks, deferred_allowed=deferred,
                  blockers=() if deferred else ("blocked",), bucket_mb=bmb, qgz=qgz,
                  device_kind=KIND, compute_s=compute)
        got, want = schedule.plan_schedule(**kw), jschedule.plan_schedule(**kw)
        same_text = got.grad_schedule == "deferred" and not got.qgz
        assert _plan_fields(got, same_text) == _plan_fields(want, same_text), kw
        assert (got.tag, got.describe() if same_text else "") == \
            (want.tag, want.describe() if same_text else "")
        assert got.implicit_sites == 0


def test_bucket_count_and_latency_are_the_jax_packages():
    assert schedule._ISSUE_LATENCY_S == jschedule._ISSUE_LATENCY_S
    for grad, bmb in itertools.product([0, 1, 4 << 20, (4 << 20) + 1, 10**9],
                                       [0.0, -1.0, 0.15, 4.0]):
        assert schedule._bucket_count(grad, bmb) == jschedule._bucket_count(grad, bmb)
    for sizes, bmb in itertools.product([[], [1 << 20] * 5, [3 << 20, 1, 5 << 20]],
                                        [0, 1, 4]):
        assert schedule.bucketize(sizes, bmb) == jschedule.bucketize(sizes, bmb)
    schedule.set_active_mode("auto")
    assert schedule.get_active_mode() == "auto"


# ------------------------------------------------------- two processes
def _batches():
    rng = np.random.default_rng(51)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _port(ranks, runs):
    return {name: [{k[len(name) + 1:]: v for k, v in r.items() if k.startswith(name + "/")}
                   for r in ranks] for name in runs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    saved = jtopo._GLOBAL_MESH
    jax_losses, jax_norms, start, wait = {}, {}, None, None

    def spec(runs, steps):
        return {"kind": "train", "n_batches": STEPS, "runs": [
            {"name": name, "config": cfg, "dtype": "fp32", "steps": steps,
             "bypass_blocks": BYPASS.get(name, [])} for name, cfg in runs.items()]}

    try:
        for name, cfg in JAX_RUNS.items():
            mesh = jtopo.MeshTopology(dp=WORLD, devices=jax.devices()[:WORLD])
            jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=cfg,
                                       mesh=mesh)
            if start is None:
                # the world-2 workers run while the JAX engines train
                start = params_from_jax(jax.device_get(jeng.state["master_params"]))
                arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
                for i, b in enumerate(batches):
                    arrays.update({f"b{i}/{k}": v for k, v in b.items()})
                wait = start_workers(spec(RUNS, STEPS), arrays,
                                     tmp_path_factory.mktemp("schedule"))
            losses, norms = [], []
            for b in batches:
                losses.append(float(jeng.train_batch(
                    batch={k: jnp.asarray(v) for k, v in b.items()})))
                norms.append(jeng.get_global_grad_norm())
            jax_losses[name], jax_norms[name] = np.array(losses), np.array(norms)
    finally:
        jtopo.set_mesh(saved)
    port = _port(wait(), RUNS)
    tp = _port(spawn(spec(TP_RUNS, 2), arrays, tmp_path_factory.mktemp("schedule_tp"),
                     world=4), TP_RUNS)
    return jax_losses, jax_norms, port, tp, start


def _equal(a, b, start):
    np.testing.assert_array_equal(a["losses"], b["losses"])
    np.testing.assert_array_equal(a["grad_norms"], b["grad_norms"])
    for k in start:
        np.testing.assert_array_equal(a[f"final/{k}"], b[f"final/{k}"], err_msg=k)


def _schedule(run):
    return json.loads(str(run["schedule"]))


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_auto_equals_manual_with_the_plans_bucket(runs, stage, gas):
    jax_losses, jax_norms, port, _, start = runs
    auto, manual = port[f"auto-s{stage}-g{gas}"], port[f"man-s{stage}-g{gas}"]
    sched = _schedule(auto[0])
    assert sched["grad_schedule"] == "deferred" and sched["bucket_mb"] == BUCKET
    assert sched["tag"] == f"deferred[b{BUCKET:g}mb]+hoist"
    # every bucket of tiny()'s 4 is issued from a hook in the backward
    assert sched["n_hoisted"] == 4 and len(sched["hook_sites"]) == 4
    assert all(_schedule(r)["n_hoisted"] == 4 for r in auto)
    _equal(auto[0], manual[0], start)
    np.testing.assert_array_equal(auto[0]["losses"], auto[1]["losses"])
    np.testing.assert_allclose(auto[0]["losses"], jax_losses[f"base-g{gas}"], rtol=2e-4)
    np.testing.assert_allclose(auto[0]["grad_norms"], jax_norms[f"base-g{gas}"], rtol=2e-4)
    foot = json.loads(str(auto[0]["footprints"]))
    assert all(s[0]["schedule"] == sched["tag"] for s in foot)


@pytest.mark.parametrize("gas", [1, 2])
def test_engine_plan_is_the_jax_plan(runs, gas):
    """The plan the engine made, against the JAX planner on the inputs the
    JAX engine hands it: the fp32 gradient bytes, gas, the ZeRO group's
    size, deferral allowed, the bucket, no qgZ, no calibration."""
    sched = _schedule(runs[2][f"auto-s2-g{gas}"][0])
    n_params = sum(p.numel() for p in GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").parameters())
    want = jschedule.plan_schedule(grad_bytes=4 * n_params, gas=gas, n_ranks=WORLD,
                                   deferred_allowed=True, bucket_mb=BUCKET,
                                   device_kind="cpu")
    assert (sched["grad_schedule"], sched["bucket_mb"], sched["tag"]) == \
        (want.grad_schedule, want.bucket_mb, want.tag)


def test_planned_per_microbatch_is_hook_issued_and_equals_off(runs):
    _, _, port, _, start = runs
    auto, off = port["auto-pmb-s2"], port["off-s2"]
    sched = _schedule(auto[0])
    assert sched["grad_schedule"] == "per_microbatch" and sched["per_micro"]
    # one region, reduce-scattered from a hook in each of the 2 microbatches
    assert sched["n_hoisted"] == 2 and sched["hook_sites"] == ["reduce_scatter"] * 2
    _equal(auto[0], off[0], start)


def test_layer_drop_and_a_bypassed_block(runs):
    """PLD at theta 0 drops block 1 in every step.  The port drops it as
    the JAX model does, masking the block's output (``torch.where``), so its
    parameters get zero gradients and their hooks fire: every bucket is
    hook-issued and the bits are manual's.  Block 0 bypassed (its forward
    passes its input through) gets no gradient at all: no hook fires for its
    parameters, so its buckets (and, in the planned order, the ones after
    them) are issued when the backward ends, while block 1's and the
    head's are issued from hooks; the bits are manual's too."""
    _, _, port, _, start = runs
    pld = _schedule(port["auto-pld"][0])
    assert pld["n_hoisted"] == 4
    _equal(port["auto-pld"][0], port["man-pld"][0], start)
    sched = _schedule(port["auto-bypass"][0])
    late = [n for prim, n in sched["step_sites"] if prim == "all_reduce" and n > 1]
    assert late and sched["n_hoisted"] > 0, sched
    assert sched["n_hoisted"] + len(late) == 4
    _equal(port["auto-bypass"][0], port["man-bypass"][0], start)
    np.testing.assert_array_equal(port["auto-bypass"][0]["losses"],
                                  port["auto-bypass"][1]["losses"])


def test_tp_plans_differ_and_auto_equals_manual(runs):
    """The JAX engine blocks the deferred reduction at tp > 1; the port's
    runs there, so its plan is deferred where JAX's is per microbatch."""
    tp, start = runs[3], runs[4]
    sched = _schedule(tp["auto-tp"][0])
    assert sched["grad_schedule"] == "deferred" and sched["n_hoisted"] > 0
    n_params = sum(p.numel() for p in GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").parameters())
    jax_plan = jschedule.plan_schedule(
        grad_bytes=4 * n_params, gas=2, n_ranks=2, deferred_allowed=False,
        blockers=("tp/sp/pp > 1 (manual-dp loop would replicate model-parallel compute)",),
        bucket_mb=BUCKET, device_kind="cpu")
    assert jax_plan.grad_schedule == "per_microbatch"
    for r in range(4):
        np.testing.assert_array_equal(tp["auto-tp"][r]["losses"], tp["man-tp"][r]["losses"])
        np.testing.assert_array_equal(tp["auto-tp"][r]["grad_norms"],
                                      tp["man-tp"][r]["grad_norms"])
    np.testing.assert_array_equal(tp["auto-tp"][0]["losses"], tp["auto-tp"][1]["losses"])


# -------------------------------------------------------------- stage 3
def _stage3(memory, budget=None, mode="manual"):
    cfg = _config(1, 3, {"schedule": {"mode": mode, "memory": memory,
                                      "hbm_budget_bytes": budget}})
    cfg["train_batch_size"] = 4
    return tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=cfg,
                           device="cpu")[0]


def test_stage3_static_budget_raises_where_jax_raises():
    abstract = jax.eval_shape(lambda: JaxGPTNeoX(JaxConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    want = jax_static_peak(abstract)
    got = stage3_static_peak_bytes(
        (p.shape, torch.float32) for p in GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").parameters())
    assert got == want
    for budget in (want - 1, want // 2):
        with pytest.raises(jmemplan.HBMBudgetError):
            jmemplan.assert_hbm_fit("zero-3 static param placement", want, budget)
        with pytest.raises(memplan.HBMBudgetError, match="zero-3 static param placement"):
            _stage3("static", budget)
    jmemplan.assert_hbm_fit("zero-3 static param placement", want, want)
    assert _stage3("static", want).memory_plan is None
    # auto checks the largest leaf only: a budget static refuses is taken
    eng = _stage3("auto", want // 2, mode="auto")
    assert eng._memory_mode == "auto" and memplan.get_active_memory_mode() == "auto"


def test_stage3_movement_plan_peak_is_the_ledgers():
    eng = _stage3("auto", mode="auto")
    batch = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").example_batch(batch_size=4, seq_len=16)
    eng.train_batch(batch=batch)
    summ = memplan.movement_summary(eng.memory_plan)
    ledger = eng._gather_ledger
    gathered = [g for *_, g in eng._compute if g is not None]
    # each unit's regions gathered twice (the forward, the recompute)
    assert summ["n_sites"] == 2 * len(gathered)
    assert summ["gathered_bytes"] == 2 * sum(g.nbytes for g in gathered)
    assert summ["peak_live_bytes"] == ledger.peak_bytes > 0
    assert ledger.live_bytes == 0 and ledger.events is None
    assert eng.scheduled_step.move_sites == eng.memory_plan
    # one unit's regions at a time: the largest unit's
    units = {}
    for g in gathered:
        units[g.region.unit] = units.get(g.region.unit, 0) + g.nbytes
    assert ledger.peak_bytes == max(units.values())
    eng.train_batch(batch=batch)           # published once
    assert len(eng.memory_plan) == summ["n_sites"]


def test_hooked_reduction_issues_in_order_and_raises():
    """The hook machinery alone: a collective is issued once all its
    parameters' gradients are final and every one before it in the planned
    order is issued; a parameter the loss never reaches goes through
    ``on_missing`` at the end; an issue that fails raises out of the
    backward, with no fallback."""
    from deeperspeed_tpu_torch.runtime.engine import _HookedReduction

    a, b, c = (torch.nn.Parameter(torch.ones(2)) for _ in range(3))
    issued, grads, missing = [], [], []
    # planned order: the one reading b, then the one reading a and c
    hooks = _HookedReduction([a, b, c], [[1], [0, 2]],
                             lambda k: issued.append(k) or (lambda: k))
    hooks.begin(lambda i, p: grads.append(i), divisor=2)
    ((a * 3).sum() + (b * 2).sum()).backward()
    assert sorted(grads) == [0, 1] and issued == [0]     # c has no gradient yet
    assert [f() for f in hooks.end(missing.append)] == [0, 1]
    assert missing == [2] and issued == [0, 1] and hooks.divisor == 2
    a.grad = b.grad = None
    ((a * 3).sum() + (b * 2).sum()).backward()           # inactive: nothing issued
    assert issued == [0, 1]

    def fail(k):
        raise RuntimeError("collective failed")

    a.grad = b.grad = None
    failing = _HookedReduction([a, b], [[0], [1]], fail)
    failing.begin(None, divisor=1)
    with pytest.raises(RuntimeError, match="collective failed"):
        ((a * 3).sum() + (b * 2).sum()).backward()
