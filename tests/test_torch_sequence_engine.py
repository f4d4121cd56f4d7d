"""Sequence parallelism in the training engine: the PyTorch port at ``sp``
2 (four ``gloo`` processes, ``torch_dp_worker.py``) against the JAX engine
on ``MeshTopology(dp=2, sp=2[, tp=2], devices=jax.devices()[:n])``.

GPT-NeoX ``tiny()`` (4 heads, H 64), 8 rows a batch at sequence 16, gas 2,
Adam at lr 1e-3, clip 1.0, three steps; every batch carries an uneven
``loss_mask``, so each run also holds the mask weighting of the sequence
slices.  The JAX engine's losses are the same at ``sp`` 1 and 2 and under
each ``seq_parallel_mode``, at ZeRO 0-3 and under ``comm.overlap`` (its
GSPMD computes one device's function), so one JAX run at dp 2 x sp 2 under
``ulysses`` holds the port's ``None`` / ``ulysses`` / ``ring`` runs at
stages 0-3, at dp 1 x sp 4, at sp 2 x tp 2 (``ring``, ZeRO-1) and under the
``auto`` and ``manual`` schedules.  bf16 at sp 2 x tp 2 (``ulysses``),
1-bit Adam (its manual loop over dp: per-row-rank means, exact over sp),
qgZ and the curriculum's seqlen each have a JAX run of their own.

Tolerances (the engine tests'): losses and grad norms within 1e-5 relative
in fp32 (as PRs 22-23 held the pipelines), within 1e-3 in bf16
(``test_torch_train.py``'s); 1-bit Adam within 1e-5, qgZ within
``test_torch_zero.py``'s 1e-3 (its int8 rounding turns last-bit
differences of the mean into a step of the wire's grid).  Attention
dropout under ``ulysses`` trains (its draws are the port's own generator,
seeded by each rank's ZeRO index, so every sequence slice draws its own
masks).  The refusals are the JAX engine's: qgZ under ``ring``, 1-bit Adam
and qgZ with sp and tp together; random-LTD at sp > 1 names its ROADMAP
item.  Checkpoints: a dp 2 x sp 2 save (ZeRO 2)
loads at sp 1 x dp 2 (beside tp 2) and at dp 4 bit for bit; the JAX
engine's sp 2 checkpoint loads into the port and the port's into the JAX
engine.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeperspeed_tpu as jdst
from deeperspeed_tpu.comm import schedule as jschedule
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from torch_dp_worker import start
from torch_layout_common import BASE, by_run
import torch_threads  # noqa: F401  (torch at one intra-op thread)

ROWS, SEQ, STEPS = 8, 16, 3
THRESHOLD = 1000
MODES = {"none": None, "uly": "ulysses", "ring": "ring"}


def _cfg(stage=0, **extra):
    return {**BASE, "zero_optimization": {"stage": stage,
                                          "param_persistence_threshold": THRESHOLD}, **extra}


def _batches():
    rng = np.random.default_rng(24)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        mask = (rng.random((ROWS, SEQ)) < 0.6).astype(np.float32)
        mask[:, SEQ // 2:] *= rng.random((ROWS, SEQ // 2)) < 0.5    # slices differ
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask})
    return out


ONEBIT = _cfg(0, optimizer={"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 1}})
QGZ = _cfg(0, comm={"quantized": {"enabled": True}})
BF16 = _cfg(0, bf16={"enabled": True})
CURRICULUM = _cfg(0, curriculum_learning={
    "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 16,
    "schedule_type": "fixed_linear",
    "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 4}})
LTD = _cfg(0, data_efficiency={"enabled": True, "data_routing": {"random_ltd": {
    "enabled": True, "random_ltd_schedule": {
        "min_value": 8, "max_value": 16,
        "schedule_config": {"require_steps": 4, "seq_per_step": 8}}}}})
OVERLAP = {"auto": {"enabled": True, "schedule": {"mode": "auto"}},
           "manual": {"enabled": True, "bucket_mb": 0.05}}
DPSP, SPTP = {"dp": 2, "sp": 2}, {"sp": 2, "tp": 2}
# the JAX runs: configuration, mesh and GPT-NeoX fields
JAX = {"uly": (_cfg(0), DPSP, {"seq_parallel_mode": "ulysses"}),
       "bf16-tp": (BF16, SPTP, {"seq_parallel_mode": "ulysses", "dtype": jnp.bfloat16}),
       "onebit": (ONEBIT, DPSP, {}),
       "qgz": (QGZ, DPSP, {"seq_parallel_mode": "ulysses"}),
       "curriculum": (CURRICULUM, DPSP, {})}


def _run(name, cfg, mesh, mode=None, dtype="fp32", **kw):
    return {"name": name, "config": cfg, "dtype": dtype, "steps": STEPS, "mesh": mesh,
            "model": {"seq_parallel_mode": mode, **kw.pop("model", {})}, **kw}


def _port_runs():
    runs = [_run(f"{m}-s{stage}", _cfg(stage), DPSP, mode, eval=stage == 0)
            for m, mode in MODES.items() for stage in range(4)]
    runs += [_run("none-sp4", _cfg(0), {"sp": 4}),
             _run("ring-tp2", _cfg(1), SPTP, "ring"),
             _run("bf16-tp2", BF16, SPTP, "ulysses", dtype="bf16"),
             _run("onebit", ONEBIT, DPSP),
             _run("qgz", QGZ, DPSP, "ulysses"),
             _run("dropout", _cfg(0), DPSP, "ulysses", model={"attention_dropout": 0.1}),
             _run("auto", _cfg(0, comm={"overlap": OVERLAP["auto"]}), DPSP, "ulysses"),
             _run("manual", _cfg(0, comm={"overlap": OVERLAP["manual"]}), DPSP),
             _run("curriculum", CURRICULUM, DPSP),
             _run("legacy", _cfg(2), DPSP, "ring", legacy=True)]
    return runs


REFUSALS = [
    {"model": {"seq_parallel_mode": "ring"}, "mesh": DPSP, "config": QGZ},
    {"model": {}, "mesh": SPTP, "config": ONEBIT},
    {"model": {"seq_parallel_mode": "ulysses"}, "mesh": SPTP, "config": QGZ},
    {"model": {}, "mesh": DPSP, "config": LTD},
]
REFUSED = ["the reference does not run it",
           "onebitadam supports sp OR tp alongside dp, not both",
           "comm.quantized supports sp OR tp alongside dp, not both",
           "random-LTD at mesh.sequence_parallel_size > 1 is not ported yet"]


def _ckpt_runs(tmp):
    saved, jax_dir = str(tmp / "port_ckpt"), str(tmp / "jax_ckpt")
    ck = _cfg(2)
    return [
        {"name": "ck-save", "config": ck, "dtype": "fp32", "mesh": DPSP,
         "model": {"seq_parallel_mode": "ulysses"}, "steps": [0, 1], "save": saved,
         "save_after": 1},
        {"name": "ck-dp2tp2", "config": ck, "dtype": "fp32", "mesh": {"dp": 2, "tp": 2},
         "load": saved, "steps": [1]},
        {"name": "ck-dp4", "config": _cfg(1), "dtype": "fp32", "mesh": {"dp": 4},
         "load": saved, "steps": [1]},
        {"name": "ck-jax", "config": ck, "dtype": "fp32", "mesh": DPSP,
         "model": {"seq_parallel_mode": "ring"}, "load": jax_dir,
         "wait": str(tmp / "jax_saved"), "steps": [2]},
    ], saved, jax_dir


def _jax_engine(cfg, mesh, model_kw, start=None):
    n = int(np.prod(list(mesh.values())))
    m = jtopo.MeshTopology(**mesh, devices=jax.devices()[:n])
    kw = {} if start is None else {"model_parameters": start}
    return jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny(**model_kw)), config=cfg,
                           mesh=m, **kw)[0]


def _train(jeng, batches):
    losses, norms = [], []
    for b in batches:
        losses.append(float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in b.items()})))
        norms.append(jeng.get_global_grad_norm())
    return np.array(losses), np.array(norms)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence_engine")
    saved_mesh = jtopo._GLOBAL_MESH
    batches = _batches()
    try:
        uly = _jax_engine(*JAX["uly"])
        start_tree = jax.device_get(uly.state["master_params"])
        start_sd = params_from_jax(start_tree)
        ckpt_runs, port_dir, jax_dir = _ckpt_runs(tmp)
        arrays = {f"w/{k}": v.numpy() for k, v in start_sd.items()}
        for i, b in enumerate(batches):
            arrays.update({f"b{i}/{k}": v for k, v in b.items()})
        spec = {"kind": ["moe", "ckpt"], "n_batches": STEPS, "refusals": REFUSALS,
                "moe_runs": _port_runs(), "runs": ckpt_runs}
        finish = start(spec, arrays, tmp, world=4)
        jax_out = {"uly": _train(uly, batches)}
        uly.save_checkpoint(jax_dir)
        jax_out["jax_ckpt"] = params_from_jax(jax.device_get(uly.state["master_params"]))
        (tmp / "jax_saved").write_text("ok")
        for name in ("bf16-tp", "onebit", "qgz", "curriculum"):
            cfg, mesh, kw = JAX[name]
            jeng = _jax_engine(cfg, mesh, kw, start=start_tree)
            jax_out[name] = _train(jeng, batches)
        got = finish()
        # the JAX engine reads the port's dp 2 x sp 2 checkpoint
        uly.load_checkpoint(port_dir)
        jax_out["port_ckpt"] = params_from_jax(jax.device_get(uly.state["master_params"]))
    finally:
        jtopo.set_mesh(saved_mesh)
    names = [r["name"] for r in spec["moe_runs"] + spec["runs"]]
    return jax_out, by_run(got, names), got, start_sd


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), (got, want)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_modes_and_stages_match_the_jax_engine(runs, mode, stage):
    """dp 2 x sp 2 under each mode and ZeRO stage: the JAX engine's losses
    and grad norms (its GSPMD loss is the global masked mean)."""
    jax_out, port, _, _ = runs
    ranks = port[f"{mode}-s{stage}"]
    for r in ranks:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    _close(ranks[0]["losses"], jax_out["uly"][0], 1e-5)
    _close(ranks[0]["grad_norms"], jax_out["uly"][1], 1e-5)


@pytest.mark.parametrize("name", ["none-sp4", "ring-tp2", "auto", "manual", "legacy"])
def test_other_layouts_and_schedules_give_the_same_losses(runs, name):
    """dp 1 x sp 4, sp 2 x tp 2 under ring at ZeRO-1, and the auto and
    manual schedules at dp 2 x sp 2: the JAX engine's losses; the legacy
    ``forward`` / ``backward`` / ``step`` under ring at ZeRO-2 (its losses
    are each rank's): the JAX engine's grad norms."""
    jax_out, port, _, _ = runs
    if name != "legacy":
        _close(port[name][0]["losses"], jax_out["uly"][0], 1e-5)
    _close(port[name][0]["grad_norms"], jax_out["uly"][1], 1e-5)


def test_eval_is_one_function_under_every_mode(runs):
    """``eval_batch`` after training: the same masked mean under each mode,
    on every rank."""
    _, port, _, _ = runs
    evals = [float(r["eval"]) for m in MODES for r in port[f"{m}-s0"]]
    _close(evals, [evals[0]] * len(evals), 1e-5)


@pytest.mark.parametrize("name,jax_name,tol", [("bf16-tp2", "bf16-tp", 1e-3),
                                               ("onebit", "onebit", 1e-5),
                                               ("qgz", "qgz", 1e-3),
                                               ("curriculum", "curriculum", 1e-5)])
def test_bf16_onebit_and_qgz_match_their_jax_runs(runs, name, jax_name, tol):
    """bf16 at sp 2 x tp 2 under ulysses; 1-bit Adam (freeze_step 1: two
    compressed steps) and qgZ at dp 2 x sp 2, their means per row rank
    and exact over sp, as the JAX manual-dp loops take them; the
    curriculum's seqlen, cut before the sequence is split.  1-bit Adam's
    grad norms are held over its exact step (``test_torch_wire_onebit.py``
    holds its compressed steps by the losses, as here)."""
    jax_out, port, _, _ = runs
    _close(port[name][0]["losses"], jax_out[jax_name][0], tol)
    n = 1 if name == "onebit" else STEPS
    _close(port[name][0]["grad_norms"][:n], jax_out[jax_name][1][:n], tol)


def test_attention_dropout_trains_with_a_draw_a_slice(runs):
    """ulysses with attention_dropout 0.1 trains (finite, within 2% of the
    run without it), and the four ranks (two rows x two sequence slices) seed
    four different generators."""
    _, port, _, _ = runs
    ranks = port["dropout"]
    losses = ranks[0]["losses"]
    assert np.all(np.isfinite(losses))
    plain = port["uly-s0"][0]["losses"]
    assert np.all(np.abs(losses - plain) < 0.02 * plain)
    assert len({int(r["seed"]) for r in ranks}) == 4


def test_the_auto_plan_beside_the_jax_plan(runs):
    """The JAX engine blocks the deferred reduction at sp > 1 and plans over
    the dp ranks; the port's deferred reduction runs over the ZeRO group
    (dp x sp), so its plan is deferred where the JAX one is per microbatch
    (a standing choice, ROADMAP Queue C)."""
    _, port, _, _ = runs
    sched = json.loads(str(port["auto"][0]["schedule"]))
    assert sched["grad_schedule"] == "deferred" and not sched["per_micro"]
    n_params = sum(p.numel() for p in GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").parameters())
    jax_plan = jschedule.plan_schedule(
        grad_bytes=4 * n_params, gas=2, n_ranks=2, deferred_allowed=False,
        blockers=("tp/sp/pp > 1 (manual-dp loop would replicate model-parallel compute)",),
        bucket_mb=0.0, device_kind="cpu")
    assert jax_plan.grad_schedule == "per_microbatch"


def test_refusals_say_the_reference_does_not_run_them(runs):
    """qgZ under ring (the JAX engine fails), and 1-bit Adam and qgZ with
    sp and tp together (the JAX engine refuses them in these words);
    random-LTD over sequence slices waits for its ROADMAP item."""
    _, _, got, _ = runs
    for i, words in enumerate(REFUSED):
        msg = str(got[0][f"refusal{i}"])
        assert msg.startswith("NotImplementedError") and words in msg, msg


def _masters(res, key):
    return {k[len(key) + 3:]: v for k, v in res.items() if k.startswith(key + "/m/")}


def test_checkpoints_across_sp_and_packages(runs):
    """The dp 2 x sp 2 ZeRO-2 save loads at dp 2 x tp 2 and at dp 4 bit for
    bit, and they take the next step as the saving run did; the JAX
    engine's sp 2 checkpoint loads into the port, and the port's into the
    JAX engine, bit for bit."""
    jax_out, port, got, _ = runs
    rank0 = got[0]
    saved = _masters(rank0, "ck-save/saved")
    assert saved
    for name in ("ck-dp2tp2", "ck-dp4"):
        loaded = _masters(rank0, f"{name}/loaded")
        assert loaded.keys() == saved.keys()
        for k in saved:
            np.testing.assert_array_equal(loaded[k], saved[k])
        _close(port[name][0]["losses"], port["ck-save"][0]["losses"][1:], 1e-5)
    port_from_jax = params_from_jax(_unflat(_masters(rank0, "ck-jax/loaded")))
    assert port_from_jax.keys() == jax_out["jax_ckpt"].keys()
    for k, v in jax_out["jax_ckpt"].items():
        np.testing.assert_array_equal(port_from_jax[k].numpy(), v.numpy())
    port_saved = params_from_jax(_unflat(saved))
    for k, v in port_saved.items():
        np.testing.assert_array_equal(jax_out["port_ckpt"][k].numpy(), v.numpy())


def _unflat(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree

