"""Data-parallel training of the PyTorch port at world 2 against the JAX
engine at dp = 2 on the CPU: ZeRO stages 0-3 in fp32 and bf16, qgZ
(``comm.quantized``) over int8 and fp8, and the engine's loader
(``training_data=``, at fp32 stage 1).

The JAX engines run here on two devices of the 8-device CPU mesh
(``MeshTopology(dp=2, devices=jax.devices()[:2])``); their initial masters
go through ``params_from_jax`` to two port processes (``gloo``, the kernels'
plain versions; ``torch_dp_worker.py``), which train on the same global
batches (gas 2, 2 rows a rank per microbatch, no dropout).  One JAX run a
configuration and one pair of processes for all of them, shared by the
tests through a module-scoped fixture.  The JAX stages differ only in
where XLA places the state, so to keep the file short bf16 stages 1 and 2
are held against the JAX bf16 run at stage 0 (stage 3 against stage 3).

Tolerances:

* stages 0-3 against the JAX engine at the same stage: the single-process
  tolerances of ``test_torch_train.py`` (fp32 losses within 1e-5 relative,
  and the final masters' summed difference within 1e-5 of their summed
  change; bf16 losses within 1e-3).  The reductions differ from the JAX
  package's only in order.
* qgZ: the first loss within 1e-5 (the weights are equal, the reduction
  has not acted yet); the later ones within 1e-3 relative.  Quantization
  moves each later loss from the exact reduction's by up to 4.2e-5 (int8)
  and 7.2e-6 (fp8) relative in the JAX package and 2.6e-5 and 1.1e-4 in
  the port, on these batches; the two packages quantize different groups
  of 128 (a Linear weight is flat [out, in] here and [in, out] there), so
  their errors are independent draws of that size (port against JAX: up to
  3.3e-5 int8 and 1.1e-4 fp8 measured).  The reduction
  itself equals the JAX package's bit for bit on equal inputs
  (``test_torch_comm.py``).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from torch_dp_worker import start as start_workers
import torch_threads  # noqa: F401  (torch at one intra-op thread)

STEPS = 3
ROWS, SEQ = 8, 16
THRESHOLD = 1000            # stage 3 partitions tiny()'s matrices, keeps its vectors
BASE = {"train_batch_size": ROWS, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
JAX_DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
LOSS_TOL = {"fp32": 1e-5, "bf16": 1e-3}
QGZ_TOL = 1e-3


def _config(dtype="fp32", stage=0, wire=None, **zero):
    cfg = dict(BASE)
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    if wire is not None:
        cfg["comm"] = {"quantized": {"enabled": True, "wire_dtype": wire}}
    else:
        cfg["zero_optimization"] = {"stage": stage,
                                    "param_persistence_threshold": THRESHOLD, **zero}
    return cfg


STAGE_RUNS = [f"{dt}-stage{s}" for dt in ("fp32", "bf16") for s in range(4)]
LOADER_RUN = "fp32-stage1"      # trains on training_data= through the engine's loader
RUNS = {**{name: (_config(name[:4], int(name[-1])), name[:4]) for name in STAGE_RUNS},
        "qgz-int8": (_config(wire="int8"), "fp32"),
        "qgz-fp8": (_config(wire="fp8"), "fp32")}
# the JAX run each port run is held against
JAX_RUN = {**{name: name for name in RUNS}, "bf16-stage1": "bf16-stage0",
           "bf16-stage2": "bf16-stage0"}
# port-only runs: zero_quantized_gradients above stage 0 is ignored; B6's
# optimizer over each rank's pieces
PORT_ONLY = {"zqg-stage2": (_config(stage=2, zero_quantized_gradients=True), "fp32"),
             "fusedadam-stage2": ({**_config(stage=2), "optimizer": {
                 "type": "FusedAdam", "params": {"lr": 1e-3}}}, "fp32")}


def _batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _columns():
    toks = np.random.default_rng(12).integers(0, 256, (48, SEQ + 1)).astype(np.int32)
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


def _start_port(start, batches, cols, tmp):
    arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    arrays.update({f"d/{k}": v for k, v in cols.items()})
    spec = {"kind": "train", "n_batches": STEPS, "runs": [
        {"name": name, "config": cfg, "dtype": dtype, "steps": STEPS,
         "training_data": name == LOADER_RUN}
        for name, (cfg, dtype) in {**RUNS, **PORT_ONLY}.items()]}
    return start_workers(spec, arrays, tmp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: {"jax": (losses, grad norms, final masters) of the JAX run it
    is held against, "port": [rank 0 results, rank 1 results]}}."""
    batches, cols = _batches(), _columns()
    saved = jtopo._GLOBAL_MESH
    out, start, wait = {}, None, None
    try:
        for name in sorted(set(JAX_RUN.values())):
            cfg, dtype = RUNS[name]
            mesh = jtopo.MeshTopology(dp=2, devices=jax.devices()[:2])
            data = cols if name == LOADER_RUN else None
            jeng, *_ = jdst.initialize(
                model=JaxGPTNeoX(JaxConfig.tiny(dtype=JAX_DTYPES[dtype])), config=cfg,
                mesh=mesh, training_data=data)
            masters = params_from_jax(jax.device_get(jeng.state["master_params"]))
            if start is None:
                # the port's workers start from these weights and run while
                # the JAX engines train
                start = masters
                wait = _start_port(start, batches, cols, tmp_path_factory.mktemp("zero"))
            assert all(torch.equal(masters[k], start[k]) for k in start)
            losses, norms = [], []
            for step in range(STEPS):
                b = None if data is not None else {k: jnp.asarray(v)
                                                   for k, v in batches[step].items()}
                losses.append(float(jeng.train_batch(batch=b)))
                norms.append(jeng.get_global_grad_norm())
            final = params_from_jax(jax.device_get(jeng.state["master_params"]))
            out[name] = (np.array(losses), np.array(norms), final)
    finally:
        jtopo.set_mesh(saved)
    ranks = wait()
    result = {"start": start}
    for name in {**RUNS, **PORT_ONLY}:
        result[name] = {"jax": out.get(JAX_RUN.get(name)), "port": [
            {k[len(name) + 1:]: v for k, v in r.items() if k.startswith(name + "/")}
            for r in ranks]}
    return result


def _masters_agree(final, got, start, tol=1e-5):
    """As test_torch_train.py: per parameter, the summed |difference|
    within ``tol`` of the summed change, the key-bias entries outside the
    rotary dims left out (their true gradient is zero)."""
    cfg = GPTNeoXConfig.tiny()
    D, rot = cfg.head_dim, int(cfg.head_dim * cfg.rotary_pct)
    for name, want in final.items():
        keep = torch.ones_like(want, dtype=torch.bool)
        if name.endswith("query_key_value.bias"):
            keep.view(cfg.num_heads, 3 * D)[:, D + rot:2 * D] = False
        diff = (torch.from_numpy(got[f"final/{name}"]) - want).abs()[keep].sum()
        moved = (want - start[name]).abs()[keep].sum()
        assert diff <= tol * moved + 1e-12, (name, float(diff), float(moved))


@pytest.mark.parametrize("name", STAGE_RUNS)
def test_zero_stage_matches_jax(runs, name):
    """The losses, the first grad norm and (fp32) the final masters; at
    fp32 stage 1 the batches come from training_data= through each rank's
    loader, which yields its slice of every global microbatch."""
    dtype = name[:4]
    jl, jn, jfinal = runs[name]["jax"]
    r0, r1 = runs[name]["port"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    tol = LOSS_TOL[dtype]
    assert np.all(np.abs(r0["losses"] - jl) <= tol * np.abs(jl)), (r0["losses"], jl)
    assert abs(r0["grad_norms"][0] - jn[0]) <= tol * jn[0]
    if dtype == "fp32":
        _masters_agree(jfinal, r0, runs["start"])


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stage_holds_its_share(runs, stage):
    """Stages 1-3: each rank holds 1/world of the fp32 masters and of both
    Adam moments (up to one partition's padding); stage 3 also 1/world of
    the compute parameters it partitions; stage 0 holds everything."""
    total = sum(t.numel() for t in runs["start"].values())
    r0, r1 = runs[f"fp32-stage{stage}"]["port"]
    masters = [int(r["master_numel"]) for r in (r0, r1)]
    for r, m in zip((r0, r1), masters):
        assert int(r["opt_numel"]) == 2 * m
    if stage == 0:
        assert masters == [total, total]
    else:
        assert sum(masters) == total and max(masters) <= math.ceil(total / 2)
    partitioned = sum(t.numel() for t in runs["start"].values()
                      if t.dim() >= 2 and t.numel() >= THRESHOLD)
    shards = [int(r["shard_numel"]) for r in (r0, r1)]
    if stage == 3:
        n_units = 2 + GPTNeoXConfig.tiny().num_layers       # embed_in, blocks, embed_out
        assert shards[0] == shards[1] and partitioned / 2 <= shards[0] \
            <= partitioned / 2 + n_units
    else:
        assert shards == [0, 0]


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_qgz_matches_jax_qgz(runs, wire):
    name = f"qgz-{wire}"
    jl = runs[name]["jax"][0]
    r0, r1 = runs[name]["port"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    assert abs(r0["losses"][0] - jl[0]) <= 1e-5 * abs(jl[0])
    assert np.all(np.abs(r0["losses"] - jl) <= QGZ_TOL * np.abs(jl)), (r0["losses"], jl)
    # B5 once a step for every parameter of at least group_size x world elements
    model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu")
    big = sum(p.numel() >= 128 * 2 for p in model.parameters())
    assert big == 12 and list(r0["b5_calls"]) == [big] * STEPS
    assert list(runs["fp32-stage0"]["port"][0]["b5_calls"]) == [0] * STEPS


def test_zero_quantized_gradients_above_stage0_is_ignored(runs):
    r0, _ = runs["zqg-stage2"]["port"]
    assert any("zero_quantized_gradients" in w for w in json.loads(str(r0["warnings"])))
    np.testing.assert_array_equal(r0["losses"], runs["fp32-stage2"]["port"][0]["losses"])
    assert list(r0["b5_calls"]) == [0] * STEPS


def test_fused_adam_steps_over_each_ranks_pieces(runs):
    """FusedAdam at stage 2 (each rank's optimizer over its pieces of the
    flat buffers) trains as Adam does, within the fp32 tolerance."""
    got = runs["fusedadam-stage2"]["port"]
    want = runs["fp32-stage2"]["port"][0]["losses"]
    np.testing.assert_array_equal(got[0]["losses"], got[1]["losses"])
    assert np.all(np.abs(got[0]["losses"] - want) <= 1e-5 * np.abs(want))
    assert int(got[0]["opt_numel"]) == 2 * int(got[0]["master_numel"])


@pytest.mark.parametrize("extra,error", [
    ({"fp16": {"enabled": True}, "comm": {"quantized": {"enabled": True}}}, ValueError),
    ({"zero_optimization": {"stage": 2}, "comm": {"quantized": {"enabled": True}}},
     ValueError),
    ({"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}},
      "eigenvalue": {"enabled": True}}, NotImplementedError),
    ({"mesh": {"pipe_parallel_size": 2},
      "comm": {"overlap": {"enabled": True, "schedule": {"mode": "auto"}}}},
     NotImplementedError),
    ({"mesh": {"sequence_parallel_size": 2}}, ValueError),
    ({"mesh": {"expert_parallel_size": 2}}, ValueError),
    ({"comm": {"quantized": {"enabled": True, "intra_axis": "ep"}}}, ValueError),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}},
      "hybrid_engine": {"enabled": True}}, NotImplementedError),
    ({"comm": {"quantized": {"enabled": True, "bucket_mb": 8}}}, NotImplementedError),
])
def test_refused_configurations(extra, error):
    """qgZ refuses fp16 and stages above 0, as the JAX engine does, and an
    intra hop on ``ep`` (its hops run over dp and zshard); an ``ep`` or an
    ``sp`` that does not divide the processes is refused; what is not
    ported yet (eigenvalue, the hybrid engine, the ``auto`` schedule over a
    pipeline) names its ROADMAP item, beside the offload tiers too."""
    match = "ROADMAP Queue A" if error is NotImplementedError else "comm|mesh"
    with pytest.raises(error, match=match):
        tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                        config={**BASE, **extra}, device="cpu")


def test_one_process_takes_every_stage_and_ignored_knobs():
    """World 1: stages 1-3 hold everything (one partition) and train as
    stage 0 does; the bucket and overlap knobs the JAX package ignores are
    accepted."""
    batch = _batches()[0]
    losses = []
    for stage in range(4):
        cfg = {**BASE, "zero_optimization": {
            "stage": stage, "param_persistence_threshold": THRESHOLD,
            "overlap_comm": True, "reduce_bucket_size": 10, "contiguous_gradients": True}}
        eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                                  config=cfg, device="cpu")
        assert eng.zero_optimization_stage() == stage
        losses.append([float(eng.train_batch(batch=batch)) for _ in range(2)])
    for got in losses[1:]:
        np.testing.assert_allclose(got, losses[0], rtol=1e-6)


@pytest.mark.parametrize("stage,world", [(0, 2), (1, 3), (2, 2), (3, 4)])
def test_partition_plan_covers_every_parameter_once(stage, world):
    """Every element of every parameter lies in exactly one rank's pieces
    (in every rank's at stage 0); stage 3 splits the regions by unit, dtype
    and persistence, and partitions only matrices at the threshold."""
    from deeperspeed_tpu_torch.runtime.zero.sharding import build_partition_plan, unit_of

    model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu")
    named = dict(model.named_parameters())
    specs = {n: (tuple(p.shape), torch.float32 if "embed_in" in n else torch.bfloat16)
             for n, p in named.items()}
    units = {n: unit_of(n, model) for n in named}
    seen = {n: torch.zeros(p.numel(), dtype=torch.int64) for n, p in named.items()}
    for rank in range(world):
        plan = build_partition_plan(specs, stage, world, rank, THRESHOLD, units)
        assert sorted(plan.order) == sorted(named)
        for region in plan.regions:
            assert len({specs[n][1] for n in region.names}) == 1
            assert region.padded % region.parts == 0 and region.padded >= region.numel
            for n, shape, a, b, at in region.pieces(plan.index):
                assert shape == specs[n][0] and 0 <= at and at + b - a <= region.part
                seen[n][a:b] += 1
            if stage == 3:
                assert all(units[n] == region.unit for n in region.names)
                assert all((len(specs[n][0]) >= 2 and named[n].numel() >= THRESHOLD)
                           == region.gathered for n in region.names)
    want = world if stage == 0 else 1
    assert all(bool((s == want).all()) for s in seen.values())
    if stage == 3:
        assert {units[n] for n in named} == {"embed_in", "layers.0", "layers.1",
                                             "final_layer_norm", "embed_out"}


def test_stage3_recompute_replays_dropout():
    """Stage 3 runs each unit under recompute; with dropout the recompute
    draws the forward's masks again, so one process at stage 3 trains as
    at stage 0, bit for bit."""
    batch = _batches()[0]
    losses = []
    for stage in (0, 3):
        cfg = {**BASE, "zero_optimization": {"stage": stage,
                                             "param_persistence_threshold": THRESHOLD}}
        model = GPTNeoX(GPTNeoXConfig.tiny(hidden_dropout=0.1, attention_dropout=0.1),
                        device="cpu")
        eng, *_ = tdst.initialize(model=model, config=cfg, device="cpu")
        losses.append([float(eng.train_batch(batch=batch)) for _ in range(3)])
    assert losses[0] == losses[1]
