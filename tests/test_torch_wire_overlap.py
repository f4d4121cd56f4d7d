"""The gradient reduction's schedules in the PyTorch port at world 2 (two
``gloo`` processes on the CPU, ``torch_dp_worker.py``), GPT-NeoX ``tiny()``
in fp32 on seeded batches (8 rows, 16 tokens, 3 Adam steps, clip 1.0),
against the JAX engine at dp = 2 on two devices of the CPU mesh:

* ``comm.overlap`` (deferred reduction, one reduction a batch) at stages
  0-3 and gas 1 and 2, and ``schedule.mode: off`` at stages 0-2: losses
  and each step's global gradient norm within the JAX test's rtol 2e-4
  (``test_comm_overlap.py:53-62``) of the JAX engine's per-microbatch
  trajectory (summation order differs).  The norm is taken before
  clipping, so it sees a wrong division by gas x world that Adam's
  scale-free update would hide from the losses;
* ``bucket_mb`` 1e-4 (every piece of a parameter its own collective)
  equal to ``bucket_mb`` 0 **bit for bit** in the port at stages 0-3:
  losses and final masters;
* qgZ under ``comm.overlap`` with ``bucket_mb`` 1e-4 within 2e-2 of plain
  qgZ (``test_comm_overlap.py:76-87``): a bucket draws its int8 groups
  across the edges of its parameters;
* ``schedule.mode: off``: a collective a region each microbatch at every
  stage, counted by the comms logger, against one a bucket each batch
  under the deferred schedule;
* each step's record of the reduction (``engine.comm_footprint``) equal to
  the JAX package's ``telemetry/wire.py`` ``plain_wire_bytes`` of the
  collectives that schedule issues (their padded payload);
* qwZ (``zero_quantized_weights``, stage 3): the first loss within 1e-3
  relative of the JAX qwZ engine's (the quantization groups differ: a
  stage-3 region's flat partition here, each parameter's last dimension
  there, as for qgZ in ``test_torch_zero.py``); the trajectory falling and
  within the JAX test's 0.05 of stage 3 without qwZ
  (``test_zero_extensions.py:253-264``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu.telemetry.wire import plain_wire_bytes
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.runtime.zero.sharding import build_partition_plan, unit_of
from torch_dp_worker import start as start_workers
import torch_threads  # noqa: F401  (torch at one intra-op thread)

STEPS, ROWS, SEQ, WORLD = 3, 8, 16, 2
THRESHOLD = 1000            # stage 3 partitions tiny()'s matrices
TINY_BUCKET = 1e-4          # MiB: every parameter piece its own bucket


def _config(gas=2, stage=0, overlap=None, quantized=None, **zero):
    cfg = {"train_batch_size": ROWS, "gradient_accumulation_steps": gas,
           "gradient_clipping": 1.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": stage, "param_persistence_threshold": THRESHOLD,
                                 **zero},
           "comms_logger": {"enabled": True}}
    comm = {}
    if overlap is not None:
        comm["overlap"] = {"enabled": True, **overlap}
    if quantized is not None:
        comm["quantized"] = {"enabled": True, **quantized}
    if comm:
        cfg["comm"] = comm
    return cfg


RUNS = {
    **{f"def-s{s}-g{g}": _config(g, s, {}) for s in range(4) for g in (1, 2)},
    **{f"bkt-s{s}": _config(2, s, {"bucket_mb": TINY_BUCKET}) for s in range(4)},
    **{f"off-s{s}": _config(2, s, {"schedule": {"mode": "off"}}) for s in (0, 1, 2)},
    "pmb-s3": _config(2, 3),
    "qgz": _config(2, 0, quantized={}),
    "qgz-bkt": _config(2, 0, {"bucket_mb": TINY_BUCKET}, quantized={}),
    "qwz-s3": _config(2, 3, zero_quantized_weights=True),
}
JAX_RUNS = {"base-g1": _config(1), "base-g2": _config(2),
            "qwz": _config(2, 3, zero_quantized_weights=True)}


def _jax_config(cfg):
    cfg = dict(cfg)
    cfg.pop("comms_logger")
    return cfg


def _batches():
    rng = np.random.default_rng(51)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _start_port(start, batches, tmp):
    arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    spec = {"kind": "train", "n_batches": STEPS, "runs": [
        {"name": name, "config": cfg, "dtype": "fp32", "steps": STEPS}
        for name, cfg in RUNS.items()]}
    return start_workers(spec, arrays, tmp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    saved = jtopo._GLOBAL_MESH
    jax_losses, jax_norms, start, wait = {}, {}, None, None
    try:
        for name, cfg in JAX_RUNS.items():
            mesh = jtopo.MeshTopology(dp=WORLD, devices=jax.devices()[:WORLD])
            jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()),
                                       config=_jax_config(cfg), mesh=mesh)
            masters = params_from_jax(jax.device_get(jeng.state["master_params"]))
            if start is None:
                # the workers run while the JAX engines train
                start = masters
                wait = _start_port(start, batches, tmp_path_factory.mktemp("overlap"))
            losses, norms = [], []
            for b in batches:
                losses.append(float(jeng.train_batch(
                    batch={k: jnp.asarray(v) for k, v in b.items()})))
                norms.append(jeng.get_global_grad_norm())
            jax_losses[name] = np.array(losses)
            jax_norms[name] = np.array(norms)
    finally:
        jtopo.set_mesh(saved)
    ranks = wait()
    port = {name: [{k[len(name) + 1:]: v for k, v in r.items() if k.startswith(name + "/")}
                   for r in ranks] for name in RUNS}
    return jax_losses, port, jax_norms


def _rows(run):
    """The comms logger's calls by op name."""
    counts = {}
    for row in json.loads(str(run["comms_rows"])):
        counts[row[0]] = counts.get(row[0], 0) + row[2]
    return counts


def _regions(stage):
    model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu")
    named = dict(model.named_parameters())
    specs = {n: (tuple(p.shape), torch.float32) for n, p in named.items()}
    units = {n: unit_of(n, model) for n in named} if stage == 3 else None
    return build_partition_plan(specs, stage, WORLD, 0, THRESHOLD, units).regions


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_deferred_matches_jax_per_microbatch(runs, stage, gas):
    jax_losses, port, jax_norms = runs
    r0, r1 = port[f"def-s{stage}-g{gas}"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_allclose(r0["losses"], jax_losses[f"base-g{gas}"], rtol=2e-4)
    np.testing.assert_allclose(r0["grad_norms"], jax_norms[f"base-g{gas}"], rtol=2e-4)
    steps = json.loads(str(r0["footprints"]))
    assert all(s[0]["schedule"] == "deferred" for s in steps)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bucketed_equals_unbucketed_bit_for_bit(runs, stage):
    _, port, jax_norms = runs
    one, many = port[f"def-s{stage}-g2"][0], port[f"bkt-s{stage}"][0]
    np.testing.assert_array_equal(many["losses"], one["losses"])
    finals = [k for k in one if k.startswith("final/")]
    assert finals and all(np.array_equal(many[k], one[k]) for k in finals)
    buckets = json.loads(str(many["footprints"]))[0][0]["count"]
    regions = 1 if stage == 0 else len(_regions(stage))
    assert json.loads(str(one["footprints"]))[0][0]["count"] == regions
    # every parameter (28 in tiny(), each above 1e-4 MiB) a bucket of its
    # own at stage 0; at stages 1-3 a bucket between two columns where some
    # rank's piece of a parameter starts or ends: more than a region's one
    n_params = len(list(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").parameters()))
    assert buckets == n_params if stage == 0 else buckets > 2 * regions
    assert _rows(many)["grad_reduce"] == STEPS * buckets
    assert _rows(one)["grad_reduce"] == STEPS * regions


def test_qgz_bucketed_within_quantization_of_plain_qgz(runs):
    _, port, jax_norms = runs
    plain, bucketed = port["qgz"][0], port["qgz-bkt"][0]
    np.testing.assert_allclose(bucketed["losses"], plain["losses"], rtol=2e-2)
    # B5 runs on both hops' sums: once a quantized collective, fewer of
    # them than parameters once buckets fuse the large ones
    assert 0 < bucketed["b5_calls"][0] <= plain["b5_calls"][0]


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_schedule_off_reduces_every_microbatch(runs, stage):
    _, port, jax_norms = runs
    r0 = port[f"off-s{stage}"][0]
    regions = len(_regions(stage))
    steps = json.loads(str(r0["footprints"]))
    assert all(s[0]["schedule"] == "per_microbatch" and s[0]["count"] == 2 * regions
               for s in steps)
    assert _rows(r0)["grad_reduce"] == STEPS * 2 * regions
    np.testing.assert_allclose(r0["losses"], port[f"def-s{stage}-g2"][0]["losses"],
                               rtol=2e-4)
    np.testing.assert_allclose(r0["grad_norms"], jax_norms["base-g2"], rtol=2e-4)


@pytest.mark.parametrize("name", ["def-s0-g2", "def-s1-g2", "def-s2-g2", "def-s3-g2",
                                  "bkt-s2", "off-s0", "off-s2", "pmb-s3"])
def test_footprint_equals_jax_wire_bytes(runs, name):
    _, port, jax_norms = runs
    stage = int(name.split("-s")[1][0])
    per_micro = name.startswith(("off", "pmb"))
    payload = sum(r.padded for r in _regions(stage)) * 4
    op = "all_reduce" if stage == 0 else "reduce_scatter"
    want = plain_wire_bytes(op, payload, WORLD) * (2 if per_micro else 1)
    for step in json.loads(str(port[name][0]["footprints"])):
        rec, = step
        assert rec["op"] == "grad_reduce_dp" and rec["n_ranks"] == WORLD
        assert rec["variant"] == "float32" and rec["bytes"] == want
        assert rec["schedule"] == ("per_microbatch" if per_micro else "deferred")


def test_qwz_matches_jax_first_loss_and_tracks_stage3(runs):
    jax_losses, port, jax_norms = runs
    r0, r1 = port["qwz-s3"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    q, base = r0["losses"], port["pmb-s3"][0]["losses"]
    assert abs(q[0] - jax_losses["qwz"][0]) <= 1e-3 * abs(jax_losses["qwz"][0])
    assert abs(q[0] - base[0]) < 0.05 and np.all(np.abs(q - base) < 0.05)
    assert q[-1] < q[0]
    assert not np.array_equal(q, base)           # the gather did quantize
    rows = _rows(r0)
    assert rows.get("stage3_gather_qwz", 0) > 0 and "stage3_gather" not in rows
    assert _rows(port["pmb-s3"][0]).get("stage3_gather", 0) > 0
