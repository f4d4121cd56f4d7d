"""The pure parts of the PyTorch port's wire slice against the JAX
package's, on one process: ``comm/overlap.py`` ``bucketize``,
``comm/comms_logging.py`` (``calc_bw_log``, the ``log_all`` rows, the
per-step record against the JAX trace-time record, ``get_caller_func``),
``telemetry/wire.py`` (``q_bytes``, ``wire_bytes``, ``plain_wire_bytes``,
``quantized_variant``, ``variant_dtype``), each equal to the JAX package's
on the same inputs (exactly: both compute the same float expressions);
``apply_xla_latency_hiding`` returning ``[]`` with one warning; the facade's
timing and ``async_op`` handle; qwZ's gradient; and the config surface of
the slice (what it now accepts, and what stays refused by ROADMAP title).

qwZ's gradient, both packages side by side: through the JAX package's
quantize-dequantize round trip the gradient reaches only the element that
sets each group's scale (the int8 cast passes none), one element a group;
through the port's quantized gather it is the plain gather's, exactly.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu.comm.comms_logging as jlog
import deeperspeed_tpu.comm.overlap as joverlap
import deeperspeed_tpu.telemetry.wire as jwire
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.runtime.zero import quantized as jquantized
from deeperspeed_tpu_torch import comm
from deeperspeed_tpu_torch.comm import comms_logging, overlap
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.runtime.zero import stage3
from deeperspeed_tpu_torch.runtime.zero.sharding import Region
from deeperspeed_tpu_torch.telemetry import wire
import torch_threads  # noqa: F401  (torch at one intra-op thread)

BASE = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


@pytest.mark.parametrize("bucket_mb", [0, -1, 1e-4, 0.5, 1, 3.2])
def test_bucketize_matches_jax(bucket_mb):
    rng = np.random.default_rng(61)
    for sizes in ([], [100], rng.integers(1, 3 << 20, 40).tolist(),
                  [5 << 20, 10, 10, 4 << 20, 1 << 20]):
        assert overlap.bucketize(sizes, bucket_mb) == joverlap.bucketize(sizes, bucket_mb)


def test_calc_bw_log_and_wire_model_match_jax():
    names = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast",
             "all_reduce_quantized", "reduce_scatter_quantized", "grad_reduce"]
    for name, size, dur, n in itertools.product(names, [1, 4096, 10**9], [0.0, 1e-3, 2.5],
                                                [1, 2, 4, 8]):
        assert comms_logging.calc_bw_log(name, size, dur, n) == \
            jlog.calc_bw_log(name, size, dur, n)
    for n_elems, gs in itertools.product([0, 1, 127, 128, 301, 10**6], [1, 64, 128]):
        assert wire.q_bytes(n_elems, gs) == jwire.q_bytes(n_elems, gs)
    variants = ["fp32", "int8_flat", "fp8_flat", "int8_two_level", "fp8_two_level"]
    for coll, var, n_elems, n1, n2 in itertools.product(
            ["all_reduce", "reduce_scatter"], variants, [4096, 38633472], [1, 2, 4], [1, 2]):
        if var.endswith("two_level") and n2 == 1 or var.endswith("flat") and n2 > 1:
            continue
        assert wire.wire_bytes(coll, var, n_elems, n1, n2, 128) == \
            jwire.wire_bytes(coll, var, n_elems, n1, n2, 128)
    for coll, nb, n in itertools.product(["all_reduce", "reduce_scatter", "all_to_all",
                                          "all_gather", "broadcast", "ppermute"],
                                         [0, 12, 10**8], [1, 2, 3, 8]):
        assert wire.plain_wire_bytes(coll, nb, n) == jwire.plain_wire_bytes(coll, nb, n)
    for n1, n2, dt in itertools.product([1, 2, 8], [1, 4], ["int8", "fp8", "fp8_e5m2",
                                                            "e4m3", "INT8"]):
        assert wire.quantized_variant(n1, n2, dt) == jwire.quantized_variant(n1, n2, dt)
    for v in ["fp32", "int8_flat", "fp8_two_level", "", None]:
        assert wire.variant_dtype(v) == jwire.variant_dtype(v)


@pytest.mark.parametrize("straggler", [False, True])
def test_log_all_rows_match_jax(straggler):
    ours, theirs = comms_logging.CommsLogger(), jlog.CommsLogger()
    rng = np.random.default_rng(62)
    calls = [("all_reduce", "grad_reduce", 4096, 2), ("all_gather", "stage3_gather", 512, 4),
             ("reduce_scatter", "reduce_scatter", 4096, 2), ("broadcast", "broadcast", 8, 2)]
    for _ in range(5):
        for raw, rec, size, n in calls:
            lat = float(rng.uniform(1e-4, 1e-2))
            ours.append(raw, rec, lat, size, n)
            theirs.append(raw, rec, lat, size, n)
    rows = ours.log_all(print_log=True, show_straggler=straggler)
    assert rows == theirs.log_all(print_log=False, show_straggler=straggler)
    assert len(rows) == len(calls) and all(r[2] == 5 for r in rows)
    ours.configure(prof_all=False, prof_ops=["all_gather"])
    theirs.configure(prof_all=False, prof_ops=["all_gather"])
    for lg in (ours, theirs):
        lg.append("all_reduce", "skipped", 1e-3, 4, 2)
    assert ours.log_all(print_log=False) == theirs.log_all(print_log=False)


def test_step_record_matches_jax_trace_record():
    """The per-step record keeps the JAX trace-time record's keys and
    aggregation; nothing is recorded outside a step."""
    ours, theirs = comms_logging.CommsLogger(), jlog.CommsLogger()
    recs = [("grad_reduce_dp", 1e6, 2, "float32", 1, "deferred"),
            ("all_reduce", 3.5e5, 4, "int8_two_level", 1, None),
            ("grad_reduce_dp", 2e6, 2, "float32", 3, "deferred"),
            ("all_reduce", 1.5e5, 4, "int8_two_level", 2, None)]
    ours.record(*recs[0])
    assert ours.end_step() == []
    ours.begin_step()
    theirs.begin_trace_capture()
    for op, nbytes, n, variant, count, schedule in recs:
        ours.record(op, nbytes, n, variant=variant, count=count, schedule=schedule)
        theirs.record_traced(op, nbytes, n, variant=variant, count=count, schedule=schedule)
    assert ours.end_step() == theirs.end_trace_capture()


def test_get_caller_func_walks_out_of_the_package():
    """Frames of the comm package (here a function run in the facade's
    module globals) are walked past, to the caller outside it."""
    import types

    from deeperspeed_tpu_torch.comm import comm as facade

    scope = dict(vars(facade), get_caller_func=comms_logging.get_caller_func)
    inside = types.FunctionType((lambda: get_caller_func()).__code__, scope)  # noqa: F821

    def my_training_loop():
        return inside()

    assert my_training_loop() == "my_training_loop"


def test_apply_xla_latency_hiding_warns_once_and_appends_nothing(monkeypatch):
    said = []
    monkeypatch.setattr(overlap.logger, "warning", lambda msg, *a: said.append(msg))
    env = {"XLA_FLAGS": "--foo=1"}
    assert overlap.apply_xla_latency_hiding(env) == []
    assert overlap.apply_xla_latency_hiding() == []
    assert len(said) == 2 and all("TPU" in m for m in said)
    assert env == {"XLA_FLAGS": "--foo=1"}
    assert overlap.effective_latency_hiding_flags() == []
    # the JAX function off a TPU says the same: nothing appended
    assert joverlap.apply_xla_latency_hiding({"JAX_PLATFORMS": "cpu"}) == []


def test_timed_ops_and_async_handle(monkeypatch):
    """One process: every collective is the identity; logged when the
    comms logger is enabled (an inner collective inside an outer one is
    not); ``async_op`` returns a handle under ``eager_async`` only."""
    monkeypatch.setattr(comm.comms_logger, "enabled", True)
    monkeypatch.setattr(comm.comms_logger, "comms_dict", type(comm.comms_logger.comms_dict)(
        comm.comms_logger.comms_dict.default_factory))
    x = torch.arange(256, dtype=torch.float32)
    assert torch.equal(comm.all_reduce(x.clone(), log_name="mine"), x)
    comm.all_gather(x)
    comm.all_reduce_quantized(x)
    names = {r[0]: r[2] for r in comm.log_summary(show_straggler=True)}
    assert names == {"mine": 1, "all_gather": 1, "all_reduce_quantized": 1}
    assert not isinstance(comm.all_reduce(x, async_op=True), overlap.AsyncOpHandle)
    from deeperspeed_tpu_torch.comm import comm as facade

    monkeypatch.setattr(facade, "_eager_async", True)
    for h in (comm.all_reduce(x, async_op=True), comm.all_gather(x, async_op=True),
              comm.reduce_scatter(x, async_op=True)):
        assert isinstance(h, overlap.AsyncOpHandle) and h.is_completed()
        assert torch.equal(h.wait(), x)


def test_qwz_gradient_is_the_plain_gathers_in_the_port_and_not_in_jax():
    rng = np.random.default_rng(63)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    w = rng.standard_normal((4, 256)).astype(np.float32)

    def f(a):
        q, s = jquantized.quantize_int8(a)
        return jnp.sum(jquantized.dequantize_int8(q, s, jnp.float32) * w)

    jg = np.asarray(jax.grad(f)(jnp.asarray(x)))
    assert np.count_nonzero(jg) == 8              # one element a group of 128
    region = Region(["p"], [(1024,)], [0], torch.float32, 1, "", True)
    grads = {}
    for quantized in (False, True):
        shard = torch.from_numpy(x.reshape(-1)).clone().requires_grad_(True)
        g = stage3.GatheredRegion(region, shard, comm.get_data_parallel_group(),
                                  torch.float32, lambda t, q=quantized: grads.__setitem__(q, t),
                                  deferred=True, quantized=quantized)
        full = stage3._GatherRegion.apply(shard, g)
        if quantized:
            assert not torch.equal(full, shard.detach())        # int8 on the wire
            assert torch.allclose(full, shard.detach(), atol=0.03)
        (full * torch.from_numpy(w.reshape(-1))).sum().backward()
    assert torch.equal(grads[True], grads[False])
    assert torch.equal(grads[True], torch.from_numpy(w.reshape(-1)))


def _init(**extra):
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config={**BASE, **extra}, device="cpu")
    return eng


@pytest.mark.parametrize("extra", [
    {"comm": {"overlap": {"enabled": True, "bucket_mb": 4, "eager_async": True,
                          "xla_latency_hiding": True, "prefetch_depth": 2,
                          "schedule": {"mode": "manual", "memory": "static"}}}},
    {"comm": {"overlap": {"enabled": True, "deferred_reduction": False,
                          "schedule": {"mode": "off", "memory": "off"}}}},
    {"comms_logger": {"enabled": True, "verbose": False, "prof_ops": ["all_reduce"]}},
    {"comm": {"quantized": {"enabled": True, "intra_axis": "dp"}}},
    {"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
    {"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 5}}},
])
def test_wire_configs_initialise_and_train(extra, monkeypatch):
    from deeperspeed_tpu_torch.comm import comm as facade

    monkeypatch.setattr(comm.comms_logger, "enabled", False)
    monkeypatch.setattr(facade, "_eager_async", False)
    eng = _init(**extra)
    b = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").example_batch(8, 16)
    losses = [float(eng.train_batch(batch=b)) for _ in range(3)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_wire_config_fields():
    from deeperspeed_tpu_torch.runtime.config import DeeperSpeedConfig

    cfg = DeeperSpeedConfig(BASE)
    ov = cfg.comm_overlap
    assert (ov.enabled, ov.deferred_reduction, ov.bucket_mb, ov.xla_latency_hiding,
            ov.prefetch_depth, ov.eager_async) == (False, True, 0.0, False, 1, False)
    assert (ov.schedule.mode, ov.schedule.memory, ov.schedule.hbm_budget_bytes) == \
        ("manual", "static", None)
    assert cfg.comms_config.enabled is False and cfg.comms_config.prof_all is True
    assert DeeperSpeedConfig({**BASE, "optimizer": {"type": "OneBitAdam"}}) \
        .optimizer.params.freeze_step == 100
    below = DeeperSpeedConfig({**BASE, "zero_optimization": {
        "stage": 2, "zero_quantized_weights": True}})
    assert below.zero_quantized_weights is False          # qwZ acts at stage 3 only


@pytest.mark.parametrize("extra,item", [
    ({"mesh": {"pipe_parallel_size": 2},
      "comm": {"overlap": {"enabled": True, "schedule": {"mode": "auto"}}}}, "Pipelines"),
    # qgZ's first hop on sp: the reference fails on it, so it stays refused
    ({"comm": {"quantized": {"enabled": True, "intra_axis": "sp"}}},
     "the reference does not run it"),
    ({"comm": {"overlap": {"enabled": True}, "compression": {}}}, "The rest of the surface"),
])
def test_refused_wire_configs_name_their_item(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        _init(**extra)


@pytest.mark.parametrize("extra,match", [
    ({"optimizer": {"type": "OneBitAdam"}, "zero_optimization": {"stage": 2}},
     "zero stage 0"),
    ({"optimizer": {"type": "OneBitAdam"}, "fp16": {"enabled": True}}, "fp32/bf16"),
    ({"comm": {"quantized": {"enabled": True, "intra_axis": "rows"}}}, "intra_axis"),
])
def test_onebit_and_qgz_guards(extra, match):
    with pytest.raises(ValueError, match=match):
        _init(**extra)


def test_two_level_schedule_on_cuda_launches_b5_or_raises(monkeypatch):
    """Where the accelerator runs the kernels, both hops of the two-level
    schedule go to B5's CUDA branch, which launches or raises (here: the
    tensors are not on a card); nothing falls back to the plain version."""
    from deeperspeed_tpu_torch.accelerator.cuda_accelerator import CudaAccelerator
    from deeperspeed_tpu_torch.comm import compressed
    from deeperspeed_tpu_torch.ops.quantizer import fused

    x = torch.randn(8, 128)
    one = comm.get_data_parallel_group()
    calls = []
    monkeypatch.setattr(fused, "get_accelerator", lambda device=None: CudaAccelerator())
    monkeypatch.setattr(fused, "_dequant_reduce_plain", lambda *a: calls.append(a))
    for fn in (compressed.hierarchical_quantized_reduce_scatter,
               compressed.hierarchical_quantized_all_reduce):
        with pytest.raises(ValueError, match="not on a CUDA device"):
            fn(x, one, one)
    assert not calls
