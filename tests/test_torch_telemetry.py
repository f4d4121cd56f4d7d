"""The PyTorch port's request tracer and serving events on the CPU: span
records with the JAX package's layout, the bounded span ring and flight
recorder, the engine's ``engine_round`` span and speculation channels, the
scheduler's per-request spans, and no work at all when tracing is off."""

import json
import os
import types

import numpy as np
import pytest

from deeperspeed_tpu.telemetry.trace import TraceContext as JaxTraceContext
from deeperspeed_tpu.telemetry.trace import Tracer as JaxTracer
from deeperspeed_tpu_torch.inference.v2 import (DSScheduler,
                                                InferenceEngineV2, engine_v2)
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.telemetry import (FLIGHT_REASONS, TelemetryRegistry,
                                             TraceContext, Tracer,
                                             get_registry, get_tracer,
                                             quantile, registry_from_config,
                                             serving, set_registry, set_tracer,
                                             slo_percentiles)
import torch_threads  # noqa: F401  (torch at one intra-op thread)


def _tracer(tmp_path, cls=Tracer, **kw):
    kw.setdefault("jsonl", False)
    return cls(enabled=True, run_dir=str(tmp_path), job_name="t", **kw)


def _engine(speculative=None, kv_dtype=""):
    cfg = {"dtype": "float32",
           "kv_cache": {"num_blocks": 32, "block_size": 8, "dtype": kv_dtype},
           "state_manager": {"max_context": 64, "max_decode_batch": 4}}
    if speculative:
        cfg["speculative"] = speculative
    return InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), cfg,
                             device="cpu")


PROMPTS = [np.asarray([5, 6, 7, 8] * 4, np.int32),
           np.random.default_rng(1).integers(0, 256, 11).astype(np.int32)]


@pytest.fixture
def tracer(tmp_path):
    old = get_tracer()
    yield set_tracer(_tracer(tmp_path, flight_spans=8))
    set_tracer(old)


@pytest.fixture
def registry():
    old = get_registry()
    yield set_registry(TelemetryRegistry(enabled=True, jsonl=False))
    set_registry(old)


# ------------------------------------------------------------------- spans
def _drive(tr, ctx_cls):
    """The same calls on either package's tracer."""
    root = ctx_cls.root(tr, "request", uid="u")
    root.record("queue_wait", dur_s=0.25, uid="u")
    root.event("token", seq=0)
    child = root.fork("attempt", replica=0)
    adopted = ctx_cls.adopt(tr, child.wire(), scope="host_serve")
    adopted.close()
    child.close()
    root.annotate(queue_wait_s=0.25)
    root.close(state="DONE", slo="standard", e2e_s=0.5)
    tr.record_span("engine_round", "engine", dur_s=0.01, n_seqs=2)
    return tr.spans()


def test_span_records_have_the_jax_layout(tmp_path):
    """Same names, kinds, parents and attribute keys as the JAX package's
    tracer for the same calls (ids and clocks differ)."""
    mine = _drive(_tracer(tmp_path / "a"), TraceContext)
    ref = _drive(_tracer(tmp_path / "b", cls=JaxTracer), JaxTraceContext)
    assert [(r["kind"], r["name"]) for r in mine] == \
        [(r["kind"], r["name"]) for r in ref]
    for m, r in zip(mine, ref):
        assert set(m) == set(r)
        assert (m["parent_id"] is None) == (r["parent_id"] is None)
    by = {r["name"]: r for r in mine}
    assert by["queue_wait"]["parent_id"] == by["request"]["span_id"]
    assert by["host_serve"]["parent_id"] == by["attempt"]["span_id"]
    assert by["request"]["queue_wait_s"] == 0.25 and by["request"]["e2e_s"] == 0.5
    assert len({r["trace_id"] for r in mine}) == 2      # request + engine
    assert all(len(r["span_id"]) == 16 for r in mine)


def test_span_ring_is_bounded_and_jsonl_written(tmp_path):
    tr = _tracer(tmp_path, jsonl=True, buffer_spans=4, flight_spans=2)
    for i in range(10):
        tr.record_span(f"s{i}", "tid", dur_s=0.001 * i)
    assert [r["name"] for r in tr.spans()] == ["s6", "s7", "s8", "s9"]
    assert [r["name"] for r in tr.recent()] == ["s8", "s9"]
    assert tr.span_count == 10
    tr.flush()
    with open(tr.jsonl_path) as f:
        assert len([json.loads(line) for line in f]) == 10
    tr.reset()
    assert tr.spans() == [] and len(tr.recent()) == 2
    tr.close()


def test_open_span_never_leaks_and_scope_marks_errors(tmp_path):
    tr = _tracer(tmp_path)
    tr.start_span("leaked")
    assert tr.spans() == []
    with pytest.raises(KeyError):
        with tr.span("failing"):
            raise KeyError("x")
    assert tr.spans(name="failing")[0]["error"] == "KeyError"


def test_flight_dump_snapshot_and_rotation(tmp_path, registry):
    tr = _tracer(tmp_path, flight_spans=4, max_dumps=2)
    for i in range(10):
        tr.record_span(f"s{i}", "tid")
    a = tr.flight_dump("circuit_break", extra={"uid": "r"})
    with open(a) as f:
        snap = json.load(f)
    assert snap["reason"] == "circuit_break" and snap["extra"] == {"uid": "r"}
    assert [r["name"] for r in snap["spans"]] == ["s6", "s7", "s8", "s9"]
    tr.flight_dump("b")
    c = tr.flight_dump("c")             # cap hit: the oldest rotates away
    assert not os.path.exists(a) and c.endswith("flight_c_3.json")
    assert len(tr.flight_dumps) == 2 and tr.recorder.rotated_dumps == 1
    assert registry.counter(serving.FLIGHT_DUMPS_ROTATED).total == 1
    assert "circuit_break" in FLIGHT_REASONS


def test_chrome_export_and_percentiles(tmp_path):
    tr = _tracer(tmp_path)
    for i in range(10):
        ctx = TraceContext.root(tr, "request", uid=str(i))
        ctx.event("token", seq=0)
        ctx.close(slo="standard", ttft_s=0.01 * (i + 1), e2e_s=0.1)
    path = tr.export_chrome(str(tmp_path / "chrome.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "i", "M"}
    out = slo_percentiles(tr.spans())
    assert out["standard"]["count"] == 10
    assert out["standard"]["ttft_s"]["p50"] == pytest.approx(0.055)
    assert quantile([float(v) for v in range(1, 101)], 0.5) == \
        pytest.approx(50.5)


def test_disabled_tracer_creates_no_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tr = Tracer(enabled=False)
    tr.record_span("x", "tid")
    tr.flight_dump("reason")
    assert list(tmp_path.iterdir()) == []
    assert tr.spans() == [] and tr.flight_dumps == []
    assert not get_tracer().enabled     # null by default


def test_registry_from_config_installs_the_tracer(tmp_path):
    trace = types.SimpleNamespace(enabled=True, jsonl=False, buffer_spans=64,
                                  flight_spans=32, max_dumps=4)
    cfg = types.SimpleNamespace(
        enabled=True, output_path=str(tmp_path), job_name="job", jsonl=False,
        prometheus=False, rank0_only=True, buffer_events=16, flush_every=4,
        trace=trace)
    old_reg, old_tr = get_registry(), get_tracer()
    try:
        reg = registry_from_config(cfg)
        assert get_registry() is reg and get_tracer().enabled
        assert get_tracer().recorder._ring.maxlen == 32
    finally:
        set_registry(old_reg)
        set_tracer(old_tr)


# ------------------------------------------------------ engine and scheduler
def test_engine_round_span(tracer):
    eng = _engine()
    eng.put_round([1, 2], [p.tolist() for p in PROMPTS])
    eng.put_round([1, 2], [[3], [4]])
    recs = tracer.spans(name="engine_round")
    assert [r["dispatch"] for r in recs] == [0, 1]
    assert all(r["trace_id"] == "engine" and r["dur_s"] > 0 for r in recs)
    assert (recs[0]["n_seqs"], recs[0]["n_tokens"], recs[0]["decodes"]) == \
        (2, 27, 0)
    assert (recs[1]["n_seqs"], recs[1]["n_tokens"], recs[1]["decodes"]) == \
        (2, 2, 2)


def test_speculation_channels(registry):
    """``emit_speculation`` from the engine: drafted/accepted counters, the
    accept-rate and tokens-per-round scalars, and ``infer/kv_bytes`` tagged
    with the pool's own dtype."""
    eng = _engine(speculative={"method": "ngram", "k": 4}, kv_dtype="fp8")
    DSScheduler(eng).generate([p.copy() for p in PROMPTS], max_new_tokens=16)
    drafted = registry.counter(serving.SPEC_DRAFTED).total
    accepted = registry.counter(serving.SPEC_ACCEPTED).total
    assert 0 < accepted <= drafted
    assert 0.0 <= registry.scalar(serving.SPEC_ACCEPT_RATE).value <= 1.0
    assert registry.scalar(serving.TOKENS_PER_ROUND).value >= 1.0
    assert registry.counter("infer/dispatches").total == eng.dispatch_count
    assert registry.scalar("infer/kv_bytes").value == eng.kv_pool_bytes
    assert registry.histogram(serving.QUEUE_WAIT).count == len(PROMPTS)
    serving.emit_speculation(0, 0, 3, 3)    # draftless round: rate untouched
    assert registry.counter(serving.SPEC_DRAFTED).total == drafted


@pytest.mark.parametrize("kv,tag", [("", "float32"), ("int8", "int8"),
                                    ("fp8", "fp8")])
def test_kv_bytes_tagged_with_pool_dtype(registry, kv, tag):
    eng = _engine(kv_dtype=kv)
    eng.put_round([1], [[1, 2, 3]])
    eng.put_round([1], [[4]])           # recorded once per engine
    events = [e for e in registry.recent() if e["name"] == "infer/kv_bytes"]
    assert [(e["dtype"], e["value"]) for e in events] == \
        [(tag, float(eng.kv_pool_bytes))]
    # payload + scales: 2 layers x (k, v) x 32 blocks x 8 slots x 4 heads
    per_head = 16 + 4 if kv else 16 * 4
    assert eng.kv_pool_bytes == 2 * 2 * 32 * 8 * 4 * per_head


def test_scheduler_request_spans(tracer):
    eng = _engine(speculative={"method": "ngram", "k": 4})
    sched = DSScheduler(eng)
    ctx = TraceContext.root(tracer, "request", uid="a")
    sched.request("a", PROMPTS[0], trace=ctx)
    done = {}
    while len(done.get("a", ())) < 10:
        for uid, toks in sched.step().items():
            done.setdefault(uid, []).extend(int(t) for t in toks)
            sched.request(uid, [int(toks[-1])])
    sched.finish("a")
    ctx.close(state="DONE")
    mine = tracer.spans(trace_id=ctx.trace_id)
    names = [r["name"] for r in mine]
    assert names[0] == "queue_wait" and names[1] == "prefill_chunk"
    assert names[-1] == "request" and "decode_round" in names
    root = mine[-1]
    assert all(r["parent_id"] == root["span_id"] for r in mine[:-1])
    assert root["queue_wait_s"] >= 0
    drafted = [r for r in mine if r.get("draft")]
    assert drafted and all(0 <= r["accepted"] <= r["draft"] for r in drafted)
    assert len(tracer.spans(name="engine_round")) == eng.dispatch_count


def test_circuit_break_dumps_the_flight_ring(tracer, monkeypatch):
    def seam(batch_uids, outputs):
        outputs.finite = np.zeros(len(outputs.finite), bool)
        return outputs

    monkeypatch.setattr(engine_v2, "_round_seam", seam)
    sched = DSScheduler(_engine(), max_step_failures=0)
    ctx = TraceContext.root(tracer, "request", uid="r")
    sched.request("r", PROMPTS[1], trace=ctx)
    assert sched.step() == {}
    assert sched.quarantined == {"r": "nan_logits"}
    events = [r for r in tracer.spans(trace_id=ctx.trace_id)
              if r["kind"] == "event"]
    assert [e["name"] for e in events] == ["round_failure"]
    assert events[0]["cause"] == "nan_logits"
    (dump,) = tracer.flight_dumps
    with open(dump) as f:
        snap = json.load(f)
    assert snap["reason"] == "circuit_break" and snap["extra"]["uid"] == "r"


def test_traced_hot_path_does_zero_work_when_off(monkeypatch):
    """A whole scheduled, speculative generation with every span-producing
    method patched to raise: the ``enabled`` guards at every call site keep
    the hot path from reaching one."""
    def boom(*a, **k):
        raise AssertionError("tracer touched with tracing off")

    for name in ("start_span", "end_span", "record_span", "event", "_record"):
        monkeypatch.setattr(Tracer, name, boom)
    assert not get_tracer().enabled and not get_registry().enabled
    eng = _engine(speculative={"method": "ngram", "k": 4})
    outs = DSScheduler(eng).generate([p.copy() for p in PROMPTS],
                                     max_new_tokens=8)
    assert [o.size for o in outs] == [24, 19]
    assert get_tracer().span_count == 0
