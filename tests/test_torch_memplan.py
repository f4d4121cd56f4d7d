"""The PyTorch port's trace-free planners (``comm/memplan.py``) and the
device tables (``telemetry/wire.py``) against the JAX package's, on the
same inputs, field for field with exact equality (both do the same float
arithmetic): ``plan_chunk_stream`` over a grid of unit sizes, budgets,
per-chunk compute and host-link rates (the raising cases raising alike),
``static_plan``, ``movement_summary``, ``stream_exposed_estimate`` and
``overlap_estimate``; at a device kind neither table holds both price at
the CPU nominals.  The card's entries name the H100 they were measured
on.  The calibration round trip (``save_calibration`` /
``load_calibration`` through ``DST_TUNER_CACHE``) reads either package's
file.  The port's ``plan_param_movement`` takes the stage-3 gathers and
releases in their order (its movement plan has no jaxpr to walk)."""

import dataclasses
import itertools
import json

import pytest

from deeperspeed_tpu.comm import memplan as jmemplan
from deeperspeed_tpu.telemetry import wire as jwire
from deeperspeed_tpu_torch.comm import memplan
from deeperspeed_tpu_torch.telemetry import wire
import torch_threads  # noqa: F401  (torch at one intra-op thread)

KIND = "NVIDIA A100-SXM4-40GB"       # in neither package's tables
H100 = "NVIDIA H100 80GB HBM3"

UNITS = [
    {"embed": 65536, "c0": 199936, "c1": 199936, "head": 66048},       # tiny() in 2 chunks
    {"embed": 206045184, **{f"c{i}": 100716544 for i in range(4)},      # Pythia-1.4B's width,
     "head": 206053376},                                               # 4 layers, bf16
    {"a": 1 << 20, "b": 3 << 20, "c": 2 << 20, "d": 3 << 20},          # ties broken by name
    {"only": 12345},
]


def _budgets(units):
    big, total = max(units.values()), sum(units.values())
    return [None, 0, big - 1, big, big + big // 2, 2 * big, total // 2, total, 4 * total]


def _plan_or_error(fn, units, **kw):
    try:
        return dataclasses.asdict(fn(units, **kw))
    except Exception as e:          # noqa: BLE001 -- the type is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("units", UNITS, ids=["tiny", "pythia-1.4b-4l", "ties", "one"])
def test_plan_chunk_stream_matches_jax(units):
    n = 0
    for budget, compute, h2d, passes, working in itertools.product(
            _budgets(units), [None, 0.0, 1e-6, 1e-4, 0.01],
            [None, 8e9, 45.13e9], [1, 2], [0, 4096]):
        kw = dict(hbm_budget_bytes=budget, compute_s_per_chunk=compute,
                  h2d_bytes_per_s=h2d, passes=passes, working_bytes=working,
                  device_kind=KIND)
        got = _plan_or_error(memplan.plan_chunk_stream, units, **kw)
        want = _plan_or_error(jmemplan.plan_chunk_stream, units, **kw)
        assert got == want, kw
        n += isinstance(got, tuple)
    assert n > 0                    # the grid holds raising budgets too


def test_plan_chunk_stream_raises_alike():
    units = UNITS[1]
    budget = max(units.values()) - 1
    with pytest.raises(memplan.HBMBudgetError) as got:
        memplan.plan_chunk_stream(units, hbm_budget_bytes=budget, device_kind=KIND)
    with pytest.raises(jmemplan.HBMBudgetError) as want:
        jmemplan.plan_chunk_stream(units, hbm_budget_bytes=budget, device_kind=KIND)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        memplan.plan_chunk_stream({}, device_kind=KIND)


def test_the_h100_budgets_of_the_smoke_run():
    """The plans chip_smoke.py phase 25 (b) holds the engine to, at the
    card's host-link figure: 300 MiB streams at depth 0, 700 MiB pins the
    embedding, the head and one chunk, 1 GiB pins all 777.2 MiB; static
    needs 393.0 MiB."""
    units = UNITS[1]
    assert memplan.static_plan(units).peak_bytes / 2**20 == pytest.approx(393.0, abs=0.05)
    p300 = memplan.plan_chunk_stream(units, hbm_budget_bytes=300 << 20, device_kind=H100)
    assert p300.resident == () and p300.prefetch_depth == 0
    p700 = memplan.plan_chunk_stream(units, hbm_budget_bytes=700 << 20, device_kind=H100)
    assert set(p700.resident) == {"embed", "head", "c0"} and p700.prefetch_depth == 1
    p1g = memplan.plan_chunk_stream(units, hbm_budget_bytes=1 << 30, device_kind=H100)
    assert p1g.streamed == () and p1g.peak_bytes / 2**20 == pytest.approx(777.2, abs=0.05)


@pytest.mark.parametrize("units", UNITS, ids=["tiny", "pythia-1.4b-4l", "ties", "one"])
def test_static_plan_matches_jax(units):
    for working in (0, 1000):
        got = memplan.static_plan(units, working)
        want = jmemplan.static_plan(units, working)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.tag, got.describe()) == (want.tag, want.describe())


def test_movement_summary_matches_jax():
    specs = [[], [("a", 100, 0, 5, 0, 5)],
             [("a", 100, 3, 9, 0, 9), ("b", 50, 4, 6, 4, 6), ("c", 70, 10, 12, 2, 12)],
             [(f"u{i}", 10 * (i + 1), 2 * i, 2 * i + 1, 2 * i, 2 * i + 1) for i in range(6)]]
    for spec in specs:
        got = memplan.movement_summary([memplan.MoveSite(*s) for s in spec])
        want = jmemplan.movement_summary([jmemplan.MoveSite(*s) for s in spec])
        assert got == want
    site = memplan.MoveSite("a", 8, 3, 9, 0, 9)
    assert site.live_span == jmemplan.MoveSite("a", 8, 3, 9, 0, 9).live_span


def test_plan_param_movement_from_the_ledgers_events():
    """Two regions of one unit gathered together, released in the unit's
    order, then a second unit: each gather is a site from its event to the
    event before its release, and the summary's peak is the two regions
    live together."""
    events = [("gather", "u0#0", 100), ("gather", "u0#1", 40), ("release", "u0#0", 100),
              ("release", "u0#1", 40), ("gather", "u1#0", 120), ("release", "u1#0", 120),
              ("gather", "u0#0", 100)]              # never released: to the last event
    sites = memplan.plan_param_movement(events)
    assert [(s.name, s.first_use, s.last_use, s.gather_at) for s in sites] == [
        ("u0#0", 0, 1, 0), ("u0#1", 1, 2, 1), ("u1#0", 4, 4, 4), ("u0#0", 6, 6, 6)]
    assert memplan.movement_summary(sites)["peak_live_bytes"] == 140
    assert [s.gather_at for s in memplan.plan_param_movement(events, lookahead=2)] == \
        [0, 0, 2, 4]


def test_wire_estimates_match_jax():
    for chunks, compute, bw, depth in itertools.product(
            [[], [1 << 20], [3 << 20, 1 << 20, 7]], [None, 0.0, 1e-5, 1e-3],
            [0.5, 5e9, 45.13e9], [0, 1, 3]):
        assert wire.stream_exposed_estimate(chunks, compute, bw, depth) == \
            jwire.stream_exposed_estimate(chunks, compute, bw, depth)
    for comm_bytes, step, compute, bw in itertools.product(
            [0, 1e6, 3e9], [0.0, 0.01, 2.0], [None, 0.0, 0.005, 5.0], [0.5, 1e10]):
        assert wire.overlap_estimate(comm_bytes, step, compute, bw) == \
            jwire.overlap_estimate(comm_bytes, step, compute, bw)


def test_device_tables():
    """A kind in neither table prices at the JAX package's CPU nominals in
    both; the card's figures are keyed by its name, none is a TPU's."""
    for kind in (KIND, "cpu", "", None):
        assert wire.host_link_bandwidth(kind) == jwire.host_link_bandwidth(kind) == 5e9
        assert wire.ici_bandwidth(kind) == jwire.ici_bandwidth(kind) == 10e9
        assert wire.ici_bandwidth(kind, "gloo") == 10e9
    assert wire.host_link_bandwidth(H100) == 45.13e9
    assert wire.ici_bandwidth(H100) == 450e9
    assert wire.ici_bandwidth(H100, "gloo") == 2.236e8
    tables = [wire.HOST_LINK_BANDWIDTH_SPECS, *wire.ICI_BANDWIDTH_SPECS.values()]
    assert all(k == H100 for t in tables for k in t)
    assert wire.match_device_spec({"H100": 1, "H100 80GB": 2}, H100) == ("H100 80GB", 2)
    assert wire.match_device_spec({"TPU v5": 1}, H100) is None
    specs = {"TPU v5": 1, "TPU v5 lite": 2}
    assert wire.match_device_spec(specs, "TPU v5 lite") == \
        jwire.match_device_spec(specs, "TPU v5 lite")


def test_calibration_round_trip(tmp_path, monkeypatch):
    assert (memplan.CALIBRATION_FILE, memplan.CALIBRATION_ENV, memplan.DEFAULT_LOOKAHEAD) == \
        (jmemplan.CALIBRATION_FILE, jmemplan.CALIBRATION_ENV, jmemplan.DEFAULT_LOOKAHEAD)
    monkeypatch.delenv(memplan.CALIBRATION_ENV, raising=False)
    assert memplan.load_calibration() is None
    path = memplan.save_calibration(str(tmp_path / "cache"), compute_s=0.25, h2d_gbps=52.7,
                                    device_kind=H100, step_time_s=0.3)
    monkeypatch.setenv(memplan.CALIBRATION_ENV, str(tmp_path / "cache"))
    cal = memplan.load_calibration()
    assert (cal.compute_s, cal.h2d_gbps, cal.device_kind, cal.step_time_s) == \
        (0.25, 52.7, H100, 0.3)
    assert cal.h2d_bytes_per_s == 52.7e9
    assert dataclasses.asdict(jmemplan.load_calibration()) == dataclasses.asdict(cal)
    assert dataclasses.asdict(memplan.load_calibration(path)) == dataclasses.asdict(cal)
    jpath = jmemplan.save_calibration(str(tmp_path / "jax"), compute_s=0.5)
    assert memplan.load_calibration(jpath).compute_s == 0.5
    assert memplan.load_calibration(jpath).h2d_bytes_per_s is None
    (tmp_path / "bad.json").write_text("{")
    assert memplan.load_calibration(str(tmp_path / "bad.json")) is None
    with open(path) as f:
        assert set(json.load(f)) == {f.name for f in dataclasses.fields(memplan.Calibration)}


def test_measure_h2d_bandwidth_on_the_cpu_and_the_mode():
    assert memplan.measure_h2d_bandwidth(1 << 20, iters=2, device="cpu") > 0
    assert memplan.device_kind_of("cpu") == "cpu"
    memplan.set_active_memory_mode("static")
    assert memplan.get_active_memory_mode() == "static"
