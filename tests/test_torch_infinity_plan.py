"""ZeRO-Infinity's planned chunk stream in the PyTorch port
(``ZeroInfinityEngine(memory_schedule="auto")``, ``comm/memplan.py``
``plan_chunk_stream``) on the CPU: GPT-NeoX ``tiny()`` in 2 chunks, fp32.

* The plan equals the JAX ``ZeroInfinityEngine(memory_schedule="auto")``'s
  ``mem_plan`` on the same model, budget and calibration, field for field.
* ``auto`` equals ``static`` bit for bit (losses, and every unit's masters
  after the steps), at gas 1 and 2, for a plan with an issue-ahead window
  of 4 copies and nothing resident, one that pins part of the model, one
  that pins all of it (``resident_set_bytes`` the plan's, fewer bytes read
  from disk than static), and the depth-0 stream of a budget below the
  static peak, which ``static`` refuses at construction
  (``HBMBudgetError``); ``peak_device_param_bytes`` stays within the plan's
  ``peak_bytes`` in every run.

The JAX engine needs its native ``cpu_adam`` library.  Test processes that
start together in a fresh checkout would each compile it into the same
temporary file, and a process whose load fails keeps that failure cached;
the module fixture ``jax_cpu_adam`` builds it under a file lock, retries
once, and clears the JAX loader's cached result (``torch_native_adam.py``'s
``ensure_jax_cpu_adam``, which every port test module runs at import).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.comm.memplan import Calibration as JaxCalibration
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.models.gpt_neox_pipe import GPTNeoXPipe
from deeperspeed_tpu.op_builder import CPUAdamBuilder
from deeperspeed_tpu.ops.adam import cpu_adam as jax_cpu_adam_module
from deeperspeed_tpu.runtime.zero.infinity import ZeroInfinityEngine as JaxZeroInfinity
from deeperspeed_tpu_torch.comm.memplan import Calibration, HBMBudgetError
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine
from torch_native_adam import ensure_jax_cpu_adam
import torch_threads  # noqa: F401  (torch at one intra-op thread)

BATCH = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").example_batch(batch_size=8, seq_len=16)
UNITS = {"c0": 199936, "c1": 199936, "embed": 65536, "head": 66048}   # tiny()'s, fp32
STATIC_PEAK = 2 * max(UNITS.values())
# (layers a chunk's model, budget, calibration): the window at depth 4 and
# nothing resident; 4 layers in 4 chunks with two resident and the rest
# through the window; everything resident
CASES = {"window": (2, None, (1e-6, 8.0)), "part": (4, 900000, None),
         "all": (2, 1 << 20, None)}


def _engine(path, layers=2, **kw):
    cfg = dataclasses.replace(GPTNeoXConfig.tiny(), num_layers=layers)
    return ZeroInfinityEngine(GPTNeoX(cfg, device="cpu", seed=11),
                              nvme_path=str(path), num_chunks=layers, lr=1e-3,
                              compute_dtype=torch.float32, device="cpu", **kw)


def _auto(path, budget, cal, layers=2):
    return _engine(path, layers, memory_schedule="auto", hbm_budget_bytes=budget,
                   calibration=Calibration(*cal) if cal else None)


@pytest.fixture(scope="module")
def jax_cpu_adam():
    assert ensure_jax_cpu_adam(), "the JAX cpu_adam library did not load"


def test_the_fixture_recovers_from_a_failed_load(monkeypatch):
    """A cached failed load and a first build that fails (the lost race)
    still end with the library loaded."""
    real_build = CPUAdamBuilder.build
    calls = []

    def flaky(self, verbose=False):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("native build of cpu_adam failed: lost the race")
        return real_build(self, verbose)

    monkeypatch.setattr(CPUAdamBuilder, "build", flaky)
    monkeypatch.setattr(jax_cpu_adam_module, "_lib", None)
    monkeypatch.setattr(jax_cpu_adam_module, "_checked", True)
    assert not jax_cpu_adam_module.cpu_adam_available()
    assert ensure_jax_cpu_adam()
    assert len(calls) >= 2
    assert jax_cpu_adam_module._lib is not None


@pytest.mark.parametrize("case", ["window", "all", "tight"])
def test_plan_equals_the_jax_engines(case, tmp_path, jax_cpu_adam):
    _, budget, cal = CASES.get(case, (2, STATIC_PEAK - 1, None))
    jeng = JaxZeroInfinity(GPTNeoXPipe(JaxConfig.tiny(), num_stages=2),
                           nvme_path=str(tmp_path / "jax"), compute_dtype=jnp.float32,
                           memory_schedule="auto", hbm_budget_bytes=budget,
                           calibration=JaxCalibration(*cal) if cal else None)
    eng = _auto(tmp_path / "port", budget, cal)
    assert eng._unit_bytes == jeng._unit_bytes == UNITS
    assert list(eng._unit_bytes) == list(jeng._unit_bytes)
    assert dataclasses.asdict(eng.mem_plan) == dataclasses.asdict(jeng.mem_plan)
    jeng.close()
    eng.close()


def _masters(eng):
    return {n: eng.master(n) for n in eng.units}


@pytest.fixture(scope="module")
def static(tmp_path_factory):
    """The static stream's losses (2 steps at gas 1, then 2 at gas 2),
    masters and ``swap_stats``, by the model's layers."""
    out = {}
    for layers in (2, 4):
        eng = _engine(tmp_path_factory.mktemp(f"static{layers}"), layers)
        losses = [eng.train_batch(BATCH, gas) for gas in (1, 1, 2, 2)]
        out[layers] = losses, _masters(eng), eng.swap_stats
        eng.close()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_equals_static_bit_for_bit(case, static, tmp_path):
    layers, budget, cal = CASES[case]
    want, masters, stats = static[layers]
    eng = _auto(tmp_path, budget, cal, layers)
    plan = eng.mem_plan
    if case == "window":
        assert plan.resident == () and plan.prefetch_depth == 4
    elif case == "part":
        assert plan.resident == ("c0", "c1") and plan.prefetch_depth == 1
    else:
        assert plan.streamed == () and set(plan.resident) == set(UNITS)
    assert [eng.train_batch(BATCH, gas) for gas in (1, 1, 2, 2)] == want
    for n, ms in _masters(eng).items():
        for x, y in zip(ms, masters[n]):
            assert torch.equal(x, y), n
    s = eng.swap_stats
    assert s["peak_device_param_bytes"] <= plan.peak_bytes == s["planned_peak_bound"]
    assert s["planned_prefetch_depth"] == plan.prefetch_depth
    assert s["resident_set_bytes"] == plan.resident_bytes
    assert not eng._h2d_inflight and eng._resident_bytes == plan.resident_bytes
    if plan.resident:
        # a resident unit reads the disk's compute copy once
        assert s["bytes_read"] < stats["bytes_read"]
    eng.close()


def test_a_budget_static_refuses_trains_under_auto(static, tmp_path):
    budget = STATIC_PEAK - 1
    with pytest.raises(HBMBudgetError, match="static placement"):
        _engine(tmp_path / "s", hbm_budget_bytes=budget)
    eng = _auto(tmp_path / "a", budget, None)
    assert eng.mem_plan.prefetch_depth == 0 and eng.mem_plan.resident == ()
    assert eng.mem_plan.peak_bytes <= budget < eng.total_param_bytes
    assert [eng.train_batch(BATCH, gas) for gas in (1, 1)] == static[2][0][:2]
    assert eng.swap_stats["peak_device_param_bytes"] <= eng.mem_plan.peak_bytes
    eng.close()
