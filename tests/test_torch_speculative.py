"""Speculative decoding in the PyTorch port on the CPU: the drafters and the
governor (unit cases, and the n-gram drafter against the JAX package's on
random histories), greedy bit-exact parity of speculative against plain
decoding for fp and fp8 pools (and against the JAX scheduler), a poisoned
round through the engine's fault seam, and the rollback of rejected draft
tails."""

import jax
import numpy as np
import pytest

from deeperspeed_tpu.inference.v2 import DSScheduler as JaxScheduler
from deeperspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deeperspeed_tpu.inference.v2 import NGramDrafter as JaxNGramDrafter
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.inference.v2 import (CallableDrafter, DSScheduler,
                                                InferenceEngineV2,
                                                NGramDrafter,
                                                SpeculationGovernor,
                                                SpeculativeConfig,
                                                engine_v2, make_drafter)
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.telemetry import (TelemetryRegistry, get_registry,
                                             set_registry)
import torch_threads  # noqa: F401  (torch at one intra-op thread)


def _config(num_blocks=64, kv_dtype="", speculative=None, **sm_kw):
    cfg = {"dtype": "float32",
           "kv_cache": {"num_blocks": num_blocks, "block_size": 8,
                        "dtype": kv_dtype},
           "state_manager": {"max_context": 64, "max_decode_batch": 4,
                             **sm_kw}}
    if speculative is not None:
        cfg["speculative"] = speculative
    return cfg


@pytest.fixture(scope="module")
def weights():
    model = JaxGPTNeoX(JaxConfig.tiny(max_seq_len=64))
    params = JaxEngine(model, config=_config()).params
    return model, params, params_from_jax(jax.device_get(params))


def _engine(weights, **kw):
    return InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                             _config(**kw), params=weights[2], device="cpu")


def _prompts(seed, sizes=(18, 23, 9)):
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, 256, size=n).astype(np.int32) for n in sizes]
    # one periodic prompt so prompt-lookup drafting engages at once
    ps.append(np.asarray([5, 6, 7, 8] * 5, np.int32))
    return ps


def _assert_pool_clean(eng):
    sm = eng.state_manager
    total = sm.allocator.total_blocks
    assert sm.free_blocks_with_evictable() == total
    if sm.prefix_cache is not None:
        sm.prefix_cache.evict(total)
    assert sm.allocator.free_blocks == total
    sm.allocator.audit()


@pytest.fixture
def registry():
    old = get_registry()
    yield set_registry(TelemetryRegistry(enabled=True, jsonl=False))
    set_registry(old)


# ------------------------------------------------------------------ drafters
def test_ngram_drafter_prefers_longest_then_most_recent():
    d = NGramDrafter(ngram_max=3, ngram_min=1)
    hist = [7, 8, 20, 1, 7, 8, 30, 2, 7, 8]
    assert d.propose(hist, 1) == [30]
    assert d.propose([2, 7, 8, 99] + hist, 1) == [99]


def test_ngram_drafter_caps_at_k_and_match_end():
    d = NGramDrafter(ngram_max=2, ngram_min=1)
    hist = [4, 10, 11, 12, 13, 4]
    assert d.propose(hist, 3) == [10, 11, 12]
    assert d.propose(hist, 99) == [10, 11, 12, 13, 4]
    assert d.propose([1, 2, 3], 4) == []
    assert d.propose(hist, 0) == []


def test_ngram_drafter_rejects_bad_window():
    with pytest.raises(ValueError):
        NGramDrafter(ngram_max=1, ngram_min=2)


@pytest.mark.parametrize("window", [(3, 1), (2, 2), (5, 2)])
def test_ngram_drafter_matches_jax(window):
    """Random low-entropy histories: the same proposals as the JAX
    package's drafter for every length and k."""
    mine, ref = NGramDrafter(*window), JaxNGramDrafter(*window)
    rng = np.random.default_rng(sum(window))
    proposed = 0
    for _ in range(200):
        hist = rng.integers(0, 4, size=rng.integers(1, 40)).tolist()
        k = int(rng.integers(0, 6))
        got = mine.propose(hist, k)
        assert got == ref.propose(hist, k)
        proposed += bool(got)
    assert proposed > 50


def test_callable_drafter_contains_failures():
    good = CallableDrafter(lambda h, k: [1, 2, 3, 4, 5])
    assert good.propose([0], 3) == [1, 2, 3]
    assert good.propose([0], 0) == []

    def boom(h, k):
        raise RuntimeError("draft model fell over")

    assert CallableDrafter(boom).propose([0], 4) == []


def test_make_drafter_dispatch():
    assert make_drafter(SpeculativeConfig()) is None
    d = make_drafter(SpeculativeConfig(method="ngram", ngram_max=2))
    assert isinstance(d, NGramDrafter) and d.ngram_max == 2
    with pytest.raises(ValueError, match="draft_fn"):
        make_drafter(SpeculativeConfig(method="draft"))
    d2 = make_drafter(SpeculativeConfig(method="draft"),
                      draft_fn=lambda h, k: [])
    assert isinstance(d2, CallableDrafter)


# ------------------------------------------------------------------ governor
def test_governor_degrades_then_reprobes(registry):
    cfg = SpeculativeConfig(method="ngram", k=4, accept_rate_floor=0.5,
                            floor_patience=2, floor_cooldown=3,
                            accept_rate_alpha=1.0)
    gov = SpeculationGovernor(cfg)
    assert gov.effective_k == 4
    gov.observe(4, 0)                   # ema 0.0 < floor: strike 1
    assert gov.effective_k == 4
    gov.observe(4, 0)                   # strike 2 == patience: breach
    assert gov.breaches == 1 and gov.effective_k == 0 and not gov.active
    assert registry.counter("infer/spec_floor_breach").total == 1
    for _ in range(3):                  # cooldown rounds tick regardless
        assert gov.effective_k == 0
        gov.observe(0, 0)
    assert gov.active and gov.effective_k == 4 and gov.ema is None
    gov.observe(4, 0)
    assert gov.breaches == 1            # one low round != instant re-breach


def test_governor_ignores_draftless_rounds():
    cfg = SpeculativeConfig(method="ngram", k=2, accept_rate_floor=0.5,
                            floor_patience=1)
    gov = SpeculationGovernor(cfg)
    for _ in range(10):
        gov.observe(0, 0)
    assert gov.breaches == 0 and gov.ema is None and gov.effective_k == 2


# ------------------------------------------------------- greedy parity gates
@pytest.mark.parametrize("kv_dtype", ["", "fp8"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_bitexact_parity(weights, registry, k, kv_dtype):
    """Speculation is invisible under greedy decoding: every output equal
    to the non-speculative scheduler's, in no more rounds, with the KV pool
    returned whole."""
    base = _engine(weights, kv_dtype=kv_dtype)
    ref = DSScheduler(base).generate(_prompts(30), max_new_tokens=24)
    spec = _engine(weights, kv_dtype=kv_dtype,
                   speculative={"method": "ngram", "k": k})
    out = DSScheduler(spec).generate(_prompts(30), max_new_tokens=24)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    drafted = registry.counter("infer/spec_drafted_tokens").total
    accepted = registry.counter("infer/spec_accepted_tokens").total
    assert drafted > 0, "parity proved nothing: no draft entered the engine"
    assert 0 < accepted <= drafted
    # a sequence whose drafts never land still takes a round a token
    assert spec.dispatch_count <= base.dispatch_count
    _assert_pool_clean(spec)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_speculative_matches_jax_scheduler(weights, kv_dtype):
    """The same speculative rounds as the JAX scheduler: tokens, round
    count and the governor's accept-rate average."""
    kw = dict(kv_dtype=kv_dtype, speculative={"method": "ngram", "k": 4})
    jeng = JaxEngine(weights[0], config=_config(**kw), params=weights[1])
    teng = _engine(weights, **kw)
    jsched, tsched = JaxScheduler(jeng), DSScheduler(teng)
    want = jsched.generate(_prompts(36), max_new_tokens=20)
    got = tsched.generate(_prompts(36), max_new_tokens=20)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert teng.dispatch_count == jeng.dispatch_count
    assert tsched.governor.ema == pytest.approx(jsched.governor.ema)
    _assert_pool_clean(teng)


def test_parity_across_prefix_cache_hits(weights):
    rng = np.random.default_rng(31)
    prefix = list(rng.integers(0, 256, size=24))
    prompts = [np.asarray(prefix + list(rng.integers(0, 256, size=n)),
                          np.int32) for n in (3, 5)]
    base_sched = DSScheduler(_engine(weights))
    ref = [base_sched.generate([p.copy()], max_new_tokens=16)[0]
           for p in prompts]
    spec = _engine(weights, speculative={"method": "ngram", "k": 4})
    sched = DSScheduler(spec)
    out = [sched.generate([p.copy()], max_new_tokens=16)[0] for p in prompts]
    assert spec.state_manager.prefix_cache.hits >= 1
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    _assert_pool_clean(spec)


@pytest.mark.parametrize("kv_dtype", ["", "fp8"])
def test_parity_under_preemption(weights, kv_dtype):
    rng = np.random.default_rng(32)
    prompts = [rng.integers(0, 256, size=22).astype(np.int32)
               for _ in range(3)]
    spec = _engine(weights, num_blocks=9, kv_dtype=kv_dtype,
                   speculative={"method": "ngram", "k": 4})
    sched = DSScheduler(spec)
    out = sched.generate([p.copy() for p in prompts], max_new_tokens=6)
    assert sched.preemption_count > 0, "geometry must force preemption"
    ref = DSScheduler(_engine(weights, kv_dtype=kv_dtype)).generate(
        [p.copy() for p in prompts], max_new_tokens=6)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    _assert_pool_clean(spec)


@pytest.mark.parametrize("kv_dtype", ["", "fp8"])
def test_nan_round_requeues_bitexact_no_leak(weights, monkeypatch, registry,
                                             kv_dtype):
    """A poisoned round under speculation requeues every affected row,
    drops all forked draft blocks, and the final greedy outputs still equal
    an unpoisoned engine's."""
    ref = DSScheduler(_engine(weights, kv_dtype=kv_dtype)).generate(
        _prompts(33), max_new_tokens=12)
    spec = _engine(weights, kv_dtype=kv_dtype,
                   speculative={"method": "ngram", "k": 3})
    sched = DSScheduler(spec)
    hits = {"n": 0}

    def seam(batch_uids, outputs):
        hits["n"] += 1
        if hits["n"] in (2, 5):         # poison two mid-stream rounds
            outputs.finite = np.zeros(len(outputs.finite), bool)
        return outputs

    monkeypatch.setattr(engine_v2, "_round_seam", seam)
    out = sched.generate(_prompts(33), max_new_tokens=12)
    assert hits["n"] >= 5
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert sched.step_failure_count == 2
    failures = sched.take_round_failures()
    assert failures and {c for _, c in failures} == {"nan_logits"}
    assert sched.take_round_failures() == []
    assert registry.counter("infer/step_failures").total == 2
    assert registry.counter("infer/requeue_count").total == len(failures)
    _assert_pool_clean(spec)


def test_raising_round_requeues_then_quarantines(weights, monkeypatch):
    """An exception inside a round requeues its requests with backoff;
    past ``max_step_failures`` the request is quarantined and stays out."""
    eng = _engine(weights)
    sched = DSScheduler(eng, max_step_failures=1, retry_backoff=lambda n: 0.0)

    def seam(batch_uids, outputs):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(engine_v2, "_round_seam", seam)
    sched.request("r", _prompts(34)[0])
    assert sched.step() == {} and sched.step_failure_count == 1
    assert [r.uid for r in sched.waiting] == ["r"] and not sched.live
    assert sched.step() == {}           # second failure: over the budget
    assert "RuntimeError" in sched.quarantined["r"]
    assert not sched.has_work
    assert sched.request("r", [1, 2, 3]).name == "QUARANTINED"
    assert len(sched.take_round_failures()) == 2
    _assert_pool_clean(eng)


# ------------------------------------------------------------- COW rollback
def test_rejected_draft_tail_blocks_freed(weights):
    """A drafter that is always wrong: every tail block allocated for the
    drafted span comes back through ``rollback_draft_tail`` the same round,
    and the pool survives an allocator audit after every step."""
    prompt = np.random.default_rng(34).integers(0, 256, 19).astype(np.int32)
    truth = [int(t) for t in DSScheduler(_engine(weights)).generate(
        [prompt.copy()], max_new_tokens=16)[0]]
    spec = _engine(weights, speculative={"method": "draft", "k": 4,
                                         "floor_patience": 100})
    sm = spec.state_manager

    def wrong(hist, k):
        if len(hist) >= len(truth):
            return []
        return [(truth[len(hist)] + 1) % 256] * k

    sched = DSScheduler(spec, drafter=CallableDrafter(wrong))
    rolled = {"blocks": 0}
    orig = sm.rollback_draft_tail

    def counting_rollback(uid):
        n = orig(uid)
        rolled["blocks"] += n
        return n

    sm.rollback_draft_tail = counting_rollback
    sched.request("r", prompt.copy())
    outs, steps = {}, 0
    while len(outs.get("r", ())) < 12 and steps < 64:
        for uid, toks in sched.step().items():
            got = [int(t) for t in toks]
            outs.setdefault(uid, []).extend(got)
            sched.request(uid, [got[-1]])
        sm.allocator.audit()            # clean after every round
        steps += 1
    sched.finish("r")
    assert rolled["blocks"] > 0, "no draft tail ever spilled into a fresh block"
    assert sched.governor.ema == 0.0    # nothing ever accepted
    assert outs["r"] == truth[19:19 + 12]
    _assert_pool_clean(spec)


def test_scheduler_warns_and_disables_on_missing_draft_fn(weights):
    spec = _engine(weights, speculative={"method": "draft", "k": 2})
    sched = DSScheduler(spec)
    assert sched.drafter is None
    outs = sched.generate([np.random.default_rng(35).integers(
        0, 256, size=10).astype(np.int32)], max_new_tokens=4)
    assert outs[0].size == 14
