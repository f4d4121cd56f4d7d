"""The PyTorch port's ``DSScheduler`` on the CPU: against the JAX package's
scheduler on the same prompts and weights (greedy tokens identical for fp,
int8 and fp8 pools, with SplitFuse chunking, preemption and prefix-cache
hits), and the host-logic cases of the JAX package's own scheduler tests
(admission, queueing, preemption, cancellation) run on the port."""

import jax
import numpy as np
import pytest

from deeperspeed_tpu.inference.v2 import DSScheduler as JaxScheduler
from deeperspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.inference.v2 import (DSScheduler,
                                                InferenceEngineV2,
                                                SchedulingResult,
                                                UnservableRequestError)
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
    """One set of JAX-initialised tiny weights: the JAX model, its
    parameter tree, and the same weights as a state dict for the port."""
    model = JaxGPTNeoX(JaxConfig.tiny(max_seq_len=64))
    params = JaxEngine(model, config=_config()).params
    return model, params, params_from_jax(jax.device_get(params))


def _engine(weights, **kw):
    return InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                             _config(**kw), params=weights[2], device="cpu")


def _jax_engine(weights, **kw):
    return JaxEngine(weights[0], config=_config(**kw), params=weights[1])


def _rng_prompt(rng, n, vocab=256):
    return rng.integers(0, vocab, size=n).astype(np.int32)


def _assert_pool_clean(eng):
    sm = eng.state_manager
    total = sm.allocator.total_blocks
    assert sm.free_blocks_with_evictable() == total
    if sm.prefix_cache is not None:
        sm.prefix_cache.evict(total)
    assert sm.allocator.free_blocks == total
    sm.allocator.audit()


# --------------------------------------------------- against the JAX package
def _same_generate(weights, prompts, max_new_tokens, sched_kw=None, **kw):
    """Both schedulers serve ``prompts``: identical tokens, identical
    scheduling (round and preemption counts), the port's pool whole."""
    sched_kw = sched_kw or {}
    jeng, teng = _jax_engine(weights, **kw), _engine(weights, **kw)
    jsched, tsched = JaxScheduler(jeng, **sched_kw), DSScheduler(teng, **sched_kw)
    want = jsched.generate([p.copy() for p in prompts], max_new_tokens)
    got = tsched.generate([p.copy() for p in prompts], max_new_tokens)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert teng.dispatch_count == jeng.dispatch_count
    assert tsched.preemption_count == jsched.preemption_count
    _assert_pool_clean(teng)
    return jsched, tsched


@pytest.mark.parametrize("kv_dtype", ["", "int8", "fp8"])
def test_generate_matches_jax(weights, kv_dtype):
    rng = np.random.default_rng(4)
    prompts = [_rng_prompt(rng, n) for n in (5, 12, 9, 20)]
    _, tsched = _same_generate(weights, prompts, 8, kv_dtype=kv_dtype)
    pools = tsched.engine.kv_cache[0]
    assert len(pools) == (4 if kv_dtype else 2)
    assert pools[0].element_size() == (1 if kv_dtype else 4)


@pytest.mark.parametrize("kv_dtype", ["", "fp8"])
def test_splitfuse_chunking_matches_jax(weights, kv_dtype):
    """A 16-token budget and 6-token chunks: the 40-token prompt runs over
    several rounds beside the short ones' decodes."""
    rng = np.random.default_rng(5)
    prompts = [_rng_prompt(rng, n) for n in (40, 7, 11)]
    _same_generate(weights, prompts, 6, sched_kw={"prefill_chunk": 6},
                   kv_dtype=kv_dtype, max_ragged_batch_size=16)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_oversubscribed_pool_preempts_like_jax(weights, kv_dtype):
    """9 blocks hold three 22-token sequences with no slack: decode growth
    preempts, and recompute is exact on both sides."""
    rng = np.random.default_rng(3)
    prompts = [_rng_prompt(rng, 22) for _ in range(3)]
    jsched, tsched = _same_generate(weights, prompts, 6, num_blocks=9,
                                    kv_dtype=kv_dtype)
    assert tsched.preemption_count > 0


@pytest.mark.parametrize("kv_dtype", ["", "fp8"])
def test_prefix_cache_hits_match_jax(weights, kv_dtype):
    """The second prompt rides the first one's cached blocks (its write
    into the shared tail block copies payload and scales)."""
    rng = np.random.default_rng(31)
    prefix = list(rng.integers(0, 256, size=24))
    prompts = [np.asarray(prefix + list(rng.integers(0, 256, size=n)),
                          np.int32) for n in (3, 5)]
    jeng = _jax_engine(weights, kv_dtype=kv_dtype)
    teng = _engine(weights, kv_dtype=kv_dtype)
    jsched, tsched = JaxScheduler(jeng), DSScheduler(teng)
    for p in prompts:
        want = jsched.generate([p.copy()], max_new_tokens=8)[0]
        got = tsched.generate([p.copy()], max_new_tokens=8)[0]
        np.testing.assert_array_equal(got, want)
    assert teng.state_manager.prefix_cache.hits == \
        jeng.state_manager.prefix_cache.hits >= 1
    _assert_pool_clean(teng)


# ------------------------------------------------- host logic, on the port
def test_token_budget_admission(weights):
    """A round never schedules more tokens than max_ragged_batch_size; the
    excess prompt waits (ENGINE_FULL is a queue state, not an error)."""
    eng = _engine(weights, max_ragged_batch_size=16)
    sched = DSScheduler(eng)
    rng = np.random.default_rng(0)
    for uid in range(4):
        assert sched.request(uid, _rng_prompt(rng, 10)) == \
            SchedulingResult.SUCCESS
    done = sched.step()  # 16-token budget admits only one 10-token prompt
    assert len(done) == 1
    assert sched.has_work
    seen = set(done)
    while sched.has_work:
        seen |= set(sched.step())
    assert seen == {0, 1, 2, 3}


def test_splitfuse_chunks_long_prompt(weights):
    """A prompt longer than the token budget is chunked across rounds;
    its token surfaces only on the final chunk and equals the one-shot
    prefill's."""
    eng = _engine(weights, max_ragged_batch_size=16)
    sched = DSScheduler(eng)
    prompt = _rng_prompt(np.random.default_rng(1), 40)  # ceil(40/16) = 3
    sched.request("long", prompt)
    rounds, done = 0, {}
    while sched.has_work:
        done.update(sched.step())
        rounds += 1
        assert rounds < 10
    assert rounds == 3 and "long" in done
    ref = _engine(weights).put(["x"], [prompt])[0]
    assert int(done["long"][-1]) == int(ref.argmax())


def test_oversubscribed_pool_queues_not_raises(weights):
    # 8 blocks x 8 tokens = 64 KV slots; 6 prompts x 24 tokens = 144
    eng = _engine(weights, num_blocks=8)
    rng = np.random.default_rng(2)
    outs = DSScheduler(eng).generate([_rng_prompt(rng, 24) for _ in range(6)],
                                     max_new_tokens=4)
    assert [o.size for o in outs] == [28] * 6
    _assert_pool_clean(eng)


def test_preempted_sequence_matches_unpreempted(weights):
    rng = np.random.default_rng(4)
    prompts = [_rng_prompt(rng, 22) for _ in range(3)]
    small = DSScheduler(_engine(weights, num_blocks=9))
    outs_small = small.generate([p.copy() for p in prompts], max_new_tokens=6)
    assert small.preemption_count > 0
    big = DSScheduler(_engine(weights))
    outs_big = big.generate([p.copy() for p in prompts], max_new_tokens=6)
    assert big.preemption_count == 0
    for a, b in zip(outs_small, outs_big):
        np.testing.assert_array_equal(a, b)


def test_request_length_overflow_rejected(weights):
    sched = DSScheduler(_engine(weights))
    r = sched.request("too_long", np.zeros(100, np.int32))  # max_context=64
    assert r == SchedulingResult.MAX_LENGTH_EXCEEDED
    assert not sched.has_work


def test_small_prefill_chunk_exact(weights):
    """prefill_chunk < token budget: chunks must advance through the
    prompt, never re-slicing one chunk twice into a batch."""
    sched = DSScheduler(_engine(weights, max_ragged_batch_size=32),
                        prefill_chunk=4)
    prompt = _rng_prompt(np.random.default_rng(5), 10)
    sched.request("p", prompt)
    done = {}
    while sched.has_work:
        done.update(sched.step())
    ref = _engine(weights).put(["x"], [prompt])[0]
    assert int(done["p"][-1]) == int(ref.argmax())


def test_prefill_cannot_starve_scheduled_decodes(weights):
    # bs=8, 7 blocks: A prefills 24 tokens (3 blocks, boundary-exact); its
    # next decode token needs a 4th.  A 24-token prefill B (3 blocks)
    # leaves exactly 1 block -- admission must reserve it for A.
    sched = DSScheduler(_engine(weights, num_blocks=7))
    rng = np.random.default_rng(6)
    sched.request("a", _rng_prompt(rng, 24))
    la = sched.step()["a"]
    sched.request("a", [int(la[-1])])
    sched.request("b", _rng_prompt(rng, 24))
    assert "a" in sched.step()          # must not raise MemoryError
    while sched.has_work:
        sched.step()


def test_unservable_growth_raises_clearly(weights):
    # 4 blocks x 8 = 32 slots; prompt 30 fits, +3 generated tokens cannot
    sched = DSScheduler(_engine(weights, num_blocks=4))
    prompt = _rng_prompt(np.random.default_rng(7), 30)
    with pytest.raises(UnservableRequestError, match="never be scheduled") as e:
        sched.generate([prompt], max_new_tokens=6)
    assert e.value.uid == 0 and isinstance(e.value, MemoryError)


def test_request_rejects_prompt_larger_than_pool(weights):
    sched = DSScheduler(_engine(weights, num_blocks=2))  # 16 KV slots
    assert sched.request("big", np.zeros(20, np.int32)) == \
        SchedulingResult.KV_CACHE_FULL
    assert not sched.has_work


@pytest.fixture
def registry():
    old = get_registry()
    yield set_registry(TelemetryRegistry(enabled=True, jsonl=False))
    set_registry(old)


def test_double_finish_idempotent_and_counted(weights, registry):
    sched = DSScheduler(_engine(weights))
    sched.request("r", _rng_prompt(np.random.default_rng(8), 12))
    sched.step()
    assert sched.finish("r") is True
    assert sched.finish("r") is False
    assert sched.finish("never-seen") is False
    assert sched.redundant_finish_count == 2
    assert registry.counter("infer/redundant_finish").total == 2
    assert not sched.has_work


def test_requeue_cap_surfaces_in_telemetry(weights, registry):
    sched = DSScheduler(_engine(weights), max_requeues=1)
    sched.request("r", _rng_prompt(np.random.default_rng(9), 12))
    req = sched.waiting[0]
    req.requeue_for_recompute(cap=sched.max_requeues)   # 1: at cap
    req.requeue_for_recompute(cap=sched.max_requeues)   # 2: over cap
    assert registry.counter("infer/requeue_count").total == 2
    assert registry.counter("infer/requeue_cap_exceeded").total == 1


def test_cancel_racing_preemption_no_leak(weights):
    """Cancelling every request the moment preemption churn starts -- some
    live, some just evicted and requeued -- must return every block."""
    eng = _engine(weights, num_blocks=9)
    sched = DSScheduler(eng)
    rng = np.random.default_rng(10)
    for uid in range(3):
        assert sched.request(uid, _rng_prompt(rng, 22)) == \
            SchedulingResult.SUCCESS
    rounds = 0
    while sched.preemption_count == 0 and rounds < 50:
        for uid, toks in sched.step().items():
            sched.request(uid, [int(toks[-1])])
        rounds += 1
    assert sched.preemption_count > 0, "geometry must force preemption"
    for uid in range(3):
        sched.finish(uid)
    assert not sched.has_work
    assert sched.step() == {}
    _assert_pool_clean(eng)


@pytest.mark.parametrize("kv_dtype", ["", "fp8"])
def test_cancel_mid_cow_fork_refcounts_zero(weights, kv_dtype):
    """Cancel a request whose KV is forked copy-on-write from the prefix
    cache, then evict the cache: every refcount returns to zero."""
    eng = _engine(weights, kv_dtype=kv_dtype)
    sched = DSScheduler(eng)
    prompt = _rng_prompt(np.random.default_rng(11), 20)
    assert sched.generate([prompt.copy()], max_new_tokens=2)[0].size == 22
    sched.request("b", prompt.copy())
    for uid, toks in sched.step().items():
        sched.request(uid, [int(toks[-1])])
    sched.step()      # at least one decode extension past the fork point
    assert eng.state_manager.prefix_cache.hits >= 1
    sched.finish("b")
    assert not sched.has_work
    _assert_pool_clean(eng)


def test_finish_mid_chunk_does_not_resurrect(weights):
    """finish() on a uid that is live and still queued (mid-chunk) drops
    the queued tail too."""
    eng = _engine(weights, max_ragged_batch_size=8)
    sched = DSScheduler(eng, prefill_chunk=8)
    assert sched.request(0, _rng_prompt(np.random.default_rng(7), 20)) == \
        SchedulingResult.SUCCESS
    done = sched.step()  # first 8-token chunk: uid 0 now live and queued
    assert done == {} and 0 in sched.live
    assert any(r.uid == 0 for r in sched.waiting)
    sched.finish(0)
    assert 0 not in sched.live
    assert not any(r.uid == 0 for r in sched.waiting)
    assert not sched.has_work
    assert sched.step() == {}
    _assert_pool_clean(eng)


def test_preempt_victims_and_admission_hooks(weights):
    """Targeted preemption requeues the matching live sequence for exact
    recompute; ``admission_policy`` reorders the queue and
    ``admission_gate`` holds a request back without losing its place."""
    eng = _engine(weights)
    gated = {"b"}
    sched = DSScheduler(eng, admission_policy=lambda r: -len(r.history),
                        admission_gate=lambda uid: uid not in gated)
    rng = np.random.default_rng(12)
    prompts = {"a": _rng_prompt(rng, 9), "b": _rng_prompt(rng, 30),
               "c": _rng_prompt(rng, 14)}
    for uid, p in prompts.items():
        sched.request(uid, p)
    first = sched.step()
    assert set(first) == {"a", "c"} and list(sched.live) == ["c", "a"]
    assert [r.uid for r in sched.waiting] == ["b"]
    gated.clear()
    assert sched.preempt_victims(lambda r: r.uid == "c") == 1
    assert sched.preemption_count == 1 and "c" not in sched.live
    out = sched.step()
    assert set(out) == {"b", "c"}
    # recompute is exact: the re-prefilled sequence emits the same token
    assert int(out["c"][-1]) == int(first["c"][-1])
    for uid in prompts:
        sched.finish(uid)
    _assert_pool_clean(eng)
