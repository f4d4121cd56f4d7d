"""The PyTorch port's paged serving engine against the JAX package's, on the
CPU: allocator and state-manager bookkeeping, and rounds of every kind --
prefill (s_pad > 8), a 4-token extend (2 <= s_pad <= 8), pure decode, and a
prefix-cache hit with a copy-on-write block copy -- giving the same greedy
tokens and logits from the same weights."""

import jax
import numpy as np
import pytest
import torch

from deeperspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.inference.v2 import (BlockedAllocator,
                                                DSStateManager,
                                                InferenceEngineV2,
                                                RaggedInferenceEngineConfig)
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

ENGINE_CFG = {"dtype": "float32",
              "kv_cache": {"num_blocks": 64, "block_size": 8},
              "state_manager": {"max_context": 64, "max_decode_batch": 4}}
TOL = 1e-4       # fp32 logits, summation order only


class TestBlockedAllocator:
    def test_allocate_free_cycle(self):
        a = BlockedAllocator(8)
        blocks = a.allocate(5)
        assert len(blocks) == 5 and a.free_blocks == 3
        a.free(blocks[:2])
        assert a.free_blocks == 5
        with pytest.raises(MemoryError):
            a.allocate(6)
        with pytest.raises(ValueError):
            a.free([blocks[2], blocks[2]])

    def test_double_free_detected(self):
        a = BlockedAllocator(4)
        b = a.allocate(2)
        a.free(b)
        with pytest.raises(ValueError):
            a.free(b)


class TestStateManager:
    def _cfg(self):
        return RaggedInferenceEngineConfig(
            kv_cache={"num_blocks": 16, "block_size": 4},
            state_manager={"max_context": 32})

    def test_block_growth(self):
        sm = DSStateManager(self._cfg())
        seq = sm.extend("a", 6)
        assert len(seq.blocks) == 2
        seq.seen_tokens = 6
        sm.extend("a", 2)
        assert len(seq.blocks) == 2
        seq.seen_tokens = 8
        sm.extend("a", 1)
        assert len(seq.blocks) == 3

    def test_flush_returns_blocks(self):
        sm = DSStateManager(self._cfg())
        sm.extend("a", 10)
        used = sm.allocator.free_blocks
        sm.flush_sequence("a")
        assert sm.allocator.free_blocks == used + 3
        assert not sm.known("a")

    def test_max_context_enforced(self):
        sm = DSStateManager(self._cfg())
        with pytest.raises(MemoryError):
            sm.extend("a", 33)


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine holding the same (JAX-initialised)
    weights of the tiny GPT-NeoX."""
    jeng = JaxEngine(JaxGPTNeoX(JaxConfig.tiny(max_seq_len=64)),
                     config=ENGINE_CFG)
    params = params_from_jax(jax.device_get(jeng.params))
    teng = InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                             ENGINE_CFG, params=params, device="cpu")
    return jeng, teng


def _same_round(jeng, teng, uids, feed, what):
    """One put_round on both engines: logits agree to TOL, and every greedy
    token agrees -- each one decided by a top-2 margin wider than TOL, so a
    mismatch cannot be a rounding tie."""
    jo, to = jeng.put_round(uids, feed), teng.put_round(uids, feed)
    n = len(uids)
    jl = np.asarray(jo.logits)[:n]
    tl = to.logits[:n].numpy()
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL, err_msg=what)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    assert (margin > 10 * TOL).all(), f"{what}: near-tie margins {margin}"
    np.testing.assert_array_equal(to.tokens, jo.tokens, err_msg=what)
    return [[int(t)] for t in to.tokens[:, -1]]


def test_rounds_of_every_kind_match_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, 13).tolist(), rng.integers(0, 256, 16).tolist()]
    nxt = _same_round(jeng, teng, [1, 2], prompts, "prefill")          # s_pad 16
    for i in range(3):
        nxt = _same_round(jeng, teng, [1, 2], nxt, f"decode {i}")     # s_pad 1
    ext = [nxt[0] + rng.integers(0, 256, 3).tolist(), nxt[1]]
    _same_round(jeng, teng, [1, 2], ext, "4-token extend")            # s_pad 4
    for eng in (jeng, teng):
        eng.flush(1)
        eng.flush(2)
    # uid 3 repeats uid 2's prompt: both full blocks come from the prefix
    # cache and the one recomputed token's write copies the shared block
    matched = [eng.state_manager.match_prefix(3, prompts[1]) for eng in (jeng, teng)]
    assert matched == [15, 15]
    _same_round(jeng, teng, [3], [prompts[1][15:]], "prefix hit")
    for eng in (jeng, teng):
        assert eng.state_manager.prefix_cache.hits == 1
        eng.flush(3)


def test_generate_gives_identical_greedy_tokens(engines):
    jeng, teng = engines
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 12, 9)]
    want = jeng.generate(prompts, max_new_tokens=8)
    got = teng.generate(prompts, max_new_tokens=8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_put_logits_match_jax(engines):
    jeng, teng = engines
    toks = np.random.default_rng(6).integers(0, 256, 21)
    np.testing.assert_allclose(teng.put([7], [toks]), jeng.put([7], [toks]),
                               rtol=TOL, atol=TOL)
    jeng.flush(7)
    teng.flush(7)


def test_warmup_buckets_match_jax(engines):
    _, teng = engines
    # the JAX package's own test pins these buckets
    assert teng.warmup([(3, 12), (4, 1)]) == [(4, 16, 1), (4, 1, 1)]
    assert teng._round_buckets(5, 4, 2) == (8, 4, 4)


@pytest.mark.parametrize("bad", [{"tp_size": 2},
                                 {"kv_cache": {"dtype": "fp8_e5m2"}},
                                 {"kv_cache": {"dtype": "e5m2"}},
                                 {"kv_tier": {"enabled": True}}])
def test_unported_options_raise(bad):
    with pytest.raises(NotImplementedError):
        InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), bad,
                          device="cpu")


def test_engine_without_cuda_needs_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine defaults to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), ENGINE_CFG)
