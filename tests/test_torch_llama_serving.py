"""The Llama family served by the PyTorch port's paged engine and
scheduler on the CPU, against the JAX package's v2 engine on the same
weights: ``InferenceEngineV2`` rounds of every kind (prefill, decode, a
4-token extend) and ``DSScheduler.generate`` over fp32 and int8 pools,
with grouped-query attention (tiny: 4 query heads on 2 KV heads, folded
into the batch of the paged kernels); Mistral's sliding window against the
dense forward; and the attention route each row bucket takes.

Tolerances: logits within 1e-4 of the JAX engine's (fp32, summation order)
and greedy tokens equal, each decided by a top-2 margin wider than that;
the windowed model within 2e-4 of the dense forward (the JAX test
``test_v2_mistral_window_matches_dense``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.inference.v2 import DSScheduler as JaxScheduler
from deeperspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deeperspeed_tpu.models.llama import Llama as JaxLlama
from deeperspeed_tpu.models.llama import LlamaConfig as JaxConfig
from deeperspeed_tpu_torch.inference.v2 import DSScheduler, InferenceEngineV2
from deeperspeed_tpu_torch.models import Llama, LlamaConfig
from deeperspeed_tpu_torch.models import llama as llama_module
from deeperspeed_tpu_torch.models.llama import params_from_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

TOL = 1e-4
WINDOW_TOL = 2e-4


def _config(kv_dtype="", speculative=None, num_blocks=64):
    cfg = {"dtype": "float32",
           "kv_cache": {"num_blocks": num_blocks, "block_size": 8, "dtype": kv_dtype},
           "state_manager": {"max_context": 64, "max_decode_batch": 4}}
    if speculative is not None:
        cfg["speculative"] = speculative
    return cfg


@pytest.fixture(scope="module")
def weights():
    """The JAX tiny Llama, its engine's parameters, and the same weights
    as a state dict for the port."""
    model = JaxLlama(JaxConfig.tiny())
    params = JaxEngine(model, config=_config()).params
    return model, params, params_from_jax(jax.device_get(params))


def _engines(weights, **kw):
    jeng = JaxEngine(weights[0], config=_config(**kw), params=weights[1])
    teng = InferenceEngineV2(Llama(LlamaConfig.tiny(), device="cpu"), _config(**kw),
                             params=weights[2], device="cpu")
    return jeng, teng


def _same_round(jeng, teng, uids, feed, what):
    jo, to = jeng.put_round(uids, feed), teng.put_round(uids, feed)
    n = len(uids)
    jl, tl = np.asarray(jo.logits)[:n], to.logits[:n].numpy()
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL, err_msg=what)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 10 * TOL).all(), f"{what}: near-tie margins"
    np.testing.assert_array_equal(to.tokens, jo.tokens, err_msg=what)
    return [[int(t)] for t in to.tokens[:, -1]]


@pytest.mark.parametrize("kv", ["", "int8"])
def test_rounds_match_jax(weights, kv):
    """Prefill (s_pad 16), three decodes (s_pad 1, K2 / K2q on the card)
    and a 4-token extend (s_pad 4, K3 / K3q): logits and greedy tokens."""
    jeng, teng = _engines(weights, kv_dtype=kv)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, 13).tolist(), rng.integers(0, 256, 16).tolist()]
    nxt = _same_round(jeng, teng, [1, 2], prompts, "prefill")
    for i in range(3):
        nxt = _same_round(jeng, teng, [1, 2], nxt, f"decode {i}")
    _same_round(jeng, teng, [1, 2], [nxt[0] + rng.integers(0, 256, 3).tolist(), nxt[1]],
                "4-token extend")


SCHEDULED = {"fp32": ("", None), "int8": ("int8", None),
             "fp32-ngram": ("", {"method": "ngram", "k": 4})}


@pytest.mark.parametrize("case", list(SCHEDULED))
def test_scheduler_generate_matches_jax(weights, case):
    """``DSScheduler.generate`` serves Llama: token for token and round for
    round the JAX scheduler's, the pool whole afterwards."""
    kv, spec = SCHEDULED[case]
    jeng, teng = _engines(weights, kv_dtype=kv, speculative=spec)
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(0, 256, 5), 3).astype(np.int32),
               rng.integers(0, 256, 9).astype(np.int32),
               np.tile(rng.integers(0, 256, 3), 4).astype(np.int32)]
    want = JaxScheduler(jeng).generate([p.copy() for p in prompts], 10)
    got = DSScheduler(teng).generate([p.copy() for p in prompts], 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert teng.dispatch_count == jeng.dispatch_count
    sm = teng.state_manager
    total = sm.allocator.total_blocks
    assert sm.free_blocks_with_evictable() == total
    if sm.prefix_cache is not None:
        sm.prefix_cache.evict(total)
    assert sm.allocator.free_blocks == total
    sm.allocator.audit()


def test_window_matches_dense(weights):
    """Mistral's window (8 over a 16-token prompt) served through the paged
    engine equals the dense model's logits, prefill and decode (the JAX
    test ``test_v2_mistral_window_matches_dense``), and the JAX dense
    model's."""
    cfg = LlamaConfig.tiny(sliding_window=8)
    eng = InferenceEngineV2(Llama(cfg, device="cpu"), {
        "dtype": "float32", "kv_cache": {"num_blocks": 8, "block_size": 8},
        "state_manager": {"max_context": 64}}, params=weights[2], device="cpu")
    dense = Llama(cfg, device="cpu")
    dense.load_state_dict(weights[2])
    jdense = JaxLlama(JaxConfig.tiny(sliding_window=8))
    prompt = np.random.RandomState(3).randint(0, 256, size=16).astype(np.int32)
    seq = prompt
    got = eng.put([7], [prompt])[0]
    for step in range(3):
        with torch.no_grad():
            want = dense(torch.from_numpy(seq[None]).long())[0, -1].numpy()
        jwant = np.asarray(jdense.apply({"params": weights[1]}, jnp.asarray(seq[None])))[0, -1]
        np.testing.assert_allclose(got, want, rtol=WINDOW_TOL, atol=WINDOW_TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(got, jwant, rtol=WINDOW_TOL, atol=WINDOW_TOL,
                                   err_msg=f"step {step}")
        tok = np.array([int(np.argmax(got))], np.int32)
        seq = np.concatenate([seq, tok])
        got = eng.put([7], [tok])[0]


ROUTES = [(window, s) for window in (None, 8) for s in (1, 4, 16)]


@pytest.mark.parametrize("window,s", ROUTES,
                         ids=[f"window{w}-s{s}" for w, s in ROUTES])
def test_rows_take_the_jax_routes(weights, monkeypatch, window, s):
    """The JAX routing (``llama.py:298-345``): without a window an S = 1
    round calls the paged decode attention once a layer, an S = 4 round
    the speculative one, an S = 16 round neither (the dense path); under a
    window every round takes the dense path."""
    calls = {"decode": 0, "spec": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(llama_module, "paged_decode_attention",
                        counted("decode", llama_module.paged_decode_attention))
    monkeypatch.setattr(llama_module, "paged_spec_decode_attention",
                        counted("spec", llama_module.paged_spec_decode_attention))
    eng = InferenceEngineV2(Llama(LlamaConfig.tiny(sliding_window=window), device="cpu"),
                            _config(), params=weights[2], device="cpu")
    rng = np.random.default_rng(1)
    eng.put_round([1], [rng.integers(0, 256, 12).tolist()])
    calls.update(decode=0, spec=0)
    out = eng.put_round([1], [rng.integers(0, 256, s).tolist()])
    assert np.isfinite(out.logits.numpy()).all()
    layers = LlamaConfig.tiny().num_layers
    want = {"decode": layers if (window is None and s == 1) else 0,
            "spec": layers if (window is None and s == 4) else 0}
    assert calls == want
