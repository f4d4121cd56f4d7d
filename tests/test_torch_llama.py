"""The PyTorch Llama family (Llama-2, Mistral, OPT) against the JAX
package's ``models/llama.py`` on the CPU, with the JAX parameters carried
across by ``params_from_jax``: forward logits and gradients in fp32, the
caches at the KV heads, parameter counts, the weight round trip, and
training through both engines from the same weights.

Tolerances: logits within 1e-5 (fp32, summation order only); each
gradient leaf within 1e-5 of its largest entry; training losses within
1e-5 relative of the JAX engine's, as ``test_torch_train.py``'s fp32
trajectory."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.llama import Llama as JaxLlama
from deeperspeed_tpu.models.llama import LlamaConfig as JaxConfig
from deeperspeed_tpu_torch.inference import InferenceEngine
from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deeperspeed_tpu_torch.models import DecodeCache, Llama, LlamaConfig
from deeperspeed_tpu_torch.models.llama import params_from_jax, params_to_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

CASES = {"tiny": ("tiny", {}), "tiny_mistral": ("tiny_mistral", {}),
         "tiny_opt": ("tiny_opt", {}), "kv1": ("tiny", {"num_kv_heads": 1})}
TOL = 1e-5


def _pair(case, seed=0):
    preset, kw = CASES[case]
    jmodel = JaxLlama(getattr(JaxConfig, preset)(**kw))
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))["params"]
    tree = jax.device_get(params)
    model = Llama(getattr(LlamaConfig, preset)(**kw), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jmodel, params, tree, model


def _tokens(seed=0, rows=2, seq=40):
    return np.random.default_rng(seed).integers(0, 256, (rows, seq)).astype(np.int32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_match_jax(case):
    """Seq 40 > tiny_mistral's window of 16, so the window binds."""
    jmodel, params, _, model = _pair(case)
    toks = _tokens()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks)))
    got = model(torch.from_numpy(toks).long()).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax(case):
    """One ``loss_fn`` backward: every parameter's gradient."""
    jmodel, params, _, model = _pair(case, seed=1)
    toks = _tokens(seed=2, seq=33)
    batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(jmodel.loss_fn())(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = model.loss_fn()(model, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=TOL)
    got = dict(_leaves(params_to_jax({n: p.grad for n, p in model.named_parameters()})))
    want = dict(_leaves(jax.device_get(jg)))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path].numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (path, err)


def test_caches_at_kv_heads():
    """The v2 pools and the v1 cache hold num_kv_heads (the JAX test
    ``test_gqa_cache_stored_at_kv_heads``), as the JAX model's caches do."""
    cfg = JaxConfig.tiny(num_kv_heads=2, paged_num_blocks=8, paged_block_size=8)
    toks = jnp.zeros((1, 8), jnp.int32)
    jdec = JaxLlama(cfg, decode=True).init(jax.random.PRNGKey(0), toks)["cache"]
    jpaged = JaxLlama(cfg, paged=True).init(jax.random.PRNGKey(0), toks)["cache"]
    want_dec = jdec["layers_0"]["attention"]["cached_key"].shape
    want_pool = jpaged["layers_0"]["attention"]["paged_key"].shape
    v2 = InferenceEngineV2(Llama(LlamaConfig.tiny(), device="cpu"),
                           {"dtype": "float32", "kv_cache": {"num_blocks": 8, "block_size": 8},
                            "state_manager": {"max_context": 64}}, device="cpu")
    assert tuple(v2.kv_cache[0][0].shape) == tuple(want_pool) == (8, 8, 2, 16)
    v1 = InferenceEngine(Llama(LlamaConfig.tiny(), device="cpu"), {"dtype": "fp32"},
                         device="cpu")
    cache = v1._new_cache(1, 64)
    assert isinstance(cache, DecodeCache)
    assert tuple(cache.layers[0][0].shape) == tuple(want_dec) == (1, 64, 2, 16)


PRESETS = ["tiny", "tiny_mistral", "tiny_opt", "llama2_7b", "mistral_7b", "opt_125m"]


@pytest.mark.parametrize("preset", PRESETS)
def test_num_params_counts_the_parameters(preset):
    """The analytic count equals the module's, the 7B presets built on
    ``meta``; and the JAX model's count."""
    full = preset.endswith(("7b", "125m"))
    cfg = getattr(LlamaConfig, preset)()
    model = Llama(cfg, device="meta" if full else "cpu")
    assert model.num_params() == sum(p.numel() for p in model.parameters())
    assert model.num_params() == JaxLlama(getattr(JaxConfig, preset)()).num_params()
    assert model.flops_per_token() == JaxLlama(getattr(JaxConfig, preset)()).flops_per_token()


@pytest.mark.parametrize("case", list(CASES))
def test_params_round_trip(case):
    """``params_to_jax(params_from_jax(t)) == t`` leaf for leaf, and the
    port's state dict has a parameter for every leaf."""
    _, _, tree, model = _pair(case)
    back = dict(_leaves(params_to_jax(params_from_jax(tree))))
    want = dict(_leaves(tree))
    assert set(back) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path].numpy(), np.asarray(w), err_msg=path)
    assert len(model.state_dict()) == len(want)
    with pytest.raises(ValueError, match="unmapped"):
        params_from_jax(dict(tree, extra={"kernel": np.zeros((2, 2), np.float32)}))


def test_tp_needs_whole_kv_heads():
    """Tensor parallelism splits whole KV heads: tp 2 refuses one KV head."""
    with pytest.raises(ValueError, match="num_kv_heads 1"):
        Llama(LlamaConfig.tiny(num_kv_heads=1), device="cpu").check_tensor_parallel(2)
    Llama(LlamaConfig.tiny(), device="cpu").check_tensor_parallel(2)


TRAIN = {"train_batch_size": 16, "gradient_clipping": 1.0,
         "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}, "seed": 2}
_TOKS = _tokens(seed=5, rows=16, seq=33)
BATCH = {"input_ids": _TOKS[:, :-1], "labels": _TOKS[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_trajectory(preset):
    """The JAX engine's 6 losses at stage 0 and its initial weights (at
    world 1 the stages differ only in where the state lives)."""
    jeng, *_ = jdst.initialize(model=JaxLlama(getattr(JaxConfig, preset)()),
                               config={**TRAIN, "zero_optimization": {"stage": 0}})
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    losses = [float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in BATCH.items()}))
              for _ in range(6)]
    return start, losses


@pytest.mark.parametrize("stage", [0, 2])
@pytest.mark.parametrize("preset", ["tiny", "tiny_mistral", "tiny_opt"])
def test_trains_like_the_jax_engine(preset, stage):
    """6 Adam steps (JAX ``test_trains_on_flat_engine``) from the same
    weights on one batch: the loss falls, and each step's loss is the JAX
    engine's within 1e-5 relative."""
    start, want = _jax_trajectory(preset)
    teng, *_ = tdst.initialize(model=Llama(getattr(LlamaConfig, preset)(), device="cpu"),
                               config={**TRAIN, "zero_optimization": {"stage": stage}},
                               model_parameters=start, device="cpu")
    got = [float(teng.train_batch(batch={k: torch.from_numpy(v).long()
                                         for k, v in BATCH.items()})) for _ in range(6)]
    assert all(np.isfinite(got)) and got[-1] < got[0], got
    np.testing.assert_allclose(got, want, rtol=TOL)
