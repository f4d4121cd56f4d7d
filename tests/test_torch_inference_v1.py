"""The PyTorch port's v1 engine (``init_inference`` ->
``InferenceEngine.generate``) against the JAX package's on the CPU, on
GPT-NeoX ``tiny()`` and Llama ``tiny()`` with the JAX engine's weights:
greedy generation with and without left padding, eos and pad, the sampling
filter, the full-sequence forward, weight-only quantization (q and scales
bit for bit against the jitted JAX function, greedy tokens against the
JAX wq engine), checkpoints across the packages, and what became of the
MoE refusals.

Tolerances: forward logits within 1e-5 (fp32); greedy tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.inference import engine as jax_engine_module
from deeperspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deeperspeed_tpu.inference.quantization import dequantize_param_tree as jax_dequantize
from deeperspeed_tpu.inference.quantization import quantize_param_tree as jax_quantize
from deeperspeed_tpu.inference.quantization import quantized_bytes as jax_bytes
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxNeoXConfig
from deeperspeed_tpu.models.llama import Llama as JaxLlama
from deeperspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.inference import DeeperSpeedInferenceConfig, InferenceEngine
from deeperspeed_tpu_torch.inference.engine import _filter_logits
from deeperspeed_tpu_torch.inference.quantization import (QuantizedWeight,
                                                          dequantize_param_tree,
                                                          quantize_param_tree,
                                                          quantized_bytes)
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, Llama, LlamaConfig
from deeperspeed_tpu_torch.models import gpt_neox as neox_module
from deeperspeed_tpu_torch.models import llama as llama_module
import torch_threads  # noqa: F401  (torch at one intra-op thread)

TOL = 1e-5
FAMILIES = {
    "neox": (lambda: JaxGPTNeoX(JaxNeoXConfig.tiny(max_seq_len=64)),
             lambda: GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), neox_module.params_from_jax),
    "llama": (lambda: JaxLlama(JaxLlamaConfig.tiny()),
              lambda: Llama(LlamaConfig.tiny(), device="cpu"), llama_module.params_from_jax),
}
FP32 = {"dtype": "fp32"}


@pytest.fixture(scope="module", autouse=True)
def _jax_mesh_restored():
    """The JAX v1 engine sets the JAX package's global mesh; later tests in
    this process expect the one they found."""
    saved = jtopo._GLOBAL_MESH
    yield
    jtopo.set_mesh(saved)


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX v1 engine per family (its own random weights), by name."""
    return {name: JaxEngine(model=make(), config=FP32) for name, (make, _, _) in
            FAMILIES.items()}


def _port(jax_engines, name, config=FP32):
    _, make, convert = FAMILIES[name]
    params = convert(jax.device_get(jax_engines[name].params))
    return InferenceEngine(make(), config, params=params, device="cpu")


def _prompts(seed, rows=3, seq=7):
    return np.random.default_rng(seed).integers(1, 256, (rows, seq)).astype(np.int32)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left-padded"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_greedy_generate_matches_jax(jax_engines, name, padded):
    """Greedy tokens bit for bit; left-padded rows (the JAX test
    ``test_left_padded_prompts``) equal the same prompts unpadded."""
    jeng, teng = jax_engines[name], _port(jax_engines, name)
    ids = _prompts(1)
    mask = np.ones_like(ids)
    if padded:
        mask[0, :3] = 0
        mask[2, :1] = 0
        ids = ids * mask
    want = np.asarray(jeng.generate(jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                    max_new_tokens=6))
    got = teng.generate(ids, attention_mask=mask, max_new_tokens=6).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    if padded:
        alone = teng.generate(ids[:1, 3:], max_new_tokens=6).cpu().numpy()
        np.testing.assert_array_equal(got[0, 7:], alone[0, 4:])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_eos_marks_rows_done_and_pads(jax_engines, name):
    """eos on the first generated token: the row then emits ``pad`` (the
    JAX test ``test_eos_stops_with_pad``), as the JAX engine does."""
    jeng, teng = jax_engines[name], _port(jax_engines, name)
    ids = _prompts(2, rows=2, seq=4)
    first = int(teng.generate(ids, max_new_tokens=1)[0, -1])
    got = teng.generate(ids, max_new_tokens=4, eos_token_id=first, pad_token_id=99)
    want = jeng.generate(jnp.asarray(ids), max_new_tokens=4, eos_token_id=first,
                         pad_token_id=99)
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0, 4:].cpu().numpy(), [first, 99, 99, 99])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_logits_match_jax(jax_engines, name):
    """``engine(ids, attention_mask)``: full-sequence logits with a key
    mask, within 1e-5."""
    jeng, teng = jax_engines[name], _port(jax_engines, name)
    ids = _prompts(3, rows=2, seq=10)
    mask = np.ones_like(ids)
    mask[1, :4] = 0
    want = np.asarray(jeng(jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    got = teng(ids, attention_mask=mask).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_sampling_is_reproducible_by_seed(jax_engines):
    """The JAX test ``test_sampling_reproducible``: one seed, one draw."""
    teng = _port(jax_engines, "llama")
    ids = np.ones((2, 5), np.int32)

    def draw(seed):
        return teng.generate(ids, max_new_tokens=6, do_sample=True, temperature=0.8,
                             top_k=50, seed=seed).cpu().numpy()

    np.testing.assert_array_equal(draw(7), draw(7))
    assert not np.array_equal(draw(7), draw(8))
    assert teng.generate(ids, max_new_tokens=3, do_sample=True, top_p=0.9).shape == (2, 8)


FILTERS = [(1.0, 5, None), (0.7, None, 0.9), (1.0, 3, 0.5), (1.3, 40, 0.95), (1.0, None, 0.2)]


@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS)
def test_filter_keeps_the_jax_set(monkeypatch, temperature, top_k, top_p):
    """On fixed logits with ties, the entries top-k and top-p keep are the
    JAX ``_sample_tokens``'s (its draw replaced by the filtered logits)."""
    logits = np.random.default_rng(4).integers(-20, 20, (6, 64)).astype(np.float32) / 4
    monkeypatch.setattr(jax.random, "categorical", lambda rng, lg, axis=-1: lg)
    want = np.asarray(jax_engine_module._sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(0), True, temperature, top_k, top_p))
    got = _filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)


def _flax_like_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": (rng.standard_normal((128, 64)) * 0.05).astype(np.float32),
                      "bias": rng.standard_normal(64).astype(np.float32)},
            "emb": {"embedding": rng.standard_normal((256, 64)).astype(np.float32)},
            "odd": {"kernel": rng.standard_normal((96, 48)).astype(np.float32)},
            # rows over four decades of scale: a true division by n instead of
            # the compiled multiply-add gives other int4 scales here
            "wide": {"kernel": (rng.standard_normal((4096, 1024)) * rng.uniform(
                0.001, 10, (4096, 1))).astype(np.float32)}}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_bit_for_bit(bits):
    """q and bf16 scales equal the jitted JAX ``quantize_param_tree``'s
    (its scale is a multiply by the fp32 reciprocal fused with the sum,
    which the port reproduces); small leaves stay exact; the dequantized
    tree and ``quantized_bytes`` agree."""
    tree = _flax_like_tree(bits)
    jq = jax.jit(lambda t: jax_quantize(t, bits=bits, group_size=64, min_size=4096))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tq = quantize_param_tree({k: {n: torch.from_numpy(v) for n, v in d.items()}
                              for k, d in tree.items()}, bits=bits, group_size=64)
    for path in (("dense", "kernel"), ("emb", "embedding"), ("odd", "kernel"),
                 ("wide", "kernel")):
        j, t = jq[path[0]][path[1]], tq[path[0]][path[1]]
        assert isinstance(t, QuantizedWeight) and t.group == j.group
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.float().numpy(),
                                      np.asarray(j.scale.astype(jnp.float32)))
    np.testing.assert_array_equal(tq["dense"]["bias"].numpy(), tree["dense"]["bias"])
    back = dequantize_param_tree(tq, torch.float32)
    want = jax_dequantize(jq, jnp.float32)
    np.testing.assert_array_equal(back["dense"]["kernel"].numpy(),
                                  np.asarray(want["dense"]["kernel"]))
    assert quantized_bytes(tq) == jax_bytes(jq)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_wq_engine_matches_jax(jax_engines, name, bits):
    """The JAX test ``test_engine_wq_generate_parity`` held exactly: the
    port's quantized engine gives the JAX wq engine's greedy tokens, and
    holds fewer weight bytes (int4 fewer than int8)."""
    quant = {"dtype": "fp32", "quant": {"enabled": True, "bits": bits, "group_size": 64}}
    jeng = JaxEngine(model=FAMILIES[name][0](), config=quant,
                     params=jax_engines[name].params)
    teng = _port(jax_engines, name, quant)
    full = _port(jax_engines, name).weight_bytes
    assert teng.weight_bytes == jax_bytes(jeng.params)
    assert teng.weight_bytes < (0.45 if bits == 8 else 0.3) * full
    prompt = np.array([[5, 7, 11, 13, 17, 19, 23, 29]], np.int32)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), max_new_tokens=4))
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=4).cpu().numpy(),
                                  want)


TRAIN = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


def _batch():
    toks = np.random.default_rng(9).integers(0, 256, (8, 17))
    return toks[:, :-1], toks[:, 1:]


def test_serves_a_jax_checkpoint(tmp_path):
    """A Llama checkpoint the JAX training engine wrote, served by both v1
    engines (``config.checkpoint``): the same greedy tokens."""
    jeng, *_ = jdst.initialize(model=JaxLlama(JaxLlamaConfig.tiny()), config=TRAIN)
    x, y = _batch()
    jeng.train_batch(batch={"input_ids": jnp.asarray(x), "labels": jnp.asarray(y)})
    jeng.save_checkpoint(str(tmp_path))
    cfg = {"dtype": "fp32", "checkpoint": str(tmp_path)}
    prompt = _prompts(5, rows=2, seq=6)
    want = np.asarray(JaxEngine(model=JaxLlama(JaxLlamaConfig.tiny()), config=cfg)
                      .generate(jnp.asarray(prompt), max_new_tokens=5))
    got = tdst.init_inference(Llama(LlamaConfig.tiny(), device="cpu", seed=3), cfg,
                              device="cpu").generate(prompt, max_new_tokens=5)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_jax_serves_a_port_checkpoint(tmp_path):
    """The reverse: the port's training engine writes the checkpoint, the
    JAX v1 engine serves it with the port's v1 engine's tokens."""
    teng, *_ = tdst.initialize(model=Llama(LlamaConfig.tiny(), device="cpu"),
                               config=TRAIN, device="cpu")
    x, y = _batch()
    teng.train_batch(batch={"input_ids": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    teng.save_checkpoint(str(tmp_path))
    cfg = {"dtype": "fp32", "checkpoint": {"checkpoint_dir": str(tmp_path)}}
    prompt = _prompts(6, rows=2, seq=6)
    want = np.asarray(JaxEngine(model=JaxLlama(JaxLlamaConfig.tiny()), config=cfg)
                      .generate(jnp.asarray(prompt), max_new_tokens=5))
    got = tdst.init_inference(Llama(LlamaConfig.tiny(), device="cpu", seed=3), cfg,
                              device="cpu").generate(prompt, max_new_tokens=5)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_init_inference_api():
    """The JAX test ``test_init_inference_api``: keyword config, the
    reference's aliases, logits of the prompt's length."""
    eng = tdst.init_inference(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              dtype="float32", replace_with_kernel_inject=False,
                              max_tokens=16, tp={"tp_size": 1}, device="cpu")
    assert isinstance(eng, InferenceEngine)
    assert eng.config.max_out_tokens == 16 and eng.config.kernel_inject is False
    assert eng(np.ones((1, 4), np.int32)).shape == (1, 4, 256)
    assert eng.generate(np.ones((1, 4), np.int32)).shape == (1, 20)


def test_init_inference_defaults_to_cuda(monkeypatch):
    """Without ``device="cpu"`` the engine asks for CUDA, and raises
    without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdst.init_inference(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"))


def _moe_engine_generates():
    """An MoE model served by the v1 engine under ``moe_experts``."""
    model = GPTNeoX(GPTNeoXConfig.tiny(moe_num_experts=4, moe_drop_tokens=False), device="cpu")
    eng = tdst.init_inference(model, {"dtype": "fp32", "moe": True, "moe_experts": 4},
                              device="cpu")
    assert eng.config.moe_experts == 4
    assert eng.generate(np.ones((1, 4), np.int32), max_new_tokens=3).shape == (1, 7)


def _ep_not_dividing_is_refused():
    with pytest.raises(ValueError, match="expert_parallel_size 2 does not divide"):
        tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), device="cpu",
                        config={**TRAIN, "mesh": {"expert_parallel_size": 2}})


def _moe_initialize(config):
    model = GPTNeoX(GPTNeoXConfig.tiny(moe_num_experts=4), device="cpu")
    eng, *_ = tdst.initialize(model=model, device="cpu", config={**TRAIN, **config})
    eng.train_batch(batch=model.example_batch(8, 16))
    return eng


# the MoE refusals the port made before MoE was ported, each now running
# the accepted path, or (an ep that does not divide the processes) the
# refusal that stays
REFUSED = [
    ("inference moe", lambda: DeeperSpeedInferenceConfig(moe=True).moe),
    ("inference moe_experts", _moe_engine_generates),
    ("model moe_num_experts", lambda: len(GPTNeoX(GPTNeoXConfig.tiny(moe_num_experts=4),
                                                  device="cpu").moe_layers()) == 1),
    ("mesh expert_parallel_size", _ep_not_dividing_is_refused),
    ("comm moe_alltoall", lambda: _moe_initialize(
        {"comm": {"quantized": {"moe_alltoall": True, "moe_alltoall_dtype": "fp8"}}}
    ).module.config.moe_quantized_alltoall_dtype == "fp8"),
    ("config moe", lambda: _moe_initialize({"moe": {"enabled": True}}) is not None),
]


@pytest.mark.parametrize("what,make", REFUSED, ids=[w for w, _ in REFUSED])
def test_moe_refusals_name_their_item(what, make):
    """What became of each MoE refusal: the inference config's ``moe`` keys
    are accepted and not acted on (the JAX package's rule), an MoE model
    builds, serves and trains, ``comm.quantized.moe_alltoall`` reaches the
    model's config, the config's ``moe`` block is accepted; an
    ``expert_parallel_size`` the processes do not fill is refused."""
    assert make() is not False
