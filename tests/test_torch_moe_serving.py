"""MoE serving: the PyTorch port's ``InferenceEngineV2`` (the paged
forward) and its v1 engine (the cached decode) against the JAX package's
v2 engine, on GPT-NeoX ``tiny()`` with MoE blocks and the JAX engine's
weights.

As in the JAX package's ``test_moe_model_serves_ragged``, the gating is
no-drop (``moe_drop_tokens=False``): the capacity is a function of the
batch's shape, and the ragged batch and the dense one differ in shape, so
under drops the routing near the capacity may part.  Both engines serve
with the evaluation capacity.  Greedy tokens equal; each round's logits
within 1e-5 of the JAX engine's (fp32).
"""

import jax
import numpy as np
import pytest

from deeperspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngineV2
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.inference import InferenceEngine
from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

TOL = 1e-5
V2 = {"dtype": "float32", "kv_cache": {"num_blocks": 64, "block_size": 8},
      "state_manager": {"max_context": 64, "max_decode_batch": 4}}
CASES = {
    "k1": dict(moe_num_experts=2, moe_expert_interval=1),
    "k2-residual": dict(moe_num_experts=4, moe_expert_interval=2, moe_top_k=2,
                        moe_use_residual=True),
}


@pytest.fixture(scope="module")
def engines():
    saved = jtopo._GLOBAL_MESH
    # the JAX engines are built on the default mesh over every device, not
    # on a mesh an earlier test file in this process left behind
    jtopo._GLOBAL_MESH = None
    out = {}
    try:
        for name, kw in CASES.items():
            kw = dict(kw, moe_drop_tokens=False)
            jeng = JaxEngineV2(JaxGPTNeoX(JaxConfig.tiny(max_seq_len=64, **kw)), config=V2)
            params = params_from_jax(jax.device_get(jeng.params))
            teng = InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(**kw), device="cpu"), V2,
                                     params=params, device="cpu")
            v1 = InferenceEngine(GPTNeoX(GPTNeoXConfig.tiny(**kw), device="cpu"),
                                 {"dtype": "fp32"}, params=params, device="cpu")
            out[name] = jeng, teng, v1
    finally:
        jtopo.set_mesh(saved)
    return out


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in (9, 14, 5)]


@pytest.mark.parametrize("name", list(CASES))
def test_v2_and_v1_serve_moe_with_the_jax_tokens(engines, name):
    jeng, teng, v1 = engines[name]
    prompts = _prompts(0)
    want = jeng.generate(prompts, max_new_tokens=6)
    got = teng.generate(prompts, max_new_tokens=6)
    for p, w, g in zip(prompts, want, got):
        np.testing.assert_array_equal(g, w)
        one = np.asarray(v1.generate(p[None], max_new_tokens=6)).reshape(-1)
        np.testing.assert_array_equal(one, w)


@pytest.mark.parametrize("name", list(CASES))
def test_v2_rounds_match_jax_logits(engines, name):
    """A prefill round and two decode rounds: each round's logits."""
    jeng, teng, _ = engines[name]
    prompts = [p.tolist() for p in _prompts(1)[:2]]
    uids = [11, 12]
    feed = prompts
    for what in ("prefill", "decode 0", "decode 1"):
        jo, to = jeng.put_round(uids, feed), teng.put_round(uids, feed)
        np.testing.assert_allclose(to.logits[:2].numpy(), np.asarray(jo.logits)[:2],
                                   rtol=TOL, atol=TOL, err_msg=what)
        np.testing.assert_array_equal(to.tokens, jo.tokens, err_msg=what)
        feed = [[int(t)] for t in to.tokens[:, -1]]
    for eng in (jeng, teng):
        for uid in uids:
            eng.flush(uid)
