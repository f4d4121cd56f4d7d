"""The PyTorch GPT-NeoX against the JAX package's model on the CPU, with the
JAX parameters carried across by ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

CONFIGS = {
    "tiny": dict(hidden_size=64, num_layers=2, num_heads=4, vocab_size=256,
                 max_seq_len=64),
    "h256": dict(hidden_size=256, num_layers=2, num_heads=4, vocab_size=512,
                 max_seq_len=64, rotary_pct=0.25),
}


def _pair(name, seed=0):
    jmodel = JaxGPTNeoX(JaxConfig(**CONFIGS[name]))
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))["params"]
    tree = jax.device_get(params)
    model = GPTNeoX(GPTNeoXConfig(**CONFIGS[name]), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jmodel, params, tree, model


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def test_params_from_jax_round_trips_every_leaf():
    _, _, tree, model = _pair("tiny")
    sd = model.state_dict()
    leaves = dict(_leaves(tree))
    assert len(leaves) == len(sd)
    for path, value in leaves.items():
        name = (path.replace("/", ".").replace("layers_", "layers.")
                .replace(".scale", ".weight").replace(".kernel", ".weight")
                .replace("embed_in.embedding", "embed_in.weight"))
        back = sd[name].numpy()
        if path.endswith("kernel"):
            back = back.T
        np.testing.assert_array_equal(back, np.asarray(value, np.float32), err_msg=path)


def test_params_from_jax_rejects_unmapped_leaves():
    _, _, tree, _ = _pair("tiny")
    tree = dict(tree, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unmapped"):
        params_from_jax(tree)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unpaged_logits_match_jax(name):
    jmodel, params, _, model = _pair(name, seed=3)
    ids = np.random.default_rng(1).integers(0, CONFIGS[name]["vocab_size"], (2, 24))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_model_without_cuda_needs_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: construction defaults to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTNeoX(GPTNeoXConfig.tiny())
