"""The chunked cross entropy (``ce_chunk_tokens`` > 0) of the PyTorch port
against the JAX package's ``loss_chunked`` on the CPU, with the JAX
parameters carried across by ``params_from_jax``.

Tolerances: the loss within 1e-6 relative and the gradient (every
parameter's, as one vector) within 1e-5 of its norm: fp32 throughout,
the two frameworks differ by summation order only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    """The tiny model's parameters, made once by one compile of init: the
    chunk size changes none of them."""
    init = jax.jit(JaxGPTNeoX(JaxConfig.tiny()).init)
    return init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))["params"]


def _pair(chunk, seed=0):
    jmodel = JaxGPTNeoX(JaxConfig.tiny(ce_chunk_tokens=chunk))
    params = _jax_params(seed)
    model = GPTNeoX(GPTNeoXConfig.tiny(ce_chunk_tokens=chunk), device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def _batch(B, S, masked, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S + 1))
    batch = {"input_ids": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    if masked:
        batch["loss_mask"] = (rng.random((B, S)) > 0.25).astype(np.float32)
    return batch


def _torch_loss_and_grads(model, batch):
    model.zero_grad()
    loss = model.loss_fn()(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _flat(grads, names):
    return torch.cat([grads[n].reshape(-1).to(torch.float64) for n in names])


def _assert_grads(got, want):
    names = sorted(want)
    g, w = _flat(got, names), _flat(want, names)
    assert float(torch.linalg.vector_norm(g - w)) <= 1e-5 * float(torch.linalg.vector_norm(w))


# (B, S, C, masked): a padded last chunk, chunks that tile T, C > T, odd sizes
CASES = [(2, 24, 20, True), (2, 24, 16, False), (1, 24, 64, True), (3, 10, 7, True)]


@pytest.mark.parametrize("B,S,C,masked", CASES)
def test_chunked_loss_and_grads_match_jax(B, S, C, masked):
    jmodel, params, model = _pair(C)
    batch = _batch(B, S, masked)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn()(p, jbatch)))(params)
    loss, grads = _torch_loss_and_grads(model, batch)
    assert abs(loss - float(jloss)) <= 1e-6 * abs(float(jloss)), (loss, float(jloss))
    _assert_grads(grads, params_from_jax(jax.device_get(jgrads)))


def test_chunked_equals_monolithic():
    _, _, model = _pair(20)
    batch = _batch(2, 24, True)
    chunked = _torch_loss_and_grads(model, batch)
    model.replace_config(ce_chunk_tokens=0)
    whole = _torch_loss_and_grads(model, batch)
    assert abs(chunked[0] - whole[0]) <= 1e-6 * abs(whole[0])
    _assert_grads(chunked[1], whole[1])


def test_chunked_loss_keeps_no_logits_for_backward():
    """Only each chunk's inputs ([C, H] hidden rows, the head weight, its
    labels and mask) are saved for the backward: no tensor of logits
    (last dimension V), neither a chunk's [C, V] nor the [T, V] ones.  The
    vocabulary (384) is set apart from every other width of the model."""
    model = GPTNeoX(GPTNeoXConfig.tiny(vocab_size=384, ce_chunk_tokens=16), device="cpu")
    batch = model.example_batch(2, 24)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model.loss_fn()(model, batch)
    assert saved and not [s for s in saved if s and s[-1] == 384], saved
    loss.backward()                       # the recompute runs in the backward
    assert all(p.grad is not None for p in model.parameters())
    model.replace_config(ce_chunk_tokens=0)       # the monolithic loss keeps them
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss_fn()(model, batch)
    assert [s for s in saved if s and s[-1] == 384]


def test_chunked_loss_with_moe_is_refused():
    model = GPTNeoX(GPTNeoXConfig.tiny(ce_chunk_tokens=16), device="cpu")
    model.replace_config(moe_num_experts=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        model.loss_fn()
