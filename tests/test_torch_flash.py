"""K5-K7 (flash attention) of the PyTorch port against the JAX package's
Pallas kernels, run in interpret mode on the CPU: the forward, and the
grads of q, k and v through the port's ``autograd.Function`` and the JAX
``custom_vjp``.  The JAX default block reaches the fused one-pass backward
(``_dkv_fused_kernel``); ``block=128`` at S 1024 reaches the two-pass
``_dq_kernel`` + ``_dkv_kernel``.  The port's CPU path is the kernels'
plain versions; the CUDA kernels are held against those on the card by
chip_smoke.py and tests/test_torch_cuda_kernels.py.

Tolerances are those of tests/unit/ops/test_flash_attention.py: fp32
forward 2e-5 and grads 2e-4 (summation order only), bf16 forward 2e-2
(about two bf16 roundings of the output, 2^-8 relative each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.attention.pallas_flash import mha as jax_mha
from deeperspeed_tpu_torch.ops.attention import flash
import torch_threads  # noqa: F401  (torch at one intra-op thread)

FWD_TOL, GRAD_TOL, BF16_TOL = 2e-5, 2e-4, 2e-2


def _inputs(S, B=2, N=2, D=16, seed=0):
    rng = np.random.default_rng(seed + S)
    return [rng.standard_normal((B, S, N, D)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [40, 256, 1000])
def test_forward_matches_jax_kernel(S, causal):
    q, k, v, _ = _inputs(S)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = flash.mha(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S,block", [(40, None), (256, None), (1000, None), (1024, 128)],
                         ids=["S40-fused", "S256-fused", "S1000-fused", "S1024-two-pass"])
def test_grads_match_jax_kernel(S, block, causal):
    import jax

    q, k, v, w = _inputs(S, B=1)

    def jax_loss(q, k, v):
        return jnp.sum(jax_mha(q, k, v, causal=causal, block=block) * jnp.asarray(w))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash.mha(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_bf16_forward_matches_jax_kernel():
    q, k, v, _ = _inputs(256)
    want = jax_mha(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True)
    got = flash.mha(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_backward_rounds_where_the_jax_kernel_does():
    """The saved q is the pre-scaled one and dq is post-scaled in q's type:
    at D 96 the scale 96^-0.5 is not exact in bf16, so the rounding points
    show in the last bits.  Compared with the same function written out."""
    rng = np.random.default_rng(5)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((1, 64, 2, 96)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    scale = torch.tensor(96 ** -0.5, dtype=torch.bfloat16)
    qp = q * scale
    o, lse = flash._fwd_reference(qp, k, v, True)
    tq = q.clone().requires_grad_()
    got = flash.mha(tq, k, v)
    assert torch.equal(got, o)
    got.backward(w)
    delta = (w.float() * o.float()).sum(-1).transpose(1, 2).reshape(2, 64)
    dq, _, _ = flash._bwd_reference(qp, k, v, w, lse, delta, True)
    assert torch.equal(tq.grad, dq * scale)


def test_supported_follows_the_jax_rule():
    assert flash.flash_attention_supported((2, 100, 4, 64), torch.bfloat16)
    assert flash.flash_attention_supported((2, 100, 4, 256), torch.float32)
    assert not flash.flash_attention_supported((2, 100, 4, 60), torch.float32)
    assert not flash.flash_attention_supported((2, 100, 4, 64), torch.float16)
