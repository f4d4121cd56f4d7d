"""K1 (LayerNorm / RMSNorm forward) of the PyTorch port against the JAX
package's Pallas kernel, run in interpret mode on the CPU.  The port's CPU
path is the kernel's plain version; the CUDA kernel itself is held against
that plain version by chip_smoke.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.transformer.normalize import layer_norm as jax_layer_norm
from deeperspeed_tpu.ops.transformer.normalize import rms_norm as jax_rms_norm
from deeperspeed_tpu_torch.ops.transformer import layer_norm, rms_norm

# fp32: the same arithmetic up to summation order; bf16: one rounding of
# the output (2^-8 relative) on top
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [128, 768])
def test_norm_matches_jax_kernel(H, dtype, rms):
    rng = np.random.default_rng(H)
    # 300 rows: not a multiple of the TPU kernel's 256-row block
    x = (rng.standard_normal((3, 100, H)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if rms:
        want = jax_rms_norm(jx, jnp.asarray(g), use_pallas=True)
        got = rms_norm(tx, torch.from_numpy(g))
    else:
        want = jax_layer_norm(jx, jnp.asarray(g), jnp.asarray(b), use_pallas=True)
        got = layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _jax_grads(x, g, b, w, rms, dtype):
    """dx, dgamma, dbeta through the JAX custom VJP with the Pallas kernels
    in interpret mode (``_ln_bwd_pallas``)."""
    import jax

    def loss(x, g, b):
        y = (jax_rms_norm(x, g, use_pallas=True) if rms
             else jax_layer_norm(x, g, b, use_pallas=True))
        return jnp.sum(y.astype(jnp.float32) * w)

    args = (jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype),
            jnp.asarray(b).astype(dtype))
    return jax.grad(loss, argnums=(0, 1) if rms else (0, 1, 2))(*args)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("H", [128, 768])
def test_norm_backward_matches_jax_kernel(H, rms):
    """fp32: dx, dgamma and dbeta within 1e-4, the tolerance of
    tests/unit/ops/test_transformer_kernels.py (summation order only)."""
    rng = np.random.default_rng(H + 1)
    x = (rng.standard_normal((3, 100, H)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    w = rng.standard_normal((3, 100, H)).astype(np.float32)
    want = _jax_grads(x, g, b, w, rms, jnp.float32)
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y = rms_norm(tx, tg) if rms else layer_norm(tx, tg, tb)
    (y * torch.from_numpy(w)).sum().backward()
    got = (tx.grad, tg.grad) if rms else (tx.grad, tg.grad, tb.grad)
    for a, ref, name in zip(got, want, ("dx", "dg", "db")):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if rms:
        assert tb.grad is None


def test_norm_backward_with_bf16_gamma():
    """Mixed-precision training casts gamma/beta to bf16: the grads come
    back in bf16, as the JAX VJP returns them in gamma's type.  bf16 x and
    dx: one bf16 rounding (2^-8 relative) on each side; dgamma/dbeta are
    sums over 300 rows rounded once to bf16."""
    H = 768
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((300, H)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    w = rng.standard_normal((300, H)).astype(np.float32)
    want = _jax_grads(x, g, b, w, False, jnp.bfloat16)
    tx, tg, tb = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (x, g, b))
    (layer_norm(tx, tg, tb).float() * torch.from_numpy(w)).sum().backward()
    for a, ref, name in zip((tx.grad, tg.grad, tb.grad), want, ("dx", "dg", "db")):
        assert a.dtype == torch.bfloat16, name
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max(), err_msg=name)
