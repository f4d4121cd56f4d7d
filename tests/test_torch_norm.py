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
import torch_threads  # noqa: F401  (torch at one intra-op thread)

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


def _dispatch_inputs(seed, H=256):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 25, H)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    dy = rng.standard_normal((4, 25, H)).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad_x", "grad_gamma"])
def test_norm_dispatch_matches_plain_and_jax(mode):
    """The slimmed call path on the CPU: without a gradient to take (no_grad,
    inference_mode) it skips the autograd.Function; with grad on x or on
    gamma it goes through it.  The output equals ``_ln_ref`` and the JAX
    package's ``layer_norm`` (fp32, 1e-5: summation order only), and the
    gradients that flow equal ``_ln_bwd_ref``'s (the same function on the
    same inputs: 1e-6)."""
    from deeperspeed_tpu_torch.ops.transformer import normalize

    x, g, b, dy = _dispatch_inputs(11)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, g, b))
    if mode == "grad_x":
        tx.requires_grad_()
    elif mode == "grad_gamma":
        tg.requires_grad_()
    if mode == "no_grad":
        with torch.no_grad():
            y = layer_norm(tx, tg, tb)
    elif mode == "inference_mode":
        with torch.inference_mode():
            y = layer_norm(tx, tg, tb)
    else:
        y = layer_norm(tx, tg, tb)
    assert y.requires_grad == mode.startswith("grad")
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), use_pallas=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(y.detach(), normalize._ln_ref(tx.detach(), tg.detach(), tb, 1e-5, False))
    if mode.startswith("grad"):
        y.backward(torch.from_numpy(dy))
        rdx, rdg, _ = normalize._ln_bwd_ref(torch.from_numpy(x).reshape(-1, x.shape[-1]),
                                            torch.from_numpy(g),
                                            torch.from_numpy(dy).reshape(-1, x.shape[-1]),
                                            1e-5, False)
        got, ref = (tx.grad, rdx.reshape(x.shape)) if mode == "grad_x" else (tg.grad, rdg)
        assert (tg.grad is None) == (mode == "grad_x") and (tx.grad is None) == (mode == "grad_gamma")
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
def test_bf16_gamma_reaches_the_forward_without_a_cast(monkeypatch, rms):
    """gamma and beta in bf16 (mixed-precision training) go to the forward
    as they are: the kernel takes them in their own type, so no cast runs
    before it.  The result equals the plain version on fp32 copies (the
    upcast is exact)."""
    from deeperspeed_tpu_torch.ops.transformer import normalize

    x, g, b, _ = _dispatch_inputs(12)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tg = torch.from_numpy(g).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_()
    seen = []
    real = normalize._ln_ref
    monkeypatch.setattr(normalize, "_ln_ref", lambda x, g, b, *a: (
        seen.append((g.dtype, None if b is None else b.dtype, g.data_ptr())), real(x, g, b, *a))[1])
    y = rms_norm(tx, tg) if rms else layer_norm(tx, tg, tb)
    assert seen == [(torch.bfloat16, None if rms else torch.bfloat16, tg.data_ptr())]
    want = real(tx, tg.detach().float(), None if rms else tb.detach().float(), 1e-5, rms)
    assert y.dtype == torch.bfloat16 and torch.equal(y.detach(), want)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
def test_bf16_gamma_reaches_the_backward_without_a_cast(monkeypatch, rms):
    """gamma in bf16 goes to the backward as it is: K8 takes it in its own
    type, so no cast runs before it.  The grads equal the plain version's
    on an fp32 copy of gamma (the upcast is exact), cast to gamma's type."""
    from deeperspeed_tpu_torch.ops.transformer import normalize

    x, g, b, dy = _dispatch_inputs(14)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tg = torch.from_numpy(g).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_()
    tdy = torch.from_numpy(dy).to(torch.bfloat16)
    seen = []
    real = normalize._ln_bwd_ref
    monkeypatch.setattr(normalize, "_ln_bwd_ref", lambda x, g, *a: (
        seen.append((g.dtype, g.data_ptr())), real(x, g, *a))[1])
    y = rms_norm(tx, tg) if rms else layer_norm(tx, tg, tb)
    y.backward(tdy)
    assert seen == [(torch.bfloat16, tg.data_ptr())]
    h = x.shape[-1]
    dx, dg, db = real(tx.detach().reshape(-1, h), tg.detach().float(), tdy.reshape(-1, h),
                      1e-5, rms)
    assert tg.grad.dtype == torch.bfloat16
    assert torch.equal(tx.grad, dx.reshape(x.shape))
    assert torch.equal(tg.grad, dg.to(torch.bfloat16))
    if rms:
        assert tb.grad is None
    else:
        assert torch.equal(tb.grad, db.to(torch.bfloat16))


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "forward_backward"])
def test_cpu_tensor_never_reaches_the_kernel_library(monkeypatch, grad):
    """On the CPU (whose accelerator runs no CUDA kernels) the tensor's own
    device sends LayerNorm to its plain versions: ``library()`` is never
    called, forward or backward."""
    from deeperspeed_tpu_torch.accelerator import get_accelerator
    from deeperspeed_tpu_torch.ops.transformer import normalize

    assert not get_accelerator("cpu").use_cuda_kernels()

    def no_library(name):
        raise AssertionError(f"library({name!r}) reached from a CPU tensor")

    monkeypatch.setattr(normalize, "library", no_library)
    x, g, b, dy = _dispatch_inputs(13, H=96)
    tx = torch.from_numpy(x).requires_grad_(grad)
    y = layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    if grad:
        y.backward(torch.from_numpy(dy))
        assert tx.grad is not None and torch.isfinite(tx.grad).all()
    assert torch.isfinite(y).all()
