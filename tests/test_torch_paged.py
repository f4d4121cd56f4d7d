"""K2/K3 (paged decode and speculative-decode attention) of the PyTorch port
against the JAX package's Pallas kernels in interpret mode on the CPU."""

import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.attention.paged import \
    paged_decode_attention as jax_decode
from deeperspeed_tpu.ops.attention.paged import \
    paged_spec_decode_attention as jax_spec_decode
from deeperspeed_tpu_torch.ops.attention import (paged_decode_attention,
                                                 paged_spec_decode_attention)

# fp32: online softmax vs one softmax, summation order only; bf16: inputs
# and output rounded to bf16, accumulation in fp32 on both sides
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _setup(B=3, N=4, D=16, P=16, bs=8, max_blocks=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, D)).astype(np.float32)
    pool_k = rng.standard_normal((P, bs, N, D)).astype(np.float32)
    pool_v = rng.standard_normal((P, bs, N, D)).astype(np.float32)
    tables = np.stack([rng.choice(P, max_blocks, replace=False)
                       for _ in range(B)]).astype(np.int32)
    seq_lens = rng.integers(1, max_blocks * bs + 1, size=B).astype(np.int32)
    return q, pool_k, pool_v, tables, seq_lens


def _spec_setup(B=3, S=3, N=4, D=16, P=16, bs=8, max_blocks=4, seed=20):
    q, pool_k, pool_v, tables, _ = _setup(B, N, D, P, bs, max_blocks, seed)
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((B, S, N, D)).astype(np.float32)
    last = rng.integers(S, max_blocks * bs, size=B)
    positions = np.stack([np.arange(l - S + 1, l + 1) for l in last]
                         ).astype(np.int32)
    return q, pool_k, pool_v, tables, positions


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype) if a.dtype == np.float32 else torch.int32)


def _j(a, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(dtype) if a.dtype == np.float32 \
        else jnp.asarray(a)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64])
def test_decode_matches_jax_kernel(dtype, D):
    args = _setup(D=D, seed=D)
    want = jax_decode(*(_j(a, dtype) for a in args), force_kernel=True)
    got = paged_decode_attention(*(_t(a, dtype) for a in args))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want.astype("float32"), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 5, 8])
def test_spec_decode_matches_jax_kernel(dtype, S):
    args = _spec_setup(S=S, seed=S)
    want = jax_spec_decode(*(_j(a, dtype) for a in args), force_kernel=True)
    got = paged_spec_decode_attention(*(_t(a, dtype) for a in args))
    _close(got, want.astype("float32"), dtype)


def test_reallocated_blocks_are_invisible():
    """Stale data in pool blocks outside a sequence's table must not leak."""
    q, pk, pv, bt, sl = _setup(B=1, max_blocks=2, P=8)
    got1 = paged_decode_attention(_t(q), _t(pk), _t(pv), _t(bt), _t(sl))
    outside = np.ones(pk.shape[0], bool)
    outside[bt[0]] = False
    pk2, pv2 = pk.copy(), pv.copy()
    pk2[outside] = 1e3
    pv2[outside] = -1e3
    got2 = paged_decode_attention(_t(q), _t(pk2), _t(pv2), _t(bt), _t(sl))
    assert torch.equal(got1, got2)


def test_spec_decode_s1_equals_decode():
    q, pk, pv, bt, sl = _setup(seed=21)
    spec = paged_spec_decode_attention(_t(q[:, None]), _t(pk), _t(pv), _t(bt),
                                       _t((sl - 1)[:, None]))
    ref = paged_decode_attention(_t(q), _t(pk), _t(pv), _t(bt), _t(sl))
    torch.testing.assert_close(spec[:, 0], ref, rtol=1e-6, atol=1e-6)


def test_quantized_pools_not_ported():
    q, pk, pv, bt, sl = (_t(a) for a in _setup())
    scales = torch.ones(pk.shape[:3])
    with pytest.raises(NotImplementedError):
        paged_decode_attention(q, pk, pv, bt, sl, k_scale=scales,
                               v_scale=scales)
