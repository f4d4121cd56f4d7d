"""K2/K3 (paged decode and speculative-decode attention) of the PyTorch port
and their quantized forms K2q/K3q (int8 and fp8 pools with per-(slot, head)
scales) against the JAX package's Pallas kernels in interpret mode on the
CPU."""

import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.attention.paged import \
    paged_decode_attention as jax_decode
from deeperspeed_tpu.ops.attention.paged import \
    paged_spec_decode_attention as jax_spec_decode
from deeperspeed_tpu_torch.ops.attention import (paged_decode_attention,
                                                 paged_spec_decode_attention)
from deeperspeed_tpu_torch.ops.attention.paged import (_decode_reference,
                                                       _spec_decode_reference)
from deeperspeed_tpu_torch.ops.quantizer import dequantize_kv, quantize_kv
import torch_threads  # noqa: F401  (torch at one intra-op thread)

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
    """Quantized pools were once refused outright; what is still refused is
    one scale pool without the other."""
    q, pk, pv, bt, sl = (_t(a) for a in _setup())
    scales = torch.ones(pk.shape[:3])
    for kw in ({"k_scale": scales}, {"v_scale": scales}):
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            paged_decode_attention(q, pk, pv, bt, sl, **kw)
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            paged_spec_decode_attention(q[:, None], pk, pv, bt,
                                        (sl - 1)[:, None], **kw)


# ------------------------------------------------- K2q / K3q: quantized pools
def _quantized(pool, kv_dtype):
    """(torch payload, torch scales, jax payload, jax scales) of one pool,
    quantized once: both sides read the same bytes."""
    import jax.numpy as jnp

    q, scale = quantize_kv(torch.from_numpy(pool), kv_dtype)
    raw = q.view(torch.uint8).numpy()
    jq = (jnp.asarray(raw.view(np.int8)) if kv_dtype == "int8"
          else jnp.asarray(raw).view(jnp.float8_e4m3fn))
    return q, scale, jq, jnp.asarray(scale.numpy())


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_quantized_matches_jax_kernel(kv_dtype, S):
    """Ragged lengths, fp32 queries: the plain K2q (S 1, through the decode
    entry point) and K3q against the JAX kernels' fused dequant."""
    q, pk, pv, bt, pos = _spec_setup(B=4, S=S, seed=40 + S)
    tk, tks, jk, jks = _quantized(pk, kv_dtype)
    tv, tvs, jv, jvs = _quantized(pv, kv_dtype)
    if S == 1:
        lens = pos[:, 0] + 1
        want = jax_decode(_j(q[:, 0]), jk, jv, _j(bt), _j(lens),
                          force_kernel=True, k_scale=jks, v_scale=jvs)
        got = paged_decode_attention(_t(q[:, 0]), tk, tv, _t(bt), _t(lens),
                                     k_scale=tks, v_scale=tvs)
        dense = _decode_reference(_t(q[:, 0]), dequantize_kv(tk, tks),
                                  dequantize_kv(tv, tvs), _t(bt), _t(lens),
                                  q.shape[-1] ** -0.5)
    else:
        want = jax_spec_decode(_j(q), jk, jv, _j(bt), _j(pos),
                               force_kernel=True, k_scale=jks, v_scale=jvs)
        got = paged_spec_decode_attention(_t(q), tk, tv, _t(bt), _t(pos),
                                          k_scale=tks, v_scale=tvs)
        dense = _spec_decode_reference(_t(q), dequantize_kv(tk, tks),
                                       dequantize_kv(tv, tvs), _t(bt), _t(pos),
                                       q.shape[-1] ** -0.5)
    assert got.dtype == torch.float32
    _close(got, want, "float32")
    # dequantize-then-attend is the same function
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_bf16_queries(kv_dtype):
    q, pk, pv, bt, sl = _setup(D=64, seed=50)
    tk, tks, jk, jks = _quantized(pk, kv_dtype)
    tv, tvs, jv, jvs = _quantized(pv, kv_dtype)
    want = jax_decode(_j(q, "bfloat16"), jk, jv, _j(bt), _j(sl),
                      force_kernel=True, k_scale=jks, v_scale=jvs)
    got = paged_decode_attention(_t(q, "bfloat16"), tk, tv, _t(bt), _t(sl),
                                 k_scale=tks, v_scale=tvs)
    assert got.dtype == torch.bfloat16
    _close(got, want.astype("float32"), "bfloat16")


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_zero_length_row(kv_dtype):
    """A padding row (seq_len 0) gives finite values and leaves the live
    rows as the JAX kernel has them."""
    q, pk, pv, bt, sl = _setup(B=4, seed=51)
    sl[2] = 0
    tk, tks, jk, jks = _quantized(pk, kv_dtype)
    tv, tvs, jv, jvs = _quantized(pv, kv_dtype)
    want = np.asarray(jax_decode(_j(q), jk, jv, _j(bt), _j(sl),
                                 force_kernel=True, k_scale=jks, v_scale=jvs))
    got = paged_decode_attention(_t(q), tk, tv, _t(bt), _t(sl),
                                 k_scale=tks, v_scale=tvs)
    assert torch.isfinite(got).all()
    live = sl > 0
    _close(got[torch.from_numpy(live)], want[live], "float32")


def test_quantized_s1_spec_equals_decode():
    q, pk, pv, bt, sl = _setup(seed=52)
    tk, tks, _, _ = _quantized(pk, "fp8")
    tv, tvs, _, _ = _quantized(pv, "fp8")
    spec = paged_spec_decode_attention(_t(q[:, None]), tk, tv, _t(bt),
                                       _t((sl - 1)[:, None]),
                                       k_scale=tks, v_scale=tvs)
    ref = paged_decode_attention(_t(q), tk, tv, _t(bt), _t(sl),
                                 k_scale=tks, v_scale=tvs)
    torch.testing.assert_close(spec[:, 0], ref, rtol=1e-6, atol=1e-6)
