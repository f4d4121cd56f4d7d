"""``BlockScaledTensor`` and the KV quantizer of the PyTorch port against the
JAX package on the CPU: the same numpy inputs give the same payload bytes
and the same fp32 scales, bit for bit, for int8, fp8 e4m3 and fp8 e5m2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.quantizer import dequantize_kv as jax_dequantize_kv
from deeperspeed_tpu.ops.quantizer import quantize_kv as jax_quantize_kv
from deeperspeed_tpu.quantization import BlockScaledTensor as JaxBST
from deeperspeed_tpu_torch.ops.quantizer import dequantize_kv, quantize_kv
from deeperspeed_tpu_torch.quantization import (BlockScaledTensor,
                                                block_shape_error,
                                                canonical_dtype, group_shape,
                                                qmax, wire_dtype)
import torch_threads  # noqa: F401  (torch at one intra-op thread)

DTYPES = ["int8", "fp8_e4m3", "fp8_e5m2"]


def _inputs(seed, shape=(6, 5, 256), kind="normal"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "wide":
        # magnitudes over many octaves, some far past every qmax
        x *= np.exp(rng.uniform(-12, 12, shape[:-1] + (1,))).astype(np.float32)
        x.reshape(-1, shape[-1])[0, :7] = [1e6, -1e6, 6e4, -448.0, 448.5, 127.5, -128.0]
    if kind == "zeros":
        x[1] = 0.0          # all-zero rows and groups (3-d inputs)
        x[2, 3] = 0.0
    return x


def _bytes(a):
    """Raw payload bytes of a jax / torch / numpy array of a 1-byte type."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _same(tq, jq, what):
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq), err_msg=what)


@pytest.mark.parametrize("kind", ["normal", "wide", "zeros"])
@pytest.mark.parametrize("group_size", [128, 64, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_bit_equal(dtype, group_size, kind):
    x = _inputs(3, kind=kind)
    want = JaxBST.quantize(jnp.asarray(x), dtype, group_size)
    got = BlockScaledTensor.quantize(torch.from_numpy(x), dtype, group_size)
    assert got.values.dtype == wire_dtype(dtype) and got.dtype == dtype
    assert got.scales.dtype == torch.float32
    assert block_shape_error(got.values.shape, got.scales.shape,
                             group_size) is None
    _same(got.values, want.values, "payload")
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.wire_nbytes == want.wire_nbytes
    for out in (torch.float32, torch.bfloat16):
        name = str(out).split(".")[-1]
        np.testing.assert_array_equal(
            got.dequantize(out).float().numpy(),
            np.asarray(want.dequantize(name).astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["normal", "wide", "zeros"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_bit_equal(dtype, in_dtype, kind):
    """The paged-KV row layout: ``quantize_kv`` / ``dequantize_kv``."""
    x = _inputs(4, shape=(7, 4, 64), kind=kind)
    jx = jnp.asarray(x).astype(in_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, in_dtype))
    jq, js = jax_quantize_kv(jx, dtype)
    tq, ts = quantize_kv(tx, dtype)
    assert tq.dtype == wire_dtype(dtype) and ts.dtype == torch.float32
    assert ts.shape == x.shape[:-1]
    _same(tq, jq, "payload")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_kv(tq, ts).numpy(), np.asarray(jax_dequantize_kv(jq, js)))
    np.testing.assert_array_equal(
        BlockScaledTensor.row_scale(tx, dtype).numpy(),
        np.asarray(JaxBST.row_scale(jx, dtype)))
    view, jview = BlockScaledTensor.from_rows(tq, ts), JaxBST.from_rows(jq, js)
    assert view.group_size == jview.group_size == 64
    assert block_shape_error(view.values.shape, view.scales.shape, 64) is None
    np.testing.assert_array_equal(view.dequantize(torch.float32).numpy(),
                                  np.asarray(jview.dequantize(jnp.float32)))


@pytest.mark.parametrize("dst", DTYPES)
@pytest.mark.parametrize("src", DTYPES)
def test_cast_bit_equal(src, dst):
    x = _inputs(5, shape=(4, 256), kind="wide")
    want = JaxBST.quantize(jnp.asarray(x), src, 64).cast(dst)
    t = BlockScaledTensor.quantize(torch.from_numpy(x), src, 64)
    got = t.cast(dst)
    assert (got is t) == (src == dst)
    assert got.dtype == dst
    _same(got.values, want.values, "payload")
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


@pytest.mark.parametrize("dtype", DTYPES)
def test_values_past_qmax_saturate(dtype):
    """A value past the grid must come out at +-qmax, never NaN or inf:
    the clamp runs before the narrowing cast."""
    y = torch.tensor([[1e9, -1e9, 3.0, 0.0]])
    q, scale = quantize_kv(y, dtype)
    back = dequantize_kv(q, scale)
    assert torch.isfinite(back).all()
    assert abs(float(q.float()[0, 0])) == qmax(dtype)
    from deeperspeed_tpu_torch.quantization.block_scaled import _narrow
    far = _narrow(torch.tensor([1e9, -1e9, float(qmax(dtype)) * 1.01]),
                  canonical_dtype(dtype)).float()
    assert far.tolist() == [qmax(dtype), -qmax(dtype), qmax(dtype)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_wire_round_trip(dtype):
    x = _inputs(6, shape=(3, 128))
    t = BlockScaledTensor.quantize(torch.from_numpy(x), dtype, 32)
    values, scales = t.wire_payloads()
    assert isinstance(values, np.ndarray) and values.dtype.itemsize == 1
    assert scales.dtype == np.float32
    assert values.nbytes + scales.nbytes == t.wire_nbytes
    # the JAX package's wire bytes are the same bytes
    jvalues, jscales = JaxBST.quantize(jnp.asarray(x), dtype, 32).wire_payloads()
    np.testing.assert_array_equal(values.view(np.uint8), jvalues.view(np.uint8))
    np.testing.assert_array_equal(scales, jscales)
    back = BlockScaledTensor.from_wire([values, scales], 32, dtype=dtype)
    assert back.dtype == dtype and back.group_size == 32
    assert torch.equal(back.values.view(torch.uint8),
                       t.values.view(torch.uint8))
    assert torch.equal(back.scales, t.scales)
    assert torch.equal(back.dequantize(torch.float32),
                       t.dequantize(torch.float32))


def test_from_wire_needs_the_dtype_of_raw_bytes():
    t = BlockScaledTensor.quantize(torch.ones(2, 8), "fp8", 8)
    with pytest.raises(ValueError, match="wire dtype"):
        BlockScaledTensor.from_wire(t.wire_payloads(), 8)


@pytest.mark.parametrize("alias,name", [
    ("int8", "int8"), ("uint8", "int8"), ("fp8", "fp8_e4m3"),
    ("FP8_E4M3", "fp8_e4m3"), ("e4m3", "fp8_e4m3"), ("e5m2", "fp8_e5m2"),
    (torch.int8, "int8"), (torch.float8_e4m3fn, "fp8_e4m3"),
    (torch.float8_e5m2, "fp8_e5m2"), (np.int8, "int8")])
def test_canonical_dtype(alias, name):
    assert canonical_dtype(alias) == name
    assert wire_dtype(alias) == wire_dtype(name)


@pytest.mark.parametrize("bad", ["fp4", "float16", torch.float16, np.float32])
def test_canonical_dtype_rejects(bad):
    with pytest.raises(ValueError, match="unsupported block-scaled"):
        canonical_dtype(bad)


def test_shape_helpers_match_jax():
    from deeperspeed_tpu.quantization import block_shape_error as jbse
    from deeperspeed_tpu.quantization import group_shape as jgs
    from deeperspeed_tpu.quantization import qmax as jqmax
    for d, g in [(256, 128), (256, 100), (64, 0), (64, 64), (7, 3)]:
        assert group_shape(d, g) == jgs(d, g)
    for name in DTYPES:
        assert qmax(name) == jqmax(name)
    for vs, ss, g in [((4, 256), (4, 2, 1), 128), ((4, 256), (4, 2), 128),
                      ((), (), 8), ((3, 5, 64), (3, 5, 1, 1), 64)]:
        assert block_shape_error(vs, ss, g) == jbse(vs, ss, g)
    assert "BlockScaledTensor(int8[2, 8], group_size=8)" == repr(
        BlockScaledTensor.quantize(torch.ones(2, 8), "int8", 8))
