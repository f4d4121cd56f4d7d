"""B5, the fused dequant-reduce: the port's plain version
(``ops/quantizer/fused.py`` ``_dequant_reduce_plain``, what the wrapper runs
for CPU tensors) against the JAX package's ``_xla_dequant_reduce`` and its
Pallas kernel in interpret mode, bit for bit: int8, fp8 e4m3 and fp8 e5m2
values, 1, 2 and 4 peers, a row tiled by the group and a row that is not
(one group a row), -0.0 values and all-zero groups.  The CUDA kernel is
held against the same plain version on the card
(``test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.quantizer import fused as jfused
from deeperspeed_tpu.quantization import BlockScaledTensor as JaxBlockScaled
from deeperspeed_tpu_torch.ops.quantizer import fused
from deeperspeed_tpu_torch.quantization import BlockScaledTensor
import torch_threads  # noqa: F401  (torch at one intra-op thread)

WIRES = ["int8", "fp8_e4m3", "fp8_e5m2"]


def _partials(n, rows, d, seed):
    """n peers' fp32 partials with a -0.0 run and an all-zero group."""
    x = np.random.default_rng(seed).standard_normal((n, rows, d)).astype(np.float32)
    x *= np.float32(2.0) ** np.arange(rows, dtype=np.float32)[None, :, None] / 8
    x[:, 0, :min(d, 128)] = 0.0                    # an all-zero group (or row)
    x[0, 1, :5] = -0.0                             # -0.0 values
    x[-1, 1, 5:9] = -0.0
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("d", [256, 96], ids=["tiled", "one-group-a-row"])
def test_plain_version_equals_the_jax_package(wire, n, d):
    x = _partials(n, 12, d, seed=n * 7 + d)
    ours = BlockScaledTensor.quantize(torch.from_numpy(x), wire, 128)
    theirs = JaxBlockScaled.quantize(jnp.asarray(x), wire, 128)
    assert np.array_equal(ours.scales.numpy(), np.asarray(theirs.scales))
    got = fused.fused_dequant_reduce(ours).numpy()
    assert got.shape == (12, d) and got.dtype == np.float32
    for impl in ("xla", "pallas"):
        want = jfused.fused_dequant_reduce(theirs, impl=impl)
        assert np.array_equal(_bits(got), _bits(want)), impl
    # raw values and scales in the quantize layout, [n, rows, groups, 1]
    raw = fused.fused_dequant_reduce(ours.values, ours.scales, group_size=128)
    assert np.array_equal(_bits(raw.numpy()), _bits(got))


def test_sum_runs_in_peer_order_from_the_first_product():
    """Peer order matters in fp32, and a sum of -0.0 products stays -0.0
    (it starts from the first peer's product, not from +0)."""
    big, small = np.float32(2.0 ** 24), np.float32(1.0)
    q = torch.tensor([[[1]], [[1]], [[-1]]], dtype=torch.int8)
    s = torch.tensor([[[small]], [[big]], [[big]]])
    got = fused.fused_dequant_reduce(q, s, group_size=1)
    assert float(got) == 0.0                      # (1 + 2^24) - 2^24 in order
    neg = torch.tensor([[[-0.0]], [[-0.0]]]).to(torch.float8_e5m2)
    got = fused.fused_dequant_reduce(neg, torch.ones(2, 1, 1), group_size=1)
    assert np.signbit(got.numpy()).all()


def test_shapes_and_arguments_are_checked():
    q = torch.zeros(2, 4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="scale size"):
        fused.fused_dequant_reduce(q, torch.ones(2, 4, 3), group_size=4)
    with pytest.raises(ValueError, match="expected q"):
        fused.fused_dequant_reduce(q[0, 0], torch.ones(1), group_size=8)
    with pytest.raises(ValueError, match="unknown impl"):
        fused.fused_dequant_reduce(q, torch.ones(2, 4, 2), group_size=4, impl="triton")
    out = fused.fused_dequant_reduce(q.view(2, 2, 2, 8), torch.ones(2, 2, 2, 2), 4)
    assert out.shape == (2, 2, 8)
