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
