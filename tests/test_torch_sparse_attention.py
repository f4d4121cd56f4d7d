"""Block-sparse attention of the PyTorch port against the JAX package on the
CPU: every sparsity config's layout bit for bit (the seeded random blocks
included), and ``sparse_attention`` forward and gradients for every config,
causal and not, with shared and per-head layouts, and under Fixed at the
blocks (64, 256) and head dim (64) of the card's Hopper kernels.  The JAX
side runs its Pallas kernels in interpret mode (as
``tests/unit/ops/test_sparse_attention.py`` does); the port runs B10's
plain version.  Inputs are made with numpy.

Tolerances are the JAX tests': 2e-5 on the output, 2e-4 on the gradients
(fp32; the two sum in other orders).  The one case where the two differ on
purpose, a query row with no live key, is shown side by side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import sparse_attention as jsa
from deeperspeed_tpu_torch.ops import sparse_attention as tsa
import torch_threads  # noqa: F401  (torch at one intra-op thread)

B, S, N, D = 2, 512, 2, 16
BLOCK = 128
NAMES = ["DenseSparsityConfig", "FixedSparsityConfig", "VariableSparsityConfig",
         "BigBirdSparsityConfig", "BSLongformerSparsityConfig"]
# pattern options per config (the attention direction is set per case)
OPTIONS = {
    "DenseSparsityConfig": {},
    "FixedSparsityConfig": {"num_local_blocks": 2, "num_global_blocks": 1},
    "VariableSparsityConfig": {"local_window_blocks": [1, 2], "global_block_indices": [0],
                               "num_random_blocks": 1, "seed": 3},
    "BigBirdSparsityConfig": {"num_random_blocks": 1, "num_sliding_window_blocks": 3,
                              "seed": 5},
    "BSLongformerSparsityConfig": {"num_sliding_window_blocks": 3},
}


def _pair(name, attention=None, **kw):
    """The JAX and the port config of one pattern."""
    kw = {**OPTIONS[name], **kw}
    if name != "DenseSparsityConfig" and attention is not None:
        kw["attention"] = attention
    return getattr(jsa, name)(**kw), getattr(tsa, name)(**kw)


def test_port_exports_the_same_names():
    assert tsa.__all__ == jsa.__all__


@pytest.mark.parametrize("attention", ["unidirectional", "bidirectional"])
@pytest.mark.parametrize("name", NAMES)
def test_layouts_equal_jax_bit_for_bit(name, attention):
    for heads, per_head, block, seq in ((1, False, 128, 1024), (4, True, 16, 512),
                                        (3, False, 64, 448)):
        extra = {"num_heads": heads, "block": block, "different_layout_per_head": per_head}
        if name == "FixedSparsityConfig" and per_head:
            extra["num_different_global_patterns"] = 2
        jcfg, tcfg = _pair(name, attention, **extra)
        want, got = jcfg.make_layout(seq), tcfg.make_layout(seq)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        tcfg.make_layout(seq + 1)


def _qkv(seed, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, N, d)).astype(np.float32) for _ in range(4)]


def _both(layout, causal, q, k, v, do, block=BLOCK):
    """(output, dq, dk, dv) from the JAX kernels and from the port."""
    jo, vjp = jax.vjp(lambda a, b, c: jsa.sparse_attention(a, b, c, layout, causal=causal,
                                                           block=block),
                      *(jnp.asarray(t) for t in (q, k, v)))
    want = [jo, *vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    to = tsa.sparse_attention(tq, tk, tv, layout, causal=causal, block=block)
    got = [to, *torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))]
    return [np.asarray(w) for w in want], [g.detach().numpy() for g in got]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_sparse_attention_matches_jax(name, causal):
    jcfg, _ = _pair(name, "unidirectional" if causal else "bidirectional",
                    num_heads=N, block=BLOCK)
    layout = jcfg.make_layout(S)
    want, got = _both(layout, causal, *_qkv(NAMES.index(name) + 10 * causal))
    for g, w, tol, what in zip(got, want, (2e-5, 2e-4, 2e-4, 2e-4), ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block", [64, 256])
def test_sparse_attention_matches_jax_at_hopper_blocks(block, causal):
    """Fixed at blocks 64 and 256 and D 64: the blocks and head dim whose
    bf16 passes run on the card's Hopper kernels, of which this plain
    version is the oracle."""
    jcfg, _ = _pair("FixedSparsityConfig", "unidirectional" if causal else "bidirectional",
                    num_heads=N, block=block)
    layout = jcfg.make_layout(S)
    want, got = _both(layout, causal, *_qkv(60 + block + causal, d=64), block=block)
    for g, w, tol, what in zip(got, want, (2e-5, 2e-4, 2e-4, 2e-4), ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_per_head_layouts_match_jax(causal):
    jcfg, _ = _pair("FixedSparsityConfig", "unidirectional" if causal else "bidirectional",
                    num_heads=N, block=BLOCK, num_local_blocks=2,
                    different_layout_per_head=True, num_different_global_patterns=2)
    layout = jcfg.make_layout(S)
    assert (layout[0] != layout[1]).any()
    want, got = _both(layout, causal, *_qkv(30 + causal))
    for g, w, tol in zip(got, want, (2e-5, 2e-4, 2e-4, 2e-4)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_row_with_no_live_key_jax_and_port_side_by_side():
    """S 256, block 128, layout [[0, 1], [1, 1]], causal: query block 0's one
    live tile lies above the diagonal, so its rows see no key.  The JAX
    kernel gives each such row the mean of v over that tile's keys (it
    takes exp(NEG_INF - NEG_INF) = 1); the port gives zeros, as the JAX
    docstring promises.  Rows 128-255 agree."""
    rng = np.random.default_rng(40)
    q, k, v = (rng.standard_normal((1, 256, 2, 16)).astype(np.float32) for _ in range(3))
    layout = np.array([[[0, 1], [1, 1]]], np.uint8)
    jo = np.asarray(jsa.sparse_attention(*(jnp.asarray(t) for t in (q, k, v)), layout,
                                         causal=True))
    to = tsa.sparse_attention(*(torch.from_numpy(t) for t in (q, k, v)), layout,
                              causal=True).numpy()
    mean_v = np.broadcast_to(v[:, 128:].mean(axis=1, keepdims=True), (1, 128, 2, 16))
    np.testing.assert_allclose(jo[:, :128], mean_v, rtol=1e-5, atol=1e-6)
    assert np.abs(jo[:, :128]).max() > 0.05
    assert not to[:, :128].any()
    np.testing.assert_allclose(to[:, 128:], jo[:, 128:], rtol=2e-5, atol=2e-5)


def test_sparse_self_attention_caches_its_layouts():
    jcfg, tcfg = _pair("BSLongformerSparsityConfig", "unidirectional", num_heads=N,
                       block=BLOCK)
    q, k, v, _ = _qkv(50)
    attn = tsa.SparseSelfAttention(tcfg, causal=True)
    out1, out2 = (attn(*(torch.from_numpy(t) for t in (q, k, v))) for _ in range(2))
    assert torch.equal(out1, out2)
    assert S in attn._layouts and list(attn._on_device) == [(S, torch.device("cpu"))]
    want = jsa.SparseSelfAttention(jcfg, causal=True)(*(jnp.asarray(t) for t in (q, k, v)))
    np.testing.assert_allclose(out1.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_layout_that_does_not_fit_raises():
    q = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError, match="does not fit"):
        tsa.sparse_attention(q, q, q, np.ones((3, 2, 2), np.uint8))
    with pytest.raises(ValueError, match="does not fit"):
        tsa.sparse_attention(q, q, q, np.ones((1, 2, 2), np.uint8), block=64)
