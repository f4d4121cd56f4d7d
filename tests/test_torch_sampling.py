"""K4 (sorted top-k) and the token-selection functions of the PyTorch port
against the JAX package on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.sampling import sample_tokens as jax_sample_tokens
from deeperspeed_tpu.ops.sampling import sorted_topk as jax_sorted_topk
from deeperspeed_tpu.ops.sampling import verify_draft as jax_verify_draft
from deeperspeed_tpu_torch.accelerator.cuda_accelerator import CudaAccelerator
from deeperspeed_tpu_torch.ops.sampling import (sample_tokens, sorted_topk,
                                                verify_draft)
from deeperspeed_tpu_torch.ops.sampling import topk
import torch_threads  # noqa: F401  (torch at one intra-op thread)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("k", [1, 4, 16])
def test_topk_matches_jax_kernel(k):
    # values > -1e30: the range where the TPU kernel's sentinel is harmless
    x = np.random.default_rng(k).standard_normal((5, 512)).astype(np.float32)
    jv, ji = jax_sorted_topk(jnp.asarray(x), k, force_kernel=True)
    tv, ti = sorted_topk(torch.from_numpy(x), k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_ties_resolve_to_lowest_index():
    x = [[1.0, 5.0, 5.0, 0.0, 5.0]]
    _, ji = jax_sorted_topk(jnp.asarray(x, jnp.float32), 3, force_kernel=True)
    _, ti = sorted_topk(torch.tensor(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), [[1, 2, 4]])


def test_topk_never_retakes_a_slot_below_the_sentinel():
    """Rows of -inf (a masked row) follow lax.top_k: each slot once, ties
    to the lowest index.  The TPU kernel's -1e30 overwrite does not; the
    port marks taken slots with a flag."""
    x = np.full((2, 6), -np.inf, np.float32)
    x[0, 3] = 2.0
    x[1, 1] = -1e31
    rv, ri = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = sorted_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    assert all(len(set(row)) == 4 for row in ti.tolist())


def test_topk_nan_row_matches_jax_kernel():
    """A row that holds a NaN gives NaN and index V in every output: the JAX
    kernel's max propagates the NaN and no slot equals it.  K4 on the card
    follows the same rule (tests/test_torch_cuda_kernels.py)."""
    x = np.array([[1, np.nan, 3, -0.0, 0, 2], [1, 4, 3, -0.0, 0, 2]], np.float32)
    jv, ji = jax_sorted_topk(jnp.asarray(x), 3, force_kernel=True)
    tv, ti = sorted_topk(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [6, 6, 6] and bool(tv[0].isnan().all())
    assert ti[1].tolist() == [1, 2, 5]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_topk_signed_zeros_tie_by_index_as_jax_kernel(k):
    """-0.0 == 0.0: a tie between them goes to the lower index."""
    x = np.array([[-0.0, 0.0, -0.0, 1.0, -1.0, 0.0, -2.0, -0.0]], np.float32)
    _, ji = jax_sorted_topk(jnp.asarray(x), k, force_kernel=True)
    tv, ti = sorted_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [3, 0, 1, 2, 5, 7, 4, 6][:k]


@pytest.mark.parametrize("k", [4, topk.K_MAX, topk.K_MAX + 1])
def test_topk_on_cuda_launches_or_raises(monkeypatch, k):
    """Where the accelerator runs the kernels, sorted_topk goes to K4's CUDA
    branch at every k (the radix select up to K_MAX, the round kernel
    above), which launches or raises (here: the tensor is not on a card);
    it never falls back to the plain version."""
    calls = []
    monkeypatch.setattr(topk, "get_accelerator", lambda device=None: CudaAccelerator())
    monkeypatch.setattr(topk, "_topk_reference", lambda *a: calls.append(a))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        sorted_topk(torch.zeros(2, topk.K_MAX + 1), k)
    assert not calls


@pytest.mark.parametrize("case", ["bf16", "fp16", "transposed"])
def test_topk_cuda_takes_what_the_reference_takes(monkeypatch, case):
    """K4's card path takes any float type and a strided view, as the
    reference casts the row to fp32: it widens x to contiguous fp32 before
    it validates it, so a CPU tensor gets the device error, and what the
    validation sees is the exact fp32 widening."""
    x = torch.randn(4, 64)
    x = {"bf16": x.bfloat16(), "fp16": x.half(), "transposed": x.t().contiguous().t()}[case]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        topk._topk_cuda(x, 3)
    seen = []

    def validate(kernel, *ts, dtype=None):
        seen.append((ts, dtype))
        raise ValueError("validated")

    monkeypatch.setattr(topk, "require_cuda", validate)
    with pytest.raises(ValueError, match="validated"):
        topk._topk_cuda(x, 3)
    ((widened,), dtype), = seen
    assert dtype in (None, torch.float32)
    assert widened.dtype == torch.float32 and widened.is_contiguous()
    assert torch.equal(widened, x.float())


def test_topk_k_max_is_the_kernels():
    """The wrapper's K_MAX is the bound the launcher of csrc/topk.cu uses."""
    src = (ROOT / "deeperspeed_tpu_torch" / "csrc" / "topk.cu").read_text()
    assert f"constexpr int K_MAX = {topk.K_MAX};" in src
    assert "if (k <= K_MAX)" in src


def test_topk_k_out_of_range():
    x = torch.zeros(2, 16)
    for k in (0, 17):
        with pytest.raises(ValueError):
            sorted_topk(x, k)


def _logits(n=2, R=3, V=64, seed=2):
    return np.random.default_rng(seed).standard_normal((n, R, V)).astype(np.float32)


def test_greedy_is_bit_equal():
    x = _logits()
    want = jax_sample_tokens(jnp.asarray(x), jax.random.PRNGKey(0), temperature=0.0)
    got = sample_tokens(torch.from_numpy(x), temperature=0.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_filter_confines_samples():
    """The noise differs from JAX's by design; the property holds for both."""
    x = _logits(n=1, R=1, V=32, seed=4)
    allowed = set(np.asarray(jax.lax.top_k(jnp.asarray(x).reshape(1, -1), 5)[1])[0])
    gen = torch.Generator().manual_seed(0)
    seen = {int(sample_tokens(torch.from_numpy(x), gen, temperature=2.0,
                              top_k=5)[0, 0]) for _ in range(64)}
    assert seen <= allowed and len(seen) > 1


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (0, 1e-6)])
def test_single_candidate_is_greedy(top_k, top_p):
    x = _logits(seed=3)
    gen = torch.Generator().manual_seed(1)
    for _ in range(4):
        got = sample_tokens(torch.from_numpy(x), gen, temperature=1.3,
                            top_k=top_k, top_p=top_p)
        np.testing.assert_array_equal(got.numpy(), x.argmax(-1))


def test_verify_draft_matches_jax_on_ragged_drafts():
    rng = np.random.default_rng(5)
    n, R = 6, 5
    chosen = rng.integers(0, 4, (n, R)).astype(np.int32)
    drafts = rng.integers(0, 4, (n, R - 1)).astype(np.int32)
    lens = np.array([0, 1, 2, 3, 4, 4], np.int32)
    drafts[5, :] = chosen[5, :R - 1]          # a fully accepted row
    want = jax_verify_draft(jnp.asarray(chosen), jnp.asarray(drafts),
                            jnp.asarray(lens))
    got = verify_draft(torch.from_numpy(chosen), torch.from_numpy(drafts),
                       torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[5]) == 4
