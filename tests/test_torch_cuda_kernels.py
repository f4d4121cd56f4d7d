"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  On the H100,
from the repository root (the tests' conftest imports JAX, which the card's
machine does not have, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

chip_smoke.py holds the same kernels at the serving path's shapes; these
tests sweep the edges: odd and large hidden sizes, every dtype, head dims
and block sizes, every query count, rows with ties, -inf and no live token.
"""

import numpy as np
import pytest
import torch

from deeperspeed_tpu_torch.ops.attention import paged
from deeperspeed_tpu_torch.ops.sampling import topk
from deeperspeed_tpu_torch.ops.transformer import normalize

pytestmark = pytest.mark.cuda

# fp32: summation order only; bf16/fp16: one rounding of the output
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,H", [(1, 64), (7, 100), (300, 768), (33, 4096),
                                    (5, 16384)])
def test_layer_norm(gen, rows, H, dtype, rms):
    x = (2 * torch.randn(rows, H, generator=gen, device="cuda") + 0.5).to(dtype)
    g = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    b = None if rms else 0.1 * torch.randn(H, generator=gen, device="cuda")
    got = normalize._norm(x, g, b, 1e-5, rms)
    assert got.dtype == dtype
    _close(got, normalize._ln_ref(x, g, b, 1e-5, rms), dtype)


def _pools(gen, B, N, D, bs, M, P, dtype):
    pk = torch.randn(P, bs, N, D, generator=gen, device="cuda").to(dtype)
    pv = torch.randn(P, bs, N, D, generator=gen, device="cuda").to(dtype)
    tables = torch.stack([torch.randperm(P, generator=gen, device="cuda")[:M]
                          for _ in range(B)]).to(torch.int32)
    return pk, pv, tables


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("D,bs", [(16, 8), (64, 16), (96, 64), (128, 16)])
def test_paged_decode(gen, D, bs, dtype):
    B, N, M = 5, 3, 6
    pk, pv, tables = _pools(gen, B, N, D, bs, M, 4 * M, dtype)
    q = torch.randn(B, N, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([1, bs, bs + 1, M * bs - 3, M * bs], dtype=torch.int32,
                        device="cuda")
    got = paged.paged_decode_attention(q, pk, pv, tables, lens)
    want = paged._decode_reference(q, pk, pv, tables, lens, D ** -0.5)
    _close(got, want, dtype)


@pytest.mark.parametrize("S", range(1, 9))
def test_paged_spec_decode(gen, S):
    B, N, D, bs, M = 4, 2, 64, 16, 5
    pk, pv, tables = _pools(gen, B, N, D, bs, M, 3 * M, torch.bfloat16)
    q = torch.randn(B, S, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    last = torch.tensor([S - 1, 20, 47, M * bs - 1], device="cuda")
    pos = (last[:, None] - S + 1 + torch.arange(S, device="cuda")).to(torch.int32)
    got = paged.paged_spec_decode_attention(q, pk, pv, tables, pos.contiguous())
    want = paged._spec_decode_reference(q, pk, pv, tables, pos, D ** -0.5)
    _close(got, want, torch.bfloat16)
    if S == 1:
        dec = paged.paged_decode_attention(q[:, 0].contiguous(), pk, pv, tables,
                                           (pos[:, 0] + 1).contiguous())
        assert torch.equal(got[:, 0], dec)


def test_paged_row_with_no_live_token_is_zero(gen):
    pk, pv, tables = _pools(gen, 2, 2, 64, 16, 2, 4, torch.float32)
    q = torch.randn(2, 2, 64, generator=gen, device="cuda")
    lens = torch.tensor([0, 5], dtype=torch.int32, device="cuda")
    out = paged.paged_decode_attention(q, pk, pv, tables, lens)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all()


def test_paged_wrappers_reject_what_the_kernel_does_not_take(gen):
    pk, pv, tables = _pools(gen, 2, 2, 64, 16, 2, 4, torch.float32)
    q = torch.randn(2, 2, 64, generator=gen, device="cuda")
    lens = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        paged.paged_decode_attention(q, pk, pv, tables.long(), lens)
    with pytest.raises(TypeError):
        paged.paged_decode_attention(q.half(), pk, pv, tables, lens)
    with pytest.raises(ValueError):
        paged.paged_decode_attention(q, pk.transpose(0, 1), pv, tables, lens)
    q9 = torch.randn(2, 9, 2, 64, device="cuda")
    with pytest.raises(ValueError):
        paged.paged_spec_decode_attention(q9, pk, pv, tables,
                                          torch.zeros(2, 9, dtype=torch.int32,
                                                      device="cuda"))


@pytest.mark.parametrize("V,k", [(7, 7), (1000, 1), (1000, 64), (50304, 50)])
def test_sorted_topk(gen, V, k):
    x = torch.randn(9, V, generator=gen, device="cuda")
    x[1] = torch.randint(0, 3, (V,), generator=gen, device="cuda").float()  # ties
    x[2, V // 2:] = float("-inf")                                           # masked
    x[3] = float("-inf")
    kv, ki = topk.sorted_topk(x, k)
    rv, ri = topk._topk_reference(x, k)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)
    assert all(len(set(row)) == k for row in ki.tolist())


def test_engine_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deeperspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"dtype": "float32", "kv_cache": {"num_blocks": 64, "block_size": 8},
           "state_manager": {"max_context": 64, "max_decode_batch": 4}}
    cpu_model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=3)
    gpu_model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n) for n in (13, 4, 9)]
    LAUNCHES.clear()
    got = InferenceEngineV2(gpu_model, cfg).generate(prompts, max_new_tokens=8)
    want = InferenceEngineV2(cpu_model, cfg, device="cpu").generate(
        prompts, max_new_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert LAUNCHES["layer_norm"] > 0 and LAUNCHES["paged_decode"] > 0
