"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  On the H100,
from the repository root (the tests' conftest imports JAX, which the card's
machine does not have, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

chip_smoke.py holds the same kernels at the serving and training paths'
shapes; these tests sweep the edges: odd and large hidden sizes, every
dtype, head dims and block sizes, every query count, rows with ties, -inf
and no live token, ragged sequence lengths, causal and full attention.
"""

import numpy as np
import pytest
import torch

from chip_smoke import flash_shares
from deeperspeed_tpu_torch.ops.attention import flash, paged
from deeperspeed_tpu_torch.ops.quantizer import quantize_kv
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


# K2q / K3q: the same walk over int8 and fp8 e4m3 pools with per-(slot, head)
# fp32 scales, against the plain versions on the same quantized pools.
KV_DTYPES = ["int8", "fp8"]


def _quantized_pools(gen, B, N, D, bs, M, P, kv_dtype):
    pk, pv, tables = _pools(gen, B, N, D, bs, M, P, torch.float32)
    # per-token magnitudes over two octaves, so the scales matter
    mag = 2 ** (2 * torch.rand(P, bs, N, 1, generator=gen, device="cuda") - 1)
    (qk, sk), (qv, sv) = quantize_kv(pk * mag, kv_dtype), quantize_kv(pv * mag, kv_dtype)
    return qk, qv, sk, sv, tables


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("D,bs", [(16, 8), (64, 8), (64, 16), (80, 16), (96, 32),
                                  (128, 16), (128, 32)])
def test_paged_decode_quantized(gen, D, bs, dtype, kv_dtype):
    B, N, M = 5, 3, 6
    qk, qv, sk, sv, tables = _quantized_pools(gen, B, N, D, bs, M, 4 * M, kv_dtype)
    q = torch.randn(B, N, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([1, bs, bs + 1, M * bs - 3, M * bs], dtype=torch.int32,
                        device="cuda")
    got = paged.paged_decode_attention(q, qk, qv, tables, lens, k_scale=sk, v_scale=sv)
    want = paged._decode_reference(q, qk, qv, tables, lens, D ** -0.5, sk, sv)
    assert got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S", range(1, 9))
def test_paged_spec_decode_quantized(gen, S, dtype, kv_dtype):
    B, N, D, bs, M = 4, 2, 64, 16, 5
    qk, qv, sk, sv, tables = _quantized_pools(gen, B, N, D, bs, M, 3 * M, kv_dtype)
    q = torch.randn(B, S, N, D, generator=gen, device="cuda").to(dtype)
    last = torch.tensor([S - 1, 20, 47, M * bs - 1], device="cuda")
    pos = (last[:, None] - S + 1 + torch.arange(S, device="cuda")).to(torch.int32)
    got = paged.paged_spec_decode_attention(q, qk, qv, tables, pos.contiguous(),
                                            k_scale=sk, v_scale=sv)
    want = paged._spec_decode_reference(q, qk, qv, tables, pos, D ** -0.5, sk, sv)
    _close(got, want, dtype)
    # each query sums in the same order whatever S is: query sq of the
    # S-wide launch equals a plain decode at that query's length, bit for bit
    for sq in range(S):
        dec = paged.paged_decode_attention(q[:, sq].contiguous(), qk, qv, tables,
                                           (pos[:, sq] + 1).contiguous(),
                                           k_scale=sk, v_scale=sv)
        assert torch.equal(got[:, sq], dec)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_paged_quantized_row_with_no_live_token_is_zero(gen, kv_dtype):
    qk, qv, sk, sv, tables = _quantized_pools(gen, 2, 2, 64, 16, 2, 4, kv_dtype)
    q = torch.randn(2, 2, 64, generator=gen, device="cuda")
    lens = torch.tensor([0, 5], dtype=torch.int32, device="cuda")
    out = paged.paged_decode_attention(q, qk, qv, tables, lens, k_scale=sk, v_scale=sv)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all()


def test_paged_quantized_counts_and_rejections(gen):
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    qk, qv, sk, sv, tables = _quantized_pools(gen, 2, 2, 64, 16, 2, 4, "fp8")
    q = torch.randn(2, 2, 64, generator=gen, device="cuda")
    lens = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    LAUNCHES.clear()
    paged.paged_decode_attention(q, qk, qv, tables, lens, k_scale=sk, v_scale=sv)
    paged.paged_spec_decode_attention(q[:, None].contiguous(), qk, qv, tables,
                                      (lens - 1)[:, None].contiguous(),
                                      k_scale=sk, v_scale=sv)
    assert dict(LAUNCHES) == {"paged_decode_q": 1, "paged_spec_decode_q": 1}
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged.paged_decode_attention(q, qk, qv, tables, lens, k_scale=sk)
    with pytest.raises(TypeError):      # fp pools with scales
        paged.paged_decode_attention(q, q.new_zeros(qk.shape), q.new_zeros(qk.shape),
                                     tables, lens, k_scale=sk, v_scale=sv)
    with pytest.raises(TypeError):      # e5m2 pools are refused
        e5 = qk.float().to(torch.float8_e5m2)
        paged.paged_decode_attention(q, e5, e5, tables, lens, k_scale=sk, v_scale=sv)
    with pytest.raises(TypeError):      # quantized pools without scales
        paged.paged_decode_attention(q, qk, qv, tables, lens)
    with pytest.raises(ValueError):     # scales of another shape
        paged.paged_decode_attention(q, qk, qv, tables, lens, k_scale=sk[:, :8],
                                     v_scale=sv[:, :8])
    with pytest.raises(TypeError):      # scales in another type
        paged.paged_decode_attention(q, qk, qv, tables, lens, k_scale=sk.half(),
                                     v_scale=sv.half())


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


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_scheduler_on_the_card_matches_the_cpu(kv_dtype):
    """Scheduler + quantized pool + speculation on tiny(): card tokens equal
    the CPU's and the non-speculative card run's, through K2q and K3q."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deeperspeed_tpu_torch.inference.v2 import DSScheduler, InferenceEngineV2
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False

    def run(device, speculative):
        cfg = {"dtype": "float32",
               "kv_cache": {"num_blocks": 9, "block_size": 8, "dtype": kv_dtype},
               "state_manager": {"max_context": 64, "max_decode_batch": 4}}
        if speculative:
            cfg["speculative"] = {"method": "ngram", "k": 4}
        eng = InferenceEngineV2(GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=3),
                                cfg, device=device)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 256, 22) for _ in range(2)] + \
            [np.asarray([5, 6, 7, 8] * 5)]
        sched = DSScheduler(eng)
        outs = sched.generate(prompts, max_new_tokens=10)
        sm = eng.state_manager
        sm.prefix_cache.evict(sm.allocator.total_blocks)
        sm.allocator.audit()
        assert sm.allocator.free_blocks == sm.allocator.total_blocks
        return outs, sched

    LAUNCHES.clear()
    got, sched = run(None, True)
    assert sched.preemption_count > 0       # 9 blocks: decode growth preempts
    assert LAUNCHES["paged_decode_q"] + LAUNCHES["paged_spec_decode_q"] > 0
    assert LAUNCHES["paged_spec_decode_q"] > 0
    assert LAUNCHES["paged_decode"] == LAUNCHES["paged_spec_decode"] == 0
    for other in (run(None, False)[0], run("cpu", True)[0]):
        for g, w in zip(got, other):
            np.testing.assert_array_equal(g, w)


# Flash attention (K5-K7) against the plain versions on the same tensors,
# each output held on its own scale by chip_smoke.py's rule: per element
# |got - ref| <= rtol |ref| + row rms_D(ref) + floor, and per (b, n) head
# ||got - ref|| <= head ||ref|| + floor sqrt(S D); floor is absolute, on inputs of unit scale, for rows
# whose exact value is 0 (dq and dk at S 1, where both sides keep the fp32
# noise of dP - delta, ~1e-6 times |k| up to 4).  (rtol, row, floor, head):
# fp32 sums in another order only, the grads over up to S products; bf16
# as chip_smoke.py's FLASH_TOL: one bf16 ulp of the element (2^-7), two of
# the row's RMS (the kernel rounds P and dS at its running max per 64-key
# tile, the plain version at the row's final max, one ulp apart), 1e-2 of
# each head's norm.
FLASH_TOL = {torch.float32: ((1e-5, 0.0, 1e-5, 1e-5), (1e-4, 1e-4, 1e-4, 1e-4)),
             torch.bfloat16: ((2 ** -7, 2 ** -6, 2 ** -10, 1e-2),) * 2}


def _flash_close(got, want, dtype, grad=False):
    _, elem, head = flash_shares(torch, got, want, FLASH_TOL[dtype][int(grad)])
    assert elem <= 1.0 and head <= 1.0, f"shares of the limit: element {elem}, head {head}"


def _qkv(gen, S, D, dtype, B=2, N=3):
    return [torch.randn(B, S, N, D, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S", [1, 7, 64, 1000, 1024])
@pytest.mark.parametrize("D", [16, 40, 64, 96, 128])  # bf16 D 40: padded to 48
def test_flash_forward(gen, D, S, dtype, causal):
    q, k, v, _ = _qkv(gen, S, D, dtype)
    o, lse = flash._fwd_cuda(q, k, v, causal)
    ro, rlse = flash._fwd_reference(q, k, v, causal)
    assert o.dtype == dtype and lse.shape == (q.shape[0] * q.shape[2], S)
    _flash_close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S", [1, 7, 64, 1000])
@pytest.mark.parametrize("D", [16, 40, 64, 96, 128])
def test_flash_backward(gen, D, S, dtype, causal):
    q, k, v, do = _qkv(gen, S, D, dtype, B=1)
    o, lse = flash._fwd_reference(q, k, v, causal)
    B, _, N, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
    dq = flash._dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = flash._dkv_cuda(q, k, v, do, lse, delta, causal)
    for got, want in zip((dq, dk, dv), flash._bwd_reference(q, k, v, do, lse, delta, causal)):
        assert got.dtype == dtype
        _flash_close(got, want, dtype, grad=True)


def test_flash_takes_unaligned_bf16_operands(gen):
    """A contiguous view at an odd element offset is not 16-byte aligned:
    the wrapper copies it for the tensor-core kernels, with the same
    results."""
    B, S, N, D = 1, 100, 2, 64
    n = B * S * N * D
    flat = torch.randn(4 * n + 3, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v, do = (flat[3 + i * n:3 + (i + 1) * n].view(B, S, N, D) for i in range(4))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    o, lse = flash._fwd_cuda(q, k, v, True)
    ro, rlse = flash._fwd_reference(q, k, v, True)
    _flash_close(o, ro, torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
    dq = flash._dq_cuda(q, k, v, do, lse, delta, True)
    _flash_close(dq, flash._bwd_reference(q, k, v, do, lse, delta, True)[0],
                 torch.bfloat16, grad=True)


def test_flash_autograd_launches_the_kernels(gen):
    from deeperspeed_tpu_torch.ops.attention import dot_product_attention
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    q, k, v, w = _qkv(gen, 300, 64, torch.bfloat16)
    q.requires_grad_()
    LAUNCHES.clear()
    dot_product_attention(q, k, v, causal=True).backward(w)
    assert {n: LAUNCHES[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == \
        {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    with pytest.raises(ValueError):
        flash._fwd_cuda(q.detach().half(), k.half(), v.half(), True)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 8, 1, 136, device="cuda")
        flash._fwd_cuda(big, big, big, True)


@pytest.mark.parametrize("gamma_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,H", [(1, 64), (7, 100), (300, 768), (130, 4095),
                                    (33, 16384)])
def test_layer_norm_backward(gen, rows, H, dtype, gamma_dtype):
    """dx within the dtype's TOL; dgamma/dbeta sum the rows in another
    order (per-CTA partials), so they are held relative to their largest
    entry, plus one rounding to gamma's type."""
    x = (2 * torch.randn(rows, H, generator=gen, device="cuda") + 0.5).to(dtype)
    dy = torch.randn(rows, H, generator=gen, device="cuda").to(dtype)
    g = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(gamma_dtype)
    dx, dg, db = normalize._ln_bwd_cuda(x, g.float(), dy, 1e-5, False)
    rdx, rdg, rdb = normalize._ln_bwd_ref(x, g.float(), dy, 1e-5, False)
    _close(dx, rdx, dtype)
    for got, want in ((dg, rdg), (db, rdb)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())
    # through autograd: grads in gamma's type
    xr = x.clone().requires_grad_()
    gr, br = g.clone().requires_grad_(), torch.zeros_like(g).requires_grad_()
    normalize.layer_norm(xr, gr, br).backward(dy)
    assert gr.grad.dtype == br.grad.dtype == gamma_dtype
    torch.testing.assert_close(gr.grad.float(), dg.to(gamma_dtype).float())
    rms_dx, _, _ = normalize._ln_bwd_cuda(x, g.float(), dy, 1e-5, True)
    _close(rms_dx, normalize._ln_bwd_ref(x, g.float(), dy, 1e-5, True)[0], dtype)


# card vs CPU losses over 3 steps: fp32 differs by summation order only
# (TF32 off); bf16 and fp16 products round their inputs (2^-8 and 2^-11
# relative) in another order on each side, and the card's bf16 attention
# is the flash kernels where the CPU's is the dense path.
TRAIN_TOL = {"fp32": 1e-5, "bf16": 2e-2, "fp16": 5e-3}


@pytest.mark.parametrize("mode", list(TRAIN_TOL))
def test_training_on_the_card_matches_the_cpu(mode):
    """Tiny GPT-NeoX, 3 Adam steps: card and CPU losses within TRAIN_TOL,
    the kernels of the path launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}[mode]
    cfg = {"train_batch_size": 4, "gradient_clipping": 1.0,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    if mode != "fp32":
        cfg[mode] = {"enabled": True}
    engines = [dst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(dtype=dtype), device=d,
                                            seed=3), config=cfg, device=d)[0]
               for d in ("cuda", "cpu")]
    rng = np.random.default_rng(0)
    LAUNCHES.clear()
    for _ in range(3):
        toks = rng.integers(0, 256, (4, 65))
        batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
        lg, lc = (float(e.train_batch(batch=batch)) for e in engines)
        assert abs(lg - lc) <= TRAIN_TOL[mode] * abs(lc), (lg, lc)
    kernels = ["layer_norm", "layer_norm_bwd"]
    if mode != "fp16":          # fp16 attention takes the dense path, as in JAX
        kernels += ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
    for name in kernels:
        assert LAUNCHES[name] > 0, name
