"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  On the H100,
from the repository root (the tests' conftest imports JAX, which the card's
machine does not have, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

chip_smoke.py holds the same kernels at the serving and training paths'
shapes; these tests sweep the edges: odd and large hidden sizes, every
dtype, head dims and block sizes, every query count, rows with ties, -inf
and no live token, ragged sequence lengths (to 4096 tokens), pools that
are misaligned or of odd head dims, stale block-table ids past a row's
live blocks, causal and full attention, sorted top-k (K4) bit for bit
over rows of ties, -inf, signed zeros and NaN, vocabularies to 128,256,
k above the radix path's limit, unaligned slices, bf16 / fp16 logits and
transposed views, the flash dk/dv (K6) and dq (K7) passes at the
forward's edges and repeated bit for bit, the LayerNorm backward (K8) at
every preset width, above its register layouts and repeated bit for bit,
with gamma in its own type, the
fused optimizers over flat buffers and over separate (also non-contiguous)
tensors of many sizes, the fused dequant-reduce (B5) bit for bit over every
1-byte type, peer count and alignment, two training processes sharing
the card over gloo, tanh-GELU (B9) over every type and its vector and
scalar paths (bit for bit between them), the fused softmax (B8) over every
type, odd widths and each forward path's widths, unaligned rows and rows
of -inf or NaN, and block-sparse attention (B10) over every sparsity
config, block sizes 16-256, head dims that need padding, per-head layouts,
causal and not, and rows with no live key, with its Hopper passes
(blocks 64, 128, 256) at every head dim, over a long Fixed layout, an
empty key column and query row, and repeated bit for bit, and the forward
kernel each block size launches.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import flash_shares
from deeperspeed_tpu_torch.ops.adam import fused_adam
from deeperspeed_tpu_torch.ops.attention import flash, paged
from deeperspeed_tpu_torch.ops.lion import fused_lion
from deeperspeed_tpu_torch.ops.quantizer import fused, quantize_kv
from deeperspeed_tpu_torch.quantization import BlockScaledTensor
from deeperspeed_tpu_torch.ops.sampling import topk
from deeperspeed_tpu_torch.ops.sparse_attention import sparsity_config
from deeperspeed_tpu_torch.ops.transformer import activations, normalize, softmax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

# the package exports the function under the module's name
sparse = importlib.import_module("deeperspeed_tpu_torch.ops.sparse_attention.sparse_attention")

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


def _ln_inputs(gen, rows, H, dtype, gamma_dtype=torch.float32):
    x = (2 * torch.randn(rows, H, generator=gen, device="cuda") + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(gamma_dtype)
    b = (0.1 * torch.randn(H, generator=gen, device="cuda")).to(gamma_dtype)
    return x, g, b


# the presets' hidden sizes (a warp per row up to 2048 in 2-byte types and
# 1024 in fp32, a CTA per row above)
@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("H", [1024, 2048, 2560, 5120, 8192])
def test_layer_norm_preset_widths(gen, H, dtype, rms):
    x, g, b = _ln_inputs(gen, 37, H, dtype)
    b = None if rms else b
    got = normalize._norm(x, g, b, 1e-5, rms)
    _close(got, normalize._ln_ref(x, g, b, 1e-5, rms), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,H", [(1, 768), (65537, 768), (65537, 64), (1, 16384)])
def test_layer_norm_row_counts(gen, rows, H, dtype):
    x, g, b = _ln_inputs(gen, rows, H, dtype)
    _close(normalize._norm(x, g, b, 1e-5, False), normalize._ln_ref(x, g, b, 1e-5, False),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("H", [768, 5120])
@pytest.mark.parametrize("which", ["x", "gamma"])
def test_layer_norm_unaligned_views(gen, H, dtype, which):
    """A view at a one-element offset is not 16-byte aligned: the kernel
    takes its element-by-element path, with the same results."""
    rows = 9
    x, g, b = _ln_inputs(gen, rows, H, dtype)
    if which == "x":
        flat = torch.empty(rows * H + 1, dtype=dtype, device="cuda")
        flat[1:].copy_(x.reshape(-1))
        x = flat[1:].view(rows, H)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    else:
        flat = torch.empty(2 * H + 1, dtype=g.dtype, device="cuda")
        flat[1:H + 1].copy_(g)
        flat[H + 1:].copy_(b)
        g, b = flat[1:H + 1], flat[H + 1:]
        assert g.data_ptr() % 16 != 0
    got = normalize._ln_cuda(x, g, b, 1e-5, False)
    _close(got, normalize._ln_ref(x, g, b, 1e-5, False), dtype)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("gamma_dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("H", [100, 768, 4096])
def test_layer_norm_gamma_in_its_own_type(gen, H, dtype, gamma_dtype, rms):
    """gamma and beta in bf16 or fp16 go to the kernel as they are (no cast
    launch) and are upcast exactly in registers."""
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    x, g, b = _ln_inputs(gen, 21, H, dtype, gamma_dtype)
    b = None if rms else b
    LAUNCHES.clear()
    got = normalize._norm(x, g, b, 1e-5, rms)
    assert LAUNCHES["layer_norm"] == 1
    _close(got, normalize._ln_ref(x, g, b, 1e-5, rms), dtype)
    want = normalize._norm(x, g.float(), None if rms else b.float(), 1e-5, rms)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("H", [768, 100, 5120, 40000])
def test_layer_norm_launches_repeat_bit_for_bit(gen, H, dtype):
    x, g, b = _ln_inputs(gen, 300, H, dtype)
    first = normalize._ln_cuda(x, g, b, 1e-5, False)
    assert torch.equal(first, normalize._ln_cuda(x, g, b, 1e-5, False))
    _close(first, normalize._ln_ref(x, g, b, 1e-5, False), dtype)


def test_layer_norm_grad_modes_agree_with_one_launch_each(gen):
    """Under no_grad and inference_mode the forward skips the
    autograd.Function; with grad it goes through it.  All three give the
    same bits, with one K1 launch each."""
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    x, g, b = _ln_inputs(gen, 64, 768, torch.bfloat16, torch.bfloat16)
    outs = []
    for mode in ("no_grad", "inference_mode", "grad"):
        LAUNCHES.clear()
        if mode == "no_grad":
            with torch.no_grad():
                outs.append(normalize.layer_norm(x, g, b))
        elif mode == "inference_mode":
            with torch.inference_mode():
                outs.append(normalize.layer_norm(x, g, b))
        else:
            gr = g.clone().requires_grad_()
            y = normalize.layer_norm(x, gr, b)
            assert y.requires_grad
            outs.append(y.detach())
        assert LAUNCHES["layer_norm"] == 1, mode
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_layer_norm_rejects_what_the_kernel_does_not_take(gen):
    x, g, b = _ln_inputs(gen, 4, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        normalize._ln_cuda(x.t(), g, b, 1e-5, False)           # not contiguous
    with pytest.raises(ValueError):
        normalize._ln_cuda(x, g[:32], b, 1e-5, False)          # gamma not [H]
    with pytest.raises(ValueError):
        normalize._ln_cuda(x, g, b.to(torch.bfloat16), 1e-5, False)  # two types
    with pytest.raises(ValueError):
        normalize._ln_cuda(x, g.cpu(), b.cpu(), 1e-5, False)   # another device
    with pytest.raises(TypeError):
        normalize._ln_cuda(x.double(), g, b, 1e-5, False)


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
    # each query sums in the same order whatever S is: query sq of the
    # S-wide launch equals a plain decode at that query's length, bit for bit
    for sq in range(S):
        dec = paged.paged_decode_attention(q[:, sq].contiguous(), pk, pv, tables,
                                           (pos[:, sq] + 1).contiguous())
        assert torch.equal(got[:, sq], dec)


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


# The walk's edges, over every pool kind: long ragged contexts, one or two
# rows, pools that force the element-by-element loads, stale table entries.
POOL_KINDS = ["fp32", "bf16", "fp16"] + KV_DTYPES
FP_POOLS = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _kind_case(gen, kind, B, N, D, bs, M, P, offset=0):
    """(q's dtype, pool_k, pool_v, tables, scales) for one pool kind; the
    pools start ``offset`` elements into their storage."""
    if kind in KV_DTYPES:
        pk, pv, sk, sv, tables = _quantized_pools(gen, B, N, D, bs, M, P, kind)
        dtype, scales = torch.bfloat16, {"k_scale": sk, "v_scale": sv}
    else:
        dtype, scales = FP_POOLS[kind], {}
        pk, pv, tables = _pools(gen, B, N, D, bs, M, P, dtype)
    if offset:
        def shifted(pool):
            flat = torch.empty(pool.numel() + offset, dtype=pool.dtype, device="cuda")
            view = flat[offset:].view(pool.shape)
            view.view(torch.uint8).copy_(pool.view(torch.uint8))
            return view
        pk, pv = shifted(pk), shifted(pv)
    return dtype, pk, pv, tables, scales


def _decode_and_spec(gen, q, pk, pv, tables, lens, scales, S, dtype):
    """Decode at ``lens`` and an S-wide speculative launch whose last query
    sits at ``lens - 1``, each against its plain version; every query of
    the S-wide launch equals a decode at its own length bit for bit."""
    B, N, D = q.shape
    got = paged.paged_decode_attention(q, pk, pv, tables, lens, **scales)
    _close(got, paged._decode_reference(q, pk, pv, tables, lens, D ** -0.5, **scales), dtype)
    qs = torch.randn(B, S, N, D, generator=gen, device="cuda").to(dtype)
    pos = (lens[:, None] - S + torch.arange(S, device="cuda")).clamp(min=0).to(torch.int32)
    spec = paged.paged_spec_decode_attention(qs, pk, pv, tables, pos, **scales)
    _close(spec, paged._spec_decode_reference(qs, pk, pv, tables, pos, D ** -0.5, **scales),
           dtype)
    for sq in range(S):
        dec = paged.paged_decode_attention(qs[:, sq].contiguous(), pk, pv, tables,
                                           (pos[:, sq] + 1).contiguous(), **scales)
        assert torch.equal(spec[:, sq], dec)
    return got


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("D", [64, 128])
def test_paged_long_ragged_context(gen, D, kind):
    # 256 blocks of 16; the lengths end at every offset of a 16-token walk
    # step (4 warps of 4, 2 or 1 token slots), and one row is full
    N, bs, M = 2, 16, 256
    lens = torch.cat([16 * 180 + torch.arange(16), torch.tensor([M * bs])]).to(
        torch.int32).cuda()
    B = lens.numel()
    dtype, pk, pv, tables, scales = _kind_case(gen, kind, B, N, D, bs, M, B * M)
    q = torch.randn(B, N, D, generator=gen, device="cuda").to(dtype)
    _decode_and_spec(gen, q, pk, pv, tables, lens, scales, 8, dtype)


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("B", [1, 2])
def test_paged_one_and_two_rows(gen, B, kind):
    N, D, bs, M = 12, 64, 16, 64
    dtype, pk, pv, tables, scales = _kind_case(gen, kind, B, N, D, bs, M, 2 * M)
    q = torch.randn(B, N, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([1000, 37][:B], dtype=torch.int32, device="cuda")
    _decode_and_spec(gen, q, pk, pv, tables, lens, scales, 4, dtype)


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("D,offset", [(64, 2), (100, 0), (100, 2)])
def test_paged_unaligned_pools_and_odd_head_dim(gen, D, offset, kind):
    # a pool 2 elements into its storage, or rows of 100 elements, leave the
    # 16-byte (8-byte) loads misaligned: the kernel loads element by element
    B, N, bs, M = 5, 3, 16, 6
    dtype, pk, pv, tables, scales = _kind_case(gen, kind, B, N, D, bs, M, 4 * M, offset)
    assert (pk.data_ptr() % 16 != 0) == (offset != 0)
    q = torch.randn(B, N, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([1, bs, bs + 1, M * bs - 3, M * bs], dtype=torch.int32,
                        device="cuda")
    _decode_and_spec(gen, q, pk, pv, tables, lens, scales, 3, dtype)


@pytest.mark.parametrize("kind", POOL_KINDS)
def test_paged_stale_table_entries_are_never_read(gen, kind):
    # served tables may hold stale ids past a row's live blocks: an id out of
    # the pool there changes nothing and raises no CUDA error
    B, N, D, bs, M = 4, 3, 64, 16, 8
    dtype, pk, pv, tables, scales = _kind_case(gen, kind, B, N, D, bs, M, 4 * M)
    q = torch.randn(B, N, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([0, 17, 64, M * bs - 1], dtype=torch.int32, device="cuda")
    live = (lens + bs - 1) // bs
    stale = tables.clone()
    dead = torch.arange(M, device="cuda")[None, :] >= live[:, None]
    stale[dead] = torch.where(torch.arange(int(dead.sum()), device="cuda") % 2 == 0,
                              2 ** 30, -1).to(torch.int32)
    want = paged.paged_decode_attention(q, pk, pv, tables, lens, **scales)
    got = paged.paged_decode_attention(q, pk, pv, stale, lens, **scales)
    qs = torch.randn(B, 4, N, D, generator=gen, device="cuda").to(dtype)
    # row 0's queries sit before token 0 and see nothing, as its decode
    pos = (lens[:, None] - 4 + torch.arange(4, device="cuda")).to(torch.int32)
    spec_want = paged.paged_spec_decode_attention(qs, pk, pv, tables, pos, **scales)
    spec_got = paged.paged_spec_decode_attention(qs, pk, pv, stale, pos, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(spec_got, spec_want)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def _topk_rows(gen, rows, V):
    """rows (>= 7) of V logits, with the rows where the tie and sign rules
    matter: ties, half masked, all -inf, signed zeros, a NaN, fewer finite
    values than k."""
    x = torch.randn(rows, V, generator=gen, device="cuda")
    x[1] = torch.randint(0, 3, (V,), generator=gen, device="cuda").float()  # ties
    x[2, V // 2:] = float("-inf")                                           # masked
    x[3] = float("-inf")
    x[4] = 0.0                                                              # signed zeros
    x[4, ::3] = -0.0
    x[4, 1::5] = -1.0
    x[5, V // 3] = float("nan")
    x[6, 3:] = float("-inf")                                                # 3 finite
    return x


def _check_topk(x, k):
    kv, ki = topk.sorted_topk(x, k)
    rv, ri = topk._topk_reference(x.float(), k)   # on the fp32 widening
    torch.cuda.synchronize()
    assert torch.equal(ki, ri)
    assert torch.equal(kv.isnan(), rv.isnan())
    assert torch.equal(kv.nan_to_num(), rv.nan_to_num())
    for row, vals in zip(ki.tolist(), kv.isnan().tolist()):
        assert all(vals) or len(set(row)) == k
    return kv, ki


# k <= K_MAX: the radix select, at any V (128,256 is Llama-3's vocabulary);
# (4096, 3000): the round kernel above K_MAX
@pytest.mark.parametrize("V,k", [(7, 7), (1000, 1), (1000, 64), (50304, 50), (128256, 50),
                                 (4096, 2048), (4096, 3000), (1001, 50)])
def test_sorted_topk(gen, V, k):
    x = _topk_rows(gen, 9, V)
    kv, ki = _check_topk(x, k)
    assert torch.equal(ki[5], torch.full_like(ki[5], V)) and bool(kv[5].isnan().all())
    assert torch.equal(ki[3], torch.arange(k, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("case", ["rows8", "unaligned", "nan_row", "one_row", "bf16", "fp16",
                                  "transposed"])
def test_sorted_topk_shapes(gen, case):
    """The served shape (8 rows of the GPT-NeoX vocabulary), a slice whose
    pointer is not 16-byte aligned (the element path), a row that is
    finite but for one NaN, a single row, and what the reference takes
    beyond fp32 rows: bf16 and fp16 logits and a transposed view, each
    equal to the plain version on the fp32 widening."""
    V, k = 50304, 50
    if case == "rows8":
        x = _topk_rows(gen, 8, V)
    elif case in ("bf16", "fp16"):
        x = _topk_rows(gen, 9, V).to(torch.bfloat16 if case == "bf16" else torch.float16)
    elif case == "transposed":
        x = _topk_rows(gen, 9, V).t().contiguous().t()
        assert not x.is_contiguous()
    elif case == "unaligned":
        flat = torch.randn(9 * V + 1, generator=gen, device="cuda")
        x = flat[1:].view(9, V)
        x[:7] = _topk_rows(gen, 7, V)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    elif case == "nan_row":
        x = torch.randn(2, V, generator=gen, device="cuda")
        x[0, V - 1] = float("nan")
    else:
        x = torch.randn(1, V, generator=gen, device="cuda")
    _check_topk(x, k)


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


def _delta(do, o):
    B, S, N, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()


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
    delta = _delta(do, o)
    dq = flash._dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = flash._dkv_cuda(q, k, v, do, lse, delta, causal)
    for got, want in zip((dq, dk, dv), flash._bwd_reference(q, k, v, do, lse, delta, causal)):
        assert got.dtype == dtype
        _flash_close(got, want, dtype, grad=True)


# K5's edges on the card: head dims whose second 64-column box is partly
# out of bounds (80, 112), one long sequence, S one row past a tile, a
# single head, and two waves of 132 CTAs
FLASH_EDGES = [(2, 300, 3, 80), (2, 300, 3, 112), (1, 4096, 2, 64), (2, 65, 3, 64),
               (2, 127, 3, 128), (1, 200, 1, 64), (24, 64, 11, 64), (4, 130, 66, 96)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,N,D", FLASH_EDGES)
def test_flash_forward_edges(gen, B, S, N, D, causal):
    q, k, v, _ = _qkv(gen, S, D, torch.bfloat16, B=B, N=N)
    o, lse = flash._fwd_cuda(q, k, v, causal)
    ro, rlse = flash._fwd_reference(q, k, v, causal)
    _flash_close(o, ro, torch.bfloat16)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


# K6's edges, the same shapes: the Q/dO ring over an odd or even count of q
# tiles, the ragged last q tile, second boxes partly out of bounds
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,N,D", FLASH_EDGES)
def test_flash_dkv_edges(gen, B, S, N, D, causal):
    q, k, v, do = _qkv(gen, S, D, torch.bfloat16, B=B, N=N)
    o, lse = flash._fwd_reference(q, k, v, causal)
    delta = _delta(do, o)
    dk, dv = flash._dkv_cuda(q, k, v, do, lse, delta, causal)
    _, rdk, rdv = flash._bwd_reference(q, k, v, do, lse, delta, causal)
    _flash_close(dk, rdk, torch.bfloat16, grad=True)
    _flash_close(dv, rdv, torch.bfloat16, grad=True)


# K7's edges, the same shapes: the K/V ring over an odd or even count of k
# tiles, the ragged last k tile, second boxes partly out of bounds, N 66
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,N,D", FLASH_EDGES)
def test_flash_dq_edges(gen, B, S, N, D, causal):
    q, k, v, do = _qkv(gen, S, D, torch.bfloat16, B=B, N=N)
    o, lse = flash._fwd_reference(q, k, v, causal)
    delta = _delta(do, o)
    dq = flash._dq_cuda(q, k, v, do, lse, delta, causal)
    _flash_close(dq, flash._bwd_reference(q, k, v, do, lse, delta, causal)[0],
                 torch.bfloat16, grad=True)


@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_forward_launches_repeat_bit_for_bit(gen, D):
    q, k, v, _ = _qkv(gen, 1000, D, torch.bfloat16)
    o1, l1 = flash._fwd_cuda(q, k, v, True)
    o2, l2 = flash._fwd_cuda(q, k, v, True)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_dkv_launches_repeat_bit_for_bit(gen, D):
    q, k, v, do = _qkv(gen, 1000, D, torch.bfloat16)
    o, lse = flash._fwd_cuda(q, k, v, True)
    delta = _delta(do, o)
    dk1, dv1 = flash._dkv_cuda(q, k, v, do, lse, delta, True)
    dk2, dv2 = flash._dkv_cuda(q, k, v, do, lse, delta, True)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_dq_launches_repeat_bit_for_bit(gen, D):
    q, k, v, do = _qkv(gen, 1000, D, torch.bfloat16)
    o, lse = flash._fwd_cuda(q, k, v, True)
    delta = _delta(do, o)
    dq1 = flash._dq_cuda(q, k, v, do, lse, delta, True)
    assert torch.equal(dq1, flash._dq_cuda(q, k, v, do, lse, delta, True))


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
    delta = _delta(do, o)
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
# K8's layouts: a warp per row to H 1024, a CTA per row to 8192 (the
# presets 2048-6144), the looping CTA above (16384, 20000); 100 and 4095
# take the element-by-element path
@pytest.mark.parametrize("rows,H", [(1, 64), (7, 100), (300, 768), (130, 4095),
                                    (33, 16384), (37, 1024), (37, 2048), (37, 4096),
                                    (37, 6144), (9, 20000)])
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


def _ln_bwd_inputs(gen, rows, H, dtype, gamma_dtype=torch.float32):
    x, g, _ = _ln_inputs(gen, rows, H, dtype, gamma_dtype)
    return x, g, torch.randn(rows, H, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("H", [768, 100, 6144, 20000])
def test_layer_norm_backward_launches_repeat_bit_for_bit(gen, H, dtype):
    x, g, dy = _ln_bwd_inputs(gen, 300, H, dtype)
    first = normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)
    for a, b in zip(first, normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("gamma_dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("H", [100, 768, 4096, 20000])
def test_layer_norm_backward_gamma_in_its_own_type(gen, H, dtype, gamma_dtype, rms):
    """gamma in bf16 or fp16 goes to K8 as it is (one launch, no cast) and
    is upcast exactly in registers: the same bits as with an fp32 copy."""
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    x, g, dy = _ln_bwd_inputs(gen, 45, H, dtype, gamma_dtype)
    LAUNCHES.clear()
    got = normalize._ln_bwd_cuda(x, g, dy, 1e-5, rms)
    assert LAUNCHES["layer_norm_bwd"] == 1
    for a, b in zip(got, normalize._ln_bwd_cuda(x, g.float(), dy, 1e-5, rms)):
        assert torch.equal(a, b)


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


# B6/B7 against their plain versions: each product and sum is rounded on
# its own in both, so m' and v' (and B7's u) agree to the bit; the held
# limit is two fp32 ulps (2^-22 relative), as chip_smoke.py holds them.  B6's
# u differs by how PyTorch divides by a scalar: rtol 2e-6.
OPTIM_SIZES = [1, 3, 127, 1000, 1024, 4099, 70001]


def _optim_case(gen, sizes, layout, n_moments):
    """Gradients and moments for tensors of ``sizes``: views into flat
    buffers (the engine's layout), separate tensors, or separate strided
    (non-contiguous) ones."""
    total = sum(sizes)
    flats = [torch.randn(total, generator=gen, device="cuda") * s
             for s in (1e-2, 1e-2, 1e-3)[:1 + n_moments]]
    if n_moments == 2:
        flats[2] = flats[2].abs()
    out = []
    for flat in flats:
        views, off = [], 0
        for n in sizes:
            v = flat[off:off + n]
            off += n
            if layout == "separate":
                v = v.clone()
            elif layout == "strided":      # every other element of a buffer
                v = torch.empty(n, 2, device="cuda")[:, 0].copy_(v)
            views.append(v)
        out.append(views)
    return out


def _check_rel(got, want, rtol, what):
    for a, b in zip(got, want):
        bad = (a - b).abs() > rtol * b.abs()
        assert not bool(bad.any()), (what, float((a - b).abs().max()))


@pytest.mark.parametrize("layout", ["flat", "separate", "strided"])
def test_fused_adam(gen, layout):
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES
    from deeperspeed_tpu_torch.runtime.optimizers import _bias_correction

    g, m, v = _optim_case(gen, OPTIM_SIZES, layout, 2)
    if layout == "strided":
        assert not g[1].is_contiguous()
    ref = [[t.clone() for t in lst] for lst in (g, m, v)]
    cache = {}                         # the second step reuses the first's table
    for count in (1, 7):
        before = LAUNCHES["fused_adam"]
        fused_adam.fused_adam_(g, m, v, count, 0.9, 0.999, 1e-8, cache)
        assert LAUNCHES["fused_adam"] == before + 1
        assert bool(cache) == (layout != "strided")   # copies written back: no cache
        fused_adam._adam_leaf_update_plain(*ref, _bias_correction(0.9, count),
                                           _bias_correction(0.999, count),
                                           0.9, 0.999, 1e-8)
        _check_rel(m, ref[1], 2 ** -22, "m")
        _check_rel(v, ref[2], 2 ** -22, "v")
        _check_rel(g, ref[0], 2e-6, "u")
        for a, b in zip(g, ref[0]):    # the kernel's update is the next gradient
            b.copy_(a)


@pytest.mark.parametrize("layout", ["flat", "separate", "strided"])
def test_fused_lion(gen, layout):
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    g, m = _optim_case(gen, OPTIM_SIZES, layout, 1)
    g[2].view(-1)[:5] = 0.0            # c = 0 where g and m are both 0
    m[2].view(-1)[:5] = 0.0
    g[-1].view(-1)[3] = float("nan")   # sign(NaN) is NaN, as jnp.sign gives it
    ref = [[t.clone() for t in lst] for lst in (g, m)]
    before = LAUNCHES["fused_lion"]
    fused_lion.fused_lion_(g, m, 0.9, 0.99)
    assert LAUNCHES["fused_lion"] == before + 1
    fused_lion._lion_leaf_plain(*ref, 0.9, 0.99)
    assert bool(g[-1].view(-1)[3].isnan()) and bool(m[-1].view(-1)[3].isnan())
    _check_rel([t.nan_to_num() for t in m], [t.nan_to_num() for t in ref[1]], 2 ** -22, "m")
    for a, b in zip(g, ref[0]):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert set(a[~a.isnan()].unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert float(g[2].view(-1)[:5].abs().sum()) == 0.0


def test_fused_optimizers_reject_what_the_kernel_does_not_take(gen):
    g = [torch.randn(10, device="cuda")]
    with pytest.raises(TypeError):
        fused_adam.fused_adam_([g[0].half()], [g[0].clone()], [g[0].clone()], 1)
    with pytest.raises(ValueError):
        fused_lion.fused_lion_(g, [torch.zeros(11, device="cuda")])
    with pytest.raises(ValueError):
        fused_lion.fused_lion_(g, [torch.zeros(10)])


@pytest.mark.parametrize("name", ["FusedAdam", "FusedLion"])
def test_fused_optimizer_training_on_the_card_matches_the_cpu(name):
    """Tiny GPT-NeoX in fp32, 3 steps with weight decay, chunked loss and
    block recompute: card and CPU losses within 1e-5, one launch a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = {"FusedAdam": "fused_adam", "FusedLion": "fused_lion"}[name]
    cfg = {"train_batch_size": 4, "gradient_clipping": 1.0,
           "optimizer": {"type": name, "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "activation_checkpointing": {"partition_activations": True}}
    engines = [dst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(ce_chunk_tokens=48),
                                            device=d, seed=3), config=cfg, device=d)[0]
               for d in ("cuda", "cpu")]
    rng = np.random.default_rng(0)
    LAUNCHES.clear()
    for _ in range(3):
        toks = rng.integers(0, 256, (4, 65))
        batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
        lg, lc = (float(e.train_batch(batch=batch)) for e in engines)
        assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    assert LAUNCHES[kernel] == 3


@pytest.mark.parametrize("wire", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("rows,d,offset", [(150, 128, 0), (7, 256, 0), (33, 96, 0),
                                           (40, 128, 3), (1, 16, 0)],
                         ids=["path", "two-groups", "one-group-a-row", "unaligned",
                              "one-row"])
def test_dequant_reduce(gen, wire, n, rows, d, offset):
    """B5 equals its plain version bit for bit: 16-value loads where the
    values are aligned and each run of 16 keeps one scale, one value at a
    time otherwise (an offset view, a row of 96 with one group)."""
    x = torch.randn(n, rows, d, generator=gen, device="cuda")
    x[0, 0, :4] = -0.0
    x[:, -1] = 0.0
    t = BlockScaledTensor.quantize(x, wire, 128)
    values = t.values
    if offset:
        raw = torch.empty(values.numel() + offset, dtype=torch.uint8, device="cuda")
        values = raw[offset:].view(values.dtype).view(values.shape)
        values.copy_(t.values)
    got = fused.fused_dequant_reduce(BlockScaledTensor(values, t.scales, 128))
    want = fused._dequant_reduce_plain(*fused._normalize(values, t.scales, 128)[:2],
                                       fused._normalize(values, t.scales, 128)[2])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_dequant_reduce_rejects_what_the_kernel_does_not_take(gen):
    q = torch.zeros(2, 4, 128, dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError):
        fused.fused_dequant_reduce(q, torch.ones(2, 4, 1, device="cuda").half())
    with pytest.raises(ValueError):
        fused.fused_dequant_reduce(q, torch.ones(2, 4, 1))
    with pytest.raises(ValueError):
        fused.fused_dequant_reduce(q.float(), torch.ones(2, 4, 1, device="cuda"))


def test_two_processes_on_one_card_over_gloo(tmp_path):
    """Two ranks share the card over gloo (every collective staged through
    host memory, ``comm.STAGED``): ZeRO stages 0 and 3 and qgZ train tiny
    GPT-NeoX in fp32, with equal losses on both ranks, stage 3 within 1e-5
    of stage 0, and B5 launched 12 times a step under qgZ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.ops import cuda_utils
    from torch_dp_worker import spawn

    cuda_utils.build()            # every kernel, before the two ranks would race for them
    torch.backends.cuda.matmul.allow_tf32 = False
    start = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=5).state_dict()
    rng = np.random.default_rng(5)
    arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
    for i in range(3):
        toks = rng.integers(0, 256, (8, 33)).astype(np.int64)
        arrays[f"b{i}/input_ids"], arrays[f"b{i}/labels"] = toks[:, :-1], toks[:, 1:]
    base = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    runs = {"stage0": {**base, "zero_optimization": {"stage": 0}},
            "stage3": {**base, "zero_optimization": {"stage": 3,
                                                     "param_persistence_threshold": 1000}},
            "qgz": {**base, "comm": {"quantized": {"enabled": True}}}}
    spec = {"kind": "train", "n_batches": 3, "device": "cuda", "runs": [
        {"name": n, "config": c, "dtype": "fp32", "steps": 3} for n, c in runs.items()]}
    r0, r1 = spawn(spec, arrays, tmp_path, timeout=400)
    for name in runs:
        assert np.array_equal(r0[f"{name}/losses"], r1[f"{name}/losses"]), name
    s0, s3 = r0["stage0/losses"], r0["stage3/losses"]
    assert np.all(np.abs(s3 - s0) <= 1e-5 * np.abs(s0)), (s0, s3)
    assert list(r0["qgz/b5_calls"]) == [12, 12, 12]
    assert list(r0["stage0/b5_calls"]) == [0, 0, 0]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1,), (1000,), (7, 333), (64, 3072)])
def test_gelu(gen, shape, dtype):
    x = (3 * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    y = activations._gelu_cuda(x)
    assert y.dtype == dtype
    _close(y, activations._gelu_ref(x), dtype)
    _close(activations._dgelu_cuda(x, dy), activations._dgelu_ref(x, dy), dtype)


def _unaligned_copy(t):
    """The values of ``t`` in a view one element past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    view = buf[1:].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# B9's paths: the scalar loop alone (n below one chunk of 256 threads x 2
# vectors: 1, 7, 9), whole chunks and a scalar tail (4097, 65543), and the
# same values in views that are not 16-byte aligned (the scalar loop over
# every element), which must give the vector path's results bit for bit
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 7, 9, 4097, 65543])
def test_gelu_paths(gen, n, dtype):
    x = (3 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(n, generator=gen, device="cuda").to(dtype)
    y, dx = activations._gelu_cuda(x), activations._dgelu_cuda(x, dy)
    _close(y, activations._gelu_ref(x), dtype)
    _close(dx, activations._dgelu_ref(x, dy), dtype)
    xu, dyu = _unaligned_copy(x), _unaligned_copy(dy)
    assert torch.equal(activations._gelu_cuda(xu), y)
    assert torch.equal(activations._dgelu_cuda(xu, dyu), dx)


# B8's forward against its plain version: fp32 at the JAX tests' (rtol,
# atol), bf16 / fp16 at one ulp of the element (chip_smoke.ULP_TOL)
SOFTMAX_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2 ** -7, 1e-6),
               torch.float16: (2 ** -10, 1e-6)}


def _softmax_close(got, want):
    rtol, atol = SOFTMAX_TOL[want.dtype]
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got.float().nan_to_num(), want.float().nan_to_num(), rtol=rtol,
                               atol=atol)


# widths on each forward path: a warp per row to 1024 (fp32) / 2048 values,
# a CTA per row to 16,384, a loop above; 7, 100, 333 and 1000 ragged or odd
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,W", [(1, 1), (5, 7), (33, 100), (64, 128), (16, 1000),
                                    (8, 1024), (3, 50304), (9, 2048), (7, 333), (5, 4096),
                                    (4, 2049), (3, 16384), (2, 16385)])
def test_softmax(gen, rows, W, dtype):
    x = (4 * torch.randn(rows, W, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(rows, W, generator=gen, device="cuda").to(dtype)
    y = softmax._fwd_cuda(x, 0.125)
    assert y.dtype == dtype
    _softmax_close(y, softmax._softmax_ref(x, 0.125))
    _close(softmax._bwd_cuda(y, dy, 0.125), softmax._softmax_bwd_ref(y, dy, 0.125), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("W", [1024, 4096, 50304, 333])
def test_softmax_special_rows(gen, W, dtype):
    """An x two elements past an aligned address (the element path), rows
    of -inf, with a NaN, half masked and at a negative scale: the NaN mask
    and the values equal the plain version's, and two launches the same
    bits."""
    rows = 6
    flat = (4 * torch.randn(rows * W + 2, generator=gen, device="cuda")).to(dtype)
    x = flat[2:].view(rows, W)
    assert x.data_ptr() % 16 != 0
    x[0] = float("-inf")
    x[1, W // 2] = float("nan")
    x[2, : W // 2] = float("-inf")
    x[3, W - 1] = float("inf")
    for scale in (0.125, -0.5):
        y = softmax._fwd_cuda(x, scale)
        _softmax_close(y, softmax._softmax_ref(x, scale))
        assert bool(y[0].isnan().all()) and bool(y[1].isnan().all())
        assert torch.equal(softmax._fwd_cuda(x, scale).view(torch.int16 if dtype != torch.float32
                                                            else torch.int32),
                           y.view(torch.int16 if dtype != torch.float32 else torch.int32))
        aligned = x.clone()
        assert aligned.data_ptr() % 16 == 0
        _softmax_close(softmax._fwd_cuda(aligned, scale), softmax._softmax_ref(x, scale))


def test_gelu_and_softmax_autograd_launch_the_kernels(gen):
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES
    from deeperspeed_tpu_torch.ops.transformer import bias_gelu, fused_softmax

    x = torch.randn(4, 256, generator=gen, device="cuda", requires_grad=True)
    b = torch.randn(256, generator=gen, device="cuda", requires_grad=True)
    LAUNCHES.clear()
    (bias_gelu(x, b).sum() + fused_softmax(x, 0.5).square().sum()).backward()
    assert [LAUNCHES[k] for k in ("gelu_fwd", "gelu_bwd", "softmax_fwd", "softmax_bwd")] \
        == [1, 1, 1, 1]


SPARSE_CONFIGS = {
    "dense": (sparsity_config.DenseSparsityConfig, {}),
    "fixed": (sparsity_config.FixedSparsityConfig, {"num_local_blocks": 2}),
    "bigbird": (sparsity_config.BigBirdSparsityConfig, {"num_random_blocks": 1}),
    "longformer": (sparsity_config.BSLongformerSparsityConfig, {}),
    "variable": (sparsity_config.VariableSparsityConfig, {"local_window_blocks": [1, 2],
                                                          "num_random_blocks": 1}),
    "fixed-per-head": (sparsity_config.FixedSparsityConfig, {
        "num_local_blocks": 2, "different_layout_per_head": True,
        "num_different_global_patterns": 2}),
}


def _sparse_case(gen, name, dtype, causal, B=2, S=512, N=3, D=64, block=128):
    cls, kw = SPARSE_CONFIGS[name]
    if cls is not sparsity_config.DenseSparsityConfig:
        kw = {**kw, "attention": "unidirectional" if causal else "bidirectional"}
    layout = sparse.device_layout(cls(num_heads=N, block=block, **kw).make_layout(S), "cuda")
    q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    return q, k, v, do, layout


def _sparse_vs_plain(q, k, v, do, layout, causal, block):
    """Each B10 pass against the plain version on the same inputs."""
    scale = q.shape[-1] ** -0.5
    o, lse = sparse._fwd_cuda(q, k, v, layout, causal, scale, block)
    ro, rlse = sparse._fwd_reference(q, k, v, layout, causal, scale)
    B, S, N, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
    dq = sparse._dq_cuda(q, k, v, do, lse, delta, layout, causal, scale, block)
    dk, dv = sparse._dkv_cuda(q, k, v, do, lse, delta, layout, causal, scale, block)
    want = sparse._bwd_reference(q, k, v, do, lse, delta, layout, causal, scale)
    return (o, dq, dk, dv), (ro, *want), (lse, rlse)


def _sparse_agree(got, want, lses, dtype):
    lse, rlse = lses
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    for g, w, tol in zip(got, want, (2e-5, 2e-4, 2e-4, 2e-4)):
        assert g.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        else:
            _, elem, heads = flash_shares(torch, g, w)
            assert elem <= 1.0 and heads <= 1.0, (elem, heads)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(SPARSE_CONFIGS))
def test_sparse_attention(gen, name, dtype, causal):
    q, k, v, do, layout = _sparse_case(gen, name, dtype, causal)
    _sparse_agree(*_sparse_vs_plain(q, k, v, do, layout, causal, 128), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("block,D", [(16, 64), (32, 16), (48, 40), (64, 128), (128, 72),
                                     (256, 8)])
def test_sparse_attention_blocks_and_head_dims(gen, block, D, dtype):
    """Tiles of 16, 32 and 64 rows under blocks of 16-256, and head dims the
    bf16 kernels take only zero-padded."""
    S = 8 * block
    for causal in (True, False):
        q, k, v, do, layout = _sparse_case(gen, "bigbird", dtype, causal, S=S, D=D,
                                           block=block)
        _sparse_agree(*_sparse_vs_plain(q, k, v, do, layout, causal, block), dtype)


def test_sparse_rows_with_no_live_key_are_zero(gen):
    """A causal call over a layout whose query block 0 sees only key block 1:
    its rows have no live key, and O and dq are zero there."""
    layout = torch.tensor([[[0, 1], [1, 1]]], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(1, 256, 2, 64, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        got, want, lses = _sparse_vs_plain(q, k, v, do, layout, True, 128)
        _sparse_agree(got, want, lses, dtype)
        assert not got[0][:, :128].any() and not got[1][:, :128].any()


def test_sparse_attention_autograd_and_rejections(gen):
    from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES

    cfg = sparsity_config.FixedSparsityConfig(num_heads=2, block=64, num_local_blocks=2,
                                              attention="unidirectional")
    attn = sparse.SparseSelfAttention(cfg)
    q, k, v = (torch.randn(1, 256, 2, 32, generator=gen, device="cuda", requires_grad=True)
               for _ in range(3))
    LAUNCHES.clear()
    attn(q, k, v).square().sum().backward()
    assert [LAUNCHES[n] for n in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")] \
        == [1, 1, 1]
    assert list(attn._on_device) == [(256, q.device)]     # put on the card once
    layout = attn._on_device[(256, q.device)]
    x = q.detach()
    with pytest.raises(ValueError, match="multiples of 16"):
        sparse._fwd_cuda(x[:, :192], x[:, :192], x[:, :192],
                         torch.ones(1, 8, 8, dtype=torch.int32, device="cuda"), True, 1.0, 24)
    with pytest.raises(ValueError, match="fp32/bf16"):
        sparse._fwd_cuda(x.half(), x.half(), x.half(), layout, True, 1.0, 64)
    with pytest.raises(ValueError, match="does not fit"):
        sparse._fwd_cuda(x, x, x, layout[:, :2, :2].contiguous(), True, 1.0, 64)


def _layout(seed, LH, nb, density=0.6):
    """A random [LH, nb, nb] layout (some rows and columns of blocks may
    come out empty)."""
    lay = np.random.default_rng(seed).random((LH, nb, nb)) < density
    return torch.tensor(lay.astype(np.int32), device="cuda")


def _sparse_qkv(gen, B, S, N, D):
    return [torch.randn(B, S, N, D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(4)]


# The bf16 backward passes on Hopper (blocks a multiple of 64): every head
# dim the kernels take and those the wrapper pads (8 -> 16, 40 -> 64,
# 72 -> 128), causal and full, one layout for all heads and one a head
@pytest.mark.parametrize("per_head", [False, True], ids=["LH1", "LHN"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 8, 40, 72])
@pytest.mark.parametrize("block", [64, 128, 256])
def test_sparse_hopper_backward(gen, block, D, causal, per_head):
    B, N, S = 2, 3, 4 * block
    layout = _layout(block + D + 2 * causal + per_head, N if per_head else 1, S // block)
    q, k, v, do = _sparse_qkv(gen, B, S, N, D)
    _sparse_agree(*_sparse_vs_plain(q, k, v, do, layout, causal, block), torch.bfloat16)


def test_sparse_hopper_backward_long_fixed(gen):
    """Fixed at S 4096, block 128, causal: the dk/dv CTAs of key block 3
    (a global column) walk 58 q tiles, so the ring wraps many times."""
    cfg = sparsity_config.FixedSparsityConfig(num_heads=2, block=128, num_local_blocks=4,
                                              num_global_blocks=1, attention="unidirectional")
    layout = sparse.device_layout(cfg.make_layout(4096), "cuda")
    assert int(layout[0, :, 3].sum()) == 29
    q, k, v, do = _sparse_qkv(gen, 1, 4096, 2, 64)
    _sparse_agree(*_sparse_vs_plain(q, k, v, do, layout, True, 128), torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sparse_hopper_empty_column_and_row(gen, causal):
    """Key block 1 is attended by no query, query block 2 attends to no key:
    dk and dv are zero on key block 1 and dq on query block 2 (the kernels
    write zeros, though their outputs come from torch.empty_like)."""
    lay = np.ones((1, 4, 4), np.int32)
    lay[:, :, 1] = 0
    lay[:, 2, :] = 0
    layout = torch.tensor(lay, device="cuda")
    q, k, v, do = _sparse_qkv(gen, 2, 256, 3, 64)
    got, want, lses = _sparse_vs_plain(q, k, v, do, layout, causal, 64)
    _sparse_agree(got, want, lses, torch.bfloat16)
    o, dq, dk, dv = got
    lse = lses[0].view(2, 3, 256)
    assert not o[:, 128:192].any() and (lse[..., 128:192] == sparse.NEG_INF).all()
    assert not dq[:, 128:192].any()
    assert not dk[:, 64:128].any() and not dv[:, 64:128].any()
    assert o[:, 192:].any() and dq[:, 192:].any() and dk[:, 128:].any()
    assert (lse[..., 192:] > sparse.NEG_INF).all()


@pytest.mark.parametrize("D", [64, 128])
def test_sparse_hopper_launches_repeat_bit_for_bit(gen, D):
    q, k, v, do, layout = _sparse_case(gen, "fixed", torch.bfloat16, True, S=1024, D=D)
    scale = D ** -0.5
    o, lse = sparse._fwd_cuda(q, k, v, layout, True, scale, 128)
    o2, lse2 = sparse._fwd_cuda(q, k, v, layout, True, scale, 128)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = _delta(do, o)
    args = (q, k, v, do, lse, delta, layout, True, scale, 128)
    dq1, (dk1, dv1) = sparse._dq_cuda(*args), sparse._dkv_cuda(*args)
    dq2, (dk2, dv2) = sparse._dq_cuda(*args), sparse._dkv_cuda(*args)
    assert torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.parametrize("block,kernel", [(64, "hopper::sparse_fwd_kernel"),
                                          (128, "hopper::sparse_fwd_kernel"),
                                          (16, "tc::fwd_kernel"), (32, "tc::fwd_kernel"),
                                          (48, "tc::fwd_kernel")])
def test_sparse_forward_kernel_by_block(gen, block, kernel):
    """bf16 blocks that hold whole 64-row tiles run the Hopper forward, the
    others the mma.sync one: the kernel launched, by name, from the trace
    (traced again, up to three times, if a trace drops the kernel, as one
    on the H100 was seen to)."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, _, layout = _sparse_case(gen, "bigbird", torch.bfloat16, True, S=8 * block,
                                      block=block)
    sparse._fwd_cuda(q, k, v, layout, True, 0.125, block)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sparse._fwd_cuda(q, k, v, layout, True, 0.125, block)
            torch.cuda.synchronize()
        names = [e.key.replace("(anonymous namespace)::", "") for e in prof.key_averages()
                 if e.device_type.name == "CUDA"]
        b10 = [n for n in names if "fwd_kernel" in n]
        if b10:
            break
    assert len(b10) == 1 and kernel in b10[0], names
