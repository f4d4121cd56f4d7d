#!/usr/bin/env python3
"""The attention kernels (flash K5-K7; block-sparse B10's forward, dq and
dk/dv) and the LayerNorm backward (K8) of the PyTorch port, each alone on
the card, for one checkout.

    python3 tools/torch_bwd_ab.py [--root CHECKOUT] [--label NAME] [--flex]

Imports the kernels of the checkout at ``--root`` (this one by default;
another checkout, such as a ``git archive`` of a parent commit, to compare
two trees on one card: run parent, change, change, parent in one call) and
prints one line a row, each with the card's name and power limit:

- K7 ``flash_bwd_dq`` and K6 ``flash_bwd_dkv`` at ``chip_smoke.py`` phase
  3's five shapes and at SPARSE_SHAPE (bf16, causal), each alone: 20
  launches captured in a CUDA graph (``chip_smoke._graph_ms``); K5's
  forward the same way; and a digest of each output (K5's O and LSE, K7's
  dq, K6's dk and dv), equal between two trees whose kernels compute the
  same bits;
- B10 ``sparse_fwd``, ``sparse_bwd_dq`` and ``sparse_bwd_dkv`` at
  SPARSE_SHAPE (bf16, block 128) under each of phase 17's five layouts,
  each alone from a CUDA graph, with a digest of the forward's O and LSE
  and of the backward's dq and dk + dv.  The backward passes take the LSE
  and delta of the plain forward (``_fwd_reference``), so two trees feed
  them equal inputs even where their forwards round apart; a pass through
  autograd as phase 17 runs it, device time by kernel;
- K8 ``layer_norm_bwd`` at rows 16384, H 768 in bf16 (gamma in fp32, which
  every tree takes): the whole call timed with CUDA events; the call from
  a CUDA graph (its kernels and fills, no host work); the device time of
  each kernel the call launches, by name, from ``torch.profiler`` over 20
  calls; and ``aten.native_layer_norm_backward`` alone, event-timed and
  from a graph, on the saved mean and rstd of ``aten.native_layer_norm``;
- with ``--flex``, a yardstick that the port never calls: FlexAttention
  (``torch.nn.attention.flex_attention`` under ``torch.compile``, its block
  mask made from the same layout) at SPARSE_SHAPE under the five layouts,
  forward + backward event-timed, its forward alone (no autograd) and its
  backward alone, each event-timed and by its kernels (``torch.profiler``),
  and its output's largest difference from B10's forward.  A layout that
  does not compile prints why.

Needs a CUDA device; exits 2 without one.
"""

import argparse
import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH_SHAPES = ((16, 1024, 12, 64, True), (4, 1000, 12, 64, True), (4, 1024, 16, 128, True),
                (4, 1024, 12, 64, False), (1, 4096, 12, 64, True))
LN_ROWS, LN_H = 16384, 768


def _smoke():
    """This checkout's chip_smoke.py (its timers), whatever --root is."""
    spec = importlib.util.spec_from_file_location("_smoke_timers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(torch, *ts):
    """The first 12 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def _sparse_layouts(smoke, sa, N, S):
    """Phase 17's five layouts at SPARSE_SHAPE: {name: (host layout, causal)}."""
    return {name: (getattr(sa, cls)(num_heads=N, block=smoke.SPARSE_BLOCK, **kw).make_layout(S),
                   causal)
            for name, (cls, kw, causal) in smoke.SPARSE_CONFIGS.items()}


def _flex_rows(torch, smoke, line, sparse, layouts, q, k, v, do):
    """FlexAttention under the five layouts: forward + backward, its
    forward and its backward alone and their kernels, beside B10's
    forward."""
    _, S, N, D = q.shape
    block, scale = smoke.SPARSE_BLOCK, D ** -0.5
    try:
        from torch._functorch import config as functorch_config
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention
        # the backward alone is timed on one saved graph (retain_graph), which
        # compiled backwards with donated buffers refuse
        functorch_config.donated_buffer = False
        flex = torch.compile(flex_attention)
    except Exception as e:      # the row says why the yardstick is missing
        print(f"[flex] FlexAttention not available: {type(e).__name__}: {e}", flush=True)
        return
    q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q4, k4, v4))
    do4 = do.transpose(1, 2).contiguous()
    for name, (host_layout, causal) in layouts.items():
        what = (f"FlexAttention {name} B={q.shape[0]} S={S} N={N} D={D} block {block} "
                f"{'causal' if causal else 'full'} bf16")
        try:
            lay = torch.as_tensor(host_layout, device=q.device).bool()
            head = lay.shape[0] > 1

            def mask_mod(b, h, q_idx, kv_idx):
                live = lay[h if head else 0, q_idx // block, kv_idx // block]
                return live & (q_idx >= kv_idx) if causal else live

            bm = create_block_mask(mask_mod, B=None, H=N if head else None, Q_LEN=S, KV_LEN=S,
                                   BLOCK_SIZE=block, device=q.device)

            def fwd_bwd():
                out = flex(qg, kg, vg, block_mask=bm, scale=scale)
                torch.autograd.grad(out, (qg, kg, vg), do4)

            def fwd():
                return flex(q4, k4, v4, block_mask=bm, scale=scale)

            fwd_bwd_ms = smoke._time_ms(torch, fwd_bwd, iters=10)
            fwd_ms = smoke._time_ms(torch, fwd, iters=10)
            fwd_parts = smoke._kernels_ms(torch, fwd, iters=10)
            out = flex(qg, kg, vg, block_mask=bm, scale=scale)

            def bwd():
                return torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True)

            bwd_ms = smoke._time_ms(torch, bwd, iters=10)
            parts = smoke._kernels_ms(torch, bwd, iters=10)
            dlay = sparse.device_layout(host_layout, q.device)
            o, _ = sparse._fwd_cuda(q, k, v, dlay, causal, scale, block)
            diff = (out.detach().transpose(1, 2).float() - o.float()).abs().max().item()
            line(what, fwd_bwd_ms=fwd_bwd_ms, fwd_ms=fwd_ms,
                 fwd_kernels_ms=sum(fwd_parts.values()), bwd_ms=bwd_ms,
                 bwd_kernels_ms=sum(parts.values()), max_abs_diff_vs_b10_fwd=diff)
            for part, kernels in (("forward", fwd_parts), ("backward", parts)):
                print(f"[flex] {name} {part} kernels: "
                      + ", ".join(f"{n} {ms:.4f}" for n, ms in sorted(kernels.items())),
                      flush=True)
            del out, o
        except Exception as e:  # the row says why this layout has no yardstick
            print(f"[flex] {what}: did not run: {type(e).__name__}: {e}", flush=True)
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout to measure")
    ap.add_argument("--label", default="tree", help="a name for the printed lines")
    ap.add_argument("--flex", action="store_true",
                    help="also time FlexAttention under the sparse layouts")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import deeperspeed_tpu_torch.ops.sparse_attention as sa
    from deeperspeed_tpu_torch.ops import cuda_utils
    from deeperspeed_tpu_torch.ops.attention import flash
    from deeperspeed_tpu_torch.ops.transformer import normalize

    sparse = sys.modules[sa.sparse_attention.__module__]
    cuda_utils.build(["flash_attention", "layer_norm", "sparse_attention"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    graph = smoke._graph_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def line(what, text="", **vals):
        print(f"[bwd {args.label}] {card} {what}: "
              + " ".join(f"{k}={v:.4f}" for k, v in vals.items()) + text, flush=True)

    for B, S, N, D, causal in FLASH_SHAPES + (smoke.SPARSE_SHAPE + (True,),):
        q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = flash._fwd_cuda(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
        dq = flash._dq_cuda(q, k, v, do, lse, delta, causal)
        dk, dv = flash._dkv_cuda(q, k, v, do, lse, delta, causal)
        fwd_ms = graph(torch, lambda: flash._fwd_cuda(q, k, v, causal))
        dq_ms = graph(torch, lambda: flash._dq_cuda(q, k, v, do, lse, delta, causal))
        dkv_ms = graph(torch, lambda: flash._dkv_cuda(q, k, v, do, lse, delta, causal))
        line(f"K5-K7 flash B={B} S={S} N={N} D={D} {'causal' if causal else 'full'} bf16",
             f" digests O+LSE {_digest(torch, o, lse)} dq {_digest(torch, dq)} "
             f"dk+dv {_digest(torch, dk, dv)}",
             fwd_device_ms=fwd_ms, dq_device_ms=dq_ms, dkv_device_ms=dkv_ms,
             dq_plus_dkv_device_ms=dq_ms + dkv_ms)
        del q, k, v, do, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()

    B, S, N, D = smoke.SPARSE_SHAPE
    block, scale = smoke.SPARSE_BLOCK, D ** -0.5
    q, k, v, do = (torch.randn(B, S, N, D, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    layouts = _sparse_layouts(smoke, sa, N, S)
    for name, (host_layout, causal) in layouts.items():
        layout = sparse.device_layout(host_layout, dev)
        o, lse = sparse._fwd_cuda(q, k, v, layout, causal, scale, block)
        fwd_ms = graph(torch, lambda: sparse._fwd_cuda(q, k, v, layout, causal, scale, block))
        ro, rlse = sparse._fwd_reference(q, k, v, layout, causal, scale)
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).reshape(B * N, S).contiguous()
        args_ = (q, k, v, do, rlse, delta, layout, causal, scale, block)
        dq, (dk, dv) = sparse._dq_cuda(*args_), sparse._dkv_cuda(*args_)
        dq_ms = graph(torch, lambda: sparse._dq_cuda(*args_))
        dkv_ms = graph(torch, lambda: sparse._dkv_cuda(*args_))
        # a pass through autograd as phase 17 runs it, device time by kernel
        attn = sa.SparseSelfAttention(getattr(sa, smoke.SPARSE_CONFIGS[name][0])(
            num_heads=N, block=block, **smoke.SPARSE_CONFIGS[name][1]), causal=causal)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        got = smoke._sparse_pass_ms(torch, lambda: torch.autograd.grad(
            attn(*leaves), leaves, do))
        passes = {} if got is None else {"pass_device_ms": got[0], "pass_b10_ms": sum(
            got[1].values()), "pass_rest_ms": got[2]}
        line(f"B10 sparse {name} B={B} S={S} N={N} D={D} block {block} "
             f"{'causal' if causal else 'full'} bf16",
             ("" if passes else " pass not measured")
             + f" digests O+LSE {_digest(torch, o, lse)} dq {_digest(torch, dq)} "
             f"dk+dv {_digest(torch, dk, dv)}",
             fwd_device_ms=fwd_ms, dq_device_ms=dq_ms, dkv_device_ms=dkv_ms,
             dq_plus_dkv_device_ms=dq_ms + dkv_ms, **passes)
        del o, lse, ro, rlse, delta, args_, leaves, dq, dk, dv
        torch.cuda.empty_cache()
    if args.flex:
        _flex_rows(torch, smoke, line, sparse, layouts, q, k, v, do)
    del q, k, v, do
    torch.cuda.empty_cache()

    x = (2 * torch.randn(LN_ROWS, LN_H, generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    dy = torch.randn(LN_ROWS, LN_H, generator=gen, device=dev).to(torch.bfloat16)
    g = 1 + 0.1 * torch.randn(LN_H, generator=gen, device=dev)

    def call():
        return normalize._ln_bwd_cuda(x, g, dy, 1e-5, False)

    parts = smoke._kernels_ms(torch, call)
    line(f"K8 layer_norm_bwd rows={LN_ROWS} H={LN_H} bf16",
         call_ms=smoke._time_ms(torch, call), call_device_ms=graph(torch, call),
         **{f"{name}_ms": ms for name, ms in sorted(parts.items())})
    wb = g.to(torch.bfloat16)
    bb = torch.zeros(LN_H, device=dev, dtype=torch.bfloat16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [LN_H], wb, bb, 1e-5)

    def library():
        return torch.ops.aten.native_layer_norm_backward(dy, x, [LN_H], mean, rstd, wb, bb,
                                                         [True, True, True])

    lib_parts = smoke._kernels_ms(torch, library)
    line(f"aten.native_layer_norm_backward rows={LN_ROWS} H={LN_H} bf16 (bf16 weight)",
         ms=smoke._time_ms(torch, library), device_ms=graph(torch, library),
         **{f"{name}_ms": ms for name, ms in sorted(lib_parts.items())})
    return 0


if __name__ == "__main__":
    sys.exit(main())
