"""Ring attention: blockwise context parallelism over the ``sp`` group
(counterpart of ``deeperspeed_tpu/sequence/ring.py``; plain torch there and
here, no kernel).

Each rank holds Q/K/V for its sequence block.  For ``p`` steps it
accumulates blockwise attention of its Q against the K/V block it holds
(running max ``m``, denominator ``l`` and numerator ``o`` in fp32, a
flash-style online softmax) and passes that block to the next rank of the
ring, so that at step ``i`` rank ``r`` holds block ``(r - i) mod p``, as in
the JAX package.  The next block's send and receive are issued before the
current block's accumulation and waited for after it.  Causal masking is by
absolute position (queries at ``r S``, keys at ``block S``); a block wholly
above the diagonal adds nothing, so it is skipped, which leaves ``m``,
``l`` and ``o`` as they were (the JAX step computes them unchanged).

The backward (:class:`_RingAttention`; the JAX package differentiates its
scan under ``jax.checkpoint``) walks the ring again from the saved ``q, k,
v``, output and ``lse = m + log l``: it recomputes each block's
probabilities, adds the block's share of ``dq`` locally, and carries the
block's ``dk`` / ``dv`` partial sums along with it, so that after ``p``
steps they arrive at the rank the block belongs to.  One remote K/V block
is resident at a time in either pass.
"""

import torch

from .. import comm

_NEG_INF = -1e30  # finite: avoids (-inf) - (-inf) = nan in the online softmax
# op name of the ring's transfers (comm.STAGED)
RING_OP = "sp_ring"


def _block_accum(q, k, v, o, m, l, q_start, k_start, causal, scale):
    """One blockwise-attention accumulation step (all stats fp32).

    q: [B, Sq, N, D]; k/v: [B, Sk, N, D]; o: [B, Sq, N, D] fp32; m/l:
    [B, N, Sq] fp32.  ``q_start`` / ``k_start`` are the blocks' absolute
    sequence offsets."""
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    mask = _causal_mask(q, k, q_start, k_start) if causal else None
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, scores.amax(-1))              # [B, N, Sq]
    alpha = torch.exp(m - m_new)                           # correction for old stats
    probs = torch.exp(scores - m_new[..., None])
    if mask is not None:
        probs = probs.masked_fill(~mask, 0.0)
    l_new = l * alpha + probs.sum(-1)
    pv = torch.einsum("bnqk,bknd->bqnd", probs, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def _causal_mask(q, k, q_start, k_start):
    q_pos = q_start + torch.arange(q.shape[1], device=q.device)
    k_pos = k_start + torch.arange(k.shape[1], device=q.device)
    return q_pos[:, None] >= k_pos[None, :]                # [Sq, Sk]


def _shift(t, group):
    """Send ``t`` to the next rank of the ring and receive the previous
    rank's, issued: returns the call that waits for both and gives the
    received tensor."""
    p, r = group.size(), group.rank()
    recv = comm.irecv(torch.empty_like(t), (r - 1) % p, group, log_name=RING_OP)
    send = comm.isend(t, (r + 1) % p, group, log_name=RING_OP)
    return lambda: (send.wait(), recv.wait())[1]


def _ring(group):
    if group is None or group.size() == 1:
        return 1, 0
    return group.size(), group.rank()


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        p, r = _ring(group)
        B, S, N, D = q.shape
        o = torch.zeros((B, S, N, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, N, S), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, N, S), dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        for i in range(p):
            block = (r - i) % p
            # the next block's transfer is issued before this block's work
            nxt = _shift(kv, group) if i < p - 1 else None
            if not (causal and block > r):
                o, m, l = _block_accum(q, kv[0], kv[1], o, m, l, r * S, block * S,
                                       causal, scale)
            if nxt is not None:
                kv = nxt()
        out = (o / l.clamp(min=1e-30).transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        p, r = _ring(group)
        S = q.shape[1]
        qf, do = q.float(), dout.float()
        delta = (do * out.float()).sum(-1).transpose(1, 2)      # [B, N, Sq]
        dq = torch.zeros_like(qf)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(p):
            block = (r - i) % p
            nxt = _shift(kv, group) if i < p - 1 else None
            if not (causal and block > r):
                kf, vf = kv[0].float(), kv[1].float()
                s = torch.einsum("bqnd,bknd->bnqk", qf, kf) * scale
                probs = torch.exp(s - lse[..., None])
                if causal:
                    probs = probs.masked_fill(~_causal_mask(q, kf, r * S, block * S), 0.0)
                dkv[1] += torch.einsum("bnqk,bqnd->bknd", probs, do)
                ds = probs * (torch.einsum("bqnd,bknd->bnqk", do, vf) - delta[..., None])
                dq += torch.einsum("bnqk,bknd->bqnd", ds, kf) * scale
                dkv[0] += torch.einsum("bnqk,bqnd->bknd", ds, qf) * scale
            if p > 1:
                # the block's dk / dv travel with it: after p shifts they
                # are home
                home = _shift(dkv, group)
                if nxt is not None:
                    kv = nxt()
                dkv = home()
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None


def ring_attention(q, k, v, group=None, causal=True, scale=None):
    """Ring attention of the local blocks q/k/v [B, S_local, N, D] over
    ``group`` (None or a group of one: the single-block path); returns
    [B, S_local, N, D] in q's type."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    return _RingAttention.apply(q, k, v, group, causal, scale)


def ring_attention_sharded(q, k, v, causal=True, scale=None, group=None):
    """:func:`ring_attention` over the ``sp`` group by default (the JAX
    package's form for code over the global mesh)."""
    group = comm.get_sequence_parallel_group() if group is None else group
    return ring_attention(q, k, v, group, causal, scale)
