"""DeepSpeed-Ulysses sequence parallelism, and the exact exchange of the
models' default mode (counterpart of ``deeperspeed_tpu/sequence/layer.py``).

Ulysses (reference ``deepspeed/sequence/layer.py``): before attention an
all-to-all over the ``sp`` group scatters heads and gathers the sequence
(``[B, S/p, N, D]`` -> ``[B, S, N/p, D]``), any local attention runs on the
whole sequence for its heads, and the inverse all-to-all restores the
sequence-sharded layout.  :class:`SeqAllToAll` is the reference's
``_SeqAllToAll``: its backward is the inverse all-to-all.  The JAX package
has the explicit form (:class:`DistributedAttention`, inside a
``shard_map``) and a GSPMD one (:func:`ulysses_attention`, two sharding
constraints that XLA lowers to the same pair); the port has no GSPMD, so
both are the explicit pair.  The exchanges go through the ``comm`` facade
(``comm.all_to_all``), logged and staged as every collective is.

The default mode (``seq_parallel_mode`` None) at ``sp`` > 1: the JAX
package leaves attention on sequence-sharded activations to GSPMD, which
computes the function of one device.  The port computes it exactly by
gathering the keys and values (and the key mask) of the whole sequence on
every rank (:func:`gather_sequence`, whose backward is the reduce-scatter of
the gathered gradients) and attending each rank's queries over the keys
before their end (:func:`gathered_keys`); where nothing masks the scores,
the queries sit behind zero rows at their own rows of those keys
(:func:`padded_attention`), so that the card's flash kernels, which take
equal query and key shapes only, run on every rank.
"""

import torch

from .. import comm

# op names under which the exchanges are logged and staged (comm.STAGED)
A2A_OP = "sp_all_to_all"
GATHER_OP = "sp_all_gather"
SCATTER_OP = "sp_reduce_scatter"


def sequence_group(module):
    """The ``sp`` group a bound module runs over, or None where it holds
    whole sequences (unbound, or a group of one)."""
    group = getattr(module, "sp_group", None)
    return group if group is not None and group.size() > 1 else None


def sequence_positions(module, batch, seq, device):
    """[batch, seq] positions of the tokens a module holds: ``[r S, (r +
    1) S)`` on slice ``r`` of its ``sp`` group, ``[0, S)`` unbound."""
    group = sequence_group(module)
    start = group.rank() * seq if group is not None else 0
    return torch.arange(start, start + seq, device=device).expand(batch, seq)


def bind_sequence_parallel(model, group):
    """Give every submodule of ``model`` that declares ``sp_group`` (the
    models and their attention layers) the ``sp`` group ``group``."""
    for mod in model.modules():
        if hasattr(mod, "sp_group"):
            mod.sp_group = group
    return model


def single_all_to_all(x, scatter_idx, gather_idx, group):
    """All-to-all over ``group``: split dim ``scatter_idx`` into one chunk a
    rank, concatenate what arrives along dim ``gather_idx`` in rank order
    (reference ``sequence/layer.py:15``).  Not differentiable: see
    :class:`SeqAllToAll`."""
    return comm.all_to_all(x, group, split_axis=scatter_idx, concat_axis=gather_idx,
                           tiled=True, log_name=A2A_OP)


class SeqAllToAll(torch.autograd.Function):
    """:func:`single_all_to_all` whose backward is the inverse all-to-all
    (the reference's ``_SeqAllToAll``, ``sequence/layer.py:44``)."""

    @staticmethod
    def forward(ctx, x, scatter_idx, gather_idx, group):
        ctx.idx, ctx.group = (scatter_idx, gather_idx), group
        return single_all_to_all(x, scatter_idx, gather_idx, group)

    @staticmethod
    def backward(ctx, grad):
        scatter_idx, gather_idx = ctx.idx
        return single_all_to_all(grad.contiguous(), gather_idx, scatter_idx, ctx.group), \
            None, None, None


class SeqAllGather(torch.autograd.Function):
    """Every rank's slice of dim ``dim`` concatenated in rank order; the
    backward keeps this rank's slice of the gradients' sum over the group
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return comm.all_gather(x.contiguous(), group=group, axis=dim, log_name=GATHER_OP)

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter(grad.contiguous(), group=ctx.group, axis=ctx.dim,
                                   log_name=SCATTER_OP), None, None


def gather_sequence(x, group, dim=1):
    """``x``'s slices of dim ``dim`` over ``group``, whole (differentiable)."""
    return SeqAllGather.apply(x, group, dim)


def gathered_keys(k, v, group, key_mask=None):
    """The default mode's exchange on sequence slice ``r`` of ``p``: the
    keys and values [B, S, ...] of the whole sequence gathered over
    ``group`` and cut at the end of this rank's slice, ``(r + 1) S / p``
    (the keys after it are above every local query's diagonal), so that
    attention of the local queries under a causal mask aligned at the end
    is exact; with ``key_mask`` [B, S / p] its whole-sequence form cut
    alike.  Returns ``(k, v, key_mask, q_start)``, ``q_start = r S / p``
    the global position of the first local query."""
    q_start = group.rank() * k.shape[1]
    end = q_start + k.shape[1]
    k = gather_sequence(k, group)[:, :end]
    v = gather_sequence(v, group)[:, :end]
    if key_mask is not None:
        key_mask = comm.all_gather(key_mask.contiguous(), group=group, axis=1,
                                   log_name=GATHER_OP)[:, :end]
    return k, v, key_mask, q_start


def padded_attention(attention, q, k, v):
    """``attention(q, k, v, causal=True)`` of the local queries [B, S, N, D]
    over keys [B, E, N, D], E >= S, aligned at their end: q behind E - S zero
    rows, so that the shapes agree (the flash kernels take equal shapes
    only) and the causal mask is the plain one; returns the output's last S
    rows.  The zero rows' outputs are dropped, so they give the keys and
    values no gradient."""
    S, E = q.shape[1], k.shape[1]
    if E > S:
        q = torch.cat([q.new_zeros((q.shape[0], E - S) + q.shape[2:]), q], dim=1)
    return attention(q, k, v, causal=True)[:, E - S:]


class DistributedAttention:
    """Ulysses around any local attention (reference ``sequence/layer.py:60``).

    ``local_attention(q, k, v, *args, **kwargs)`` takes and returns
    ``[B, S, N_local, D]``; this wrapper takes and returns the
    sequence-sharded ``[B, S_local, N, D]`` of each rank of ``group``.
    ``scatter_idx`` / ``gather_idx`` default to the head and sequence dims
    of that layout."""

    def __init__(self, local_attention, group, scatter_idx=2, gather_idx=1):
        self.local_attn = local_attention
        self.group = group
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx

    def __call__(self, query, key, value, *args, **kwargs):
        s, g, group = self.scatter_idx, self.gather_idx, self.group
        q = SeqAllToAll.apply(query, s, g, group)
        k = SeqAllToAll.apply(key, s, g, group)
        v = SeqAllToAll.apply(value, s, g, group)
        out = self.local_attn(q, k, v, *args, **kwargs)
        # inverse: scatter the sequence back, gather the heads
        return SeqAllToAll.apply(out.contiguous(), g, s, group)


def ulysses_attention(local_attn, q, k, v, *args, group=None, **kwargs):
    """Ulysses over ``group`` (the ``sp`` group by default): the JAX
    package's GSPMD form, here the same pair of all-to-alls as
    :class:`DistributedAttention`.  ``q, k, v`` [B, S_local, N, D]; the
    head count must divide by the group's size."""
    group = comm.get_sequence_parallel_group() if group is None else group
    if group.size() == 1:
        return local_attn(q, k, v, *args, **kwargs)
    return DistributedAttention(local_attn, group)(q, k, v, *args, **kwargs)
