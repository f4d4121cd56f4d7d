"""Gating and the sharded MoE layer (counterpart of
``deeperspeed_tpu/moe/sharded_moe.py``).

The gating math is the JAX package's, term for term: ``_capacity``, the
noisy gates (``multiplicative_jitter``, ``gumbel_rsample``), Random Token
Selection, ``top1gating`` and ``top2gating`` with first choices placed
before second choices.  Every draw comes from a ``torch.Generator`` (the
engine's, in training), or is handed in as a tensor (``noise``,
``gumbel``, ``priority``), so that a test can give the functions the JAX
package's own draws.  Sorts are stable, as ``jnp.argsort`` is.

Routing is global over the data-parallel batch, as it is under GSPMD in the
JAX package, where ``tokens`` is every data rank's rows.  Over several
processes each rank holds its rows of the microbatch (the data index order
of the engine's batch group; under sequence parallelism its slice of
their sequences, and the sequence-order priority follows each token's
index in the batch's global row-major order) and the gate runs on them;
then:

1. each token's routing record (its chosen experts and its priority) and
   the rank's column sums of the gate probabilities are all-gathered over
   the batch group, a few bytes a token;
2. every rank computes the global capacity, ``locations``, the kept set,
   ``exp_counts`` and ``l_aux`` from the records alone, alike on every
   rank.  ``l_aux``'s backward flows through the local gates only, scaled
   by the batch group's size, so that the engine's mean of the ranks'
   gradients is the gradient of the global ``l_aux``;
3. only the rank's own kept tokens move, over the ``ep`` group, to the
   peer that holds their experts (an all-to-all of variable counts, every
   count known to every rank from the records), and the expert outputs
   come back the same way.

A token's expert output depends only on its own row, so the experts do not
run on the JAX package's global ``[E, C, M]`` buffer.  Padding: each local
expert's buffer holds the kept tokens its ``ep`` group sends it, in token
order, padded with zero rows to the count of the fullest local expert; the
padded rows' outputs are never read.  The combine adds each kept choice's
output, times its gate weight in the compute type, into its token's row;
a dropped token gets zeros, as the JAX combine gives it.

The quantized transport (``quantized_alltoall``, the config's
``comm.quantized.moe_alltoall``) quantizes the dispatched rows to a
``BlockScaledTensor`` (int8, or e4m3 under ``fp8``, in groups of
``quantized_group_size`` along the row) before the all-to-all, which moves
the 1-byte values and the fp32 scales, and dequantizes them to the compute
type where they arrive; at ``ep`` 1 too, as the JAX layer does without a
mesh.  The groups lie along a row, so per-row quantization equals the JAX
package's quantization of the whole ``[E, C, M]`` tensor, and its gradient
is the same function's (the scales carry it, as in JAX).
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import comm

# uniform noise width for RSample/Jitter noisy gating (reference
# ``sharded_moe.py:54`` multiplicative_jitter epsilon=1e-2)
_JITTER_EPS = 1e-2
_F32_EPS = float(torch.finfo(torch.float32).eps)
_F32_TINY = float(torch.finfo(torch.float32).tiny)

# bytes staged by the dispatch and combine all-to-alls (host memory under
# gloo on CUDA): the comm facade's STAGED counts them under this op name
A2A_OP = "moe_all_to_all"


def _capacity(num_tokens, num_experts, capacity_factor, min_capacity):
    cap = int(-(-num_tokens * capacity_factor // num_experts))  # ceil
    return max(cap, min_capacity)


def _uniform(shape, rng, device, low=0.0, high=1.0):
    u = torch.rand(shape, generator=rng, device=rng.device, dtype=torch.float32)
    return (u * (high - low) + low).to(device)


def multiplicative_jitter(x, rng=None, epsilon=_JITTER_EPS, noise=None):
    """x * U(1-eps, 1+eps) -- reference ``sharded_moe.py:54``; ``noise``
    is a given draw of that uniform."""
    if epsilon == 0 or (rng is None and noise is None):
        return x
    if noise is None:
        noise = _uniform(x.shape, rng, x.device, 1.0 - epsilon, 1.0 + epsilon)
    return x * noise.to(x.dtype)


def gumbel_rsample(shape, rng, device=None):
    """Standard Gumbel noise, fp32: -log(-log(U)), U in [tiny, 1)."""
    u = _uniform(shape, rng, device or rng.device).clamp_min(_F32_TINY)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass
class GateOutput:
    """One gating decision in compact form: per token (rows ``[S]``, this
    rank's) and choice (columns ``[k]``) the ``expert``, its ``location``
    in the expert's capacity buffer, whether it was ``kept`` and its
    combine ``weight`` (fp32, zero where dropped); ``l_aux`` the scalar
    load-balancing loss and ``exp_counts`` [E] the tokens routed to each
    expert before drops, both global.  :attr:`combine_weights` and
    :attr:`dispatch_mask` are the JAX package's dense [S, E, C] forms."""

    l_aux: torch.Tensor
    expert: torch.Tensor        # [S, k] int64
    location: torch.Tensor      # [S, k] int64
    kept: torch.Tensor          # [S, k] bool
    weight: torch.Tensor        # [S, k] fp32
    exp_counts: torch.Tensor    # [E] int32
    capacity: int
    num_experts: int
    # the routing over the batch group's tokens, for the transport:
    # [N, k] expert and kept of every token of the group, and this rank's
    # first token's index in them
    all_expert: Optional[torch.Tensor] = None
    all_kept: Optional[torch.Tensor] = None
    offset: int = 0

    @property
    def combine_weights(self):
        S, k = self.expert.shape
        out = torch.zeros(S, self.num_experts, self.capacity, dtype=torch.float32,
                          device=self.expert.device)
        for j in range(k):
            rows = self.kept[:, j].nonzero().squeeze(1)
            out[rows, self.expert[rows, j], self.location[rows, j]] += self.weight[rows, j]
        return out

    @property
    def dispatch_mask(self):
        return self.combine_weights.to(torch.bool)


def _assign_capacity(mask, priority, capacity):
    """Position of each routed token in its expert's capacity buffer.

    mask: [S, E] one-hot routing (0/1); priority: [S] (lower keeps its
    slot first).  Returns (locations [S, E] int64, kept [S, E] bool):
    tokens whose position reaches ``capacity`` are dropped."""
    order = torch.argsort(priority, dim=0, stable=True)
    mask = mask.to(torch.int64)
    sorted_mask = mask.index_select(0, order)
    loc_sorted = torch.cumsum(sorted_mask, 0) - sorted_mask
    locations = torch.empty_like(loc_sorted).index_copy_(0, order, loc_sorted)
    return locations, mask.to(torch.bool) & (locations < capacity)


def _batch_size(group):
    return 1 if group is None else group.size()


def _gather_records(group, records, gate_sums):
    """All-gather each rank's [S, r] ``records`` (fp64) and [E] fp64
    ``gate_sums`` over ``group``: ([N, r] in data-index order, [E] their
    sum in rank order, alike on every rank)."""
    if _batch_size(group) == 1:
        return records, gate_sums
    S, r = records.shape
    flat = torch.cat([records.reshape(-1), gate_sums])
    rows = comm.all_gather(flat, group=group, tiled=False, log_name="moe_routing")
    return rows[:, :S * r].reshape(-1, r), rows[:, S * r:].sum(0)


def _global_me(gates, group, total, gate_sums):
    """mean(gates, 0) over the batch group's tokens: the value is the
    global mean, the gradient flows through this rank's gates, times the
    group's size (the engine averages the ranks' gradients)."""
    if _batch_size(group) == 1:
        return gates.mean(0)
    n = group.size()
    local = gates.sum(0) * n
    return (local - (local - gate_sums.to(local.dtype)).detach()) / total


def _with_order(records, order):
    """``records`` with the tokens' global order as a last column."""
    return records if order is None else torch.cat([records, order[:, None]], 1)


def _sequence_order(records, order, n):
    """The gathered tokens' priority by sequence order: their global index
    (the last column) where ``order`` was given, else their gathered
    position."""
    if order is not None:
        return records[:, -1].to(torch.float32)
    return torch.arange(n, dtype=torch.float32, device=records.device)


def top1gating(logits, capacity_factor=1.0, min_capacity=8, used_token=None,
               noisy_gate_policy=None, drop_tokens=True, use_rts=True, rng=None,
               capacity=None, gumbel=None, priority=None, group=None,
               order=None) -> GateOutput:
    """Top-1 gating (reference ``sharded_moe.py:184``).

    logits: [S, E] fp32, this rank's tokens; ``group`` the batch group over
    whose tokens the routing is global (None: one process).
    ``used_token``: optional [S] 0/1 mask of non-padding tokens.  Draws:
    ``gumbel`` [S, E] (RSample) and ``priority`` [S] (Random Token
    Selection) are given or drawn from ``rng``, RSample's first.
    ``order`` [S] (fp64): each token's index in the global row-major order
    of the batch, where the batch group's data-index order is not it (the
    tokens of a sequence's slices under ``sp``); the sequence-order
    priority follows it."""
    S, E = logits.shape
    n = _batch_size(group)
    N = S * n
    offset = (group.rank() if n > 1 else 0) * S
    if capacity is None:
        capacity = _capacity(N, E, capacity_factor, min_capacity) if drop_tokens else N
    gates = torch.softmax(logits, dim=1)

    # RSample: add gumbel noise to the *selection* only (reference :205)
    select_logits = logits
    if noisy_gate_policy == "RSample" and (gumbel is not None or rng is not None):
        if gumbel is None:
            gumbel = gumbel_rsample(logits.shape, rng, logits.device)
        select_logits = logits + gumbel
    indices1 = torch.argmax(select_logits, dim=1)
    used = (torch.ones(S, dtype=torch.float64, device=logits.device) if used_token is None
            else used_token.to(torch.float64))
    # capacity assignment priority: Random Token Selection (uniform noise)
    # or sequence order (reference :236-256)
    rts = use_rts and (priority is not None or rng is not None)
    if rts and priority is None:
        priority = _uniform((S,), rng, logits.device)
    prio = (priority.to(torch.float64) if rts else
            torch.zeros(S, dtype=torch.float64, device=logits.device))
    records, gate_sums = _gather_records(
        group, _with_order(torch.stack([indices1.to(torch.float64), used, prio], 1), order),
        gates.detach().sum(0).to(torch.float64))
    all_idx = records[:, 0].to(torch.int64)
    mask1 = F.one_hot(all_idx, E).to(torch.float32) * records[:, 1:2].to(torch.float32)
    exp_counts = mask1.sum(0).to(torch.int32)

    # load-balancing loss (reference :228): E * mean(gates) . mean(mask)
    me = _global_me(gates, group, N, gate_sums)
    ce = mask1.mean(0)
    l_aux = torch.sum(me * ce) * E

    all_prio = (records[:, 2].to(torch.float32) if rts else
                _sequence_order(records, order, N))
    locations1, kept1 = _assign_capacity(mask1, all_prio, capacity)
    loc = (locations1 * kept1).sum(1)
    kept = kept1.any(1)
    mine = slice(offset, offset + S)
    weight = torch.where(kept[mine], gates.gather(1, indices1[:, None])[:, 0],
                         torch.zeros((), dtype=gates.dtype, device=gates.device))
    return GateOutput(l_aux, indices1[:, None], loc[mine, None], kept[mine, None],
                      weight[:, None], exp_counts, capacity, E,
                      all_idx[:, None], kept[:, None], offset)


def top2gating(logits, capacity_factor=1.0, min_capacity=8, drop_tokens=True, rng=None,
               capacity=None, top2_2nd_expert_sampling=True, gumbel=None,
               group=None, order=None) -> GateOutput:
    """Top-2 gating (reference ``sharded_moe.py:282``): ``gumbel`` [S, E]
    the second choice's noise, given or drawn from ``rng``; ``order`` as
    in :func:`top1gating`."""
    S, E = logits.shape
    n = _batch_size(group)
    N = S * n
    offset = (group.rank() if n > 1 else 0) * S
    if capacity is None:
        capacity = _capacity(N, E, 2 * capacity_factor, min_capacity) if drop_tokens else N
    gates = torch.softmax(logits, dim=1)
    indices1 = torch.argmax(gates, dim=1)
    logits_w_noise = logits
    if top2_2nd_expert_sampling and (gumbel is not None or rng is not None):
        if gumbel is None:
            gumbel = gumbel_rsample(logits.shape, rng, logits.device)
        logits_w_noise = logits + gumbel
    first = F.one_hot(indices1, E).to(torch.bool)
    logits_except1 = logits_w_noise.masked_fill(first, float("-inf"))
    indices2 = torch.argmax(logits_except1, dim=1)

    records, gate_sums = _gather_records(
        group, _with_order(torch.stack([indices1, indices2], 1).to(torch.float64), order),
        gates.detach().sum(0).to(torch.float64))
    all_idx = records[:, :2].to(torch.int64)
    mask1 = F.one_hot(all_idx[:, 0], E).to(torch.float32)
    mask2 = F.one_hot(all_idx[:, 1], E).to(torch.float32)
    # routed-pre-drop counts, matching top1gating / GateOutput semantics
    exp_counts = (mask1 + mask2).sum(0).to(torch.int32)

    me = _global_me(gates, group, N, gate_sums)
    ce = mask1.mean(0)
    l_aux = torch.sum(me * ce) * E

    # capacity: first-choice tokens get priority over second-choice
    # (reference offsets locations2 by the PRE-clip mask1 expert counts)
    prio = _sequence_order(records, order, N)
    counts1 = mask1.sum(0, keepdim=True).to(torch.int64)
    locations1, kept1 = _assign_capacity(mask1, prio, capacity)
    locations2, _ = _assign_capacity(mask2, prio, capacity)
    locations2 = locations2 + counts1
    kept2 = mask2.to(torch.bool) & (locations2 < capacity)
    loc = torch.stack([(locations1 * kept1).sum(1), (locations2 * kept2).sum(1)], 1)
    kept = torch.stack([kept1.any(1), kept2.any(1)], 1)

    mine = slice(offset, offset + S)
    zero = torch.zeros((), dtype=gates.dtype, device=gates.device)
    g1 = torch.where(kept[mine, 0], gates.gather(1, indices1[:, None])[:, 0], zero)
    g2 = torch.where(kept[mine, 1], gates.gather(1, indices2[:, None])[:, 0], zero)
    denom = torch.clamp(g1 + g2, min=_F32_EPS)
    weight = torch.stack([g1 / denom, g2 / denom], 1)
    return GateOutput(l_aux, torch.stack([indices1, indices2], 1), loc[mine], kept[mine],
                      weight, exp_counts, capacity, E, all_idx, kept, offset)


class TopKGate(nn.Module):
    """Gate network (reference ``TopKGate``, ``sharded_moe.py:348``): an
    fp32 linear ``wg`` ([E, H], no bias) projecting to expert logits, and
    the top-k gating function.  Under mixed precision the engine's
    compute copy of ``wg`` is cast like any other weight; the product runs
    in fp32 on the fp32 input, as the JAX gate's ``Dense(dtype=fp32)``
    promotes its kernel."""

    def __init__(self, hidden_size, num_experts, k=1, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=8, noisy_gate_policy=None,
                 drop_tokens=True, use_rts=True):
        super().__init__()
        if k not in (1, 2):
            raise ValueError("only top-1 / top-2 gating supported")
        self.wg = nn.Linear(hidden_size, num_experts, bias=False)
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens, self.use_rts = drop_tokens, use_rts

    def forward(self, x, used_token=None, train=True, rng=None, group=None, order=None):
        """``x`` [S, H] this rank's tokens; ``rng`` the training generator
        (draws: Jitter's noise first, then the gating function's), None
        draws nothing; ``group`` the batch group routing is global over,
        ``order`` the tokens' global order (:func:`top1gating`)."""
        x32 = x.to(torch.float32)
        if self.noisy_gate_policy == "Jitter" and train and rng is not None:
            x32 = multiplicative_jitter(x32, rng)
        logits = F.linear(x32, self.wg.weight.to(torch.float32))
        draw = rng if train else None
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(logits, cf, self.min_capacity, used_token,
                              self.noisy_gate_policy if train else None,
                              self.drop_tokens, self.use_rts, draw, group=group,
                              order=order)
        return top2gating(logits, cf, self.min_capacity, self.drop_tokens, draw,
                          group=group, order=order)


class _AllToAllV(torch.autograd.Function):
    """Rows to the ``ep`` peers (``send`` counts out, ``recv`` counts in);
    the backward sends the gradients back the other way."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return comm.all_to_all_v(x, send, recv, group=group, log_name=A2A_OP)

    @staticmethod
    def backward(ctx, grad):
        return (comm.all_to_all_v(grad.contiguous(), ctx.recv, ctx.send, group=ctx.group,
                                  log_name=A2A_OP), None, None, None)


def _exchange(x, group, send, recv):
    if group is None or group.size() == 1:
        return x
    return _AllToAllV.apply(x, group, send, recv)


@dataclasses.dataclass
class Transport:
    """Where each kept (token, choice) pair goes, computed alike on every
    rank of an ``ep`` group from the routing records: this rank's pairs in
    send order (``token``, ``choice``), the rows it sends each peer and
    receives from each, each received row's place in the [E_local * C_pad]
    expert buffer, and ``c_pad``."""

    token: torch.Tensor
    choice: torch.Tensor
    send: list
    recv: list
    slot: torch.Tensor
    c_pad: int


def plan_transport(gate: GateOutput, tokens_per_rank, ep_size, ep_rank, num_local,
                   peers=None):
    """The :class:`Transport` of ``gate`` for this rank, the ``ep_rank``-th
    of an ``ep`` group of ``ep_size`` ranks: ``peers`` their indices in the
    batch group, by default consecutive (this rank's among them; under
    ``sp`` they are ``sp`` apart)."""
    S, k = tokens_per_rank, gate.all_expert.shape[1]
    if peers is None:
        first = gate.offset - ep_rank * S
        span = slice(first, first + ep_size * S)
    else:
        span = (torch.tensor(peers, device=gate.all_expert.device)[:, None] * S
                + torch.arange(S, device=gate.all_expert.device)).reshape(-1)
    expert = gate.all_expert[span].reshape(-1)
    kept = gate.all_kept[span].reshape(-1)
    pair = kept.nonzero().squeeze(1)               # (token, choice) in token order
    e = expert.index_select(0, pair)
    e_sorted, order = torch.sort(e, stable=True)   # by expert, then token order
    pair, e = pair.index_select(0, order), e_sorted
    src = torch.div(pair, S * k, rounding_mode="floor")
    dst = torch.div(e, num_local, rounding_mode="floor")
    counts = torch.bincount(e, minlength=gate.num_experts)
    starts = torch.cumsum(counts, 0) - counts
    slot_in_expert = torch.arange(len(pair), device=pair.device) - starts.index_select(0, e)
    mine_out = (src == ep_rank).nonzero().squeeze(1)
    local = dst == ep_rank
    # received rows arrive by source, then in send order (expert, token)
    into = local.nonzero().squeeze(1)
    into = into.index_select(0, torch.sort(src.index_select(0, into), stable=True)[1])
    lo = ep_rank * num_local
    c_pad = max(int(counts[lo:lo + num_local].max()), 1) if num_local else 1
    slot = (e.index_select(0, into) - lo) * c_pad + slot_in_expert.index_select(0, into)
    sent = pair.index_select(0, mine_out) - ep_rank * S * k
    send = torch.bincount(dst.index_select(0, mine_out), minlength=ep_size).tolist()
    recv = torch.bincount(src.index_select(0, into), minlength=ep_size).tolist()
    return Transport(torch.div(sent, k, rounding_mode="floor"), sent % k, send, recv, slot,
                     c_pad)


class MOELayer(nn.Module):
    """Gate -> dispatch -> experts -> combine (reference ``MOELayer:425``).

    ``experts`` maps [E_local, C, M] -> [E_local, C, M] with its parameters
    stacked on the leading expert dim (``experts.Experts``).  The engine
    hands the layer its groups (:meth:`set_groups`): the batch group its
    routing is global over and the ``ep`` group its experts are spread
    over; without them it routes and computes on one process."""

    def __init__(self, gate, experts, quantized_alltoall=False, quantized_group_size=128,
                 quantized_alltoall_dtype="int8"):
        super().__init__()
        self.gate = gate
        self.experts = experts
        self.quantized_alltoall = quantized_alltoall
        self.quantized_group_size = quantized_group_size
        self.quantized_alltoall_dtype = quantized_alltoall_dtype
        self.batch_group = None
        self.ep_group = None
        self.sp_group = None
        self.last_gate = None

    def set_groups(self, batch_group, ep_group, sp_group=None):
        """``sp_group``: where the batch group spans sequence slices (the
        engine's ``sp`` axis), the group of this rank's slices."""
        self.batch_group, self.ep_group, self.sp_group = batch_group, ep_group, sp_group

    def _token_order(self, shape, device):
        """Under ``sp`` > 1 the global row-major index of each of this
        rank's tokens ``[R, S_local]`` (rows ``b R + i`` of its row slice
        ``b``, columns ``t S_local + j`` of its sequence slice ``t``); None
        where the batch group's data-index order is the global order."""
        sp = self.sp_group
        if sp is None or sp.size() == 1:
            return None
        p, t = sp.size(), sp.rank()
        R, S = shape[0], shape[1]
        rows = (self.batch_group.rank() // p) * R + torch.arange(R, device=device)
        cols = t * S + torch.arange(S, device=device)
        return (rows[:, None] * (S * p) + cols[None, :]).reshape(-1).to(torch.float64)

    def _ep_peers(self):
        """The ``ep`` group's members' indices in the batch group (None:
        consecutive, as without ``sp``)."""
        sp, ep = self.sp_group, self.ep_group
        if sp is None or sp.size() == 1 or ep is None or ep.size() == 1:
            return None
        return [self.batch_group.ranks.index(r) for r in ep.ranks]

    def _dispatch_transport(self, rows, dtype, send=(), recv=()):
        """The dispatched rows as the experts receive them, moved over the
        ``ep`` group (``send`` / ``recv`` rows a peer).  Under the quantized
        transport the sender quantizes them and the 1-byte values and fp32
        scales move, dequantized to ``dtype`` where they arrive."""
        if not self.quantized_alltoall:
            return _exchange(rows, self.ep_group, send, recv)
        from ..quantization import BlockScaledTensor

        t = BlockScaledTensor.quantize(rows, self.quantized_alltoall_dtype,
                                       self.quantized_group_size)
        return BlockScaledTensor(_exchange(t.values, self.ep_group, send, recv),
                                 _exchange(t.scales, self.ep_group, send, recv),
                                 t.group_size).dequantize(dtype)

    def forward(self, x, used_token=None, train=True, rng=None):
        """x: [..., M] this rank's tokens; returns (out [..., M], l_aux,
        exp_counts)."""
        shape, M = x.shape, x.shape[-1]
        tokens = x.reshape(-1, M)
        gate = self.gate(tokens, used_token=used_token, train=train, rng=rng,
                         group=self.batch_group, order=self._token_order(shape, x.device))
        # the last routing, for reports (exp_counts, the kept share, l_aux)
        self.last_gate = dataclasses.replace(gate, l_aux=gate.l_aux.detach(),
                                             weight=gate.weight.detach())
        ep = self.ep_group.size() if self.ep_group is not None else 1
        ep_rank = self.ep_group.rank() if ep > 1 else 0
        plan = plan_transport(gate, tokens.shape[0], ep, ep_rank, self.experts.num_local,
                              self._ep_peers())
        rows = self._dispatch_transport(tokens.index_select(0, plan.token), x.dtype,
                                        plan.send, plan.recv)
        buf = rows.new_zeros((self.experts.num_local * plan.c_pad, M))
        buf = buf.index_copy(0, plan.slot, rows)
        y = self.experts(buf.view(self.experts.num_local, plan.c_pad, M))
        y = y.reshape(-1, M).index_select(0, plan.slot)
        y = _exchange(y, self.ep_group, plan.recv, plan.send)
        w = gate.weight[plan.token, plan.choice].to(y.dtype)
        out = y.new_zeros((tokens.shape[0], M)).index_add(0, plan.token, y * w[:, None])
        return out.reshape(shape), gate.l_aux, gate.exp_counts
