"""GPT-NeoX / Pythia model family in PyTorch (counterpart of
``deeperspeed_tpu/models/gpt_neox.py``).

The NeoX computation: rotary embeddings over the first ``rotary_pct`` of
each head, the parallel attention + MLP residual, an untied output
embedding, LayerNorm (not RMS).  Module and parameter names follow the JAX
package's tree (``layers.{i}.attention.query_key_value`` for
``layers_{i}/attention/query_key_value``), and :func:`params_from_jax`
carries a flax parameter tree across.

As in flax, weights are created and kept in fp32 and each product runs in
``config.dtype``: a weight in another type is cast at its use (a no-op once
the serving engine or the training engine has cast it).  The input
embedding is looked up in its own type and the rows cast to
``config.dtype``, so under mixed-precision training its table and its
gradient stay fp32.

Two attention modes: the unpaged causal path (training, and a plain
forward over whole sequences), which goes through ``ops.attention.core``
(the flash kernels K5-K7 on the card), and the paged serving path, where
each layer reads and writes a [P, bs, N, D] KV pool pair that the inference
engine owns.  Serving attention is routed by the row bucket S, as in the
JAX package: S == 1 to the paged decode kernel, 2 <= S <= 8 to the
speculative-decode kernel, and longer rows to plain masked attention over
the gathered blocks.  A quantized pool (int8 / fp8) is written through
``quantize_kv`` with its per-(slot, head) scales beside it; the decode
kernels dequantize inside their token walk, the prefill path after its
gather.

The v1 engine's cached decode (``inference/engine.py``; the JAX model's
``decode`` mode): ``forward(..., cache=DecodeCache)`` writes each layer's
keys and values into the engine's dense [B, max_seq_len, N, D] buffers at
the cache's write index and attends under the buffer-index causal mask and
the caller's key-validity ``attention_mask`` over the buffer
(:func:`cached_attention`); the prefill and every single-token step go
through it alike.

Training (``loss_fn``) adds what the JAX package's training forward has:
hidden and attention dropout from an explicit ``torch.Generator``,
block-level recompute (``remat``, ``torch.utils.checkpoint``), progressive
layer drop, random-LTD on the middle blocks, and the chunked cross entropy
(``ce_chunk_tokens``).

Tensor parallelism (the training engine at ``tp`` > 1): the engine makes
the whole model tensor-parallel in place by :meth:`GPTNeoX.param_partition_rules`
(the JAX package's Megatron rules in torch's ``[out, in]`` layout,
``parallel/tensor_parallel.py``).  The fused ``query_key_value`` is laid
out per head (``[q | k | v]`` a head), so its column split gives each rank
whole heads and attention runs on ``num_heads / tp`` of them; the output
head is column-parallel over the vocabulary and both losses take the
vocabulary-parallel cross entropy.

Mixture-of-Experts (``moe_num_experts`` > 1): every
``moe_expert_interval``-th block's MLP is a :class:`~..moe.MoE` (the gate,
the stacked experts, Residual-MoE), named as the JAX tree nests it under
the block's ``moe``; training adds ``moe_aux_loss_coef`` times the mean of
the MoE blocks' ``l_aux`` to the loss.  The training engine keeps each
``ep`` rank's share of the experts and hands the layers their groups.
Under tensor parallelism the experts split as the JAX rules split them,
``P("ep", None, "tp")`` (column ``dense_h_to_4h``, row ``dense_4h_to_h``).
"""

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..accelerator import resolve_device
from ..moe import MoE
from ..moe.experts import Experts
from ..ops.attention import (dot_product_attention, paged_decode_attention,
                             paged_spec_decode_attention)
from ..ops.attention.core import keep_mask
from ..ops.quantizer import byte_view, dequantize_kv, quantize_kv
from ..ops.transformer import apply_rotary_pos_emb, layer_norm, rotary_tables
from ..parallel.tensor_parallel import (ColumnParallelLinear, RowParallelLinear,
                                        partition_dims, vocab_parallel_log_likelihood)
from ..quantization import canonical_dtype
from ..runtime.data_pipeline.data_routing.basic_layer import (
    random_ltd_gather, random_ltd_scatter, take_tokens)
from ..sequence import (DistributedAttention, gathered_keys, padded_attention, ring_attention,
                        sequence_group, sequence_positions)
from ..utils.recompute import checkpoint_replaying
from ..utils.tree import tree_sorted

# rows this short (S <= 8) walk only their live KV blocks in the paged
# (speculative-)decode kernels; longer rows take the dense prefill path.
# The engine's round buckets follow the same limit.
SPEC_DECODE_WINDOW = 8


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 2048
    rotary_pct: float = 0.25
    rotary_emb_base: int = 10000
    use_parallel_residual: bool = True
    layernorm_eps: float = 1e-5
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    dtype: torch.dtype = torch.float32
    remat: bool = False
    # chunked fused-linear cross entropy (0 = the monolithic loss)
    ce_chunk_tokens: int = 0
    # sequence parallelism over the sp mesh axis (``sequence/``):
    #   None      each rank's queries over the gathered keys and values
    #   "ulysses" all-to-all head-scatter / sequence-gather
    #   "ring"    blockwise ring attention (K/V passed around the sp ring)
    seq_parallel_mode: Optional[str] = None
    # μP width multiplier relative to a base width (for the mu-optimizers)
    mup_base_width: Optional[int] = None
    # MoE (0/1 experts = dense). MoE replaces the MLP on every
    # ``moe_expert_interval``-th block (layers 1, 3, ... for interval 2).
    moe_num_experts: int = 0
    moe_expert_interval: int = 2
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.0
    moe_eval_capacity_factor: float = 1.0
    moe_min_capacity: int = 4
    moe_use_residual: bool = False
    moe_noisy_gate_policy: Optional[str] = None
    moe_drop_tokens: bool = True
    moe_use_rts: bool = True
    moe_aux_loss_coef: float = 0.01
    # 1-byte tokens + per-block scales on the dispatch wire (set from the
    # runtime ``comm.quantized.moe_alltoall`` config key; dtype: int8 or
    # fp8 -> e4m3)
    moe_quantized_alltoall: bool = False
    moe_quantized_group_size: int = 128
    moe_quantized_alltoall_dtype: str = "int8"

    @property
    def has_moe(self):
        return self.moe_num_experts > 1

    def moe_layer_indices(self):
        return [i for i in range(self.num_layers)
                if self.has_moe and (i + 1) % self.moe_expert_interval == 0]

    def __post_init__(self):
        if self.seq_parallel_mode not in (None, "none", "ulysses", "ring"):
            raise ValueError(
                f"unknown seq_parallel_mode {self.seq_parallel_mode!r}; "
                f"expected None, 'ulysses' or 'ring'")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self):
        return 4 * self.hidden_size

    # ---- canonical family presets (EleutherAI Pythia / NeoX sizes)
    @staticmethod
    def pythia_160m(**kw):
        return GPTNeoXConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)

    @staticmethod
    def pythia_410m(**kw):
        return GPTNeoXConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def pythia_1_4b(**kw):
        return GPTNeoXConfig(hidden_size=2048, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def pythia_6_9b(**kw):
        return GPTNeoXConfig(hidden_size=4096, num_layers=32, num_heads=32, **kw)

    @staticmethod
    def neox_20b(**kw):
        return GPTNeoXConfig(hidden_size=6144, num_layers=44, num_heads=64,
                             vocab_size=50432, **kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 64)
        return GPTNeoXConfig(hidden_size=64, num_layers=2, num_heads=4, **kw)


@dataclasses.dataclass
class DecodeCache:
    """The v1 engine's dense KV cache, owned by the engine and passed to
    the model's forward (the JAX models' ``cache`` collection): per layer a
    (key, value) pair of [B, L, heads, D] buffers, at the KV heads the rank
    holds, and ``index``, the buffer column the next token lands in.  The
    model writes the buffers in place and advances ``index``."""

    layers: list
    index: int = 0

    @staticmethod
    def allocate(num_layers, batch, length, heads, head_dim, dtype, device):
        shape = (batch, length, heads, head_dim)
        return DecodeCache([(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device))
                            for _ in range(num_layers)])


def repeat_kv(t, rep):
    """[B, S, KV, D] -> [B, S, KV * rep, D], each KV head repeated for its
    ``rep`` query heads in turn (``jnp.repeat(t, rep, axis=2)``)."""
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


def cached_attention(q, k, v, cached, attention_mask=None, window=None):
    """The v1 cached decode of one layer: ``k`` and ``v`` [B, S, KV, D] land
    in ``cached = (key, value, index)``'s buffers at columns [index,
    index + S), then ``q`` attends over the buffer: column c is seen by the
    query at buffer column i when c <= i (and c > i - ``window``) and
    ``attention_mask`` [B, L] (key validity over the whole buffer) holds at
    c.  Columns from index + S on are masked for every query, so the
    attention runs over the written ones, [0, index + S), alone: the
    masked columns would take exactly zero weight."""
    ck, cv, index = cached
    S = q.shape[1]
    ck[:, index:index + S] = k
    cv[:, index:index + S] = v
    L = index + S
    ck, cv = ck[:, :L], cv[:, :L]
    if attention_mask is not None:
        attention_mask = attention_mask[:, :L]
    cols = torch.arange(L, device=q.device)
    q_pos = index + torch.arange(S, device=q.device)
    mask = cols[None, :] <= q_pos[:, None]
    if window is not None:
        mask = mask & (cols[None, :] > q_pos[:, None] - window)
    mask = mask[None, None]
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].to(torch.bool)
    rep = q.shape[2] // ck.shape[2]
    return dot_product_attention(q, repeat_kv(ck, rep), repeat_kv(cv, rep), mask=mask,
                                 causal=False)


def paged_writes(paged_state, positions, block_size):
    """The :class:`PagedState` of one forward: each real token's flat pool
    row from its block table and position."""
    tables = paged_state["block_tables"]
    slot = tables.long().gather(
        1, (positions // block_size).long().clamp(max=tables.shape[1] - 1))
    flat = (slot * block_size + positions % block_size).reshape(-1)
    src = paged_state["write_mask"].reshape(-1).nonzero().squeeze(1)
    return PagedState(tables, flat.index_select(0, src), src)


def write_pools(kv, k, v, paged):
    """Write the real tokens' ``k`` and ``v`` [B, S, H, D] into the pools of
    ``kv`` (quantize-on-write for a quantized pool); returns (pool_k,
    pool_v, k_scale, v_scale), the scales None for fp pools."""
    pool_k, pool_v, *scale_pools = kv
    k_scale, v_scale = scale_pools if scale_pools else (None, None)
    H, D = k.shape[2:]
    # in place: the JAX package donated the pools to the step and got
    # new ones back; here the engine's pools are mutated.  Padded tokens
    # are left out of src_rows, so neither payload nor scale of a padded
    # row ever lands in a live slot.
    for pool, scales, new in ((pool_k, k_scale, k), (pool_v, v_scale, v)):
        new = new.reshape(-1, H, D).index_select(0, paged.src_rows)
        if scales is not None:
            # quantize-on-write: the pool never holds fp values
            new, new_scale = quantize_kv(new, canonical_dtype(pool.dtype))
            scales.view(-1, H).index_copy_(0, paged.write_rows, new_scale)
        byte_view(pool).view(-1, H, D).index_copy_(0, paged.write_rows, byte_view(new))
    return pool_k, pool_v, k_scale, v_scale


def gathered_kv(pool_k, pool_v, k_scale, v_scale, tables, dtype):
    """K and V [B, M * bs, H, D] gathered from the pools by block table,
    dequantized to ``dtype`` from a quantized pool (the prefill path)."""
    B, H, D = tables.shape[0], pool_k.shape[2], pool_k.shape[3]
    idx = tables.long()
    K = byte_view(pool_k)[idx].view(pool_k.dtype).reshape(B, -1, H, D)
    V = byte_view(pool_v)[idx].view(pool_v.dtype).reshape(B, -1, H, D)
    if k_scale is not None:
        K = dequantize_kv(K, k_scale[idx].reshape(B, -1, H), dtype)
        V = dequantize_kv(V, v_scale[idx].reshape(B, -1, H), dtype)
    return K, V


@dataclasses.dataclass
class PagedState:
    """What the paged path needs for one forward, built once per forward by
    :meth:`GPTNeoX.forward` from the engine's ``paged_state``.

    ``write_rows`` are the flat pool rows ([P * bs] view) that the real
    tokens land in, and ``src_rows`` those tokens' indices in the flattened
    [B * S] batch; padded tokens are left out, so they are never written."""

    block_tables: torch.Tensor     # [B, max_blocks] int32
    write_rows: torch.Tensor       # [T] int64
    src_rows: torch.Tensor         # [T] int64


# the JAX package's tensor-parallel rules (``param_partition_rules``) in
# torch's names and ``[out, in]`` layout: the dim of each parameter split
# over ``tp`` (a flax ``P(None, "tp")`` on a Dense kernel [in, out] is dim 0
# of the torch weight); every other parameter is whole on every rank
TP_RULES = [
    (r"embed_in\.weight$", 0),
    (r"query_key_value\.(weight|bias)$", 0),
    (r"attention\.dense\.weight$", 1),
    # MoE's stacked experts [E, out, in]: the JAX P("ep", None, "tp") on
    # [E, in, out] (column dense_h_to_4h, row dense_4h_to_h, whose bias
    # stays whole); the leading expert dim is ep's
    (r"experts\.dense_h_to_4h\.(weight|bias)$", 1),
    (r"experts\.dense_4h_to_h\.weight$", 2),
    (r"experts\.dense_4h_to_h\.bias$", None),
    (r"dense_h_to_4h\.(weight|bias)$", 0),
    (r"dense_4h_to_h\.weight$", 1),
    (r"embed_out\.weight$", 0),
]


def _dense(lin, x, dtype):
    """``lin`` applied in ``dtype`` (flax ``Dense(dtype=...)`` promotion)."""
    if isinstance(lin, (ColumnParallelLinear, RowParallelLinear)):
        return lin(x, dtype)
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


class ModelLinear(nn.Linear):
    """``nn.Linear`` applied in ``config.dtype`` (the output head).  Called
    as a module, so an engine that gathers weights at their module's call
    (ZeRO stage 3) gathers it there."""

    def __init__(self, config, in_features, out_features, bias=True):
        super().__init__(in_features, out_features, bias=bias)
        self.config = config

    def forward(self, x, with_weight=None):
        """The head in ``config.dtype``; ``with_weight(x, weight)`` instead,
        for a loss that owns the product (the chunked cross entropy), so
        that an engine gathering the head's weight at this call (stage 3)
        gathers it around the loss."""
        if with_weight is not None:
            return with_weight(x, self.weight)
        return _dense(self, x, self.config.dtype)


class ModelLayerNorm(nn.Module):
    """LayerNorm over ``config.dtype`` activations with fp32 ``weight`` and
    ``bias`` (bf16 under mixed-precision training); kernels K1/K8 on a CUDA
    tensor (``ops/transformer/normalize.py``)."""

    def __init__(self, hidden, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=torch.float32))

    def forward(self, x):
        return layer_norm(x.to(self.dtype), self.weight, self.bias, eps=self.eps)


class GPTNeoXAttention(nn.Module):
    def __init__(self, config: GPTNeoXConfig):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.query_key_value = nn.Linear(H, 3 * H)
        self.dense = nn.Linear(H, H)
        # the sp group, where the engine runs the model sequence-parallel
        self.sp_group = None

    def forward(self, x, positions, kv=None, paged: Optional[PagedState] = None,
                rng=None, cached=None, attention_mask=None):
        """``cached`` (key, value, index): the v1 cached decode;
        ``attention_mask`` [B, S] (or [B, L] over the cache buffer) marks
        the valid keys."""
        cfg = self.config
        B, S, H = x.shape
        # per-head [q | k | v] layout, as the flax Dense output is reshaped
        # (num_heads / tp of them under tensor parallelism)
        qkv = _dense(self.query_key_value, x, cfg.dtype).view(
            B, S, -1, 3 * cfg.head_dim)
        q, k, v = qkv.split(cfg.head_dim, dim=-1)
        rot_dim = int(cfg.head_dim * cfg.rotary_pct)
        if rot_dim > 0:
            cos, sin = rotary_tables(positions, rot_dim, cfg.rotary_emb_base,
                                     q.dtype)
            q, k = apply_rotary_pos_emb(q, k, cos, sin)
        if paged is not None:
            out = self._paged_attention(q, k, v.contiguous(), positions, kv,
                                        paged)
        elif cached is not None:
            out = cached_attention(q, k, v, cached, attention_mask)
        else:
            out = self._causal_attention(q, k, v, rng, attention_mask)
        return _dense(self.dense, out.reshape(B, S, -1), cfg.dtype)

    def _causal_attention(self, q, k, v, rng, attention_mask):
        """Training and the plain forward: causal attention over this
        rank's tokens, by ``seq_parallel_mode`` (the JAX package's
        dispatch and refusals, at any ``sp``).  Training (an rng) with
        attention_dropout > 0 drops probabilities on the dense path, as in
        the JAX package."""
        cfg = self.config
        mode = cfg.seq_parallel_mode
        rate = cfg.attention_dropout if rng is not None else 0.0
        if mode == "ring" and rate > 0.0:
            raise NotImplementedError(
                "ring attention does not support attention_dropout; use "
                "seq_parallel_mode='ulysses' or hidden_dropout instead")
        if attention_mask is not None and mode in ("ulysses", "ring"):
            raise NotImplementedError(
                "attention_mask (padded batches) is not supported with "
                f"seq_parallel_mode={mode!r}; pad-free packed "
                "sequences are the supported long-context input format")
        group = sequence_group(self)
        if mode == "ulysses" and group is not None:
            return DistributedAttention(dot_product_attention, group)(
                q, k, v, causal=True, dropout_rate=rate, generator=rng)
        if mode == "ring":
            return ring_attention(q, k, v, group, causal=True)
        mask = None if attention_mask is None else attention_mask.to(torch.bool)
        if group is not None:
            k, v, mask, _ = gathered_keys(k, v, group, mask)
            if mask is None and rate == 0.0:
                return padded_attention(dot_product_attention, q, k, v)
        mask = None if mask is None else mask[:, None, None, :]
        return dot_product_attention(q, k, v, mask=mask, causal=True,
                                     dropout_rate=rate, generator=rng)

    def _paged_attention(self, q, k, v, positions, kv, paged):
        """Blocked KV-pool attention.  Writes happen before reads, so a token
        attends to itself; stale data in reallocated blocks is excluded by
        the position mask.  ``kv`` is (pool_k, pool_v), plus (k_scale,
        v_scale) [P, bs, N] fp32 when the pools are quantized."""
        pool_k, pool_v, k_scale, v_scale = write_pools(kv, k, v, paged)
        S = q.shape[1]
        tables = paged.block_tables
        if S == 1:
            out = paged_decode_attention(q[:, 0].contiguous(), pool_k, pool_v,
                                         tables, positions[:, 0] + 1,
                                         k_scale=k_scale, v_scale=v_scale)
            return out[:, None]
        if S <= SPEC_DECODE_WINDOW:
            return paged_spec_decode_attention(q.contiguous(), pool_k, pool_v,
                                               tables, positions,
                                               k_scale=k_scale, v_scale=v_scale)
        # prefill: plain masked attention over the gathered blocks
        K, V = gathered_kv(pool_k, pool_v, k_scale, v_scale, tables, q.dtype)
        kv_pos = torch.arange(K.shape[1], device=q.device)
        mask = kv_pos[None, None, None, :] <= positions[:, None, :, None]
        return dot_product_attention(q, K, V, mask=mask, causal=False)


class GPTNeoXMLP(nn.Module):
    def __init__(self, config: GPTNeoXConfig):
        super().__init__()
        self.config = config
        self.dense_h_to_4h = nn.Linear(config.hidden_size,
                                       config.intermediate_size)
        self.dense_4h_to_h = nn.Linear(config.intermediate_size,
                                       config.hidden_size)

    def forward(self, x):
        dt = self.config.dtype
        h = F.gelu(_dense(self.dense_h_to_4h, x, dt), approximate="tanh")
        return _dense(self.dense_4h_to_h, h, dt)


def _moe_layer(cfg):
    return MoE(cfg.hidden_size, num_experts=cfg.moe_num_experts,
               ffn_dim=cfg.intermediate_size, k=cfg.moe_top_k,
               capacity_factor=cfg.moe_capacity_factor,
               eval_capacity_factor=cfg.moe_eval_capacity_factor,
               min_capacity=cfg.moe_min_capacity, use_residual=cfg.moe_use_residual,
               noisy_gate_policy=cfg.moe_noisy_gate_policy,
               drop_tokens=cfg.moe_drop_tokens, use_rts=cfg.moe_use_rts, dtype=cfg.dtype,
               quantized_alltoall=cfg.moe_quantized_alltoall,
               quantized_group_size=cfg.moe_quantized_group_size,
               quantized_alltoall_dtype=cfg.moe_quantized_alltoall_dtype)


class GPTNeoXBlock(nn.Module):
    def __init__(self, config: GPTNeoXConfig, use_moe=False):
        super().__init__()
        self.config = config
        eps = config.layernorm_eps
        self.input_layernorm = ModelLayerNorm(config.hidden_size, eps,
                                              config.dtype)
        self.post_attention_layernorm = ModelLayerNorm(config.hidden_size, eps,
                                                       config.dtype)
        self.attention = GPTNeoXAttention(config)
        if use_moe:
            self.moe = _moe_layer(config)
        else:
            self.mlp = GPTNeoXMLP(config)

    def sync_moe(self):
        """The MoE layer's transport and compute type from ``config``."""
        moe, cfg = getattr(self, "moe", None), self.config
        if moe is not None:
            moe.quantized_alltoall = cfg.moe_quantized_alltoall
            moe.quantized_group_size = cfg.moe_quantized_group_size
            moe.quantized_alltoall_dtype = cfg.moe_quantized_alltoall_dtype
            moe.set_dtype(cfg.dtype)

    def _mlp(self, h, rng, moe_aux):
        if not hasattr(self, "moe"):
            return self.mlp(h)
        out, l_aux, _ = self.moe(h, train=rng is not None, rng=rng)
        if moe_aux is not None:
            moe_aux.append(l_aux.to(torch.float32))
        return out

    def forward(self, x, positions, kv=None, paged=None, rng=None, cached=None,
                attention_mask=None, moe_aux=None):
        """``rng`` (a ``torch.Generator``, training only) draws the
        attention and hidden dropout masks and the MoE gate's draws (and
        puts the gate in training capacity); None is deterministic.  An MoE
        block appends its ``l_aux`` to the list ``moe_aux``."""
        cfg = self.config
        attn_out = self.attention(self.input_layernorm(x), positions, kv, paged,
                                  rng, cached, attention_mask)
        if cfg.use_parallel_residual:
            mlp_out = self._mlp(self.post_attention_layernorm(x), rng, moe_aux)
            x = x + attn_out + mlp_out
        else:
            x = x + attn_out
            x = x + self._mlp(self.post_attention_layernorm(x), rng, moe_aux)
        if cfg.hidden_dropout > 0.0 and rng is not None:
            # on the whole residual stream after the adds (flax nn.Dropout:
            # x / keep where kept, else 0)
            keep = keep_mask(x.shape, cfg.hidden_dropout, rng, x.device)
            x = torch.where(keep, x / (1.0 - cfg.hidden_dropout),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return x


def _drawable(t, gen):
    """``t``, or for a parameter left on ``meta`` (another pipeline stage's)
    a scratch tensor of its shape on ``gen``'s device, which the draw fills
    and drops: ``gen`` moves on as in the whole model's draw, and no more
    than one such tensor is ever held."""
    return torch.empty(t.shape, dtype=t.dtype, device=gen.device) if t.is_meta else t


def _remat_block(blk, x, positions, rng, moe_aux=None):
    """``blk(x, positions, rng=rng)`` whose activations are recomputed in
    the backward pass (the JAX package's ``nn.remat`` of the block), the
    dropout masks drawn from ``rng`` replayed exactly."""
    return checkpoint_replaying(lambda x_in: blk(x_in, positions, rng=rng, moe_aux=moe_aux),
                                x, rng=rng)


class GPTNeoX(nn.Module):
    """Causal LM: tokens [B, S] -> logits [B, S, V] (or [B, R, V] at
    ``logits_positions``).

    Weights are drawn from ``seed`` with an explicit ``torch.Generator`` on
    the CPU, in fp32, and then moved to ``device`` (CUDA unless the caller
    passes ``device="cpu"``), so one seed gives the same model on every
    device.  ``draw_on_device`` draws them on the card instead, from a CUDA
    generator (fast for a full-size model; another draw than the CPU's, as
    for the Llama family).  They stay fp32 until an engine casts them; the
    products run in ``config.dtype`` either way.  ``device="meta"`` builds
    the module without weights (a pipeline stage draws its own part)."""

    def __init__(self, config: GPTNeoXConfig, device=None, seed=0, draw_on_device=False):
        super().__init__()
        meta = str(device) == "meta"
        device = torch.device("meta") if meta else resolve_device(device)
        on_card = draw_on_device and device.type == "cuda"
        self.config = config
        # the sp group, where the engine runs the model sequence-parallel:
        # the forward then takes this rank's slice of every sequence
        self.sp_group = None
        with torch.device("meta") if on_card or meta else contextlib.nullcontext():
            self.embed_in = nn.Embedding(config.vocab_size, config.hidden_size)
            moe_layers = set(config.moe_layer_indices())
            self.layers = nn.ModuleList(GPTNeoXBlock(config, use_moe=i in moe_layers)
                                        for i in range(config.num_layers))
            self.final_layer_norm = ModelLayerNorm(config.hidden_size,
                                                   config.layernorm_eps,
                                                   config.dtype)
            self.embed_out = ModelLinear(config, config.hidden_size, config.vocab_size,
                                         bias=False)
        if meta:
            return
        if on_card:
            self.to_empty(device=device)
            self._init_weights(torch.Generator(device=device).manual_seed(seed))
        else:
            self._init_weights(torch.Generator().manual_seed(seed))
            self.to(device)

    @torch.no_grad()
    def _init_weights(self, gen):
        """Flax's defaults, every parameter written (the card's draw starts
        from uninitialised memory): Dense kernels lecun-normal (truncated at
        two standard deviations), biases zero, LayerNorm scales one, the
        embedding N(0, 1/H).  A parameter left on ``meta`` is drawn and
        dropped (:func:`_drawable`)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = (1.0 / math.sqrt(mod.in_features)) / .87962566103423978
                nn.init.trunc_normal_(_drawable(mod.weight, gen), 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, ModelLayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        nn.init.normal_(_drawable(self.embed_in.weight, gen), 0.0,
                        1.0 / math.sqrt(self.config.hidden_size), generator=gen)
        for mod in self.modules():
            if isinstance(mod, Experts):
                mod.reset_parameters(gen)

    def set_dtype(self, dtype):
        """Cast every weight but the LayerNorms' to ``dtype`` and make it
        the compute type of the products and of the KV pools (serving)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding, Experts)):
                mod.to(dtype)
        self.replace_config(dtype=dtype)
        for mod in self.modules():
            if isinstance(mod, ModelLayerNorm):
                mod.dtype = dtype
        return self

    def replace_config(self, **changes):
        """Give this model and each of its blocks ``config`` with
        ``changes`` (the engine turns ``remat`` on this way)."""
        self.config = dataclasses.replace(self.config, **changes)
        for mod in self.modules():
            if hasattr(mod, "config"):
                mod.config = self.config
        for blk in self.layers:
            blk.sync_moe()
        return self

    def forward(self, input_ids, positions=None, paged_state=None,
                logits_positions=None, rng=None, pld_theta=None,
                random_ltd_tokens=None, return_hidden=False, pld_rng=None,
                attention_mask=None, cache=None, moe_aux=None):
        """``paged_state`` (serving) carries ``kv_cache`` (per layer (pool_k,
        pool_v), or (pool_k, pool_v, k_scale, v_scale) for quantized pools,
        updated in place), ``block_tables`` [B, M]
        int32 and ``write_mask`` [B, S] bool.  ``logits_positions`` [B] or
        [B, R] projects only those positions of each row through the head.

        Training passes ``rng``, a ``torch.Generator`` on the model's
        device: it draws the dropout masks, and with ``pld_theta`` (progressive
        layer drop: block i > 0 survives with probability
        1 - (i+1)/L (1 - theta), one draw a block from ``pld_rng`` -- a
        generator seeded alike on every rank, so that every rank drops the
        same blocks -- or from ``rng`` without it) and ``random_ltd_tokens``
        k (random-LTD: the middle blocks see a sorted random k-subset of
        each row, at its own positions) their draws too.  Without ``rng`` the forward is
        deterministic and those arguments are ignored.  ``return_hidden``
        returns the final LayerNorm's output (the chunked loss owns the
        head).

        ``attention_mask`` [B, S] (0/1) masks keys as well as the causal
        mask; with ``cache`` (a :class:`DecodeCache`, the v1 engine) it is
        [B, L] over the cache buffer and the forward is the cached decode
        of ``input_ids`` at the cache's write index, which it advances.
        ``moe_aux``, a list, receives each MoE block's ``l_aux`` (the
        training forward's).  Bound to an ``sp`` group of ``p`` ranks, the
        forward takes slice ``r`` of every sequence, whose tokens sit at the
        global positions ``[r S, (r + 1) S)`` (the default ``positions``)."""
        B, S = input_ids.shape
        if positions is None:
            positions = sequence_positions(self, B, S, input_ids.device)
        # lookup in the table's type (fp32 in training), then the compute type
        x = self.embed_in(input_ids).to(self.config.dtype)
        paged, kv_cache = None, [None] * len(self.layers)
        if paged_state is not None:
            kv_cache = paged_state["kv_cache"]
            paged = paged_writes(paged_state, positions, kv_cache[0][0].shape[1])
        L = len(self.layers)
        remat = self.config.remat and paged is None and torch.is_grad_enabled()
        for i, (blk, kv) in enumerate(zip(self.layers, kv_cache)):
            if paged is not None:
                x = blk(x, positions, kv, paged)
                continue
            if cache is not None:
                x = blk(x, positions, cached=(*cache.layers[i], cache.index),
                        attention_mask=attention_mask)
                continue
            x_in, pos_in, idx = x, positions, None
            if (rng is not None and random_ltd_tokens is not None
                    and 0 < random_ltd_tokens < S and 0 < i < L - 1):
                x_in, idx = random_ltd_gather(x, random_ltd_tokens, rng)
                pos_in = take_tokens(positions, idx)
            y = (_remat_block(blk, x_in, pos_in, rng, moe_aux) if remat
                 else blk(x_in, pos_in, rng=rng, attention_mask=attention_mask,
                          moe_aux=moe_aux))
            if idx is not None:
                y = random_ltd_scatter(x, y, idx)
            if rng is not None and pld_theta is not None and i > 0:
                keep_p = 1.0 - ((i + 1) / L) * (1.0 - pld_theta)
                coin = pld_rng if pld_rng is not None else rng
                keep = torch.rand((), generator=coin, device=coin.device).to(x.device) < keep_p
                y = torch.where(keep, y, x)
            x = y
        if cache is not None:
            cache.index += S
        x = self.final_layer_norm(x)
        if return_hidden:
            return x
        if logits_positions is not None:
            lp = logits_positions.long()
            if lp.dim() == 1:
                lp = lp[:, None]
            x = torch.gather(x, 1, lp[..., None].expand(-1, -1, x.shape[-1]))
        return self.embed_out(x)

    # ------------------------------------------------------------ engine API
    def example_batch(self, batch_size=2, seq_len=None, seed=0):
        """Random tokens from a numpy generator: ``input_ids`` and the
        next-token ``labels``, int64 [batch_size, seq_len] on the CPU."""
        seq = seq_len or min(self.config.max_seq_len, 128)
        toks = np.random.default_rng(seed).integers(
            0, self.config.vocab_size, (batch_size, seq + 1))
        toks = torch.from_numpy(toks)
        return {"input_ids": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}

    def loss_fn(self):
        """``loss(model, batch, rng=None) -> fp32 scalar``: mean next-token
        cross entropy over the tokens where ``batch["loss_mask"]`` (default
        all) is set, as logsumexp minus the gold logit over fp32 logits.

        ``rng`` (the engine's ``torch.Generator`` in training, None in
        evaluation) makes the forward stochastic: dropout, and the
        progressive layer drop and random-LTD draws when the engine passes
        ``batch["pld_theta"]`` and ``random_ltd_tokens``.  ``deterministic``
        overrides (the JAX package's ``_apply_setup``).  With
        ``ce_chunk_tokens`` > 0 the loss is the chunked one (see
        :func:`_chunked_ce`), which refuses MoE as the JAX package does.
        With MoE the loss adds ``moe_aux_loss_coef`` times the mean of the
        MoE blocks' ``l_aux``."""
        cfg = self.config
        if cfg.ce_chunk_tokens > 0 and cfg.has_moe:
            # the JAX package's refusal, in its words
            raise NotImplementedError(
                "ce_chunk_tokens with MoE is not supported yet: the chunked path "
                "bypasses the aux-loss collection")

        def setup(batch, rng, deterministic, random_ltd_tokens):
            if deterministic is None:
                deterministic = rng is None
            return {"rng": None if deterministic else rng,
                    "pld_theta": batch.get("pld_theta"),
                    "pld_rng": batch.get("pld_rng"),
                    "random_ltd_tokens": random_ltd_tokens}

        def loss(model, batch, rng=None, deterministic=None, random_ltd_tokens=None):
            kwargs = setup(batch, rng, deterministic, random_ltd_tokens)
            moe_aux = [] if cfg.has_moe else None
            logits = model(batch["input_ids"], moe_aux=moe_aux, **kwargs).to(torch.float32)
            head = model.embed_out
            if isinstance(head, ColumnParallelLinear):
                token_ll = vocab_parallel_log_likelihood(logits, batch["labels"],
                                                         head.group, head.out_start)
            else:
                lse = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
                token_ll = gold - lse
            mask = batch.get("loss_mask")
            mask = torch.ones_like(token_ll) if mask is None else mask.to(token_ll.dtype)
            ce = -(token_ll * mask).sum() / mask.sum().clamp(min=1.0)
            if moe_aux:
                # the MoE blocks' load-balancing losses (the JAX "losses" sow)
                ce = ce + cfg.moe_aux_loss_coef * sum(moe_aux) / len(moe_aux)
            return ce

        def loss_chunked(model, batch, rng=None, deterministic=None,
                         random_ltd_tokens=None):
            kwargs = setup(batch, rng, deterministic, random_ltd_tokens)
            hidden = model(batch["input_ids"], return_hidden=True, **kwargs)
            head, cfg = model.embed_out, model.config
            tp = ((head.group, head.out_start) if isinstance(head, ColumnParallelLinear)
                  else None)
            # through the head's call, so that stage 3 gathers its weight
            return head(hidden, with_weight=lambda h, w: _chunked_ce(
                h, w, batch["labels"], batch.get("loss_mask"), cfg.ce_chunk_tokens,
                cfg.dtype, tp))

        return loss_chunked if cfg.ce_chunk_tokens > 0 else loss

    def to_reference_tree(self, state_dict):
        """Checkpoints: the JAX package's parameter tree of ``state_dict``
        (or of a per-parameter optimizer tree), :func:`params_to_jax`."""
        return params_to_jax(state_dict)

    def from_reference_tree(self, tree):
        """Checkpoints: the inverse of :meth:`to_reference_tree`."""
        return params_from_jax(tree)

    def param_partition_rules(self):
        """The tensor-parallel split of each parameter: ``(regex over the
        parameter's name, dim of the torch weight)`` pairs (:data:`TP_RULES`);
        a parameter no rule names is whole on every rank."""
        return list(TP_RULES)

    def no_cast_paths(self):
        """Parameter names (regexes) that stay fp32 under mixed precision:
        the embedding table, whose gradient accumulates by scatter-add."""
        return [r"embed_in\.weight"]

    def mup_multipliers(self):
        """1/width_mult on hidden-to-hidden matrices (μP), 1.0 elsewhere;
        None without ``mup_base_width``."""
        cfg = self.config
        if cfg.mup_base_width is None:
            return None
        width_mult = cfg.hidden_size / cfg.mup_base_width
        return {name: 1.0 if ("embed_in" in name or "embed_out" in name
                              or p.dim() < 2) else 1.0 / width_mult
                for name, p in self.named_parameters()}

    def flops_per_token(self):
        """Analytic fwd+bwd FLOPs per token (6N_active + attention term);
        the input embedding, a gather, is left out of N_active."""
        cfg = self.config
        n_params = self.num_params() - cfg.vocab_size * cfg.hidden_size
        if cfg.has_moe:
            # only top-k experts run per token
            f = cfg.intermediate_size
            mlp = 2 * cfg.hidden_size * f + f + cfg.hidden_size
            inactive = (cfg.moe_num_experts - cfg.moe_top_k) * mlp
            n_params -= len(cfg.moe_layer_indices()) * inactive
        attn = 12 * cfg.num_layers * cfg.hidden_size * cfg.max_seq_len
        return 6 * n_params + attn

    def num_params(self):
        """The JAX model's count: every expert, the gates and the residual
        branches included."""
        cfg = self.config
        h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
        f = cfg.intermediate_size
        mlp = 2 * h * f + f + h
        attn = 3 * h * h + 3 * h + h * h + h  # qkv + out proj
        lns = 4 * h
        n_moe = len(cfg.moe_layer_indices())
        total = v * h + (L - n_moe) * (attn + mlp + lns) + 2 * h + v * h
        if n_moe:
            moe_mlp = cfg.moe_num_experts * mlp + h * cfg.moe_num_experts  # experts + wg
            if cfg.moe_use_residual:
                moe_mlp += mlp + 2 * h + 2  # dense branch + coefficient
            total += n_moe * (attn + moe_mlp + lns)
        return total

    def moe_layers(self):
        """The MoE layers, in block order."""
        return [blk.moe for blk in self.layers if hasattr(blk, "moe")]


def _ce_chunk(xc, w, labels, mask, dtype, tp=None):
    """Sum over one chunk of (gold - logsumexp) * mask, logits in fp32
    (over the vocabulary split ``tp = (group, start)``: the rank's slice)."""
    logits = F.linear(xc.to(dtype), w.to(dtype)).to(torch.float32)
    if tp is not None:
        return (vocab_parallel_log_likelihood(logits, labels, *tp) * mask).sum()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return ((gold - lse) * mask).sum()


def _chunked_ce(hidden, w, labels, mask, chunk_tokens, dtype, tp=None):
    """The chunked fused-linear cross entropy (``loss_chunked`` of the JAX
    package): the [T, H] hidden states (T = B S, padded with zero rows to a
    multiple of C = min(``chunk_tokens``, T), labels and mask padded with
    zeros) go through the head C tokens at a time, each chunk's [C, V]
    logits in fp32; the loss is -(sum of the chunks' sums) / max(mask sum,
    1), both sums in fp32.  Each chunk runs under ``torch.utils.checkpoint``,
    which keeps only its inputs ([C, H]) for the backward and recomputes its
    logits there, so no [T, V] logits are ever live.  ``tp = (group,
    start)``: ``w`` is the rank's rows of a vocabulary-parallel head and
    each chunk takes the vocabulary-parallel cross entropy (the hidden
    states arrive through the head's input copy)."""
    B, S, H = hidden.shape
    T = B * S
    C = min(chunk_tokens, T)
    n_chunks = -(-T // C)
    pad = n_chunks * C - T
    x = hidden.reshape(T, H)
    labels = labels.reshape(-1)
    mask = (torch.ones(T, dtype=torch.float32, device=hidden.device) if mask is None
            else mask.reshape(-1).to(torch.float32))
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    num = den = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * C, (c + 1) * C)
        num = num + checkpoint(_ce_chunk, x[sl], w, labels[sl], mask[sl], dtype, tp,
                               use_reentrant=False, preserve_rng_state=False)
        den = den + mask[sl].sum()
    return -num / den.clamp(min=1.0)


def params_from_jax(tree, tp_rank=0, tp_size=1, ep_rank=0, ep_size=1) -> dict:
    """A state dict for :class:`GPTNeoX` from a flax parameter tree given as
    nested dicts of numpy arrays (``jax.device_get(params)``); needs no JAX.

    Names follow ``checkpoint/reference_universal.py`` ``gpt_neox_param_map``
    of the JAX package; each ``Dense`` kernel [in, out] is transposed into
    ``nn.Linear.weight`` [out, in] (a stacked expert kernel [E, in, out]
    into [E, out, in]).  Raises if a leaf of ``tree`` is left unmapped.
    With ``tp_size`` > 1 each parameter :data:`TP_RULES` splits is rank
    ``tp_rank``'s slice of it, as the engine shards the model over ``tp``;
    with ``ep_size`` > 1 each stacked expert parameter is rank
    ``ep_rank``'s experts, as the engine keeps them."""
    used = set()

    def leaf(path, transpose=False):
        node = tree
        for key in path.split("/"):
            node = node[key]
        used.add(path)
        a = np.asarray(node, np.float32)
        return torch.from_numpy(np.array(np.swapaxes(a, -1, -2) if transpose else a,
                                         order="C"))

    layer_ids = sorted(int(k.split("_")[1]) for k in tree
                       if k.startswith("layers_"))
    sd = {"embed_in.weight": leaf("embed_in/embedding")}
    for i in layer_ids:
        src, dst = f"layers_{i}", f"layers.{i}"
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{dst}.{ln}.weight"] = leaf(f"{src}/{ln}/scale")
            sd[f"{dst}.{ln}.bias"] = leaf(f"{src}/{ln}/bias")
        moe = "moe" in tree[src]
        if moe:
            sd[f"{dst}.moe.gate.wg.weight"] = leaf(f"{src}/moe/gate/wg/kernel", True)
            for lin in ("experts/dense_h_to_4h", "experts/dense_4h_to_h"):
                for kind, transpose in (("weight", True), ("bias", False)):
                    t = leaf(f"{src}/moe/{lin}/{'kernel' if transpose else 'bias'}",
                             transpose)
                    sd[f"{dst}.moe.{lin.replace('/', '.')}.{kind}"] = (
                        t.chunk(ep_size, 0)[ep_rank].contiguous())
        linears = ["attention/query_key_value", "attention/dense"]
        mlp = "moe/mlp" if moe else "mlp"
        if not moe or "mlp" in tree[src]["moe"]:
            linears += [f"{mlp}/dense_h_to_4h", f"{mlp}/dense_4h_to_h"]
        if moe and "coefficient" in tree[src]["moe"]:
            linears.append("moe/coefficient")
        for lin in linears:
            name = lin.replace("/", ".")
            sd[f"{dst}.{name}.weight"] = leaf(f"{src}/{lin}/kernel", True)
            sd[f"{dst}.{name}.bias"] = leaf(f"{src}/{lin}/bias")
    sd["final_layer_norm.weight"] = leaf("final_layer_norm/scale")
    sd["final_layer_norm.bias"] = leaf("final_layer_norm/bias")
    sd["embed_out.weight"] = leaf("embed_out/kernel", True)

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            yield prefix

    unmapped = sorted(set(walk(tree, "")) - used)
    if unmapped:
        raise ValueError(f"params_from_jax: unmapped leaves {unmapped[:8]}")
    if tp_size > 1:
        for name, dim in partition_dims(list(sd), TP_RULES).items():
            sd[name] = sd[name].chunk(tp_size, dim)[tp_rank].contiguous()
    return sd


def join_tensor_parallel(shards) -> dict:
    """The whole state dict (or per-parameter tree) from the ``tp`` ranks'
    dicts in rank order: each parameter :data:`TP_RULES` splits
    concatenated along its dim, the others taken from rank 0."""
    dims = partition_dims(list(shards[0]), TP_RULES)
    return {name: (torch.cat([s[name] for s in shards], dims[name]) if name in dims
                   else value) for name, value in shards[0].items()}


_LINEARS = ("attention.query_key_value", "attention.dense", "mlp.dense_h_to_4h",
            "mlp.dense_4h_to_h", "moe.mlp.dense_h_to_4h", "moe.mlp.dense_4h_to_h",
            "moe.coefficient", "moe.gate.wg")
_EXPERTS = ("moe.experts.dense_h_to_4h", "moe.experts.dense_4h_to_h")


def params_to_jax(state_dict) -> dict:
    """The flax parameter tree of a :class:`GPTNeoX` state dict: the exact
    inverse of :func:`params_from_jax`, each ``nn.Linear.weight`` [out, in]
    transposed back to a ``Dense`` kernel [in, out] (a view), keys sorted.
    Works on any dict keyed by parameter name (an optimizer's moments too).
    A list of dicts is the ``tp`` ranks' slices, in rank order
    (:func:`join_tensor_parallel`).  Raises on a name it does not map."""
    if isinstance(state_dict, (list, tuple)):
        state_dict = join_tensor_parallel(state_dict)
    tree = {}

    def put(path, value):
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value

    for name, value in state_dict.items():
        parts = name.split(".")
        if name == "embed_in.weight":
            put("embed_in/embedding", value)
        elif name == "embed_out.weight":
            put("embed_out/kernel", value.t())
        elif parts[0] == "final_layer_norm" and len(parts) == 2:
            put(f"final_layer_norm/{'scale' if parts[1] == 'weight' else 'bias'}", value)
        elif parts[0] == "layers" and len(parts) >= 4:
            src, rest, leaf = f"layers_{int(parts[1])}", ".".join(parts[2:-1]), parts[-1]
            if rest in ("input_layernorm", "post_attention_layernorm"):
                put(f"{src}/{rest}/{'scale' if leaf == 'weight' else 'bias'}", value)
            elif rest in _LINEARS and leaf == "weight":
                put(f"{src}/{rest.replace('.', '/')}/kernel", value.t())
            elif rest in _LINEARS and leaf == "bias":
                put(f"{src}/{rest.replace('.', '/')}/bias", value)
            elif rest in _EXPERTS and leaf == "weight":
                put(f"{src}/{rest.replace('.', '/')}/kernel", value.transpose(-1, -2))
            elif rest in _EXPERTS and leaf == "bias":
                put(f"{src}/{rest.replace('.', '/')}/bias", value)
            else:
                raise ValueError(f"params_to_jax: unmapped parameter {name!r}")
        else:
            raise ValueError(f"params_to_jax: unmapped parameter {name!r}")
    return tree_sorted(tree)


def _stacked_layers(stages, stage_id, num_stages=None):
    """``{"layers_<j>": ...}``, stage ``stage_id``'s blocks (local index
    ``j``) of a pipe tree's stacked ``stages`` (leaves ``[n_stages,
    layers_per_stage, ...]``), the model cut into ``num_stages`` (by
    default the tree's own)."""
    saved_stages, saved_lps = next(iter(_leaves_of(stages))).shape[:2]
    total = saved_stages * saved_lps
    num_stages = num_stages or saved_stages
    if total % num_stages:
        raise ValueError(f"{total} layers not divisible by {num_stages} stages")
    lps = total // num_stages

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return np.asarray(node)[i // saved_lps, i % saved_lps]

    return {f"layers_{j}": pick(stages, stage_id * lps + j) for j in range(lps)}


def _stack_stage_trees(per_stage):
    """The pipe tree's ``stages``: per stage ``{"layers_<j>": block tree}``,
    stacked into leaves ``[n_stages, layers_per_stage, ...]``."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack([torch.as_tensor(np.asarray(n)) if not isinstance(n, torch.Tensor)
                            else n for n in nodes])

    lps = len(per_stage[0])
    rows = [stack([tree[f"layers_{j}"] for j in range(lps)]) for tree in per_stage]
    return tree_sorted(stack(rows))


def pipe_params_from_jax(tree, stage_id, num_stages=None, tp_rank=0, tp_size=1) -> dict:
    """Stage ``stage_id``'s state dict for ``GPTNeoXPipe`` from the JAX
    ``GPTNeoXPipe``'s ``{embed, stages, head}`` tree (nested dicts of numpy
    arrays): its blocks as ``layers.<j>`` (local index), ``embed_in`` on the
    first stage, ``final_layer_norm`` and ``embed_out`` on the last.  The
    model is cut into ``num_stages`` (by default the tree's own), so a tree
    saved at one ``pp`` loads at another; with ``tp_size`` > 1 each
    parameter :data:`TP_RULES` splits is tp rank ``tp_rank``'s slice of it,
    as the pipeline engine splits a stage (:func:`params_from_jax`)."""
    n_stages = num_stages or next(iter(_leaves_of(tree["stages"]))).shape[0]
    flat = {**tree["embed"], **tree["head"],
            **_stacked_layers(tree["stages"], stage_id, n_stages)}
    sd = params_from_jax(flat, tp_rank=tp_rank, tp_size=tp_size)
    if stage_id != 0:
        del sd["embed_in.weight"]
    if stage_id != n_stages - 1:
        for n in ("final_layer_norm.weight", "final_layer_norm.bias", "embed_out.weight"):
            del sd[n]
    return sd


def pipe_params_to_jax(stage_dicts) -> dict:
    """The JAX ``GPTNeoXPipe``'s ``{embed, stages, head}`` tree from every
    stage's state dict (or per-parameter tree), in stage order: the exact
    inverse of :func:`pipe_params_from_jax`.  A stage's entry may be a list
    of its tp ranks' dicts in rank order (:func:`join_tensor_parallel`)."""
    trees = [params_to_jax(sd) for sd in stage_dicts]
    first, last = trees[0], trees[-1]
    return {"embed": {"embed_in": first["embed_in"]},
            "head": {"final_layer_norm": last["final_layer_norm"],
                     "embed_out": last["embed_out"]},
            "stages": _stack_stage_trees(
                [{k: v for k, v in t.items() if k.startswith("layers_")} for t in trees])}


def _leaves_of(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves_of(v)
    else:
        yield np.asarray(node)
