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

Training (``loss_fn``) adds what the JAX package's training forward has:
hidden and attention dropout from an explicit ``torch.Generator``,
block-level recompute (``remat``, ``torch.utils.checkpoint``), progressive
layer drop, random-LTD on the middle blocks, and the chunked cross entropy
(``ce_chunk_tokens``).

Not ported yet (construction raises, naming the ROADMAP item): MoE layers,
sequence parallelism.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..accelerator import resolve_device
from ..ops.attention import (dot_product_attention, paged_decode_attention,
                             paged_spec_decode_attention)
from ..ops.attention.core import keep_mask
from ..ops.quantizer import byte_view, dequantize_kv, quantize_kv
from ..ops.transformer import apply_rotary_pos_emb, layer_norm, rotary_tables
from ..quantization import canonical_dtype
from ..runtime.data_pipeline.data_routing.basic_layer import (
    random_ltd_gather, random_ltd_scatter, take_tokens)
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
    # μP width multiplier relative to a base width (for the mu-optimizers)
    mup_base_width: Optional[int] = None
    moe_num_experts: int = 0

    def __post_init__(self):
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
class PagedState:
    """What the paged path needs for one forward, built once per forward by
    :meth:`GPTNeoX.forward` from the engine's ``paged_state``.

    ``write_rows`` are the flat pool rows ([P * bs] view) that the real
    tokens land in, and ``src_rows`` those tokens' indices in the flattened
    [B * S] batch; padded tokens are left out, so they are never written."""

    block_tables: torch.Tensor     # [B, max_blocks] int32
    write_rows: torch.Tensor       # [T] int64
    src_rows: torch.Tensor         # [T] int64


def _dense(lin, x, dtype):
    """``lin`` applied in ``dtype`` (flax ``Dense(dtype=...)`` promotion)."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


class ModelLinear(nn.Linear):
    """``nn.Linear`` applied in ``config.dtype`` (the output head).  Called
    as a module, so an engine that gathers weights at their module's call
    (ZeRO stage 3) gathers it there."""

    def __init__(self, config, in_features, out_features, bias=True):
        super().__init__(in_features, out_features, bias=bias)
        self.config = config

    def forward(self, x):
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

    def forward(self, x, positions, kv=None, paged: Optional[PagedState] = None,
                rng=None):
        cfg = self.config
        B, S, H = x.shape
        # per-head [q | k | v] layout, as the flax Dense output is reshaped
        qkv = _dense(self.query_key_value, x, cfg.dtype).view(
            B, S, cfg.num_heads, 3 * cfg.head_dim)
        q, k, v = qkv.split(cfg.head_dim, dim=-1)
        rot_dim = int(cfg.head_dim * cfg.rotary_pct)
        if rot_dim > 0:
            cos, sin = rotary_tables(positions, rot_dim, cfg.rotary_emb_base,
                                     q.dtype)
            q, k = apply_rotary_pos_emb(q, k, cos, sin)
        if paged is not None:
            out = self._paged_attention(q, k, v.contiguous(), positions, kv,
                                        paged)
        else:
            # training (an rng) with attention_dropout > 0 takes the dense
            # path with dropout on the probabilities, as in the JAX package
            rate = cfg.attention_dropout if rng is not None else 0.0
            out = dot_product_attention(q, k, v, causal=True, dropout_rate=rate,
                                        generator=rng)
        return _dense(self.dense, out.reshape(B, S, H), cfg.dtype)

    def _paged_attention(self, q, k, v, positions, kv, paged):
        """Blocked KV-pool attention.  Writes happen before reads, so a token
        attends to itself; stale data in reallocated blocks is excluded by
        the position mask.  ``kv`` is (pool_k, pool_v), plus (k_scale,
        v_scale) [P, bs, N] fp32 when the pools are quantized."""
        pool_k, pool_v, *scale_pools = kv
        k_scale, v_scale = scale_pools if scale_pools else (None, None)
        B, S, N, D = q.shape
        # in place: the JAX package donated the pools to the step and got
        # new ones back; here the engine's pools are mutated.  Padded tokens
        # are left out of src_rows, so neither payload nor scale of a padded
        # row ever lands in a live slot.
        for pool, scales, new in ((pool_k, k_scale, k), (pool_v, v_scale, v)):
            new = new.reshape(-1, N, D).index_select(0, paged.src_rows)
            if scales is not None:
                # quantize-on-write: the pool never holds fp values
                new, new_scale = quantize_kv(new, canonical_dtype(pool.dtype))
                scales.view(-1, N).index_copy_(0, paged.write_rows, new_scale)
            byte_view(pool).view(-1, N, D).index_copy_(
                0, paged.write_rows, byte_view(new))
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
        idx = tables.long()
        K = byte_view(pool_k)[idx].view(pool_k.dtype).reshape(B, -1, N, D)
        V = byte_view(pool_v)[idx].view(pool_v.dtype).reshape(B, -1, N, D)
        if k_scale is not None:
            K = dequantize_kv(K, k_scale[idx].reshape(B, -1, N), q.dtype)
            V = dequantize_kv(V, v_scale[idx].reshape(B, -1, N), q.dtype)
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


class GPTNeoXBlock(nn.Module):
    def __init__(self, config: GPTNeoXConfig):
        super().__init__()
        self.config = config
        eps = config.layernorm_eps
        self.input_layernorm = ModelLayerNorm(config.hidden_size, eps,
                                              config.dtype)
        self.post_attention_layernorm = ModelLayerNorm(config.hidden_size, eps,
                                                       config.dtype)
        self.attention = GPTNeoXAttention(config)
        self.mlp = GPTNeoXMLP(config)

    def forward(self, x, positions, kv=None, paged=None, rng=None):
        """``rng`` (a ``torch.Generator``, training only) draws the
        attention and hidden dropout masks; None is deterministic."""
        cfg = self.config
        attn_out = self.attention(self.input_layernorm(x), positions, kv, paged,
                                  rng)
        if cfg.use_parallel_residual:
            mlp_out = self.mlp(self.post_attention_layernorm(x))
            x = x + attn_out + mlp_out
        else:
            x = x + attn_out
            x = x + self.mlp(self.post_attention_layernorm(x))
        if cfg.hidden_dropout > 0.0 and rng is not None:
            # on the whole residual stream after the adds (flax nn.Dropout:
            # x / keep where kept, else 0)
            keep = keep_mask(x.shape, cfg.hidden_dropout, rng, x.device)
            x = torch.where(keep, x / (1.0 - cfg.hidden_dropout),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return x


def _remat_block(blk, x, positions, rng):
    """``blk(x, positions, rng=rng)`` whose activations are recomputed in
    the backward pass (the JAX package's ``nn.remat`` of the block), the
    dropout masks drawn from ``rng`` replayed exactly."""
    return checkpoint_replaying(lambda x_in: blk(x_in, positions, rng=rng), x, rng=rng)


def _not_ported(config):
    """The first configuration feature the port does not run yet, or None."""
    if config.moe_num_experts > 1:
        return "MoE layers (ROADMAP Queue A, 'Llama/Mistral, v1 inference and MoE')"
    return None


class GPTNeoX(nn.Module):
    """Causal LM: tokens [B, S] -> logits [B, S, V] (or [B, R, V] at
    ``logits_positions``).

    Weights are drawn from ``seed`` with an explicit ``torch.Generator`` on
    the CPU, in fp32, and then moved to ``device`` (CUDA unless the caller
    passes ``device="cpu"``), so one seed gives the same model on every
    device.  They stay fp32 until an engine casts them; the products run in
    ``config.dtype`` either way."""

    def __init__(self, config: GPTNeoXConfig, device=None, seed=0):
        super().__init__()
        missing = _not_ported(config)
        if missing is not None:
            raise NotImplementedError(f"GPTNeoX: {missing} is not ported yet")
        device = resolve_device(device)
        self.config = config
        self.embed_in = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(GPTNeoXBlock(config)
                                    for _ in range(config.num_layers))
        self.final_layer_norm = ModelLayerNorm(config.hidden_size,
                                               config.layernorm_eps,
                                               config.dtype)
        self.embed_out = ModelLinear(config, config.hidden_size, config.vocab_size,
                                     bias=False)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, gen):
        """Flax's defaults: Dense kernels lecun-normal (truncated at two
        standard deviations), biases zero, the embedding N(0, 1/H)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = (1.0 / math.sqrt(mod.in_features)) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
        nn.init.normal_(self.embed_in.weight, 0.0,
                        1.0 / math.sqrt(self.config.hidden_size), generator=gen)

    def set_dtype(self, dtype):
        """Cast every weight but the LayerNorms' to ``dtype`` and make it
        the compute type of the products and of the KV pools (serving)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
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
        return self

    def _paged_writes(self, paged_state, positions, block_size):
        tables = paged_state["block_tables"]
        slot = tables.long().gather(
            1, (positions // block_size).long().clamp(max=tables.shape[1] - 1))
        flat = (slot * block_size + positions % block_size).reshape(-1)
        src = paged_state["write_mask"].reshape(-1).nonzero().squeeze(1)
        return PagedState(tables, flat.index_select(0, src), src)

    def forward(self, input_ids, positions=None, paged_state=None,
                logits_positions=None, rng=None, pld_theta=None,
                random_ltd_tokens=None, return_hidden=False):
        """``paged_state`` (serving) carries ``kv_cache`` (per layer (pool_k,
        pool_v), or (pool_k, pool_v, k_scale, v_scale) for quantized pools,
        updated in place), ``block_tables`` [B, M]
        int32 and ``write_mask`` [B, S] bool.  ``logits_positions`` [B] or
        [B, R] projects only those positions of each row through the head.

        Training passes ``rng``, a ``torch.Generator`` on the model's
        device: it draws the dropout masks, and with ``pld_theta`` (progressive
        layer drop: block i > 0 survives with probability
        1 - (i+1)/L (1 - theta)) and ``random_ltd_tokens`` k (random-LTD: the
        middle blocks see a sorted random k-subset of each row, at its own
        positions) their draws too.  Without ``rng`` the forward is
        deterministic and those arguments are ignored.  ``return_hidden``
        returns the final LayerNorm's output (the chunked loss owns the
        head)."""
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, device=input_ids.device).expand(B, S)
        # lookup in the table's type (fp32 in training), then the compute type
        x = self.embed_in(input_ids).to(self.config.dtype)
        paged, kv_cache = None, [None] * len(self.layers)
        if paged_state is not None:
            kv_cache = paged_state["kv_cache"]
            paged = self._paged_writes(paged_state, positions,
                                       kv_cache[0][0].shape[1])
        L = len(self.layers)
        remat = self.config.remat and paged is None and torch.is_grad_enabled()
        for i, (blk, kv) in enumerate(zip(self.layers, kv_cache)):
            if paged is not None:
                x = blk(x, positions, kv, paged)
                continue
            x_in, pos_in, idx = x, positions, None
            if (rng is not None and random_ltd_tokens is not None
                    and 0 < random_ltd_tokens < S and 0 < i < L - 1):
                x_in, idx = random_ltd_gather(x, random_ltd_tokens, rng)
                pos_in = take_tokens(positions, idx)
            y = (_remat_block(blk, x_in, pos_in, rng) if remat
                 else blk(x_in, pos_in, rng=rng))
            if idx is not None:
                y = random_ltd_scatter(x, y, idx)
            if rng is not None and pld_theta is not None and i > 0:
                keep_p = 1.0 - ((i + 1) / L) * (1.0 - pld_theta)
                keep = torch.rand((), generator=rng, device=x.device) < keep_p
                y = torch.where(keep, y, x)
            x = y
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
        :func:`_chunked_ce`)."""
        cfg = self.config
        if cfg.ce_chunk_tokens > 0 and cfg.moe_num_experts > 1:
            raise NotImplementedError(
                "ce_chunk_tokens with MoE is not ported yet: the chunked path "
                "bypasses the aux-loss collection (ROADMAP Queue A, "
                "'Llama/Mistral, v1 inference and MoE')")

        def setup(batch, rng, deterministic, random_ltd_tokens):
            if deterministic is None:
                deterministic = rng is None
            return {"rng": None if deterministic else rng,
                    "pld_theta": batch.get("pld_theta"),
                    "random_ltd_tokens": random_ltd_tokens}

        def loss(model, batch, rng=None, deterministic=None, random_ltd_tokens=None):
            kwargs = setup(batch, rng, deterministic, random_ltd_tokens)
            logits = model(batch["input_ids"], **kwargs).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
            token_ll = gold - lse
            mask = batch.get("loss_mask")
            mask = torch.ones_like(token_ll) if mask is None else mask.to(token_ll.dtype)
            return -(token_ll * mask).sum() / mask.sum().clamp(min=1.0)

        def loss_chunked(model, batch, rng=None, deterministic=None,
                         random_ltd_tokens=None):
            kwargs = setup(batch, rng, deterministic, random_ltd_tokens)
            hidden = model(batch["input_ids"], return_hidden=True, **kwargs)
            return _chunked_ce(hidden, model.embed_out.weight, batch["labels"],
                               batch.get("loss_mask"), model.config.ce_chunk_tokens,
                               model.config.dtype)

        return loss_chunked if cfg.ce_chunk_tokens > 0 else loss

    def to_reference_tree(self, state_dict):
        """Checkpoints: the JAX package's parameter tree of ``state_dict``
        (or of a per-parameter optimizer tree), :func:`params_to_jax`."""
        return params_to_jax(state_dict)

    def from_reference_tree(self, tree):
        """Checkpoints: the inverse of :meth:`to_reference_tree`."""
        return params_from_jax(tree)

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
        attn = 12 * cfg.num_layers * cfg.hidden_size * cfg.max_seq_len
        return 6 * n_params + attn

    def num_params(self):
        cfg = self.config
        h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
        f = cfg.intermediate_size
        mlp = 2 * h * f + f + h
        attn = 3 * h * h + 3 * h + h * h + h  # qkv + out proj
        lns = 4 * h
        return v * h + L * (attn + mlp + lns) + 2 * h + v * h


def _ce_chunk(xc, w, labels, mask, dtype):
    """Sum over one chunk of (gold - logsumexp) * mask, logits in fp32."""
    logits = F.linear(xc.to(dtype), w.to(dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return ((gold - lse) * mask).sum()


def _chunked_ce(hidden, w, labels, mask, chunk_tokens, dtype):
    """The chunked fused-linear cross entropy (``loss_chunked`` of the JAX
    package): the [T, H] hidden states (T = B S, padded with zero rows to a
    multiple of C = min(``chunk_tokens``, T), labels and mask padded with
    zeros) go through the head C tokens at a time, each chunk's [C, V]
    logits in fp32; the loss is -(sum of the chunks' sums) / max(mask sum,
    1), both sums in fp32.  Each chunk runs under ``torch.utils.checkpoint``,
    which keeps only its inputs ([C, H]) for the backward and recomputes its
    logits there, so no [T, V] logits are ever live."""
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
        num = num + checkpoint(_ce_chunk, x[sl], w, labels[sl], mask[sl], dtype,
                               use_reentrant=False, preserve_rng_state=False)
        den = den + mask[sl].sum()
    return -num / den.clamp(min=1.0)


def params_from_jax(tree) -> dict:
    """A state dict for :class:`GPTNeoX` from a flax parameter tree given as
    nested dicts of numpy arrays (``jax.device_get(params)``); needs no JAX.

    Names follow ``checkpoint/reference_universal.py`` ``gpt_neox_param_map``
    of the JAX package; each ``Dense`` kernel [in, out] is transposed into
    ``nn.Linear.weight`` [out, in].  Raises if a leaf of ``tree`` is left
    unmapped (MoE experts, for one, are not ported)."""
    used = set()

    def leaf(path, transpose=False):
        node = tree
        for key in path.split("/"):
            node = node[key]
        used.add(path)
        a = np.asarray(node, np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    layer_ids = sorted(int(k.split("_")[1]) for k in tree
                       if k.startswith("layers_"))
    sd = {"embed_in.weight": leaf("embed_in/embedding")}
    for i in layer_ids:
        src, dst = f"layers_{i}", f"layers.{i}"
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{dst}.{ln}.weight"] = leaf(f"{src}/{ln}/scale")
            sd[f"{dst}.{ln}.bias"] = leaf(f"{src}/{ln}/bias")
        for lin in ("attention/query_key_value", "attention/dense",
                    "mlp/dense_h_to_4h", "mlp/dense_4h_to_h"):
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
    return sd


_LINEARS = ("attention.query_key_value", "attention.dense", "mlp.dense_h_to_4h",
            "mlp.dense_4h_to_h")


def params_to_jax(state_dict) -> dict:
    """The flax parameter tree of a :class:`GPTNeoX` state dict: the exact
    inverse of :func:`params_from_jax`, each ``nn.Linear.weight`` [out, in]
    transposed back to a ``Dense`` kernel [in, out] (a view), keys sorted.
    Works on any dict keyed by parameter name (an optimizer's moments too).
    Raises on a name it does not map."""
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
            else:
                raise ValueError(f"params_to_jax: unmapped parameter {name!r}")
        else:
            raise ValueError(f"params_to_jax: unmapped parameter {name!r}")
    return tree_sorted(tree)
