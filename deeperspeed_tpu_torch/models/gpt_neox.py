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

Not ported yet (construction raises, naming the ROADMAP item): MoE layers,
dropout, remat, chunked cross entropy, sequence parallelism.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import resolve_device
from ..ops.attention import (dot_product_attention, paged_decode_attention,
                             paged_spec_decode_attention)
from ..ops.quantizer import byte_view, dequantize_kv, quantize_kv
from ..ops.transformer import apply_rotary_pos_emb, layer_norm, rotary_tables
from ..quantization import canonical_dtype

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

    def forward(self, x, positions, kv=None, paged: Optional[PagedState] = None):
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
            out = dot_product_attention(q, k, v, causal=True)
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

    def forward(self, x, positions, kv=None, paged=None):
        attn_out = self.attention(self.input_layernorm(x), positions, kv, paged)
        if self.config.use_parallel_residual:
            mlp_out = self.mlp(self.post_attention_layernorm(x))
            return x + attn_out + mlp_out
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x))


def _not_ported(config):
    """The first configuration feature the port does not run yet, or None."""
    if config.moe_num_experts > 1:
        return "MoE layers (ROADMAP Queue A, 'Llama/Mistral, v1 inference and MoE')"
    for name in ("hidden_dropout", "attention_dropout"):
        if getattr(config, name) > 0.0:
            return f"{name} > 0 (ROADMAP Queue A, 'Training leftovers')"
    if config.remat:
        return "remat (ROADMAP Queue A, 'Training leftovers')"
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
        self.embed_out = nn.Linear(config.hidden_size, config.vocab_size,
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
        self.config = dataclasses.replace(self.config, dtype=dtype)
        for mod in self.modules():
            if hasattr(mod, "config"):
                mod.config = self.config
            if isinstance(mod, ModelLayerNorm):
                mod.dtype = dtype
        return self

    def _paged_writes(self, paged_state, positions, block_size):
        tables = paged_state["block_tables"]
        slot = tables.long().gather(
            1, (positions // block_size).long().clamp(max=tables.shape[1] - 1))
        flat = (slot * block_size + positions % block_size).reshape(-1)
        src = paged_state["write_mask"].reshape(-1).nonzero().squeeze(1)
        return PagedState(tables, flat.index_select(0, src), src)

    def forward(self, input_ids, positions=None, paged_state=None,
                logits_positions=None):
        """``paged_state`` (serving) carries ``kv_cache`` (per layer (pool_k,
        pool_v), or (pool_k, pool_v, k_scale, v_scale) for quantized pools,
        updated in place), ``block_tables`` [B, M]
        int32 and ``write_mask`` [B, S] bool.  ``logits_positions`` [B] or
        [B, R] projects only those positions of each row through the head."""
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
        for blk, kv in zip(self.layers, kv_cache):
            x = blk(x, positions, kv, paged)
        x = self.final_layer_norm(x)
        if logits_positions is not None:
            lp = logits_positions.long()
            if lp.dim() == 1:
                lp = lp[:, None]
            x = torch.gather(x, 1, lp[..., None].expand(-1, -1, x.shape[-1]))
        return _dense(self.embed_out, x, self.config.dtype)

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
        """``loss(model, batch) -> fp32 scalar``: mean next-token cross
        entropy over the tokens where ``batch["loss_mask"]`` (default all)
        is set, as logsumexp minus the gold logit over fp32 logits."""
        if self.config.ce_chunk_tokens > 0:
            raise NotImplementedError(
                "GPTNeoX: ce_chunk_tokens > 0 (the chunked cross entropy) is "
                "not ported yet (ROADMAP Queue A, 'Training leftovers')")

        def loss(model, batch):
            logits = model(batch["input_ids"]).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
            token_ll = gold - lse
            mask = batch.get("loss_mask")
            mask = torch.ones_like(token_ll) if mask is None else mask.to(token_ll.dtype)
            return -(token_ll * mask).sum() / mask.sum().clamp(min=1.0)

        return loss

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
