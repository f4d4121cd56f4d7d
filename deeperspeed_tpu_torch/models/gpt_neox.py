"""GPT-NeoX / Pythia model family in PyTorch (counterpart of
``deeperspeed_tpu/models/gpt_neox.py``).

The NeoX computation: rotary embeddings over the first ``rotary_pct`` of
each head, the parallel attention + MLP residual, an untied output
embedding, LayerNorm (not RMS).  Module and parameter names follow the JAX
package's tree (``layers.{i}.attention.query_key_value`` for
``layers_{i}/attention/query_key_value``), and :func:`params_from_jax`
carries a flax parameter tree across.

Two attention modes: the unpaged causal path (a plain forward over whole
sequences) and the paged serving path, where each layer reads and writes a
[P, bs, N, D] KV pool pair that the inference engine owns.  Serving
attention is routed by the row bucket S, as in the JAX package: S == 1 to
the paged decode kernel, 2 <= S <= 8 to the speculative-decode kernel, and
longer rows to plain masked attention over the gathered blocks.

Not ported yet: MoE layers, sequence parallelism, the training extras
(remat, random-LTD, progressive layer drop) and the loss.
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
from ..ops.transformer import apply_rotary_pos_emb, layer_norm, rotary_tables

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
    dtype: torch.dtype = torch.float32

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


class ModelLayerNorm(nn.Module):
    """LayerNorm with fp32 ``weight`` and ``bias`` that runs kernel K1 on a
    CUDA tensor (``ops/transformer/normalize.py``)."""

    def __init__(self, hidden, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=torch.float32))

    def forward(self, x):
        return layer_norm(x.contiguous(), self.weight, self.bias, eps=self.eps)


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
        qkv = self.query_key_value(x).view(B, S, cfg.num_heads, 3 * cfg.head_dim)
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
        return self.dense(out.reshape(B, S, H))

    def _paged_attention(self, q, k, v, positions, kv, paged):
        """Blocked KV-pool attention.  Writes happen before reads, so a token
        attends to itself; stale data in reallocated blocks is excluded by
        the position mask."""
        pool_k, pool_v = kv
        B, S, N, D = q.shape
        # in place: the JAX package donated the pools to the step and got
        # new ones back; here the engine's pools are mutated
        for pool, new in ((pool_k, k), (pool_v, v)):
            pool.view(-1, N, D).index_copy_(
                0, paged.write_rows,
                new.reshape(-1, N, D).index_select(0, paged.src_rows))
        tables = paged.block_tables
        if S == 1:
            out = paged_decode_attention(q[:, 0].contiguous(), pool_k, pool_v,
                                         tables, positions[:, 0] + 1)
            return out[:, None]
        if S <= SPEC_DECODE_WINDOW:
            return paged_spec_decode_attention(q.contiguous(), pool_k, pool_v,
                                               tables, positions)
        # prefill: plain masked attention over the gathered blocks
        idx = tables.long()
        K = pool_k[idx].reshape(B, -1, N, D)
        V = pool_v[idx].reshape(B, -1, N, D)
        kv_pos = torch.arange(K.shape[1], device=q.device)
        mask = kv_pos[None, None, None, :] <= positions[:, None, :, None]
        return dot_product_attention(q, K, V, mask=mask, causal=False)


class GPTNeoXMLP(nn.Module):
    def __init__(self, config: GPTNeoXConfig):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(config.hidden_size,
                                       config.intermediate_size)
        self.dense_4h_to_h = nn.Linear(config.intermediate_size,
                                       config.hidden_size)

    def forward(self, x):
        h = F.gelu(self.dense_h_to_4h(x), approximate="tanh")
        return self.dense_4h_to_h(h)


class GPTNeoXBlock(nn.Module):
    def __init__(self, config: GPTNeoXConfig):
        super().__init__()
        self.config = config
        eps = config.layernorm_eps
        self.input_layernorm = ModelLayerNorm(config.hidden_size, eps)
        self.post_attention_layernorm = ModelLayerNorm(config.hidden_size, eps)
        self.attention = GPTNeoXAttention(config)
        self.mlp = GPTNeoXMLP(config)

    def forward(self, x, positions, kv=None, paged=None):
        attn_out = self.attention(self.input_layernorm(x), positions, kv, paged)
        if self.config.use_parallel_residual:
            mlp_out = self.mlp(self.post_attention_layernorm(x))
            return x + attn_out + mlp_out
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x))


class GPTNeoX(nn.Module):
    """Causal LM: tokens [B, S] -> logits [B, S, V] (or [B, R, V] at
    ``logits_positions``).

    Weights are drawn from ``seed`` with an explicit ``torch.Generator`` on
    the CPU, in fp32, and then moved to ``device`` (CUDA unless the caller
    passes ``device="cpu"``) in ``config.dtype``, so one seed gives the same
    model on every device.  LayerNorm parameters stay fp32."""

    def __init__(self, config: GPTNeoXConfig, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embed_in = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(GPTNeoXBlock(config)
                                    for _ in range(config.num_layers))
        self.final_layer_norm = ModelLayerNorm(config.hidden_size,
                                               config.layernorm_eps)
        self.embed_out = nn.Linear(config.hidden_size, config.vocab_size,
                                   bias=False)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device)
        self.set_dtype(config.dtype)

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
        """Cast every weight but the LayerNorms' to ``dtype``, the compute
        type of the products and of the KV pools."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.to(dtype)
        self.config = dataclasses.replace(self.config, dtype=dtype)
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
                logits_positions=None):
        """``paged_state`` (serving) carries ``kv_cache`` (one (pool_k,
        pool_v) pair per layer, updated in place), ``block_tables`` [B, M]
        int32 and ``write_mask`` [B, S] bool.  ``logits_positions`` [B] or
        [B, R] projects only those positions of each row through the head."""
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, device=input_ids.device).expand(B, S)
        x = self.embed_in(input_ids)
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
        return self.embed_out(x)


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
