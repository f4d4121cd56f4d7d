"""Llama-family causal LMs in PyTorch: Llama-2, Mistral (grouped-query
attention and a sliding window) and OPT (counterpart of
``deeperspeed_tpu/models/llama.py``).

One module tree, the JAX package's, with its switches as config fields:

* RMSNorm (no bias, an fp32 ``scale``; kernels K1/K8 with ``rms``), or the
  LayerNorm of GPT-NeoX with ``norm="layernorm"`` (OPT); pre-norm and a
  sequential residual;
* separate ``q_proj`` / ``k_proj`` / ``v_proj`` without bias, k and v
  ``num_kv_heads * head_dim`` wide (grouped-query attention when
  ``num_kv_heads`` < ``num_heads``), full-dim rotary when ``use_rope``;
  every cache and pool holds the KV heads, which are repeated for their
  query heads only at attention time;
* the SwiGLU MLP (``silu(gate) * up``, no bias), or a GELU / ReLU MLP with
  biases (OPT);
* Mistral's sliding window: a query at position i sees keys j with
  i - window < j <= i, on the dense, the cached and the paged paths alike;
* OPT's learned positions and tied embeddings (the logits are
  ``x @ E.T`` in fp32, as flax's ``Embed.attend``).

The engines call it through the protocol of ``models/gpt_neox.py``:
training (``loss_fn``, ``example_batch``, ``param_partition_rules``,
``no_cast_paths``, ``set_dtype`` / ``replace_config``), the v2 paged path
(``paged_state``, as GPT-NeoX: S == 1 to K2, 2 <= S <= 8 to K3, each with
the GQA query groups folded into the batch; rows under a sliding window and
longer rows to plain masked attention over the gathered blocks), and the v1
cached decode (``cache``, a :class:`DecodeCache` at the KV heads).
Parameter names follow the flax tree (``layers.{i}.attention.q_proj`` for
``layers_{i}/attention/q_proj``); :func:`params_from_jax` and
:func:`params_to_jax` carry weights across.

Weights are drawn as the flax initialisers draw them: Dense kernels
lecun-normal truncated at two standard deviations, biases zero, norm scales
one, embeddings N(0, 1/H).  On the CPU they come from a CPU
``torch.Generator``; on a CUDA device the parameters are made on ``meta``
and the same initialisers drawn on the card from a CUDA generator, so a 7B
model is never held on the host (the two devices draw different weights
from one seed).
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
from ..ops.transformer import apply_rotary_pos_emb, rms_norm, rotary_tables
from ..parallel.tensor_parallel import (ColumnParallelLinear, VocabParallelEmbedding,
                                        copy_to_tensor_parallel, partition_dims,
                                        vocab_parallel_log_likelihood)
from ..sequence import gathered_keys, padded_attention, sequence_group, sequence_positions
from ..utils.recompute import checkpoint_replaying
from ..utils.tree import tree_sorted
from .gpt_neox import (SPEC_DECODE_WINDOW, ModelLayerNorm, ModelLinear, _dense,
                       _drawable, cached_attention, gathered_kv, paged_writes,
                       repeat_kv, write_pools)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32            # < num_heads: GQA (Mistral: 8)
    intermediate_size: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    sliding_window: Optional[int] = None   # Mistral: 4096
    # OPT-style switches
    use_rope: bool = True
    learned_positions: bool = False
    mlp: str = "swiglu"               # "swiglu" | "gelu" | "relu"
    norm: str = "rmsnorm"             # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.float32
    remat: bool = False

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a multiple of "
                             f"num_heads {self.num_heads}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
        if self.mlp not in ("swiglu", "gelu", "relu"):
            raise ValueError(f"mlp {self.mlp!r}: expected swiglu, gelu or relu")
        if self.norm not in ("rmsnorm", "layernorm"):
            raise ValueError(f"norm {self.norm!r}: expected rmsnorm or layernorm")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    # ---- presets
    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def mistral_7b(**kw):
        kw.setdefault("num_kv_heads", 8)
        kw.setdefault("intermediate_size", 14336)
        kw.setdefault("sliding_window", 4096)
        kw.setdefault("max_seq_len", 8192)
        kw.setdefault("vocab_size", 32000)
        return LlamaConfig(**kw)

    @staticmethod
    def opt_125m(**kw):
        kw.setdefault("vocab_size", 50272)
        kw.setdefault("hidden_size", 768)
        kw.setdefault("num_layers", 12)
        kw.setdefault("num_heads", 12)
        kw.setdefault("num_kv_heads", 12)
        kw.setdefault("intermediate_size", 3072)
        kw.setdefault("max_seq_len", 2048)
        kw.setdefault("use_rope", False)
        kw.setdefault("learned_positions", True)
        kw.setdefault("mlp", "relu")
        kw.setdefault("norm", "layernorm")
        kw.setdefault("tie_embeddings", True)
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_seq_len", 64)
        return LlamaConfig(**kw)

    @staticmethod
    def tiny_mistral(**kw):
        kw.setdefault("sliding_window", 16)
        return LlamaConfig.tiny(**kw)

    @staticmethod
    def tiny_opt(**kw):
        kw.setdefault("use_rope", False)
        kw.setdefault("learned_positions", True)
        kw.setdefault("mlp", "relu")
        kw.setdefault("norm", "layernorm")
        kw.setdefault("tie_embeddings", True)
        return LlamaConfig.tiny(**kw)


# the JAX package's ``param_partition_rules`` in torch's names and ``[out,
# in]`` layout: the dim of each parameter split over ``tp`` (None: whole)
TP_RULES = [
    (r"embed_tokens\.weight$", 0),
    (r"embed_positions\.weight$", None),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.(weight|bias)$", 0),
    (r"(o_proj|down_proj)\.weight$", 1),
    (r"lm_head\.weight$", 0),
]


class RMSNorm(nn.Module):
    """RMSNorm over ``config.dtype`` activations with an fp32 ``scale``;
    K1/K8 with ``rms`` on a CUDA tensor (``ops/transformer/normalize.py``)."""

    def __init__(self, hidden, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(hidden, dtype=torch.float32))

    def forward(self, x):
        return rms_norm(x.to(self.dtype), self.scale, eps=self.eps)


def _norm(cfg):
    """The JAX ``_Norm``: RMSNorm, or LayerNorm with ``norm="layernorm"``."""
    if cfg.norm == "layernorm":
        return ModelLayerNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype)
    return RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        H, N, KV, D = (config.hidden_size, config.num_heads, config.num_kv_heads,
                       config.head_dim)
        self.q_proj = nn.Linear(H, N * D, bias=False)
        self.k_proj = nn.Linear(H, KV * D, bias=False)
        self.v_proj = nn.Linear(H, KV * D, bias=False)
        self.o_proj = nn.Linear(N * D, H, bias=False)
        # the sp group, where the engine runs the model sequence-parallel
        self.sp_group = None

    def forward(self, x, positions, kv=None, paged=None, cached=None,
                attention_mask=None):
        cfg = self.config
        B, S, _ = x.shape
        D, dt = cfg.head_dim, cfg.dtype
        # the heads this rank holds (all of them without tensor parallelism)
        q = _dense(self.q_proj, x, dt).view(B, S, -1, D)
        k = _dense(self.k_proj, x, dt).view(B, S, -1, D)
        v = _dense(self.v_proj, x, dt).view(B, S, -1, D)
        if cfg.use_rope:
            cos, sin = rotary_tables(positions, D, cfg.rope_theta, dt)
            q, k = apply_rotary_pos_emb(q, k, cos, sin)
        if kv is not None:
            out = self._paged(q, k, v.contiguous(), positions, kv, paged)
        elif cached is not None:
            out = cached_attention(q, k, v, cached, attention_mask, cfg.sliding_window)
        else:
            # at sp > 1 the local queries over the gathered keys (the
            # family has no seq_parallel_mode: the JAX package's GSPMD
            # default), the window measured from the global positions;
            # unmasked, the queries padded to the keys' length (flash)
            group = sequence_group(self)
            am = None if attention_mask is None else attention_mask.to(torch.bool)
            q_start = 0
            if group is not None:
                k, v, am, q_start = gathered_keys(k, v, group, am)
            rep = q.shape[2] // k.shape[2]
            k, v = repeat_kv(k, rep), repeat_kv(v, rep)
            mask = None
            if cfg.sliding_window is not None:
                qpos = torch.arange(q_start, q_start + S, device=x.device)
                kpos = torch.arange(k.shape[1], device=x.device)
                mask = (kpos[None, :] > qpos[:, None] - cfg.sliding_window)[None, None]
            if am is not None:
                am = am[:, None, None, :]
                mask = am if mask is None else mask & am
            if mask is None:
                out = padded_attention(dot_product_attention, q, k, v)
            else:
                out = dot_product_attention(q, k, v, mask=mask, causal=True)
        return _dense(self.o_proj, out.reshape(B, S, -1), dt)

    def _paged(self, q, k, v, positions, kv, paged):
        """The v2 engine's blocked KV pools [P, bs, KV, D] (the JAX
        ``_paged``).  Without a window, S == 1 goes to the paged decode
        kernel and S <= 8 to the speculative one, each KV head's ``rep``
        query heads folded into the batch (the tables and positions
        repeated ``rep`` times, so each block is read once a group);
        otherwise plain masked attention over the gathered blocks, the
        window applied."""
        cfg = self.config
        pool_k, pool_v, k_scale, v_scale = write_pools(kv, k, v, paged)
        B, S, N, D = q.shape
        KV = k.shape[2]
        rep = N // KV
        tables = paged.block_tables
        if S == 1 and cfg.sliding_window is None:
            q0 = q[:, 0].reshape(B, KV, rep, D).transpose(1, 2).reshape(B * rep, KV, D)
            out = paged_decode_attention(
                q0.contiguous(), pool_k, pool_v, tables.repeat_interleave(rep, 0),
                (positions[:, 0] + 1).repeat_interleave(rep, 0),
                k_scale=k_scale, v_scale=v_scale)
            return out.reshape(B, rep, KV, D).transpose(1, 2).reshape(B, 1, N, D)
        if S <= SPEC_DECODE_WINDOW and cfg.sliding_window is None:
            qs = q.reshape(B, S, KV, rep, D).permute(0, 3, 1, 2, 4).reshape(B * rep, S, KV, D)
            out = paged_spec_decode_attention(
                qs.contiguous(), pool_k, pool_v, tables.repeat_interleave(rep, 0),
                positions.repeat_interleave(rep, 0), k_scale=k_scale, v_scale=v_scale)
            return out.reshape(B, rep, S, KV, D).permute(0, 2, 3, 1, 4).reshape(B, S, N, D)
        K, V = gathered_kv(pool_k, pool_v, k_scale, v_scale, tables, q.dtype)
        K, V = repeat_kv(K, rep), repeat_kv(V, rep)
        kv_pos = torch.arange(K.shape[1], device=q.device)[None, None, None, :]
        qpos = positions[:, None, :, None]
        mask = kv_pos <= qpos
        if cfg.sliding_window is not None:
            mask = mask & (kv_pos > qpos - cfg.sliding_window)
        return dot_product_attention(q, K, V, mask=mask, causal=False)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        H, f = config.hidden_size, config.intermediate_size
        swiglu = config.mlp == "swiglu"
        if swiglu:
            self.gate_proj = nn.Linear(H, f, bias=False)
        self.up_proj = nn.Linear(H, f, bias=not swiglu)
        self.down_proj = nn.Linear(f, H, bias=not swiglu)

    def forward(self, x):
        cfg = self.config
        dt = cfg.dtype
        if cfg.mlp == "swiglu":
            h = F.silu(_dense(self.gate_proj, x, dt)) * _dense(self.up_proj, x, dt)
        else:
            h = _dense(self.up_proj, x, dt)
            # flax nn.gelu is the tanh form
            h = F.relu(h) if cfg.mlp == "relu" else F.gelu(h, approximate="tanh")
        return _dense(self.down_proj, h, dt)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.input_norm = _norm(config)
        self.attention = LlamaAttention(config)
        self.post_attention_norm = _norm(config)
        self.mlp = LlamaMLP(config)

    def forward(self, x, positions, kv=None, paged=None, cached=None,
                attention_mask=None):
        x = x + self.attention(self.input_norm(x), positions, kv, paged, cached,
                               attention_mask)
        return x + self.mlp(self.post_attention_norm(x))


class Llama(nn.Module):
    """Causal LM: tokens [B, S] -> logits [B, S, V] (or [B, R, V] at
    ``logits_positions``).

    ``device`` is CUDA unless the caller passes ``device="cpu"``;
    ``device="meta"`` builds the module without weights (for shapes and
    counts).  Weights are drawn from ``seed`` on the device they live on
    (see the module docstring) and kept in fp32 until an engine casts them;
    the products run in ``config.dtype`` either way."""

    def __init__(self, config: LlamaConfig, device=None, seed=0):
        super().__init__()
        meta = str(device) == "meta"
        device = torch.device("meta") if meta else resolve_device(device)
        self.config = config
        # the sp group, where the engine runs the model sequence-parallel
        self.sp_group = None
        with torch.device("meta" if device.type == "cuda" else device):
            self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
            if config.learned_positions:
                self.embed_positions = nn.Embedding(config.max_seq_len, config.hidden_size)
            self.layers = nn.ModuleList(LlamaBlock(config)
                                        for _ in range(config.num_layers))
            self.final_norm = _norm(config)
            if not config.tie_embeddings:
                self.lm_head = ModelLinear(config, config.hidden_size, config.vocab_size,
                                           bias=False)
        if meta:
            return
        if device.type == "cuda":
            self.to_empty(device=device)
            self._init_weights(torch.Generator(device=device).manual_seed(seed))
        else:
            self._init_weights(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen):
        """Flax's defaults, every parameter written (the CUDA path starts
        from uninitialised memory): Dense kernels lecun-normal truncated at
        two standard deviations, biases zero, norm scales one, embeddings
        N(0, 1/H).  A parameter left on ``meta`` is drawn and dropped
        (``_drawable``)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = (1.0 / math.sqrt(mod.in_features)) / .87962566103423978
                nn.init.trunc_normal_(_drawable(mod.weight, gen), 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(_drawable(mod.weight, gen), 0.0,
                                1.0 / math.sqrt(self.config.hidden_size), generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
            elif isinstance(mod, ModelLayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def set_dtype(self, dtype):
        """Cast every weight but the norms' to ``dtype`` and make it the
        compute type of the products and of the KV pools (serving)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.to(dtype)
        self.replace_config(dtype=dtype)
        for mod in self.modules():
            if isinstance(mod, (RMSNorm, ModelLayerNorm)):
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

    def forward(self, input_ids, positions=None, paged_state=None,
                logits_positions=None, attention_mask=None, cache=None):
        """``paged_state`` (v2 serving) and ``cache`` (v1 serving) as in
        :meth:`GPTNeoX.forward`; ``attention_mask`` [B, S] (0/1) masks keys
        beside the causal mask and the window ([B, L] over the buffer with
        ``cache``)."""
        cfg = self.config
        B, S = input_ids.shape
        if positions is None:
            # bound to an sp group: this slice's global positions
            positions = sequence_positions(self, B, S, input_ids.device)
        # the lookup in the table's type, then the compute type
        x = self.embed_tokens(input_ids).to(cfg.dtype)
        if cfg.learned_positions:
            x = x + self.embed_positions(positions.long()).to(cfg.dtype)
        paged, kv_cache = None, [None] * len(self.layers)
        if paged_state is not None:
            kv_cache = paged_state["kv_cache"]
            paged = paged_writes(paged_state, positions, kv_cache[0][0].shape[1])
        remat = cfg.remat and paged is None and cache is None and torch.is_grad_enabled()
        for i, (blk, kv) in enumerate(zip(self.layers, kv_cache)):
            cached = None if cache is None else (*cache.layers[i], cache.index)
            if remat:
                x = checkpoint_replaying(
                    lambda x_in, blk=blk: blk(x_in, positions, attention_mask=attention_mask),
                    x, rng=None)
            else:
                x = blk(x, positions, kv, paged, cached, attention_mask)
        if cache is not None:
            cache.index += S
        x = self.final_norm(x)
        if logits_positions is not None:
            lp = logits_positions.long()
            if lp.dim() == 1:
                lp = lp[:, None]
            x = torch.gather(x, 1, lp[..., None].expand(-1, -1, x.shape[-1]))
        if cfg.tie_embeddings:
            emb = self.embed_tokens
            if isinstance(emb, VocabParallelEmbedding):
                x = copy_to_tensor_parallel(x, emb.group)
            # flax ``Embed.attend`` of fp32 rows: the logits in fp32
            return F.linear(x.to(torch.float32), emb.weight.to(torch.float32))
        return self.lm_head(x)

    # ------------------------------------------------------------ engine API
    def _head_split(self):
        """(group, start) of a vocabulary-parallel head, or None."""
        head = self.embed_tokens if self.config.tie_embeddings else self.lm_head
        if isinstance(head, ColumnParallelLinear):
            return head.group, head.out_start
        if isinstance(head, VocabParallelEmbedding):
            return head.group, head.start
        return None

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
        all) is set, over fp32 logits (vocabulary-parallel under ``tp``).
        The family has no dropout or token dropping, so ``rng`` and the
        engine's other arguments are ignored, as the JAX loss ignores them."""

        def loss(model, batch, rng=None, **_):
            logits = model(batch["input_ids"]).to(torch.float32)
            split = model._head_split()
            if split is not None:
                token_ll = vocab_parallel_log_likelihood(logits, batch["labels"], *split)
            else:
                lse = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
                token_ll = gold - lse
            mask = batch.get("loss_mask")
            mask = torch.ones_like(token_ll) if mask is None else mask.to(token_ll.dtype)
            return -(token_ll * mask).sum() / mask.sum().clamp(min=1.0)

        return loss

    def to_reference_tree(self, state_dict):
        """Checkpoints: the JAX package's parameter tree of ``state_dict``."""
        return params_to_jax(state_dict)

    def from_reference_tree(self, tree):
        """Checkpoints: the inverse of :meth:`to_reference_tree`."""
        return params_from_jax(tree)

    def param_partition_rules(self):
        """The tensor-parallel split of each parameter (:data:`TP_RULES`)."""
        return list(TP_RULES)

    def check_tensor_parallel(self, tp):
        """Raise unless ``tp`` splits the heads whole: each rank takes
        ``num_kv_heads / tp`` KV heads and their query groups."""
        cfg = self.config
        if cfg.num_kv_heads % tp:
            raise ValueError(f"Llama: num_kv_heads {cfg.num_kv_heads} is not divisible "
                             f"by tp={tp}")

    def no_cast_paths(self):
        """Nothing stays fp32 under mixed precision: the JAX engine's default
        pattern (``embed_in/embedding``) names no parameter of this family,
        so it casts the embeddings too."""
        return []

    def num_params(self):
        cfg = self.config
        h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        d = cfg.head_dim
        attn = h * cfg.num_heads * d + 2 * h * cfg.num_kv_heads * d + cfg.num_heads * d * h
        mlp = 3 * h * f if cfg.mlp == "swiglu" else 2 * h * f + f + h
        norms = (2 if cfg.norm == "rmsnorm" else 4) * h
        total = v * h + cfg.num_layers * (attn + mlp + norms) + \
            (h if cfg.norm == "rmsnorm" else 2 * h)
        if not cfg.tie_embeddings:
            total += v * h
        if cfg.learned_positions:
            total += cfg.max_seq_len * h
        return total

    def flops_per_token(self):
        cfg = self.config
        n = self.num_params() - cfg.vocab_size * cfg.hidden_size
        if cfg.learned_positions:
            n -= cfg.max_seq_len * cfg.hidden_size
        attn = 12 * cfg.num_layers * cfg.hidden_size * cfg.max_seq_len
        return 6 * n + attn


def Mistral(config=None, **kw):
    """Mistral = the Llama architecture + GQA + a sliding window."""
    return Llama(config or LlamaConfig.mistral_7b(), **kw)


def OPT(config=None, **kw):
    """OPT = learned positions + a ReLU MLP + LayerNorm + tied embeddings."""
    return Llama(config or LlamaConfig.opt_125m(), **kw)


# ---------------------------------------------------------------- weights
_KERNELS = ("attention/q_proj", "attention/k_proj", "attention/v_proj",
            "attention/o_proj", "mlp/gate_proj", "mlp/up_proj", "mlp/down_proj")
_NORMS = ("input_norm", "post_attention_norm")


def _norm_leaves(flax_path, torch_name, layernorm):
    """(flax leaf, torch name) pairs of one ``_Norm``."""
    if layernorm:
        return [(f"{flax_path}/ModelLayerNorm_0/scale", f"{torch_name}.weight"),
                (f"{flax_path}/ModelLayerNorm_0/bias", f"{torch_name}.bias")]
    return [(f"{flax_path}/scale", f"{torch_name}.scale")]


def _leaf_map(tree=None, names=None):
    """[(flax path, torch name, transposed)] of every parameter a model
    with the flax tree's keys, or with these torch names, can hold."""
    if tree is not None:
        layers = sorted(int(k.split("_")[1]) for k in tree if k.startswith("layers_"))
        layernorm = "ModelLayerNorm_0" in tree["final_norm"]
    else:
        layers = sorted({int(n.split(".")[1]) for n in names if n.startswith("layers.")})
        layernorm = any(n.endswith("norm.weight") for n in names)
    out = [("embed_tokens/embedding", "embed_tokens.weight", False),
           ("embed_positions/embedding", "embed_positions.weight", False),
           ("lm_head/kernel", "lm_head.weight", True)]
    out += [(a, b, False) for a, b in _norm_leaves("final_norm", "final_norm", layernorm)]
    for i in layers:
        src, dst = f"layers_{i}", f"layers.{i}"
        for nrm in _NORMS:
            out += [(a, b, False) for a, b in
                    _norm_leaves(f"{src}/{nrm}", f"{dst}.{nrm}", layernorm)]
        for lin in _KERNELS:
            name = f"{dst}.{lin.replace('/', '.')}"
            out += [(f"{src}/{lin}/kernel", f"{name}.weight", True),
                    (f"{src}/{lin}/bias", f"{name}.bias", False)]
    return out


def params_from_jax(tree, tp_rank=0, tp_size=1) -> dict:
    """A state dict for :class:`Llama` from a flax parameter tree given as
    nested dicts of numpy arrays (``jax.device_get(params)``); needs no JAX.
    Each ``Dense`` kernel [in, out] is transposed into ``nn.Linear.weight``
    [out, in].  Raises if a leaf of ``tree`` is left unmapped.  With
    ``tp_size`` > 1 each parameter :data:`TP_RULES` splits is rank
    ``tp_rank``'s slice of it, as the engine shards the model."""
    leaves = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                leaves[path] = v

    walk(tree, "")
    sd = {}
    for path, name, transpose in _leaf_map(tree=tree):
        if path in leaves:
            a = np.asarray(leaves.pop(path), np.float32)
            sd[name] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    if leaves:
        raise ValueError(f"params_from_jax: unmapped leaves {sorted(leaves)[:8]}")
    if tp_size > 1:
        for name, dim in partition_dims(list(sd), TP_RULES).items():
            sd[name] = sd[name].chunk(tp_size, dim)[tp_rank].contiguous()
    return sd


def join_tensor_parallel(shards) -> dict:
    """The whole state dict from the ``tp`` ranks' dicts in rank order."""
    dims = partition_dims(list(shards[0]), TP_RULES)
    return {name: (torch.cat([s[name] for s in shards], dims[name]) if name in dims
                   else value) for name, value in shards[0].items()}


def params_to_jax(state_dict) -> dict:
    """The flax parameter tree of a :class:`Llama` state dict (or of any
    dict keyed by parameter name, an optimizer's moments too): the exact
    inverse of :func:`params_from_jax`, keys sorted.  A list of dicts is
    the ``tp`` ranks' slices in rank order.  Raises on a name it does not
    map."""
    if isinstance(state_dict, (list, tuple)):
        state_dict = join_tensor_parallel(state_dict)
    by_name = {name: (path, transpose) for path, name, transpose
               in _leaf_map(names=list(state_dict))}
    tree = {}
    for name, value in state_dict.items():
        if name not in by_name:
            raise ValueError(f"params_to_jax: unmapped parameter {name!r}")
        path, transpose = by_name[name]
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value.t() if transpose else value
    return tree_sorted(tree)


_EMBED_NAMES = ("embed_tokens.", "embed_positions.")
_HEAD_NAMES = ("final_norm.", "lm_head.")


def pipe_params_from_jax(tree, stage_id, num_stages=None, tp_rank=0, tp_size=1) -> dict:
    """Stage ``stage_id``'s state dict for ``LlamaPipe`` from the JAX
    ``LlamaPipe``'s ``{embed, stages, head}`` tree: its blocks as
    ``layers.<j>`` (local index), the embeddings on the first stage, the
    final norm and ``lm_head`` on the last; cut into ``num_stages`` (by
    default the tree's own); with ``tp_size`` > 1, tp rank ``tp_rank``'s
    slices (:func:`params_from_jax`)."""
    from .gpt_neox import _leaves_of, _stacked_layers

    n_stages = num_stages or next(iter(_leaves_of(tree["stages"]))).shape[0]
    sd = params_from_jax({**tree["embed"], **tree["head"],
                          **_stacked_layers(tree["stages"], stage_id, n_stages)},
                         tp_rank=tp_rank, tp_size=tp_size)
    keep = lambda n: ((stage_id == 0 or not n.startswith(_EMBED_NAMES))
                      and (stage_id == n_stages - 1 or not n.startswith(_HEAD_NAMES)))
    return {n: t for n, t in sd.items() if keep(n)}


def pipe_params_to_jax(stage_dicts) -> dict:
    """The JAX ``LlamaPipe``'s ``{embed, stages, head}`` tree from every
    stage's state dict, in stage order (the inverse of
    :func:`pipe_params_from_jax`); a stage's entry may be a list of its tp
    ranks' dicts in rank order."""
    from .gpt_neox import _stack_stage_trees

    trees = [params_to_jax(sd) for sd in stage_dicts]
    first, last = trees[0], trees[-1]
    return {"embed": {k: first[k] for k in ("embed_tokens", "embed_positions") if k in first},
            "head": {k: last[k] for k in ("final_norm", "lm_head") if k in last},
            "stages": _stack_stage_trees(
                [{k: v for k, v in t.items() if k.startswith("layers_")} for t in trees])}
