"""InferenceEngine: the v1 engine, cached autoregressive generation on one
card or over a ``tp`` group (counterpart of
``deeperspeed_tpu/inference/engine.py``).

* ``forward`` / ``__call__`` return full-sequence logits (no cache).
* ``generate`` runs one prefill and then one step a token over a dense
  [B, max_seq_len, N_kv, D] KV cache per layer (``models.DecodeCache``,
  owned here and passed to the model), with the JAX engine's semantics:
  left-padded prompts, positions from the cumulative sum of the
  ``attention_mask``, a key-validity mask over the whole buffer whose
  column ``S + step`` is switched on at each step, eos marking a row done
  and done rows emitting ``pad``.  The JAX package compiles the whole loop
  as one program; here each step runs eagerly (``enable_cuda_graph`` is
  accepted and not acted on).
* Token choice (:func:`_sample_tokens`): greedy is an argmax; sampling
  applies temperature, top-k (by sort, ties kept) and top-p (the smallest
  prefix whose cumulative probability reaches p) and draws by Gumbel-max
  from a ``torch.Generator`` (``seed=`` or the engine's), not from
  ``jax.random``.
* Weight-only quantization (``quant``): the model's Linear and Embedding
  weights stored int8 or int4 with bf16 group scales, each dequantized at
  its own use (``inference/quantization.py``).
* ``tensor_parallel.tp_size`` > 1, over ``init_distributed`` processes:
  the model is made tensor-parallel in place by its rules, each rank holds
  ``N / tp`` heads and its slice of the cache, and the vocabulary-split
  logits are all-gathered over ``tp`` before token choice, so every rank
  emits the same tokens.
* ``config.checkpoint`` serves the model weights of a training checkpoint
  of either package (``runtime/checkpointing.py`` ``load_module_params``,
  then the model's ``from_reference_tree``).
"""

import math

import torch

from .. import comm
from ..accelerator import resolve_device
from ..models.gpt_neox import DecodeCache
from ..parallel import MeshTopology, set_mesh
from ..parallel.tensor_parallel import gather_from_tensor_parallel
from ..utils.logging import log_dist
from .config import DeeperSpeedInferenceConfig, InferenceCheckpointConfig
from .params import shard_module_params
from .quantization import quantize_module, quantized_bytes


def _filter_logits(logits, temperature=1.0, top_k=None, top_p=None):
    """fp32 ``logits`` [B, V] with temperature applied and the entries
    top-k and top-p drop set to -inf (the JAX ``_sample_tokens`` filter)."""
    logits = logits.to(torch.float32)
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p is not None and top_p < 1.0:
        ordered = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(ordered, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative probability >= top_p
        cut = (cum < top_p).sum(dim=-1).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(ordered, -1, cut[:, None])
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return logits


def _sample_tokens(logits, generator, do_sample, temperature, top_k, top_p):
    """Next tokens [B] from ``logits`` [B, V]: argmax, or a Gumbel-max draw
    from ``generator`` over the filtered logits."""
    if not do_sample:
        return torch.argmax(logits.to(torch.float32), dim=-1)
    logits = _filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


class InferenceEngine:
    """Wraps a causal LM of the port (``models.GPTNeoX``, ``models.Llama``)
    for cached generation.  ``model`` is taken over: loaded with ``params``
    (a state dict of the whole model) or ``config.checkpoint`` when given,
    moved to ``device`` (CUDA unless the caller passes ``device="cpu"``),
    cast to the config's dtype, made tensor-parallel under ``tp_size`` > 1
    and quantized under ``quant``.  ``seed`` seeds the sampling
    generator."""

    def __init__(self, model=None, config=None, params=None, seed=0, device=None):
        if model is None:
            raise ValueError("InferenceEngine needs a model")
        if config is None:
            config = DeeperSpeedInferenceConfig()
        elif isinstance(config, dict):
            config = DeeperSpeedInferenceConfig(**config)
        self.config = config
        self._config = config       # the reference's attribute name
        self.device = resolve_device(device)
        self.tp_group = None
        if config.tp_size > 1:
            self.mesh = set_mesh(MeshTopology(tp=config.tp_size))
            self.tp_group = comm.get_model_parallel_group()
        if config.checkpoint is not None:
            if params is not None:
                raise ValueError("pass either params= or config.checkpoint, not both")
            params = self._load_checkpoint_params(config.checkpoint, model)
        if params is not None:
            model.load_state_dict(params)
        self.module = model.to(self.device).set_dtype(config.torch_dtype)
        if self.tp_group is not None:
            shard_module_params(self.module, self.tp_group)
        self.module.eval()
        self._wq = config.quant.enabled
        if self._wq:
            before = quantized_bytes(self.module)
            quantize_module(self.module, bits=config.quant.bits,
                            group_size=config.quant.group_size)
            log_dist(f"wq: weights quantized to {config.quant.bits}-bit "
                     f"({before / 1e6:.1f} MB -> {self.weight_bytes / 1e6:.1f} MB)",
                     ranks=[0])
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        log_dist(f"InferenceEngine: {self.weight_bytes / 1e6:.1f} MB of weights | "
                 f"tp={config.tp_size} | dtype {config.dtype} | {self.device}", ranks=[0])

    @staticmethod
    def _load_checkpoint_params(checkpoint, model):
        """The model weights of a training checkpoint directory (either
        package's format), as a state dict."""
        from ..runtime.checkpointing import load_module_params

        if isinstance(checkpoint, InferenceCheckpointConfig):
            ckpt_dir, tag = checkpoint.checkpoint_dir, checkpoint.tag
        else:
            ckpt_dir, tag = checkpoint, None
        return model.from_reference_tree(load_module_params(ckpt_dir, tag=tag))

    @property
    def weight_bytes(self):
        """Bytes this rank holds of the weights (quantized ones as stored)."""
        return quantized_bytes(self.module)

    def _logits(self, ids, **kwargs):
        logits = self.module(ids, **kwargs)
        if self.tp_group is not None:
            # every family's rules split the output head over the vocabulary
            logits = gather_from_tensor_parallel(logits, self.tp_group)
        return logits

    def _as_ids(self, input_ids):
        ids = torch.as_tensor(input_ids, device=self.device).long()
        return ids[None] if ids.dim() == 1 else ids

    # ---------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None):
        """Full-sequence logits [B, S, V] (no cache); ``attention_mask``
        [B, S] masks keys beside the causal mask."""
        ids = self._as_ids(input_ids)
        mask = None if attention_mask is None else torch.as_tensor(
            attention_mask, device=self.device).to(torch.int32)
        return self._logits(ids, attention_mask=mask)

    def __call__(self, input_ids, attention_mask=None):
        return self.forward(input_ids, attention_mask=attention_mask)

    # --------------------------------------------------------------- generate
    def _new_cache(self, batch, length):
        mc = self.module.config
        heads = getattr(mc, "num_kv_heads", mc.num_heads) // self.config.tp_size
        return DecodeCache.allocate(mc.num_layers, batch, length, heads, mc.head_dim,
                                    mc.dtype, self.device)

    @torch.no_grad()
    def generate(self, input_ids, attention_mask=None, max_new_tokens=None,
                 do_sample=False, temperature=1.0, top_k=None, top_p=None,
                 eos_token_id=None, pad_token_id=None, seed=None):
        """Autoregressive generation; prompts are left-padded to one length
        (``attention_mask`` marks the real tokens).  Returns [B, S + new]
        token ids on the engine's device."""
        ids = self._as_ids(input_ids)
        B, S = ids.shape
        if attention_mask is None:
            mask = torch.ones((B, S), dtype=torch.int32, device=self.device)
        else:
            mask = torch.as_tensor(attention_mask, device=self.device).to(torch.int32)
        if max_new_tokens is None:
            max_new_tokens = self.config.max_out_tokens
        if max_new_tokens < 1:
            return ids
        eos = eos_token_id if eos_token_id is not None else self.config.eos_token_id
        pad = pad_token_id if pad_token_id is not None else self.config.pad_token_id
        buf_len = self.module.config.max_seq_len
        if S + max_new_tokens > buf_len:
            raise ValueError(f"prompt {S} + new {max_new_tokens} exceeds the cache's "
                             f"{buf_len}; raise the model's max_seq_len")
        gen = (self._gen if seed is None else
               torch.Generator(device=self.device).manual_seed(seed))

        cache = self._new_cache(B, buf_len)
        prompt_lens = mask.sum(dim=-1)
        # key validity over the whole cache buffer
        kv_mask = torch.zeros((B, buf_len), dtype=torch.int32, device=self.device)
        kv_mask[:, :S] = mask
        positions = (torch.cumsum(mask, dim=-1) - 1).clamp(min=0)
        last = torch.full((B,), S - 1, dtype=torch.long, device=self.device)

        def choose(logits):
            return _sample_tokens(logits[:, -1], gen, do_sample, temperature, top_k, top_p)

        tok = choose(self._logits(ids, positions=positions, attention_mask=kv_mask,
                                  cache=cache, logits_positions=last))
        done = (tok == eos) if eos is not None else torch.zeros_like(tok, dtype=torch.bool)
        out = [tok]
        for step in range(max_new_tokens - 1):
            # the token fed lands at buffer column S + step, at rotary
            # position prompt_len + step
            kv_mask[:, S + step] = 1
            pos = (prompt_lens + step)[:, None]
            nxt = choose(self._logits(tok[:, None], positions=pos, attention_mask=kv_mask,
                                      cache=cache))
            nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
            if eos is not None:
                done = done | (nxt == eos)
            out.append(nxt)
            tok = nxt
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)

    # ------------------------------------------------------------- utilities
    def eval(self):
        return self

    def train(self, mode=False):
        return self

    def to(self, *a, **k):  # placement is the engine's, made at construction
        return self
