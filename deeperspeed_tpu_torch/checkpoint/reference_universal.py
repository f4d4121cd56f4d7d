"""Read and write upstream DeepSpeed's universal checkpoint layout
(counterpart of ``deeperspeed_tpu/checkpoint/reference_universal.py``).

Interop with the DeepSpeed/NeoX checkpoint ecosystem: upstream defines a
universal checkpoint as one folder per parameter of
torch-saved dicts (``deepspeed/checkpoint/ds_to_universal.py``, loaded by
``universal_checkpoint.py:98`` ``load_hp_checkpoint_state``):

    <dir>/zero/<param_name>/fp32.pt         {'param': fp32 tensor,
                                             'cat_dim': int (tp concat dim),
                                             'vocab_tensor': bool}
    <dir>/zero/<param_name>/exp_avg.pt      same dict shape, Adam moment 1
    <dir>/zero/<param_name>/exp_avg_sq.pt   Adam moment 2
    <dir>/zero/optimizer_state.pt           base optimizer scalars
    <root>/latest_universal                 tag file

plus the source checkpoint's ``mp_rank_*`` model files (not needed for the
parameter state itself).  This module converts between that layout and the
checkpoints' flax-named state:

* **naming** -- folder names follow the NeoX/Megatron pipeline-module
  convention (``{seq_idx}.{module_path}.{weight|bias}``): embedding at
  index 0, transformer layer ``i`` at ``i + layer_offset`` (NeoX uses 2:
  EmbeddingPipe, then the dropout/float-cast shim), final norm at
  ``num_layers + layer_offset + 1``, untied LM head one after.
* **orientation** -- torch ``nn.Linear`` stores ``[out, in]``; flax Dense
  kernels are ``[in, out]``.  2D projection weights transpose on the way
  out and back in; embedding tables do not (both store ``[vocab, h]``).
* **tp metadata** -- ``cat_dim`` is the dim the reference concatenates tp
  slices along in ITS orientation (column-parallel 0, row-parallel 1);
  ``vocab_tensor`` marks vocab-padded tables.

Import reuses :func:`universal.install_universal_state`, so a reference
universal checkpoint loads into a port engine at any world size and ZeRO
stage.  ``torch.save`` / ``torch.load`` are native here.
"""

import os
import re

import numpy as np
import torch

from .universal import install_universal_state

ZERO_DIR = "zero"
FP32_FILE = "fp32.pt"
MOMENT_FILES = {"mu": "exp_avg.pt", "nu": "exp_avg_sq.pt"}
PARAM_KEY = "param"
CAT_DIM_KEY = "cat_dim"
VOCAB_KEY = "vocab_tensor"


class _Entry:
    """One parameter's bidirectional mapping."""

    def __init__(self, ours, ref, transpose=False, cat_dim=0, vocab=False):
        self.ours = ours          # '/'-joined flax path
        self.ref = ref            # reference folder name
        self.transpose = transpose
        self.cat_dim = cat_dim
        self.vocab = vocab

    def reorient(self, arr):
        """flax <-> torch orientation; transpose is an involution, so ONE
        definition serves both directions (bijectivity by construction)."""
        a = np.asarray(arr, np.float32)
        return a.T if self.transpose else a

    to_ref = reorient
    to_ours = reorient


def gpt_neox_param_map(num_layers, layer_offset=2):
    """Mapping for the GPT-NeoX model (models/gpt_neox.py, by its flax
    names) against NeoX's pipeline sequential naming."""
    entries = [
        _Entry("embed_in/embedding", "0.word_embeddings.weight",
               vocab=True),
    ]
    for i in range(num_layers):
        r = i + layer_offset
        o = f"layers_{i}"
        entries += [
            _Entry(f"{o}/input_layernorm/scale", f"{r}.input_layernorm.weight"),
            _Entry(f"{o}/input_layernorm/bias", f"{r}.input_layernorm.bias"),
            _Entry(f"{o}/post_attention_layernorm/scale",
                   f"{r}.post_attention_layernorm.weight"),
            _Entry(f"{o}/post_attention_layernorm/bias",
                   f"{r}.post_attention_layernorm.bias"),
            _Entry(f"{o}/attention/query_key_value/kernel",
                   f"{r}.attention.query_key_value.weight",
                   transpose=True, cat_dim=0),
            _Entry(f"{o}/attention/query_key_value/bias",
                   f"{r}.attention.query_key_value.bias", cat_dim=0),
            _Entry(f"{o}/attention/dense/kernel",
                   f"{r}.attention.dense.weight", transpose=True, cat_dim=1),
            _Entry(f"{o}/attention/dense/bias", f"{r}.attention.dense.bias"),
            _Entry(f"{o}/mlp/dense_h_to_4h/kernel",
                   f"{r}.mlp.dense_h_to_4h.weight", transpose=True, cat_dim=0),
            _Entry(f"{o}/mlp/dense_h_to_4h/bias",
                   f"{r}.mlp.dense_h_to_4h.bias", cat_dim=0),
            _Entry(f"{o}/mlp/dense_4h_to_h/kernel",
                   f"{r}.mlp.dense_4h_to_h.weight", transpose=True, cat_dim=1),
            _Entry(f"{o}/mlp/dense_4h_to_h/bias",
                   f"{r}.mlp.dense_4h_to_h.bias"),
        ]
    norm_idx = num_layers + layer_offset + 1
    entries += [
        _Entry("final_layer_norm/scale", f"{norm_idx}.norm.weight"),
        _Entry("final_layer_norm/bias", f"{norm_idx}.norm.bias"),
        _Entry("embed_out/kernel", f"{norm_idx + 1}.final_linear.weight",
               transpose=True, cat_dim=0, vocab=True),
    ]
    return entries


def _infer_num_layers(flat_names):
    layers = [int(m.group(1)) for n in flat_names
              for m in [re.match(r"layers_(\d+)/", n)] if m]
    return max(layers) + 1 if layers else 0


# ------------------------------------------------------------------ export
def export_reference_universal(ckpt_dir, out_dir, tag=None, param_map=None,
                               layer_offset=2):
    """Native checkpoint -> reference universal layout.

    Mirrors ``ds_to_universal.py``'s output so NeoX-ecosystem tooling (and
    ``universal_checkpoint.py``'s loader) can consume a checkpoint trained
    here.  Writes ``<root>/latest_universal`` next to ``out_dir`` like the
    reference's ``main`` does.
    """
    from .deeperspeed_checkpoint import DeeperSpeedCheckpoint
    from .universal import collect_moments_and_scalars

    ckpt = DeeperSpeedCheckpoint(ckpt_dir, tag=tag)
    params, flat_moments, scalars = collect_moments_and_scalars(ckpt)

    if param_map is None:
        param_map = gpt_neox_param_map(_infer_num_layers(params),
                                       layer_offset=layer_offset)
    unmapped = set(params) - {e.ours for e in param_map}
    if unmapped:
        raise ValueError(
            f"no reference name mapping for params: {sorted(unmapped)[:5]} "
            f"(pass an explicit param_map)")

    zero_dir = os.path.join(out_dir, ZERO_DIR)
    os.makedirs(zero_dir, exist_ok=True)
    for e in param_map:
        if e.ours not in params:
            continue
        pdir = os.path.join(zero_dir, e.ref)
        os.makedirs(pdir, exist_ok=True)

        def save(fname, arr):
            payload = {PARAM_KEY: torch.from_numpy(
                np.ascontiguousarray(e.to_ref(arr)))}
            if e.cat_dim:
                payload[CAT_DIM_KEY] = e.cat_dim
            if e.vocab:
                payload[VOCAB_KEY] = True
            torch.save(payload, os.path.join(pdir, fname))

        save(FP32_FILE, params[e.ours])
        for key, fname in MOMENT_FILES.items():
            if e.ours in flat_moments[key]:
                save(fname, flat_moments[key][e.ours])
            else:
                # moment-less export (SGD / fresh Adam state): the reference
                # universal loader asserts every param dir carries
                # exp_avg/exp_avg_sq -- write zero-valued moments (what a
                # step-0 Adam would hold) rather than an undersized dir
                save(fname, np.zeros_like(params[e.ours]))

    # base optimizer scalars (reference _save_optimizer_state writes the
    # param-stripped optimizer sd here); 'step' is the reference's name
    # for the Adam step count
    sd = dict(scalars)
    if "optimizer_step" in sd:
        sd["step"] = sd.pop("optimizer_step")
    torch.save({"optimizer_state_dict": sd},
               os.path.join(zero_dir, "optimizer_state.pt"))

    root = os.path.dirname(os.path.abspath(out_dir))
    with open(os.path.join(root, "latest_universal"), "w") as f:
        f.write(os.path.basename(os.path.abspath(out_dir)))
    return out_dir


# ----------------------------------------------- native NeoX layer format
def import_neox_layer_checkpoint(engine, ckpt_dir, param_map=None,
                                 layer_offset=2, strict=True):
    """Import a NeoX/Megatron-DeepSpeed NATIVE checkpoint: the per-layer
    ``layer_{idx:02d}-model_{tp:02d}-model_states.pt`` files the reference's
    ``PipelineModule._save_layers`` writes (and ``DeepSpeedCheckpoint``
    reads via its layer/file maps, ``checkpoint/deepspeed_checkpoint.py``).

    Weights-only (the optimizer state lives in the zero_* files; use the
    universal path for moments).  tp slices concatenate along each
    parameter's cat_dim; vocab-padded embedding/head rows beyond the
    model's vocab_size are stripped (the reference pads to a tp multiple).
    """
    import glob as _glob

    files = sorted(_glob.glob(os.path.join(ckpt_dir, "layer_*-model_*"
                                           "-model_states.pt")))
    pat = re.compile(r"layer_(\d+)-model_(\d+)-model_states\.pt$")
    by_layer = {}
    for f in files:
        m = pat.search(f)
        if m is None:
            continue  # glob wildcards also match non-numeric names
        layer, tp = int(m.group(1)), int(m.group(2))
        by_layer.setdefault(layer, {})[tp] = f
    if not by_layer:
        raise FileNotFoundError(
            f"no layer_XX-model_YY-model_states.pt files in {ckpt_dir}")
    tp_degree = max(len(v) for v in by_layer.values())
    short = {k: len(v) for k, v in by_layer.items() if len(v) != tp_degree}
    if short:
        raise ValueError(
            f"incomplete checkpoint: layers {sorted(short)} have "
            f"{set(short.values())} tp shard files, others have {tp_degree}")

    if param_map is None:
        # transformer layers are the files carrying a block param; the
        # map's other indices (embedding 0, final norm, head) follow from
        # the count + offset
        n_layers = 0
        for layer, tp_files in by_layer.items():
            sd = torch.load(tp_files[0], map_location="cpu",
                            weights_only=False)
            if any("input_layernorm" in k for k in sd):
                n_layers += 1
        param_map = gpt_neox_param_map(n_layers, layer_offset=layer_offset)
    by_ref = {e.ref: e for e in param_map}

    vocab = getattr(getattr(engine, "module", None), "config", None)
    vocab = getattr(vocab, "vocab_size", None)

    # expected shapes (reference orientation) from the live engine: the
    # ground truth for the sharded-vs-replicated decision -- value
    # equality would misclassify zero-initialized sharded biases as
    # replicated and NaN-carrying replicated tensors as sharded
    from ..runtime.checkpointing import to_reference_tree
    from .deeperspeed_checkpoint import flatten_state_dict as _flat

    shapes = to_reference_tree(engine.module, {
        name: torch.empty(shape, device="meta")
        for region in engine.plan.regions
        for name, shape in zip(region.names, region.shapes)})
    by_ours = {e.ours: e for e in param_map}
    exp_shapes = {
        name: tuple(reversed(a.shape)) if by_ours[name].transpose else tuple(a.shape)
        for name, a in _flat(shapes, sep="/").items() if name in by_ours}

    params = {}
    unknown = []
    for layer, tp_files in sorted(by_layer.items()):
        # per-layer load: holding every layer's shards at once would peak
        # at ~2x model size in host RAM for nothing
        shards = [torch.load(tp_files[t], map_location="cpu",
                             weights_only=False)
                  for t in sorted(tp_files)]
        for name in shards[0]:
            ref_name = f"{layer}.{name}"
            e = by_ref.get(ref_name)
            if e is None:
                unknown.append(ref_name)
                continue
            ts = [s[name].float() for s in shards]
            exp = exp_shapes.get(e.ours)
            shard_shape = tuple(ts[0].shape)

            def matches(shape):
                if exp is None:
                    return False
                if e.vocab:
                    return (shape[1:] == exp[1:] and shape[0] >= exp[0])
                return shape == exp

            if matches(shard_shape):
                merged = ts[0]          # replicated across tp
            else:
                merged = torch.cat(ts, dim=e.cat_dim)
            arr = merged.numpy()
            if e.vocab and vocab is not None and arr.shape[0] > vocab:
                arr = arr[:vocab]  # strip tp-multiple padding rows
            if exp is not None and tuple(arr.shape) != exp:
                raise ValueError(
                    f"{ref_name}: merged shape {tuple(arr.shape)} != "
                    f"expected {exp} (tp_degree={tp_degree}; wrong "
                    f"cat_dim, missing shards, or mismatched model)")
            params[e.ours] = e.to_ours(arr)
    if unknown and strict:
        raise ValueError(
            f"native checkpoint has parameters with no mapping: "
            f"{sorted(set(unknown))[:5]} (pass an explicit param_map or "
            f"strict=False)")

    meta = {"param_names": sorted(params)}
    return install_universal_state(engine, params, {}, {}, meta,
                                   load_optimizer_states=False)


# ------------------------------------------------------------------ import
def import_reference_universal(engine, universal_dir, param_map=None,
                               layer_offset=2, load_optimizer_states=True):
    """Reference universal layout -> live engine (any world size and stage).

    Upstream's loader slices per tp rank on its side
    (``universal_checkpoint.py:98``); here the full fp32 tensors are read,
    re-oriented to flax convention, and installed through the same
    ``install_universal_state`` path the native format uses, each rank
    taking its own pieces.
    """
    zero_dir = os.path.join(universal_dir, ZERO_DIR)
    if not os.path.isdir(zero_dir):
        raise FileNotFoundError(f"{zero_dir} is not a universal checkpoint")
    folders = sorted(
        d for d in os.listdir(zero_dir)
        if os.path.isdir(os.path.join(zero_dir, d)))

    if param_map is None:
        n_layers = len([d for d in folders if ".input_layernorm.weight" in d])
        param_map = gpt_neox_param_map(n_layers, layer_offset=layer_offset)
    by_ref = {e.ref: e for e in param_map}

    params, exp_avg, exp_avg_sq = {}, {}, {}
    unknown = []
    for d in folders:
        e = by_ref.get(d)
        if e is None:
            unknown.append(d)
            continue
        pdir = os.path.join(zero_dir, d)
        blob = torch.load(os.path.join(pdir, FP32_FILE), map_location="cpu",
                          weights_only=False)
        params[e.ours] = e.to_ours(blob[PARAM_KEY].float().numpy())
        for key, fname in MOMENT_FILES.items():
            path = os.path.join(pdir, fname)
            if os.path.isfile(path):
                m = torch.load(path, map_location="cpu", weights_only=False)
                (exp_avg if key == "mu" else exp_avg_sq)[e.ours] = (
                    e.to_ours(m[PARAM_KEY].float().numpy()))
    if unknown:
        raise ValueError(
            f"universal checkpoint has parameters with no mapping: "
            f"{unknown[:5]} (pass an explicit param_map)")

    meta = {"param_names": sorted(params)}
    opt_file = os.path.join(zero_dir, "optimizer_state.pt")
    if os.path.isfile(opt_file):
        sd = torch.load(opt_file, map_location="cpu", weights_only=False)
        scalars = sd.get("optimizer_state_dict", {})
        if "step" in scalars:
            meta["optimizer_step"] = int(scalars["step"])
        if "engine_step" in scalars:
            meta["engine_step"] = int(scalars["engine_step"])
        for k in ("loss_scale", "skipped_steps", "lr_step"):
            if k in scalars:
                meta[k] = scalars[k]
    return install_universal_state(
        engine, params, exp_avg, exp_avg_sq, meta,
        load_optimizer_states=load_optimizer_states)
