"""Universal checkpoint: per-parameter fp32 slices (counterpart of
``deeperspeed_tpu/checkpoint/universal.py``), the same files the JAX
package writes and reads:

    <out_dir>/zero/<param.name>/fp32.npy
    <out_dir>/zero/<param.name>/exp_avg.npy       (when Adam-family state exists)
    <out_dir>/zero/<param.name>/exp_avg_sq.npy
    <out_dir>/universal_meta.json

Names are the flax paths of the checkpoint's trees, '/'-joined.  The
checkpoint format is already topology-independent, so the export is for
tooling that wants a file per parameter; :func:`load_universal_into_engine`
loads one into a port engine at any world size and ZeRO stage, a pipeline
engine's at any ``pp`` (:func:`load_universal_into_interpreted`).
"""

import json
import os

import numpy as np

from .deeperspeed_checkpoint import DeeperSpeedCheckpoint, flatten_state_dict

UNIVERSAL_DIR = "zero"
META_FILE = "universal_meta.json"
FP32_NAME = "fp32.npy"
MOMENT_NAMES = {"mu": "exp_avg.npy", "nu": "exp_avg_sq.npy"}


def _find_adam_moments(opt_tree):
    """Locate {count, mu, nu} inside a restored optax opt_state tree.

    flax serializes optax's chained NamedTuple states as nested dicts keyed
    by tuple index / field name; the Adam-family inner state is the subtree
    holding both 'mu' and 'nu' param-pytrees.
    """
    if isinstance(opt_tree, dict):
        if "mu" in opt_tree and "nu" in opt_tree:
            return opt_tree
        for v in opt_tree.values():
            found = _find_adam_moments(v)
            if found is not None:
                return found
    return None


def collect_moments_and_scalars(ckpt):
    """Shared export front half: (params, flat_moments, scalars).

    Reads the Adam moments from either update mode: the device-side optax
    tree OR the host-update CPU Adam payload (``checkpointing.py``
    ``cpu_adam`` block, whose moment arrays are stored flat and reshaped
    here to the parameter's shape).  ``scalars`` carries the optimizer/
    scaler counters (optimizer_step, engine_step, loss_scale,
    skipped_steps, lr_step).  Used by BOTH the native universal export and
    the reference-layout export (``reference_universal.py``) so the two
    formats cannot drift."""
    params = ckpt.model_state_dict(sep="/")
    opt = ckpt.optimizer_state_tree()
    moments = _find_adam_moments(opt.get("opt_state", {}))
    host_mode = False
    if moments is None and isinstance(opt.get("cpu_adam"), dict):
        moments = _find_adam_moments(opt["cpu_adam"])
        host_mode = moments is not None
    flat_moments = {
        key: flatten_state_dict(moments[key], sep="/") if moments else {}
        for key in ("mu", "nu")
    }
    if host_mode:
        # host moments are flat fp32 buffers keyed by param name
        flat_moments = {
            key: {name: np.asarray(arr, np.float32).reshape(
                      np.asarray(params[name]).shape)
                  for name, arr in vals.items() if name in params}
            for key, vals in flat_moments.items()
        }
    # scalar optimizer/scaler state so resume keeps Adam bias correction
    # and the fp16 loss-scale trajectory
    scalars = {}
    if moments is not None and "count" in moments:
        scalars["optimizer_step"] = int(np.asarray(moments["count"]))
    elif host_mode and "t" in opt["cpu_adam"]:
        scalars["optimizer_step"] = int(np.asarray(opt["cpu_adam"]["t"]))
    if "step" in opt:
        scalars["engine_step"] = int(np.asarray(opt["step"]))
    if isinstance(opt.get("loss_scale"), dict):
        scalars["loss_scale"] = {
            k: float(np.asarray(v)) for k, v in opt["loss_scale"].items()}
    for counter in ("skipped_steps", "lr_step"):
        if counter in opt:
            scalars[counter] = int(np.asarray(opt[counter]))
    return params, flat_moments, scalars


def ds_to_universal(ckpt_dir, out_dir, tag=None):
    """Export a checkpoint into per-parameter universal folders."""
    ckpt = DeeperSpeedCheckpoint(ckpt_dir, tag=tag)
    params, flat_moments, extra = collect_moments_and_scalars(ckpt)

    zero_dir = os.path.join(out_dir, UNIVERSAL_DIR)
    os.makedirs(zero_dir, exist_ok=True)
    for name, value in params.items():
        pdir = os.path.join(zero_dir, name)
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, FP32_NAME), np.asarray(value, np.float32))
        for key, fname in MOMENT_NAMES.items():
            if name in flat_moments[key]:
                np.save(os.path.join(pdir, fname), np.asarray(flat_moments[key][name]))

    meta = dict(ckpt.meta)
    meta["param_names"] = sorted(params.keys())
    meta.update(extra)
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, default=str)
    return out_dir


def load_universal_state(universal_dir):
    """Read a universal export back as flat dicts.

    Returns (params, exp_avg, exp_avg_sq, meta) keyed by '/'-joined names.
    An engine loads these through ``engine.load_checkpoint`` with
    ``checkpoint.load_universal`` set, each rank taking its pieces there,
    so this function is topology-free.
    """
    with open(os.path.join(universal_dir, META_FILE)) as f:
        meta = json.load(f)
    zero_dir = os.path.join(universal_dir, UNIVERSAL_DIR)
    params, exp_avg, exp_avg_sq = {}, {}, {}
    for name in meta["param_names"]:
        pdir = os.path.join(zero_dir, name)
        params[name] = np.load(os.path.join(pdir, FP32_NAME))
        for key, fname in MOMENT_NAMES.items():
            path = os.path.join(pdir, fname)
            if os.path.isfile(path):
                (exp_avg if key == "mu" else exp_avg_sq)[name] = np.load(path)
    return params, exp_avg, exp_avg_sq, meta


def _unflatten(flat, sep="/"):
    tree = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_universal_into_engine(engine, universal_dir, load_optimizer_states=True):
    """Load a universal export into a live engine (any world size and stage)."""
    params, exp_avg, exp_avg_sq, meta = load_universal_state(universal_dir)
    return install_universal_state(engine, params, exp_avg, exp_avg_sq, meta,
                                   load_optimizer_states=load_optimizer_states)


def load_universal_into_interpreted(engine, universal_dir, load_optimizer_states=True):
    """A universal export into an interpreted pipeline engine at any ``pp`` x
    ``dp``: the '/'-named slices unflatten into its canonical ``{"layers",
    "tied"}`` tree, of which each stage takes its layers (the JAX package's
    ``load_universal_into_interpreted``)."""
    return load_universal_into_engine(engine, universal_dir, load_optimizer_states)


def install_universal_state(engine, params, exp_avg, exp_avg_sq, meta,
                            load_optimizer_states=True):
    """Install flat '/'-named fp32 state dicts into a live port engine, each
    rank taking its own pieces.  Shared with importers of other layouts
    (``reference_universal.py``), which assemble the state in memory."""
    from ..runtime import checkpointing as ck

    ck.load_reference_masters(engine, _unflatten(params))
    if getattr(engine, "_host_adam", None) is not None:
        # a host-update engine: the moments into its host optimizer, t from
        # the export's optimizer step (the JAX engine's ``_host_restore``)
        if load_optimizer_states and exp_avg and exp_avg_sq:
            ck.load_host_moments(engine, exp_avg, exp_avg_sq, t=meta.get("optimizer_step"))
    elif load_optimizer_states and exp_avg and exp_avg_sq:
        engine._ensure_opt_resident()
        opt_sd = ck.reference_opt_state(engine)
        moments = _find_adam_moments(opt_sd)
        if moments is not None:
            moments["mu"] = _unflatten(exp_avg)
            moments["nu"] = _unflatten(exp_avg_sq)
            if "count" in moments and "optimizer_step" in meta:
                # keep Adam's bias correction at the saved step
                moments["count"] = np.asarray(meta["optimizer_step"], np.int32)
            ck.load_reference_opt_state(engine, opt_sd)
        if "loss_scale" in meta:
            ls = ck._loss_scale_tree(engine.loss_scale_state)
            ls.update({k: v for k, v in meta["loss_scale"].items() if k in ls})
            ck._load_loss_scale(engine, ls)
    ck.restore_counters(engine, {k: v for k, v in meta.items() if k != "dataloader"})
    # the optimizer step drives the lr schedule: the applied step count
    # (fp16 skips excluded) where the export carries it
    engine.step_count = int(meta.get("engine_step", engine.global_steps))
    return meta


def main(args=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Export a DeeperSpeed checkpoint to universal "
                    "per-parameter fp32 slices")
    parser.add_argument("--input_folder", required=True)
    parser.add_argument("--output_folder", required=True)
    parser.add_argument("--tag", default=None)
    parser.add_argument(
        "--format", choices=("native", "reference"), default="native",
        help="'native': .npy slices with this framework's names; "
             "'reference': the reference ecosystem's torch-based layout "
             "(zero/<neox_name>/fp32.pt + latest_universal), consumable by "
             "its universal_checkpoint.py loader")
    ns = parser.parse_args(args)
    if ns.format == "reference":
        from .reference_universal import export_reference_universal

        export_reference_universal(ns.input_folder, ns.output_folder,
                                   tag=ns.tag)
    else:
        ds_to_universal(ns.input_folder, ns.output_folder, tag=ns.tag)
    print(f"universal checkpoint ({ns.format}) written to {ns.output_folder}")


if __name__ == "__main__":
    main()
