"""Checkpoint save, load and resume (counterpart of
``deeperspeed_tpu/runtime/checkpointing.py``), in the JAX package's on-disk
format, so either package loads the other's checkpoints:

    <save_dir>/latest                      # text file holding the newest tag
    <save_dir>/<tag>/model_states.msgpack  # fp32 masters, the flax tree
    <save_dir>/<tag>/optim_states.msgpack  # {"loss_scale", "opt_state", "step"}
    <save_dir>/<tag>/engine_state.json     # counters, client_state, loader
    <save_dir>/<tag>/manifest.json         # per-file sha256 (commit record)
    <save_dir>/<tag>/.incomplete           # present only while a save runs

Each msgpack file is flax's serialization of the JAX engine's state tree
(``checkpoint/msgpack_codec.py``): whole (unpartitioned) fp32 arrays under
the model's flax names (``to_reference_tree``: for GPT-NeoX each Linear
weight transposed back to a ``Dense`` kernel [in, out], a module without it
nests its dotted names), the optimizer state as flax's dict of the optax
state (each transformation's ``export``), the loss-scale state's four
fields, and ``step`` the optimizer steps taken (``step_count``: fp16 skips
excluded, the lr schedule's step) as int32.  So a save at one world size or
ZeRO stage loads at any other: every rank takes its own pieces of the whole
arrays.  ``engine_state.json`` carries the JAX package's keys with
``"rng_key": null`` (the JAX loader then keeps its own key); the port's
generators, one per rank, go under ``torch_rng_state``, which the JAX loader
ignores.

Durability protocol: the tag directory gets an ``.incomplete`` marker
first, every artifact goes tmp + fsync + rename, ``commit(tag)`` writes a
checksum manifest and verifies it by reading back, the marker is removed,
and only then does ``latest`` move (atomically).  A tag carrying the marker,
or failing verification, was never committed: the load path skips it and
walks back to the newest valid tag, and the next save deletes it.
Transient IO errors on the load path are retried with capped exponential
backoff.  Over several processes every rank takes part in the gathers, rank
0 alone writes, and every rank passes a barrier before anyone reads
``latest``.
"""

import json
import os
import re
import shutil
import time

import numpy as np
import torch

from .. import comm
from ..utils.logging import log_dist, logger
from ..utils.tree import tree_sorted
from .checkpoint_engine.checkpoint_engine import (
    MANIFEST_FILE,
    atomic_write_bytes,
    read_manifest,
    verify_manifest,
)
from .precision import LossScaleState

LATEST_FILE = "latest"
MODEL_FILE = "model_states.msgpack"
OPTIM_FILE = "optim_states.msgpack"
ENGINE_FILE = "engine_state.json"
INCOMPLETE_MARKER = ".incomplete"
RNG_KEY = "torch_rng_state"

_TAG_STEP_RE = re.compile(r"global_step(\d+)$")
_LOSS_SCALE_FIELDS = {"scale": torch.float32, "growth_tracker": torch.int32,
                      "hysteresis": torch.int32, "found_overflow": torch.bool}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


class CheckpointCorruptionError(RuntimeError):
    """A requested checkpoint failed checksum verification (strict mode), or
    every candidate tag in the directory is corrupt."""


def _encode(tree):
    from ..checkpoint.msgpack_codec import encode

    return encode(tree)


def _decode(data):
    from ..checkpoint.msgpack_codec import decode

    return decode(data)


def _world(engine):
    return getattr(engine, "world", 1)


def _is_writer(engine):
    return getattr(engine, "rank", 0) == 0


def _validate_tag(engine, tag):
    """Every rank saves under rank 0's tag (``tag_validation``: Ignore, Warn
    or Fail when a rank's own tag differs)."""
    mode = engine.config.checkpoint_config.tag_validation.lower()
    if mode == "ignore" or _world(engine) == 1:
        return
    mine = str(tag).encode()[:128].ljust(128, b"\0")
    buf = torch.frombuffer(bytearray(mine), dtype=torch.uint8).to(engine.device)
    comm.broadcast(buf, 0, engine.group)
    if bytes(buf.cpu().numpy()) != mine:
        msg = f"checkpoint tag '{tag}' differs across processes"
        if mode == "fail":
            raise RuntimeError(msg)
        logger.warning(msg)


def _storage(engine):
    """The configured storage engine, built on first use."""
    if getattr(engine, "checkpoint_engine", None) is None:
        from .checkpoint_engine import get_checkpoint_engine

        engine.checkpoint_engine = get_checkpoint_engine(
            engine.config.checkpoint_config)
    return engine.checkpoint_engine


# ---------------------------------------------------------------------------
# resilience helpers: telemetry, IO retry, GC, tag walk-back
# ---------------------------------------------------------------------------

def _ckpt_cfg(engine):
    try:
        return engine.config.checkpoint_config
    except AttributeError:
        return None


def _tele(engine):
    reg = getattr(engine, "telemetry", None)
    if reg is not None:
        return reg
    from ..telemetry.registry import get_registry

    return get_registry()


def _retry_io(fn, what, cfg=None):
    """Retry ``fn`` on transient OSError with capped exponential backoff.

    FileNotFoundError is not transient (a missing artifact is corruption,
    handled by the walk-back) and propagates at once."""
    retries = int(getattr(cfg, "io_retries", 3))
    base = float(getattr(cfg, "io_retry_base_s", 0.05))
    cap = float(getattr(cfg, "io_retry_cap_s", 2.0))
    attempt = 0
    while True:
        try:
            return fn()
        except FileNotFoundError:
            raise
        except OSError as e:
            if attempt >= retries:
                raise
            delay = min(cap, base * (2 ** attempt))
            attempt += 1
            logger.warning(f"[ckpt] transient IO error during {what}: {e}; "
                           f"retry {attempt}/{retries} in {delay:.2f}s")
            time.sleep(delay)


def _gc_failed_tags(save_dir, keep=()):
    """Delete tag directories still carrying the ``.incomplete`` marker
    (saves that died mid-flight).  Tags named in ``keep`` (the tag being
    written now) and the current ``latest`` target are never touched."""
    if not os.path.isdir(save_dir):
        return []
    keep = {str(k) for k in keep}
    latest = read_latest_tag(save_dir)
    if latest:
        keep.add(latest)
    removed = []
    for name in sorted(os.listdir(save_dir)):
        if name in keep:
            continue
        tag_dir = os.path.join(save_dir, name)
        if not os.path.isdir(tag_dir):
            continue
        if os.path.isfile(os.path.join(tag_dir, INCOMPLETE_MARKER)):
            shutil.rmtree(tag_dir, ignore_errors=True)
            removed.append(name)
    if removed:
        logger.warning(f"[ckpt] garbage-collected {len(removed)} interrupted "
                       f"checkpoint tag(s): {', '.join(removed)}")
    return removed


def _tag_recency_key(save_dir, name):
    """Newest first: global_stepN tags by step number, anything else by
    directory mtime (numbered tags outrank mtime-only tags)."""
    m = _TAG_STEP_RE.search(name)
    if m:
        return (1, int(m.group(1)))
    try:
        return (0, os.path.getmtime(os.path.join(save_dir, name)))
    except OSError:
        return (0, 0.0)


def _verify_tag_dir(ckpt_dir, verify=True):
    """Classify one tag directory: ('valid' | 'legacy' (no manifest, loadable
    with a warning) | 'corrupt', errors)."""
    if not os.path.isdir(ckpt_dir):
        return "corrupt", ["directory missing"]
    if os.path.isfile(os.path.join(ckpt_dir, INCOMPLETE_MARKER)):
        return "corrupt", ["save was interrupted (.incomplete marker present)"]
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        if os.path.isfile(os.path.join(ckpt_dir, MODEL_FILE)) or \
                os.path.isfile(os.path.join(ckpt_dir, ENGINE_FILE)):
            return "legacy", []
        return "corrupt", [f"no {MANIFEST_FILE} and no checkpoint artifacts"]
    if not verify:
        return "valid", []
    ok, errors = verify_manifest(ckpt_dir, manifest)
    return ("valid", []) if ok else ("corrupt", errors)


def resolve_valid_checkpoint(load_dir, tag=None, strict=False, verify=True):
    """The newest checksum-valid tag under ``load_dir``: the requested tag
    (or ``latest``) first, then, past a corrupt one, every other tag
    directory newest first.  Returns ``(tag, ckpt_dir, fell_back)``, or
    ``(None, None, False)`` when the directory holds no checkpoint.
    ``strict`` raises ``CheckpointCorruptionError`` instead of walking
    back; a directory whose every candidate is corrupt always raises."""
    requested = tag if tag is not None else read_latest_tag(load_dir)
    if requested is None:
        return None, None, False

    candidates = [str(requested)]
    if os.path.isdir(load_dir):
        others = [n for n in os.listdir(load_dir)
                  if n != str(requested)
                  and os.path.isdir(os.path.join(load_dir, n))
                  and (os.path.isfile(os.path.join(load_dir, n, ENGINE_FILE))
                       or os.path.isfile(os.path.join(load_dir, n, MODEL_FILE))
                       or os.path.isfile(os.path.join(load_dir, n, MANIFEST_FILE)))]
        others.sort(key=lambda n: _tag_recency_key(load_dir, n), reverse=True)
        candidates += others

    first_errors = None
    for i, cand in enumerate(candidates):
        ckpt_dir = os.path.join(load_dir, cand)
        status, errors = _verify_tag_dir(ckpt_dir, verify=verify)
        if status == "legacy":
            logger.warning(f"[ckpt] tag {cand} predates the manifest protocol; "
                           "loading without checksum verification")
        if status in ("valid", "legacy"):
            fell_back = i > 0
            if fell_back:
                logger.warning(
                    f"[ckpt] tag '{requested}' is corrupt "
                    f"({'; '.join(first_errors or [])}); "
                    f"falling back to newest valid tag '{cand}'")
            return cand, ckpt_dir, fell_back
        if i == 0:
            first_errors = errors
            if not os.path.isdir(ckpt_dir) and len(candidates) == 1:
                logger.warning(f"checkpoint dir {ckpt_dir} does not exist")
                return None, None, False
            msg = (f"checkpoint tag '{requested}' under {load_dir} failed "
                   f"verification: {'; '.join(errors)}")
            if strict:
                raise CheckpointCorruptionError(msg)
            logger.warning(f"[ckpt] {msg}")
        else:
            logger.warning(f"[ckpt] candidate tag '{cand}' also invalid: "
                           f"{'; '.join(errors)}")

    raise CheckpointCorruptionError(
        f"no checksum-valid checkpoint under {load_dir}: tried "
        f"{', '.join(candidates)} (requested '{requested}': "
        f"{'; '.join(first_errors or [])})")


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def write_checkpoint(engine, save_dir, tag, model_bytes, optim_bytes, meta,
                     save_latest=True):
    """The save protocol: tag validation, storage lifecycle, commit before
    ``latest``.  ``model_bytes`` / ``optim_bytes`` are called by the writer
    (rank 0) alone, so any collective must run before this call.

    Writer-side sequence: mark the tag ``.incomplete`` -> atomic artifact
    writes -> verified manifest commit -> drop the marker -> atomic
    ``latest`` swap.  A kill at any point leaves either the old ``latest``
    intact or a marked / manifest-invalid tag that the load path skips and
    the next save deletes."""
    _validate_tag(engine, tag)
    ckpt_dir = os.path.join(save_dir, str(tag))
    try:
        if _is_writer(engine):
            t0 = time.perf_counter()
            storage = _storage(engine)
            storage.create(tag)
            storage.makedirs(ckpt_dir, exist_ok=True)
            _gc_failed_tags(save_dir, keep=(str(tag),))
            marker = os.path.join(ckpt_dir, INCOMPLETE_MARKER)
            with open(marker, "w") as f:
                f.write("save in progress\n")
            storage.save(model_bytes(), os.path.join(ckpt_dir, MODEL_FILE))
            storage.save(optim_bytes(), os.path.join(ckpt_dir, OPTIM_FILE))
            storage.save(json.dumps(meta, default=str).encode(),
                         os.path.join(ckpt_dir, ENGINE_FILE))
            # commit() is the durability barrier: the manifest is written
            # and verified by reading back; only then may 'latest' move
            if not storage.commit(tag):
                info = getattr(storage, "commit_info", {}) or {}
                raise RuntimeError(
                    f"checkpoint commit failed for tag {tag}: "
                    f"{'; '.join(info.get('errors', [])) or 'write error'}")
            os.remove(marker)
            if save_latest:
                atomic_write_bytes(str(tag).encode(),
                                   os.path.join(save_dir, LATEST_FILE))
            info = getattr(storage, "commit_info", {}) or {}
            reg = _tele(engine)
            reg.scalar("ckpt/save_seconds").record(time.perf_counter() - t0)
            reg.scalar("ckpt/verify_seconds").record(info.get("verify_seconds", 0.0))
            reg.scalar("ckpt/bytes").record(info.get("bytes", 0))
    finally:
        if _world(engine) > 1:
            # no rank reads 'latest' before the writer is done; runs when
            # the writer raises too, so the others do not hang (the
            # writer's exception still propagates after the barrier)
            comm.barrier(engine.group)
    log_dist(f"saved checkpoint {ckpt_dir}", ranks=[0])
    return ckpt_dir


def to_reference_tree(module, flat):
    """The flax tree of ``flat`` (parameter name -> tensor): the module's
    ``to_reference_tree``, else the dotted names nested, keys sorted."""
    if hasattr(module, "to_reference_tree"):
        return module.to_reference_tree(flat)
    tree = {}
    for name, value in flat.items():
        node = tree
        *parents, last = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree_sorted(tree)


def from_reference_tree(module, tree):
    """The inverse of :func:`to_reference_tree`: parameter name -> fp32
    tensor on the CPU."""
    if hasattr(module, "from_reference_tree"):
        return module.from_reference_tree(tree)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                flat[name] = torch.as_tensor(np.asarray(v, np.float32))

    walk(tree, "")
    return flat


def reference_masters(engine):
    """The fp32 masters whole, as the module's flax tree (a collective at
    stages 1-3 over several processes)."""
    return to_reference_tree(engine.module, engine.gather_whole(engine.master_params))


def reference_opt_state(engine):
    """The optimizer state as flax's dict of the optax state, each
    per-parameter tree whole (a collective like :func:`reference_masters`)."""
    return engine.tx.export(engine.opt_state, lambda local: to_reference_tree(
        engine.module, engine.gather_whole(local)))


def load_reference_masters(engine, tree, strict=True):
    engine.load_whole(from_reference_tree(engine.module, tree), engine.master_params,
                      strict)
    engine._refresh_compute()


def load_reference_opt_state(engine, tree):
    """Load the optimizer state in place from flax's dict of it."""
    engine.opt_state = engine.tx.restore(
        engine.opt_state, tree,
        lambda saved, local: engine.load_whole(
            from_reference_tree(engine.module, saved), local))


def _loss_scale_tree(state):
    return {name: getattr(state, name) for name in _LOSS_SCALE_FIELDS}


def _load_loss_scale(engine, saved):
    engine.loss_scale_state = LossScaleState(**{
        name: torch.as_tensor(np.asarray(saved[name])).to(dtype).to(engine.device)
        for name, dtype in _LOSS_SCALE_FIELDS.items()})


def _generator_states(engine):
    """Each rank's generator state as hex, in rank order (a collective over
    several processes)."""
    state = engine._rng.get_state()
    if _world(engine) == 1:
        return [state.numpy().tobytes().hex()]
    every = comm.all_gather(state.to(engine.device), engine.group).cpu()
    return [chunk.numpy().tobytes().hex() for chunk in every.chunk(_world(engine))]


def _restore_generator(engine, states):
    if not states:
        return
    if len(states) != _world(engine):
        logger.warning(f"[ckpt] checkpoint holds {len(states)} generator states for "
                       f"{_world(engine)} processes; generators keep their seeds")
        return
    try:
        engine._rng.set_state(torch.frombuffer(bytearray.fromhex(states[engine.rank]),
                                               dtype=torch.uint8).clone())
    except RuntimeError as e:
        logger.warning(f"[ckpt] generator state not restored ({e})")


def _dataloader_state(engine):
    """The loader's position, so a resume neither replays nor skips samples."""
    dl = getattr(engine, "training_dataloader", None)
    if dl is not None and hasattr(dl, "state_dict"):
        try:
            return dl.state_dict()
        except Exception as e:
            logger.warning(f"[ckpt] dataloader state_dict failed: {e}")
    return None


def _restore_dataloader(engine, meta):
    """Re-seat the training loader at the saved position and rebuild the
    engine's persistent iterator around it."""
    state = meta.get("dataloader")
    dl = getattr(engine, "training_dataloader", None)
    if state is None or dl is None or not hasattr(dl, "load_state_dict"):
        return
    try:
        dl.load_state_dict(state)
    except Exception as e:
        logger.warning(f"[ckpt] dataloader state restore failed: {e}")
        return
    if getattr(engine, "_data_iterator", None) is not None:
        from .dataloader import RepeatingLoader

        engine._data_iterator = iter(RepeatingLoader(dl))


def save_checkpoint(engine, save_dir, tag=None, client_state=None, save_latest=True):
    """Save the engine between steps (the accumulation buffer is not state)."""
    from ..parallel import get_mesh

    tag = tag or f"global_step{engine.global_steps}"
    model_tree = reference_masters(engine)
    optim_tree = {
        "loss_scale": _loss_scale_tree(engine.loss_scale_state),
        "opt_state": reference_opt_state(engine),
        "step": np.asarray(engine.step_count, np.int32),
    }
    meta = {
        "tag": tag,
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "mesh": dict(get_mesh().sizes),
        "zero_stage": engine.zero_optimization_stage(),
        "dtype": _DTYPE_NAMES[engine.precision.param_dtype],
        "client_state": client_state or {},
        # the JAX engine's PRNG key: none here, so its loader keeps its own
        "rng_key": None,
        "dataloader": _dataloader_state(engine),
        RNG_KEY: _generator_states(engine),
    }
    return write_checkpoint(engine, save_dir, tag,
                            model_bytes=lambda: _encode(model_tree),
                            optim_bytes=lambda: _encode(optim_tree),
                            meta=meta, save_latest=save_latest)


def read_latest_tag(load_dir):
    latest_path = os.path.join(load_dir, LATEST_FILE)
    if os.path.isfile(latest_path):
        with open(latest_path) as f:
            return f.read().strip()
    return None


def load_module_params(load_dir, tag=None, storage=None):
    """Only the model weights of a checkpoint, without an engine (the
    serving path): the flax tree as nested dicts of numpy arrays; for
    GPT-NeoX ``models.params_from_jax`` makes a state dict of it."""
    if storage is None:
        from .checkpoint_engine import get_checkpoint_engine

        storage = get_checkpoint_engine(None)
    if tag is None:
        tag = read_latest_tag(load_dir)
    ckpt_dir = os.path.join(load_dir, str(tag)) if tag else load_dir
    path = os.path.join(ckpt_dir, MODEL_FILE)
    try:
        data = storage.load(path)
    except FileNotFoundError:
        raise FileNotFoundError(f"no {MODEL_FILE} under {ckpt_dir}")
    return _decode(data)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def open_checkpoint(engine, load_dir, tag=None, strict=None):
    """Resolve the newest checksum-valid tag (walking back past corrupt ones
    unless ``strict``) and read its meta file with IO retry.  Returns
    ``(ckpt_dir, storage, meta)``, or ``(None, None, {})`` with a warning
    when nothing is loadable."""
    cfg = _ckpt_cfg(engine)
    if strict is None:
        strict = bool(getattr(cfg, "strict_load", False))
    verify = bool(getattr(cfg, "verify_on_load", True))
    requested = tag if tag is not None else read_latest_tag(load_dir)
    if requested is None:
        logger.warning(f"no 'latest' file found in {load_dir}; nothing loaded")
        return None, None, {}
    resolved, ckpt_dir, fell_back = resolve_valid_checkpoint(
        load_dir, tag=requested, strict=strict, verify=verify)
    if resolved is None:
        return None, None, {}
    if fell_back:
        _tele(engine).counter("ckpt/rollback_count").inc(1, reason="load_fallback")
    meta = {}
    meta_path = os.path.join(ckpt_dir, ENGINE_FILE)
    if os.path.isfile(meta_path):
        data = _retry_io(lambda: open(meta_path, "rb").read(), f"read {ENGINE_FILE}", cfg)
        meta = json.loads(data.decode())
    return ckpt_dir, _storage(engine), meta


def _read_artifact(engine, storage, path):
    """An artifact's bytes with transient-IO retry; a FileNotFoundError still
    propagates (the tag passed verification, so a vanished file is real
    corruption)."""
    return _retry_io(lambda: storage.load(path), f"read {os.path.basename(path)}",
                     _ckpt_cfg(engine))


def restore_counters(engine, meta):
    """The step counters, the generators and the loader position."""
    engine.global_steps = meta.get("global_steps", engine.global_steps)
    engine.global_samples = meta.get("global_samples", engine.global_samples)
    engine.micro_steps = meta.get("micro_steps", engine.micro_steps)
    engine.skipped_steps = meta.get("skipped_steps", engine.skipped_steps)
    _restore_generator(engine, meta.get(RNG_KEY))
    _restore_dataloader(engine, meta)


def load_checkpoint(engine, load_dir, tag=None, load_optimizer_states=True,
                    load_module_only=False, strict=None, load_module_strict=True):
    """Every rank reads the files and copies its own pieces of the whole
    arrays into its masters, moments and flat buffers, in place."""
    ckpt_dir, storage, meta = open_checkpoint(engine, load_dir, tag, strict=strict)
    if ckpt_dir is None:
        return None, {}
    tree = _decode(_read_artifact(engine, storage, os.path.join(ckpt_dir, MODEL_FILE)))
    load_reference_masters(engine, tree, load_module_strict)
    del tree
    if load_optimizer_states and not load_module_only and meta.get("host_update"):
        # the host-update payload ({cpu_adam, step}) is not the optax tree
        logger.warning(
            "loading a host_update checkpoint: weights restored, optimizer moments "
            "start fresh (export via ds_to_universal to carry moments across)")
        load_optimizer_states = False
    if load_optimizer_states and not load_module_only:
        optim_path = os.path.join(ckpt_dir, OPTIM_FILE)
        if os.path.isfile(optim_path):
            payload = _decode(_read_artifact(engine, storage, optim_path))
            load_reference_opt_state(engine, payload["opt_state"])
            _load_loss_scale(engine, payload["loss_scale"])
            engine.step_count = int(payload["step"])
    restore_counters(engine, meta)
    log_dist(f"loaded checkpoint {ckpt_dir}", ranks=[0])
    return ckpt_dir, meta.get("client_state", {})
