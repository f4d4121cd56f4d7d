"""The port's checkpoint storage on the CPU: the flax msgpack codec against
flax, the durability protocol under injected storage faults (the port's
counterparts of ``tests/unit/checkpoint/test_integrity.py``, through the
port's own ``_io_*`` seam), the offline tools bit for bit against the JAX
package's, and the ``checkpoint`` config block."""

import builtins
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.checkpoint import reference_universal as j_ref
from deeperspeed_tpu.checkpoint import universal as j_uni
from deeperspeed_tpu.checkpoint import zero_to_fp32 as j_fp32
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.checkpoint import msgpack_codec as codec
from deeperspeed_tpu_torch.checkpoint import reference_universal as t_ref
from deeperspeed_tpu_torch.checkpoint import universal as t_uni
from deeperspeed_tpu_torch.checkpoint import zero_to_fp32 as t_fp32
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.runtime import checkpointing as ck
from deeperspeed_tpu_torch.runtime.checkpoint_engine import checkpoint_engine as ce
from deeperspeed_tpu_torch.runtime.config import CheckpointConfig, DeeperSpeedConfig
import torch_threads  # noqa: F401  (torch at one intra-op thread)

CONFIG = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


def _batch(rng):
    toks = rng.integers(0, 256, (16, 33))
    return {"input_ids": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _same(a, b):
    """Trees equal in structure, key order, leaf types, dtypes and bits."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


# ------------------------------------------------------------------ codec
def _mixed_tree(rng):
    return {"params": {"dense": {"kernel": rng.standard_normal((7, 5)).astype(np.float32),
                                 "bias": np.zeros((5,), np.float32)},
                       "empty": np.zeros((0, 3), np.float32)},
            "count": np.asarray(12, np.int32), "flag": np.asarray(True),
            "scalar": np.float32(0.25), "ids": np.arange(70_000, dtype=np.int64),
            "raw": np.ones((3, 3), np.uint8), "none": None, "yes": True, "n": 7,
            "neg": -40, "big": 2 ** 40, "small": -70_000, "x": 1.5,
            "name": "tag" * 40, "blob": b"\x00\x01\x02",
            "wide": {str(i): i for i in range(20)}, "nothing": {}}


def test_codec_writes_flax_bytes_and_reads_flax_files():
    tree = _mixed_tree(np.random.default_rng(0))
    want = serialization.msgpack_serialize(tree, in_place=True)
    got = codec.encode(tree)
    assert bytes(got) == want
    assert _same(codec.decode(want), serialization.msgpack_restore(want))
    assert _same(serialization.msgpack_restore(bytes(got)), serialization.msgpack_restore(want))


def test_codec_encodes_tensors_as_their_arrays():
    """Tensors (transposed views, 0-d, bool, bf16) encode as the numpy
    arrays flax would be given; bf16 decodes to a bf16 tensor."""
    w = torch.randn(5, 3).t()
    b16 = torch.randn(4).to(torch.bfloat16)
    tree = {"w": w, "z": torch.tensor(2.0), "flag": torch.tensor(True), "h": b16}
    want = serialization.msgpack_serialize(
        {"w": w.numpy(), "z": np.asarray(2.0, np.float32), "flag": np.asarray(True),
         "h": np.asarray(jnp.asarray(b16.float().numpy(), jnp.bfloat16))}, in_place=True)
    assert bytes(codec.encode(tree)) == want
    back = codec.decode(want)
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"], b16)
    assert np.array_equal(back["w"], w.numpy())


def test_codec_decodes_without_copying():
    data = bytearray(serialization.msgpack_serialize(
        {"a": np.arange(1000, dtype=np.float32)}, in_place=True))
    arr = codec.decode(data)["a"]
    base = np.frombuffer(data, np.uint8)
    assert base.ctypes.data <= arr.ctypes.data < base.ctypes.data + len(data)


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_codec_chunked_arrays_both_ways(monkeypatch, source):
    """Arrays above MAX_CHUNK_SIZE go in flax's chunked form, written and
    read by either side (both limits lowered to 64 bytes)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"p": {"k": rng.standard_normal((10, 7)).astype(np.float32)},
            "t": np.arange(5, dtype=np.float32)}
    want = serialization.msgpack_serialize(tree, in_place=False)
    mine = tree if source == "numpy" else {"p": {"k": torch.from_numpy(tree["p"]["k"])},
                                           "t": torch.from_numpy(tree["t"])}
    got = codec.encode(mine)
    assert bytes(got) == want
    assert b"__msgpack_chunked_array__" in want
    back = codec.decode(want)
    assert np.array_equal(back["p"]["k"], tree["p"]["k"]) and back["p"]["k"].shape == (10, 7)
    assert np.array_equal(serialization.msgpack_restore(bytes(got))["p"]["k"], tree["p"]["k"])


def test_jax_engine_reads_port_file_and_port_reads_jax_file(tmp_path):
    """A file the JAX engine wrote decodes to msgpack_restore's arrays, and
    one the port wrote is read by msgpack_restore."""
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=CONFIG)
    jeng.train_batch(batch={k: jnp.asarray(v) for k, v in
                            _batch(np.random.default_rng(2)).items()})
    jeng.save_checkpoint(str(tmp_path / "jax"))
    teng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                               config=CONFIG, device="cpu")
    teng.save_checkpoint(str(tmp_path / "port"))
    for name in (ck.MODEL_FILE, ck.OPTIM_FILE):
        data = (tmp_path / "jax" / "global_step1" / name).read_bytes()
        assert _same(codec.decode(data), serialization.msgpack_restore(data))
        data = (tmp_path / "port" / "global_step0" / name).read_bytes()
        assert _same(serialization.msgpack_restore(data), codec.decode(data))


# ----------------------------------------------------- fault injection
class KilledMidSave(BaseException):
    """A simulated kill -9: not an Exception, so no cleanup swallows it."""


class FaultInjector:
    """Swaps the port's ``_io_*`` seam to fire one fault at the Nth
    operation of a kind ('open_w', 'fsync', 'replace') since arming."""

    def __init__(self):
        self.mode = self.kind = self.index = None
        self.counts = {}
        self._orig = (ce._io_open, ce._io_fsync, ce._io_replace)
        ce._io_open, ce._io_fsync, ce._io_replace = self._open, self._fsync, self._replace

    def arm(self, mode, kind, index):
        self.mode, self.kind, self.index, self.counts = mode, kind, index, {}

    def disarm(self):
        self.mode = None

    def uninstall(self):
        ce._io_open, ce._io_fsync, ce._io_replace = self._orig

    def _fire(self, kind):
        if self.mode is None or kind != self.kind:
            return False
        n = self.counts.get(kind, 0)
        self.counts[kind] = n + 1
        if n != self.index:
            return False
        if self.mode == "kill":
            raise KilledMidSave(f"kill at {kind}")
        return True

    def _open(self, path, mode="r", *a, **kw):
        if any(c in mode for c in "wa+") and self._fire("open_w"):
            raise OSError(5, "Input/output error (injected)", path)
        return builtins.open(path, mode, *a, **kw)

    def _fsync(self, fd):
        if self._fire("fsync"):
            raise OSError(5, "Input/output error (injected)")
        return os.fsync(fd)

    def _replace(self, src, dst):
        if self._fire("replace"):
            raise OSError(5, "Input/output error (injected)", dst)
        return os.replace(src, dst)


@pytest.fixture
def faulty_fs():
    inj = FaultInjector()
    yield inj
    inj.uninstall()


class _StubConfig:
    def __init__(self, writer=None):
        self.checkpoint_config = CheckpointConfig(writer=writer)


class _StubEngine:
    """What ``write_checkpoint`` / ``open_checkpoint`` read of an engine."""

    def __init__(self, writer=None):
        self.config = _StubConfig(writer)
        self.checkpoint_engine = None


def _payload(step):
    return (b"model-step-%06d-" % step) * 257, (b"optim-step-%06d-" % step) * 131


def _save_step(engine, workdir, step):
    model, optim = _payload(step)
    return ck.write_checkpoint(engine, workdir, f"global_step{step}",
                               model_bytes=lambda: model, optim_bytes=lambda: optim,
                               meta={"tag": f"global_step{step}", "global_steps": step})


def _flip_one_bit(path, byte_index=0):
    with open(path, "r+b") as f:
        f.seek(byte_index)
        b = f.read(1)
        f.seek(byte_index)
        f.write(bytes([b[0] ^ 0x40]))


def _assert_recoverable(workdir, step):
    tag, ckpt_dir, _ = ck.resolve_valid_checkpoint(workdir)
    assert tag == f"global_step{step}"
    ok, errors = ce.verify_manifest(ckpt_dir)
    assert ok, errors
    model, optim = _payload(step)
    assert open(os.path.join(ckpt_dir, ck.MODEL_FILE), "rb").read() == model
    assert open(os.path.join(ckpt_dir, ck.OPTIM_FILE), "rb").read() == optim


# -------------------------------------------------------- atomic primitives
def test_atomic_write_and_manifest_roundtrip(tmp_path):
    ce.atomic_write_bytes(b"hello-checkpoint", str(tmp_path / "a.bin"))
    assert (tmp_path / "a.bin").read_bytes() == b"hello-checkpoint"
    assert not (tmp_path / "a.bin.tmp").exists()


def test_commit_verifies_and_detects_corruption(tmp_path):
    eng = ce.NativeCheckpointEngine()
    d = tmp_path / "global_step1"
    eng.create("global_step1")
    eng.makedirs(str(d))
    eng.save(b"payload-a" * 100, str(d / "a.bin"))
    eng.save(memoryview(b"payload-b" * 100), str(d / "b.bin"))
    assert eng.commit("global_step1")
    assert ce.verify_manifest(str(d)) == (True, [])
    _flip_one_bit(str(d / "b.bin"), byte_index=3)
    ok, errors = ce.verify_manifest(str(d))
    assert not ok and any("b.bin" in e for e in errors)


@pytest.mark.parametrize("writer", ["native", "async"])
def test_commit_failure_keeps_latest(tmp_path, faulty_fs, writer):
    engine = _StubEngine(writer)
    _save_step(engine, str(tmp_path), 1)
    faulty_fs.arm("eio", "fsync", 0)
    with pytest.raises((RuntimeError, OSError)):
        _save_step(engine, str(tmp_path), 2)
    faulty_fs.disarm()
    assert ck.read_latest_tag(str(tmp_path)) == "global_step1"
    _assert_recoverable(str(tmp_path), 1)


@pytest.mark.parametrize("kind,index", [("open_w", 0), ("open_w", 2), ("fsync", 1),
                                        ("replace", 1), ("replace", 3)])
def test_kill_mid_save_leaves_latest_on_old_tag(tmp_path, faulty_fs, kind, index):
    engine = _StubEngine()
    _save_step(engine, str(tmp_path), 1)
    faulty_fs.arm("kill", kind, index)
    with pytest.raises(KilledMidSave):
        _save_step(engine, str(tmp_path), 2)
    faulty_fs.disarm()
    assert ck.read_latest_tag(str(tmp_path)) == "global_step1"
    tag, _, fell_back = ck.resolve_valid_checkpoint(str(tmp_path))
    assert tag == "global_step1" and not fell_back
    assert (tmp_path / "global_step2" / ck.INCOMPLETE_MARKER).is_file()
    # a fresh process's next save deletes the interrupted tag
    _save_step(_StubEngine(), str(tmp_path), 3)
    assert not (tmp_path / "global_step2").exists()
    _assert_recoverable(str(tmp_path), 3)


def test_walk_back_to_previous_valid_tag(tmp_path):
    engine = _StubEngine()
    _save_step(engine, str(tmp_path), 1)
    _save_step(engine, str(tmp_path), 2)
    _flip_one_bit(str(tmp_path / "global_step2" / ck.MODEL_FILE))
    tag, ckpt_dir, fell_back = ck.resolve_valid_checkpoint(str(tmp_path))
    assert tag == "global_step1" and fell_back
    assert ckpt_dir == str(tmp_path / "global_step1")


def test_strict_load_raises_on_corruption(tmp_path):
    engine = _StubEngine()
    _save_step(engine, str(tmp_path), 1)
    _save_step(engine, str(tmp_path), 2)
    _flip_one_bit(str(tmp_path / "global_step2" / ck.OPTIM_FILE))
    with pytest.raises(ck.CheckpointCorruptionError):
        ck.resolve_valid_checkpoint(str(tmp_path), strict=True)


def test_all_tags_corrupt_raises(tmp_path):
    engine = _StubEngine()
    _save_step(engine, str(tmp_path), 1)
    _save_step(engine, str(tmp_path), 2)
    for step in (1, 2):
        _flip_one_bit(str(tmp_path / f"global_step{step}" / ck.MODEL_FILE))
    with pytest.raises(ck.CheckpointCorruptionError):
        ck.resolve_valid_checkpoint(str(tmp_path))


def test_legacy_manifestless_tag_still_loads(tmp_path):
    legacy = tmp_path / "global_step5"
    legacy.mkdir()
    (legacy / ck.MODEL_FILE).write_bytes(b"legacy-model")
    (legacy / ck.ENGINE_FILE).write_text(json.dumps({"global_steps": 5}))
    (tmp_path / ck.LATEST_FILE).write_text("global_step5")
    assert ck.resolve_valid_checkpoint(str(tmp_path))[0] == "global_step5"
    _save_step(_StubEngine(), str(tmp_path), 6)
    _flip_one_bit(str(tmp_path / "global_step6" / ck.MODEL_FILE))
    tag, _, fell_back = ck.resolve_valid_checkpoint(str(tmp_path), tag="global_step6")
    assert tag == "global_step5" and fell_back
    _save_step(_StubEngine(), str(tmp_path), 7)
    assert (legacy / ck.MODEL_FILE).exists()


def test_gc_only_touches_marked_tags(tmp_path):
    _save_step(_StubEngine(), str(tmp_path), 1)
    wreck = tmp_path / "global_step9"
    wreck.mkdir()
    (wreck / ck.INCOMPLETE_MARKER).write_text("save in progress\n")
    (wreck / ck.MODEL_FILE).write_bytes(b"partial")
    unrelated = tmp_path / "notes"
    unrelated.mkdir()
    (unrelated / "README").write_text("not a checkpoint")
    assert ck._gc_failed_tags(str(tmp_path)) == ["global_step9"]
    assert not wreck.exists() and unrelated.exists()
    assert (tmp_path / "global_step1" / ck.MODEL_FILE).exists()


def test_io_retry_recovers_transient_eio(tmp_path):
    engine = _StubEngine()
    engine.config.checkpoint_config.io_retries = 3
    engine.config.checkpoint_config.io_retry_base_s = 0.001
    _save_step(engine, str(tmp_path), 1)
    calls = {"n": 0}
    real_load = engine.checkpoint_engine.load

    def flaky_load(path):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(5, "Input/output error (transient)")
        return real_load(path)

    engine.checkpoint_engine.load = flaky_load
    data = ck._read_artifact(engine, engine.checkpoint_engine,
                             str(tmp_path / "global_step1" / ck.MODEL_FILE))
    assert calls["n"] == 2 and data == _payload(1)[0]


def test_async_commit_failure_clears_pending(tmp_path, faulty_fs):
    eng = ce.AsyncCheckpointEngine()
    d = tmp_path / "global_step1"
    eng.create("global_step1")
    eng.makedirs(str(d))
    faulty_fs.arm("eio", "fsync", 0)
    eng.save(b"data" * 100, str(d / "a.bin"))
    assert eng.commit("global_step1") is False
    faulty_fs.disarm()
    assert eng._pending == [] and eng._txn == {}
    d2 = tmp_path / "global_step2"
    eng.create("global_step2")
    eng.makedirs(str(d2))
    eng.save(b"fresh" * 100, str(d2 / "a.bin"))
    assert eng.commit("global_step2") is True
    assert ce.verify_manifest(str(d2))[0]


def test_engine_walks_back_past_a_corrupt_tag(tmp_path):
    """The engine's load takes the newest valid tag, counts the rollback,
    and with ``strict_load`` raises instead."""
    from deeperspeed_tpu_torch.telemetry.registry import TelemetryRegistry

    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config=CONFIG, device="cpu")
    eng.telemetry = TelemetryRegistry(enabled=True, jsonl=False)
    rng = np.random.default_rng(4)
    eng.train_batch(batch=_batch(rng))
    eng.save_checkpoint(str(tmp_path))
    want = {n: t.clone() for n, t in eng.master_params.items()}
    eng.train_batch(batch=_batch(rng))
    eng.save_checkpoint(str(tmp_path))
    assert eng.telemetry.scalar("ckpt/bytes").value > 0
    _flip_one_bit(str(tmp_path / "global_step2" / ck.OPTIM_FILE), 100)
    ckpt_dir, _ = eng.load_checkpoint(str(tmp_path))
    assert ckpt_dir.endswith("global_step1") and eng.global_steps == 1
    assert all(torch.equal(eng.master_params[n], t) for n, t in want.items())
    assert eng.telemetry.counter("ckpt/rollback_count").total == 1
    strict, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                                 config={**CONFIG, "checkpoint": {"strict_load": True}},
                                 device="cpu")
    with pytest.raises(ck.CheckpointCorruptionError):
        strict.load_checkpoint(str(tmp_path))


# ------------------------------------------------------------------ tools
@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX engine's checkpoint after 2 fp16 Adam steps (moments, a loss
    scale and counters in it)."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    config = {**CONFIG, "fp16": {"enabled": True, "initial_scale_power": 8}}
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny(dtype=jnp.float16)),
                               config=config)
    rng = np.random.default_rng(5)
    for _ in range(2):
        jeng.train_batch(batch={k: jnp.asarray(v) for k, v in _batch(rng).items()})
    jeng.save_checkpoint(str(root / "ckpt"))
    return root, config


def _same_files(a, b):
    names_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert names_a == names_b and names_a
    for name in names_a:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def test_zero_to_fp32_matches_the_jax_tool(jax_checkpoint):
    root, _ = jax_checkpoint
    got = t_fp32.get_fp32_state_dict_from_checkpoint(str(root / "ckpt"))
    want = j_fp32.get_fp32_state_dict_from_checkpoint(str(root / "ckpt"))
    assert list(got) == list(want)
    assert all(_same(got[k], want[k]) for k in want)
    t_fp32.main([str(root / "ckpt"), str(root / "port.npz")])
    j_fp32.main([str(root / "ckpt"), str(root / "jax.npz")])
    with np.load(root / "port.npz") as a, np.load(root / "jax.npz") as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


def test_ds_to_universal_matches_the_jax_tool(jax_checkpoint):
    root, _ = jax_checkpoint
    t_uni.ds_to_universal(str(root / "ckpt"), str(root / "uni_port"))
    j_uni.ds_to_universal(str(root / "ckpt"), str(root / "uni_jax"))
    _same_files(str(root / "uni_port"), str(root / "uni_jax"))


def test_reference_universal_matches_the_jax_tool(jax_checkpoint):
    root, _ = jax_checkpoint
    t_ref.export_reference_universal(str(root / "ckpt"), str(root / "ref_port" / "out"))
    j_ref.export_reference_universal(str(root / "ckpt"), str(root / "ref_jax" / "out"))
    top_j, top_p = root / "ref_jax" / "out" / "zero", root / "ref_port" / "out" / "zero"
    names = sorted(os.path.relpath(os.path.join(d, f), top_j)
                   for d, _, fs in os.walk(top_j) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), top_p)
                           for d, _, fs in os.walk(top_p) for f in fs)
    assert "optimizer_state.pt" in names and len(names) > 40
    for name in names:
        a = torch.load(top_p / name, weights_only=False)
        b = torch.load(top_j / name, weights_only=False)
        assert a.keys() == b.keys(), name
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
            else:
                assert a[k] == b[k], (name, k)
    assert (root / "ref_port" / "latest_universal").read_text() == "out"


@pytest.mark.parametrize("route", ["universal", "reference"])
def test_universal_exports_load_into_a_port_engine(jax_checkpoint, route):
    """``load_universal`` (and the reference layout's import) give the
    checkpoint's masters, moments, step and loss scale."""
    root, config = jax_checkpoint
    if route == "universal":
        out = root / f"load_{route}"
        t_uni.ds_to_universal(str(root / "ckpt"), str(out))
    eng, *_ = tdst.initialize(
        model=GPTNeoX(GPTNeoXConfig.tiny(dtype=torch.float16), device="cpu", seed=3),
        config={**config, "checkpoint": {"load_universal": route == "universal"}},
        device="cpu")
    if route == "universal":
        eng.load_checkpoint(str(out))
    else:
        t_ref.import_reference_universal(eng, str(root / "ref_port" / "out"))
    direct, *_ = tdst.initialize(
        model=GPTNeoX(GPTNeoXConfig.tiny(dtype=torch.float16), device="cpu", seed=4),
        config=config, device="cpu")
    direct.load_checkpoint(str(root / "ckpt"))
    for n, t in direct.master_params.items():
        assert torch.equal(eng.master_params[n], t), n
    for k in ("mu", "nu"):
        for n, t in direct.opt_state[0][k].items():
            assert torch.equal(eng.opt_state[0][k][n], t), (k, n)
    assert eng.opt_state[0]["count"] == direct.opt_state[0]["count"] == 2
    assert eng.step_count == direct.step_count
    assert eng.get_loss_scale() == direct.get_loss_scale()


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("block", [
    {"checkpoint": {"writer": "native"}},
    {"checkpoint": {"writer": "async", "tag_validation": "Fail"}},
    {"checkpoint": {"async_save": True, "load_universal": True}},
    {"checkpoint": {"tag_validation": "Ignore", "strict_load": True, "io_retries": 1}},
    {"zero_optimization": {"stage": 2, "load_from_fp32_weights": False}},
    {"zero_optimization": {"stage": 1, "elastic_checkpoint": True}},
    {"zero_optimization": {"stage": 3, "gather_16bit_weights_on_model_save": True}},
])
def test_checkpoint_config_is_accepted(block):
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config={**CONFIG, **block}, device="cpu")
    cfg = eng.config
    for key, value in block.get("checkpoint", {}).items():
        assert getattr(cfg.checkpoint_config, key) == value
    for key, value in block.get("zero_optimization", {}).items():
        assert getattr(cfg, "zero_stage" if key == "stage" else key) == value
    writer = ck._storage(eng)
    async_ = block.get("checkpoint", {}).get("writer") == "async" or \
        block.get("checkpoint", {}).get("async_save")
    assert isinstance(writer, ce.AsyncCheckpointEngine if async_ else
                      ce.NativeCheckpointEngine)


def test_checkpoint_config_refuses_unknown_keys():
    with pytest.raises(NotImplementedError):
        DeeperSpeedConfig({**CONFIG, "checkpoint": {"no_such_key": 1}})
    with pytest.raises(ValueError):
        DeeperSpeedConfig({**CONFIG, "checkpoint": {"tag_validation": "Sometimes"}})
