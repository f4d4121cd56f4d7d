"""Host-update checkpoints across the two packages, on the CPU, and the
async checkpoint writer's aio route.

The port's host-update engine writes the JAX package's host-update files
(the model file as in device mode, ``{"cpu_adam": {mu, nu, t}, "step"}`` as
the optimizer file, ``"host_update": true``), so:

* port host save -> port host load: the resumed run is the same bits;
* port host save -> the JAX device-mode engine: weights equal, moments
  fresh, with the JAX loader's warning;
* port host save -> JAX ``ds_to_universal`` -> the JAX device engine: the
  moments equal the port's (in the flax layout) and the step carries;
* a JAX device-mode save -> the port's host engine: weights equal;
* a JAX device save -> JAX ``ds_to_universal`` -> the port's host engine:
  ``t`` continues, and the next loss is within ``rtol=2e-5`` of the JAX
  engine's (the JAX package's
  ``test_universal_carries_moments_across_update_modes``).
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu_torch import op_builder
from deeperspeed_tpu.checkpoint.deeperspeed_checkpoint import flatten_state_dict
from deeperspeed_tpu.checkpoint.universal import _find_adam_moments, ds_to_universal
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.runtime import checkpointing as jck
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.runtime import checkpointing as ck
from deeperspeed_tpu_torch.runtime.checkpoint_engine import checkpoint_engine as ce
import torch_threads  # noqa: F401  (torch at one intra-op thread)

HOST = {"stage": 0, "offload_optimizer": {"device": "cpu", "host_update": True}}


def _cfg(**extra):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "seed": 7}
    cfg.update(extra)
    return cfg


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 256, (16, 33))
        out.append({"input_ids": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)})
    return out


def _port(config, seed=0):
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=seed),
                              config=config, device="cpu")
    return eng


def _jax(config):
    return jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=config)[0]


def _jstep(jeng, batch):
    return float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in batch.items()}))


def _jax_masters(jeng):
    return {k: np.asarray(v) for k, v in
            flatten_state_dict(jax.device_get(jeng.state["master_params"]), sep="/").items()}


def _jax_moments(jeng):
    sd = serialization.to_state_dict(jax.device_get(jeng.state["opt_state"]))
    m = _find_adam_moments(sd)
    return ({k: {n: np.asarray(v) for n, v in flatten_state_dict(m[k], sep="/").items()}
             for k in ("mu", "nu")}, int(np.asarray(m["count"])))


def _port_masters(eng):
    return {n: v.detach().numpy().copy() for n, v in
            ck._flat_reference(eng, eng.full_master_params()).items()}


def test_port_host_resume_is_bit_for_bit(tmp_path):
    b = _batches(5)
    eng = _port(_cfg(zero_optimization=HOST))
    for x in b[:3]:
        eng.train_batch(batch=x)
    eng.save_checkpoint(str(tmp_path))
    fresh = _port(_cfg(zero_optimization=HOST), seed=9)
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.global_steps == 3 and fresh._host_adam.t == 3 and fresh.step_count == 3
    assert [float(eng.train_batch(batch=x)) for x in b[3:]] == \
        [float(fresh.train_batch(batch=x)) for x in b[3:]]
    for n, t in eng.master_params.items():
        assert torch.equal(t, fresh.master_params[n])
        for i in (0, 1):
            assert torch.equal(eng._host_adam._moments[n][i], fresh._host_adam._moments[n][i])


def test_port_host_save_loads_into_jax_device_engine(tmp_path, monkeypatch):
    """Weights equal, moments fresh, with the JAX loader's warning."""
    eng = _port(_cfg(zero_optimization=HOST))
    for x in _batches(2):
        eng.train_batch(batch=x)
    eng.save_checkpoint(str(tmp_path))
    warned = []
    monkeypatch.setattr(jck.logger, "warning", lambda msg, *a: warned.append(msg))
    jeng = _jax(_cfg())
    path, _ = jeng.load_checkpoint(str(tmp_path))
    assert path is not None and jeng.global_steps == 2
    assert any("host_update checkpoint" in w and "fresh" in w for w in warned)
    want = _port_masters(eng)
    got = _jax_masters(jeng)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
    moments, _ = _jax_moments(jeng)
    assert all(not v.any() for k in ("mu", "nu") for v in moments[k].values())


def test_port_host_moments_reach_jax_through_universal(tmp_path):
    eng = _port(_cfg(zero_optimization=HOST))
    for x in _batches(3):
        eng.train_batch(batch=x)
    eng.save_checkpoint(str(tmp_path / "h"))
    ds_to_universal(str(tmp_path / "h"), str(tmp_path / "hu"))
    jeng = _jax(_cfg(checkpoint={"load_universal": True}))
    jeng.load_checkpoint(str(tmp_path / "hu"))
    moments, count = _jax_moments(jeng)
    assert count == 3 and int(jeng.state["step"]) == 3
    flat = ck.host_moments(eng)
    for k in ("mu", "nu"):
        for n, v in moments[k].items():
            np.testing.assert_array_equal(v.reshape(-1), flat[k][n].numpy())
    for n, v in _port_masters(eng).items():
        np.testing.assert_array_equal(_jax_masters(jeng)[n], v)


def test_jax_device_save_loads_into_port_host_engine(tmp_path):
    jeng = _jax(_cfg())
    for x in _batches(2):
        _jstep(jeng, x)
    jeng.save_checkpoint(str(tmp_path))
    eng = _port(_cfg(zero_optimization=HOST), seed=5)
    eng.load_checkpoint(str(tmp_path))
    assert eng.global_steps == 2 and eng.step_count == 2 and eng._host_adam.t == 0
    want = _jax_masters(jeng)
    for n, v in _port_masters(eng).items():
        np.testing.assert_array_equal(v, want[n])


def test_jax_moments_reach_port_host_engine_through_universal(tmp_path):
    """JAX device engine -> ``ds_to_universal`` -> the port's host engine:
    ``t`` continues and the next loss matches the JAX engine's."""
    b = _batches(4, seed=3)
    jeng = _jax(_cfg())
    for x in b[:3]:
        _jstep(jeng, x)
    jeng.save_checkpoint(str(tmp_path / "d"))
    ds_to_universal(str(tmp_path / "d"), str(tmp_path / "du"))
    eng = _port(_cfg(zero_optimization=HOST, checkpoint={"load_universal": True}), seed=5)
    eng.load_checkpoint(str(tmp_path / "du"))
    assert eng._host_adam.t == 3 and eng.step_count == 3
    np.testing.assert_allclose(float(eng.train_batch(batch=b[3])), _jstep(jeng, b[3]),
                               rtol=2e-5)


def test_async_writer_aio_route(tmp_path, monkeypatch):
    """The async writer's aio pool writes the same bytes as the synchronous
    engine, commits through the pool's wait, and a failed write fails the
    commit."""
    payloads = {"a.bin": b"alpha" * 1000, "b.bin": memoryview(bytearray(b"beta" * 777))}
    dirs = {}
    for name, eng in (("native", ce.NativeCheckpointEngine()),
                      ("async", ce.AsyncCheckpointEngine({"aio": True}))):
        d = tmp_path / name / "global_step1"
        eng.create("global_step1")
        eng.makedirs(str(d), exist_ok=True)
        op_builder.CALLS.clear()
        for fname, data in payloads.items():
            eng.save(data, str(d / fname))
        assert eng.commit("global_step1") is True
        assert op_builder.CALLS["aio_pwrite"] == (2 if name == "async" else 0)
        assert sorted(p.name for p in d.iterdir()) == ["a.bin", "b.bin", ce.MANIFEST_FILE]
        dirs[name] = d
    match, mismatch, errors = filecmp.cmpfiles(dirs["native"], dirs["async"],
                                               ["a.bin", "b.bin", ce.MANIFEST_FILE],
                                               shallow=False)
    assert not mismatch and not errors and len(match) == 3
    # the pool's pwrite fails on a descriptor opened for reading: EBADF
    # from the native side fails the commit, and the next tag commits

    def read_only(path, mode="r", *a, **kw):
        open(path, "wb").close()
        return open(path, "rb")

    eng = ce.AsyncCheckpointEngine()
    d = tmp_path / "bad" / "global_step2"
    eng.create("global_step2")
    eng.makedirs(str(d), exist_ok=True)
    monkeypatch.setattr(ce, "_io_open", read_only)
    eng.save(b"lost", str(d / "x.bin"))
    assert eng.commit("global_step2") is False and eng._txn == {} and eng._pending == []
    assert not (d / "x.bin").exists()
    monkeypatch.undo()
    eng.create("global_step3")
    eng.save(b"kept" * 10, str(d / "y.bin"))
    assert eng.commit("global_step3") is True and (d / "y.bin").read_bytes() == b"kept" * 10
