"""The port's native host routines on the CPU (``csrc/host/``, built with
the system compiler at first use): the CPU optimizer steps against their
plain PyTorch versions and the numpy formula of the JAX package's
``dst_cpu_adam.cpp``, and the aio pool's reads and writes.

Tolerances: ``rtol=2e-5, atol=2e-6`` over 4 steps at n = 4097 (not a
multiple of the SIMD width), the JAX package's own for its CPU Adam.  The
native loop may contract a product and a sum into one fused multiply-add
where the plain version rounds twice.
"""

import os
import threading

import numpy as np
import pytest
import torch

from deeperspeed_tpu_torch import op_builder
from deeperspeed_tpu_torch.op_builder import builder as builder_module
from deeperspeed_tpu_torch.ops.adam import cpu_adam as ca
from deeperspeed_tpu_torch.ops.aio import AsyncIOHandle
import torch_threads  # noqa: F401  (torch at one intra-op thread)

N, STEPS = 4097, 4
RTOL, ATOL = 2e-5, 2e-6


def _state(seed, n=N):
    rng = np.random.default_rng(seed)
    return {"p": rng.standard_normal(n).astype(np.float32),
            "g": [rng.standard_normal(n).astype(np.float32) for _ in range(STEPS)]}


def _adam_numpy(p, grads, m, v, lr, b1, b2, eps, wd, adamw):
    """The JAX package's C loop in numpy, fp32."""
    f = np.float32
    for t, g in enumerate(grads, start=1):
        bc1, bc2 = f(1 - b1 ** t), f(1 - b2 ** t)
        if not adamw and wd > 0:
            g = g + f(wd) * p
        m = f(b1) * m + f(1 - b1) * g
        v = f(b2) * v + f(1 - b2) * g * g
        upd = (m * (f(1) / bc1)) / (np.sqrt(v * (f(1) / bc2)) + f(eps))
        if adamw and wd > 0:
            upd = upd + f(wd) * p
        p = p - f(lr) * upd
    return p, m, v


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("adamw,wd", [(False, 0.0), (False, 0.01), (True, 0.1)])
def test_cpu_adam_matches_plain_and_numpy(adamw, wd, gdtype):
    """fp32 gradients, and bf16 ones (a bf16 wire's), which the library
    widens in its sweep; the numpy formula takes them widened."""
    s = _state(0)
    s["g"] = [torch.from_numpy(g).to(gdtype).float().numpy() for g in s["g"]]
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    p, m, v = (torch.from_numpy(s["p"].copy()), torch.zeros(N), torch.zeros(N))
    pp, mp, vp = p.clone(), m.clone(), v.clone()
    op_builder.CALLS.clear()
    for t, g in enumerate(s["g"], start=1):
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        gt = torch.from_numpy(g).to(gdtype)
        ca.cpu_adam_step_(p, gt, m, v, lr, b1, b2, eps, wd, bc1, bc2, adamw)
        ca.cpu_adam_step_plain(pp, gt, mp, vp, lr, b1, b2, eps, wd, bc1, bc2, adamw)
    assert op_builder.CALLS["cpu_adam"] == STEPS
    want_p, want_m, want_v = _adam_numpy(s["p"], s["g"], 0, 0, lr, b1, b2, eps, wd, adamw)
    for got, plain, want in ((p, pp, want_p), (m, mp, want_m), (v, vp, want_v)):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_adam_class_keeps_the_jax_api():
    """``step(params, grads, lr=)`` by name, ``t``, ``_moments`` by name;
    a bf16 gradient is read as it is; a strided one is refused."""
    s = _state(1)
    opt = ca.DeeperSpeedCPUAdam(lr=1e-3, adamw_mode=False)
    params = {"a": torch.from_numpy(s["p"].copy()), "b": torch.ones(3, 5)}
    for g in s["g"]:
        opt.step(params, {"a": torch.from_numpy(g), "b": torch.ones(15).bfloat16()}, lr=1e-3)
    assert opt.t == STEPS and set(opt._moments) == {"a", "b"}
    want_p, want_m, _ = _adam_numpy(s["p"], s["g"], 0, 0, 1e-3, 0.9, 0.999, 1e-8, 0.0, False)
    np.testing.assert_allclose(params["a"].numpy(), want_p, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(opt._moments["a"][0].numpy(), want_m, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="contiguous float32"):
        opt.step({"c": torch.ones(4, 4).t()}, {"c": torch.ones(16)})
    with pytest.raises(ValueError, match="contiguous gradient"):
        opt.step({"d": torch.ones(16)}, {"d": torch.ones(4, 4).t()})
    with pytest.raises(ValueError, match="contiguous gradient"):
        ca.cpu_lion_step_(torch.ones(4), torch.ones(4).bfloat16(), torch.zeros(4),
                          1e-4, 0.9, 0.99, 0.0)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_cpu_adagrad_matches_plain_and_numpy(wd):
    s = _state(2)
    lr, eps = 1e-2, 1e-10
    p, h = torch.from_numpy(s["p"].copy()), torch.zeros(N)
    pp, hp = p.clone(), h.clone()
    want_p, want_h = s["p"].copy(), np.zeros(N, np.float32)
    for g in s["g"]:
        ca.cpu_adagrad_step_(p, torch.from_numpy(g), h, lr, eps, wd)
        ca.cpu_adagrad_step_plain(pp, torch.from_numpy(g), hp, lr, eps, wd)
        gw = g + np.float32(wd) * want_p if wd > 0 else g
        want_h = want_h + gw * gw
        want_p = want_p - np.float32(lr) * gw / (np.sqrt(want_h) + np.float32(eps))
    for got, plain, want in ((p, pp, want_p), (h, hp, want_h)):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_cpu_lion_matches_plain_and_numpy(wd):
    """Lion, with sign(0) = 0: the first step's moment is 0, so where the
    gradient is 0 the update is 0."""
    s = _state(3)
    s["g"][0][::7] = 0.0
    lr, b1, b2 = 1e-4, 0.9, 0.99
    p, m = torch.from_numpy(s["p"].copy()), torch.zeros(N)
    pp, mp = p.clone(), m.clone()
    want_p, want_m = s["p"].copy(), np.zeros(N, np.float32)
    before = p.clone()
    for t, g in enumerate(s["g"]):
        ca.cpu_lion_step_(p, torch.from_numpy(g), m, lr, b1, b2, wd)
        ca.cpu_lion_step_plain(pp, torch.from_numpy(g), mp, lr, b1, b2, wd)
        if t == 0 and wd == 0.0:
            assert torch.equal(p[::7], before[::7])
        upd = np.sign(np.float32(b1) * want_m + np.float32(1 - b1) * g)
        if wd > 0:
            upd = upd + np.float32(wd) * want_p
        want_p = want_p - np.float32(lr) * upd
        want_m = np.float32(b2) * want_m + np.float32(1 - b2) * g
    for got, plain, want in ((p, pp, want_p), (m, mp, want_m)):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_host_routines_refuse_device_tensors():
    with pytest.raises(ValueError, match="CPU tensors"):
        ca.cpu_adam_step_(torch.zeros(4, device="meta"), torch.zeros(4), torch.zeros(4),
                          torch.zeros(4), 1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001, True)


def test_aio_round_trip_tensors_and_bytes(tmp_path):
    h = AsyncIOHandle(num_threads=3)
    op_builder.CALLS.clear()
    x = torch.arange(1000, dtype=torch.float32)
    y = torch.arange(77, dtype=torch.bfloat16)
    h.async_pwrite(x, tmp_path / "x.bin")
    h.async_pwrite(y, str(tmp_path / "y.bin"), fsync=False)
    h.async_pwrite(b"header" * 100, str(tmp_path / "b.bin"))
    h.async_pwrite(memoryview(bytearray(b"view" * 10)), str(tmp_path / "v.bin"))
    assert h.wait() == 0 and h.pending == 0
    assert op_builder.CALLS["aio_pwrite"] == 4
    assert (tmp_path / "b.bin").read_bytes() == b"header" * 100
    assert (tmp_path / "v.bin").read_bytes() == b"view" * 10
    assert not any(p.name.endswith(".dst_tmp") for p in tmp_path.iterdir())
    gx, gy = torch.empty_like(x), torch.empty_like(y)
    h.async_pread(gx, str(tmp_path / "x.bin"))
    h.async_pread(gy, str(tmp_path / "y.bin"))
    assert h.wait() == 0
    assert torch.equal(gx, x) and torch.equal(gy, y)
    assert op_builder.CALLS["aio_pread"] == 2
    assert bytes(h.read_bytes(str(tmp_path / "b.bin"), 12)) == b"headerheader"
    h.close()


def test_aio_errors_pending_and_wait(tmp_path):
    h = AsyncIOHandle(num_threads=1)
    buf = torch.empty(8)
    h.async_pread(buf, str(tmp_path / "missing.bin"))
    assert h.wait() == -2                     # ENOENT, reported once
    assert h.wait() == 0
    with pytest.raises(OSError) as err:
        h.read_bytes(str(tmp_path / "missing.bin"), 4)
    assert err.value.errno == 2
    (tmp_path / "short.bin").write_bytes(b"abc")
    h.async_pread(bytearray(8), str(tmp_path / "short.bin"))
    assert h.wait() == -5                     # EIO: the file is shorter than the buffer
    # requests queue behind each other on one thread: pending counts them
    big = torch.zeros(8 << 20)
    for i in range(4):
        h.async_pwrite(big, str(tmp_path / f"big{i}.bin"))
    assert 0 < h.pending <= 4
    assert h.wait() == 0 and h.pending == 0
    with pytest.raises(ValueError, match="writable"):
        h.async_pread(b"read-only", str(tmp_path / "big0.bin"))
    h.close()


def test_builder_names_by_hash_and_raises_on_a_failed_build(tmp_path, monkeypatch):
    """The library's name hashes sources, flags and host; a build writes
    a per-process temporary name and renames it; a failed build raises
    (no fallback)."""
    b = op_builder.CPUAdamBuilder()
    target = b.target()
    assert target.name.startswith("libdst_cpu_adam-") and target.suffix == ".so"
    assert f".{os.getpid()}.{threading.get_ident()}.tmp" not in str(target)
    monkeypatch.setattr(builder_module, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(op_builder.CPUAdamBuilder, "extra_compile_args",
                        lambda self: ["-DDELIBERATE", "-include", "/nonexistent.h"])
    with pytest.raises(RuntimeError, match="native build of dst_cpu_adam failed"):
        op_builder.CPUAdamBuilder().build()
    assert not list(tmp_path.glob("*.tmp"))
