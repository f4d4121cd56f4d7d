"""1-bit Adam and ``all_to_all(tiled=False)`` of the PyTorch port at world 2
(two ``gloo`` processes on the CPU, ``torch_dp_worker.py``) against the JAX
package at dp = 2 (``jax.shard_map`` and the JAX engine on two devices of
the CPU mesh), on inputs from numpy seeds.

* ``comm/compressed.py`` ``onebit_all_reduce`` over three chained calls,
  each rank's error fed back: the packed sign bytes equal the JAX
  package's; the mean estimates and the errors within 1e-6 relative of
  their largest magnitude (``mean|c|`` sums in another order, so a scale
  may differ by an ulp);
* ``comm.all_to_all(tiled=False)`` equal to ``jax.lax.all_to_all(...,
  tiled=False)`` bit for bit, at two (split, concat) axis pairs;
* a OneBitAdam engine (GPT-NeoX ``tiny()``, gas 2, 2 rows a rank per
  microbatch, ``freeze_step`` 2, 5 steps): its warm-up steps equal plain
  Adam's within the JAX test's rtol 1e-6 (``test_onebit_adam.py:32-55``),
  in the port and in the JAX engine; the compressed steps track the JAX
  OneBitAdam engine within 1e-6 relative (measured on these batches: at
  most 8.0e-8, the size of the warm-up steps' differences, which come from
  summation order; a sign that flipped would move a loss far more); a save
  and a load into a fresh engine keep the masters bit for bit and leave
  the error feedback zero, as in the JAX engine (it is not part of the
  checkpoint).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu as jdst
from deeperspeed_tpu.comm import compressed as jcompressed
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.models import params_from_jax
from torch_dp_worker import spawn
import torch_threads  # noqa: F401  (torch at one intra-op thread)

STEPS, FREEZE = 5, 2
ROWS, SEQ = 8, 16
ONEBIT_STEPS, ONEBIT_N = 3, 301                  # chained calls; a length that pads
A2A = {"a2a-0-0": ((2, 3, 5), 0, 0), "a2a-1-2": ((3, 2, 4), 1, 2)}
COMPRESSED_TOL = 1e-6


def _config(opt):
    return {"train_batch_size": ROWS, "gradient_accumulation_steps": 2,
            "optimizer": {"type": opt, "params": {"lr": 1e-3, "freeze_step": FREEZE}},
            "seed": 3}


RUNS = {"onebit": "OneBitAdam", "adam": "Adam"}


def _batches():
    rng = np.random.default_rng(41)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _comm_inputs():
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, ONEBIT_STEPS, ONEBIT_N)).astype(np.float32)
    x[1] *= 2.5
    out = {"onebit": x}
    for name, (shape, _, _) in A2A.items():
        out[name] = rng.standard_normal((2,) + shape).astype(np.float32)
    return out


def _jax_comm(inputs):
    mesh = jtopo.set_mesh(jtopo.MeshTopology(dp=2, devices=jax.devices()[:2]))

    def one(x, err):
        x, err = x[0], err[0]
        c = x + err
        packed = jcompressed._pack_signs(jnp.pad(c >= 0, (0, (-c.shape[0]) % 8)))
        y, new_err = jcompressed.onebit_all_reduce(x, "dp", err)
        return y[None], new_err[None], packed[None]

    fn = jax.jit(jax.shard_map(one, mesh=mesh.mesh, in_specs=(P("dp"), P("dp")),
                               out_specs=(P("dp"), P("dp"), P("dp")), check_vma=False))
    err = jnp.zeros((2, ONEBIT_N), jnp.float32)
    out = {}
    for i in range(ONEBIT_STEPS):
        y, err, packed = fn(jnp.asarray(inputs["onebit"][:, i]), err)
        out[f"onebit/{i}"] = tuple(np.asarray(a) for a in (y, err, packed))
    for name, (_, split, concat) in A2A.items():
        def a2a(x, split=split, concat=concat):
            return jax.lax.all_to_all(x[0], "dp", split, concat, tiled=False)[None]

        out[name] = np.asarray(jax.jit(jax.shard_map(
            a2a, mesh=mesh.mesh, in_specs=P("dp"), out_specs=P("dp"),
            check_vma=False))(jnp.asarray(inputs[name])))
    return out


def _jax_engines(batches):
    out, start = {}, None
    for name, opt in RUNS.items():
        mesh = jtopo.MeshTopology(dp=2, devices=jax.devices()[:2])
        jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=_config(opt),
                                   mesh=mesh)
        masters = params_from_jax(jax.device_get(jeng.state["master_params"]))
        start = start or masters
        out[name] = np.array([float(jeng.train_batch(
            batch={k: jnp.asarray(v) for k, v in b.items()})) for b in batches])
        if name == "onebit":
            assert jeng._onebit
    return out, start


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("onebit")
    batches, inputs = _batches(), _comm_inputs()
    saved = jtopo._GLOBAL_MESH
    try:
        jax_comm = _jax_comm(inputs)
        jax_losses, start = _jax_engines(batches)
    finally:
        jtopo.set_mesh(saved)
    arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    for name, x in inputs.items():
        arrays.update({f"x/{name}/{r}": x[r] for r in range(2)})
    spec = {"kind": ["comm", "train"], "n_batches": STEPS,
            "cases": [{"name": "onebit", "op": "onebit", "steps": ONEBIT_STEPS}] + [
                {"name": name, "op": "all_to_all_untiled", "split": split, "concat": concat}
                for name, (_, split, concat) in A2A.items()],
            "runs": [{"name": name, "config": _config(opt), "dtype": "fp32", "steps": STEPS,
                      **({"reload": str(tmp / "ckpt")} if name == "onebit" else {})}
                     for name, opt in RUNS.items()]}
    ranks = spawn(spec, arrays, tmp)
    return jax_comm, jax_losses, ranks


def test_onebit_all_reduce_matches_jax(both):
    jax_comm, _, ranks = both
    for i in range(ONEBIT_STEPS):
        jy, jerr, jpacked = jax_comm[f"onebit/{i}"]
        for r in range(2):
            np.testing.assert_array_equal(ranks[r][f"onebit/{i}/packed"], jpacked[r])
            for got, want in ((ranks[r][f"onebit/{i}/y"], jy[r]),
                              (ranks[r][f"onebit/{i}/err"], jerr[r])):
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (i, r)
        # the estimate is the same on both ranks, and error feedback is live
        np.testing.assert_array_equal(ranks[0][f"onebit/{i}/y"], ranks[1][f"onebit/{i}/y"])
        assert np.abs(ranks[0][f"onebit/{i}/err"]).max() > 0


@pytest.mark.parametrize("name", list(A2A))
def test_all_to_all_untiled_matches_jax(both, name):
    jax_comm, _, ranks = both
    for r in range(2):
        got, want = ranks[r][name], jax_comm[name][r]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_onebit_warmup_is_plain_adam(both):
    _, jax_losses, ranks = both
    ob, adam = ranks[0]["onebit/losses"], ranks[0]["adam/losses"]
    np.testing.assert_array_equal(ob, ranks[1]["onebit/losses"])
    np.testing.assert_allclose(ob[:FREEZE], adam[:FREEZE], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(jax_losses["onebit"][:FREEZE], jax_losses["adam"][:FREEZE],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ob[:FREEZE], jax_losses["onebit"][:FREEZE], rtol=1e-5)
    # compression engaged after freeze_step: the trajectory leaves Adam's
    assert any(abs(a - b) > 1e-6 for a, b in zip(ob[FREEZE + 1:], adam[FREEZE + 1:]))


def test_onebit_compressed_steps_track_jax(both):
    _, jax_losses, ranks = both
    ob, want = ranks[0]["onebit/losses"], jax_losses["onebit"]
    rel = np.abs(ob - want) / np.abs(want)
    assert rel.max() <= COMPRESSED_TOL, rel
    assert ob[-1] < ob[0]


def test_onebit_footprint_and_reload(both):
    _, _, ranks = both
    r0 = ranks[0]
    steps = json.loads(str(r0["onebit/footprints"]))
    assert [s[0]["op"] for s in steps] == ["grad_reduce_dp"] * FREEZE + \
        ["onebit_all_reduce"] * (STEPS - FREEZE)
    assert float(r0["onebit/error_before"]) > 0
    assert float(r0["onebit/error_after"]) == 0.0
    assert bool(r0["onebit/reload_equal"])
