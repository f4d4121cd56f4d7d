"""The fused optimizers B6 (Adam) and B7 (Lion) of the PyTorch port against
the JAX package on the CPU: their plain versions against the JAX package's
jnp formulas and its Pallas kernels run in interpret mode, the
transformations step for step, and ``FusedAdam`` / ``FusedLion`` engine
trajectories against the JAX engine's.

Tolerances: no looser than the JAX package's own tests
(``tests/unit/ops/test_fused_adam.py``: u rtol 1e-4, m and v rtol 1e-5 and
atol 1e-8 against the interpret-mode kernel).  Against the jnp formulas
m' and v' hold within rtol 1e-6 (both sides round each product and sum
once, in the same order); the interpret-mode kernels contract a product
and a sum into one FMA, which moves an m' that nearly cancels by more,
so there the JAX tests' rtol 1e-5 / atol 1e-8 holds.  u within rtol 1e-5;
Lion's u equal wherever the sign's argument is not within rounding of 0.
Trajectories: ``LOSS_TOL["fp32"]`` of ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.ops.adam import fused_adam as jfused_adam
from deeperspeed_tpu.ops.adam import pallas_adam as jpallas_adam
from deeperspeed_tpu.ops.lion import fused_lion as jfused_lion
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.ops import multi_tensor
from deeperspeed_tpu_torch.ops.adam import fused_adam
from deeperspeed_tpu_torch.ops.lion import fused_lion
from deeperspeed_tpu_torch.runtime.optimizers import _bias_correction
import torch_threads  # noqa: F401  (torch at one intra-op thread)

# under and over one Pallas block row (1024 = 8 x 128), and a non-multiple of 128
SIZES = [100, 1000, 1024, 4000, 5003]
B1, B2, EPS = 0.9, 0.999, 1e-8


def _jax_engine(model, config, **kw):
    """The JAX engine, its step counter placed on the mesh as its first step
    leaves it: the second step then reuses the first's compile instead of
    tracing again.  The values are the same."""
    jeng, *_ = jdst.initialize(model=model, config=config, **kw)
    mesh = jax.tree.leaves(jeng.state["master_params"])[0].sharding.mesh
    jeng.state["step"] = jax.device_put(jeng.state["step"], NamedSharding(mesh, P()))
    return jeng



def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    m = (0.1 * rng.standard_normal(n)).astype(np.float32)
    v = np.abs(0.01 * rng.standard_normal(n)).astype(np.float32)
    return g, m, v


def _adam_plain(g, m, v, count):
    tg, tm, tv = (torch.from_numpy(a.copy()) for a in (g, m, v))
    fused_adam._adam_leaf_update_plain([tg], [tm], [tv], _bias_correction(B1, count),
                                       _bias_correction(B2, count), B1, B2, EPS)
    return tg.numpy(), tm.numpy(), tv.numpy()


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("count", [1, 3, 50])
def test_adam_plain_matches_jnp(n, count):
    g, m, v = _inputs(n, n + count)
    u, m2, v2 = _adam_plain(g, m, v, count)
    ur, mr, vr = jfused_adam._adam_leaf_update_jnp(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), jnp.float32(count), B1, B2, EPS)
    _close(m2, mr, 1e-6, 1e-12)
    _close(v2, vr, 1e-6, 1e-15)
    _close(u, ur, 1e-5, 1e-7)


def _interpret(fn, *args):
    orig = pl.pallas_call
    try:
        pl.pallas_call = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
        return fn.__wrapped__(*args)
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("n", SIZES)
def test_adam_plain_matches_the_pallas_kernel(n):
    g, m, v = _inputs(n, 7 * n)
    count = 3
    u, m2, v2 = _adam_plain(g, m, v, count)
    ur, mr, vr = _interpret(jpallas_adam.fused_adam_kernel, jnp.asarray(g), jnp.asarray(m),
                            jnp.asarray(v), jnp.float32(count), B1, B2, EPS)
    _close(m2, mr, 1e-5, 1e-8)
    _close(v2, vr, 1e-5, 1e-8)
    _close(u, ur, 1e-5, 1e-7)


def _lion_plain(g, m, b1=0.9, b2=0.99):
    tg, tm = torch.from_numpy(g.copy()), torch.from_numpy(m.copy())
    fused_lion._lion_leaf_plain([tg], [tm], b1, b2)
    return tg.numpy(), tm.numpy()


def _lion_check(g, m, u, m2, ur, mr, b1=0.9, rtol=1e-6, atol=1e-12):
    bm, bg = b1 * m, (1.0 - b1) * g
    clear = np.abs(bm + bg) > 2.0 ** -22 * (np.abs(bm) + np.abs(bg))
    np.testing.assert_array_equal(u[clear], np.asarray(ur)[clear])
    _close(m2, mr, rtol, atol)


@pytest.mark.parametrize("n", SIZES)
def test_lion_plain_matches_jnp_and_the_pallas_kernel(n):
    g, m, _ = _inputs(n, 3 * n)
    g[:3] = 0.0
    m[:3] = 0.0                       # sign(0) is 0 in both
    g[3] = np.nan                     # sign(NaN) is NaN in both
    u, m2 = _lion_plain(g, m)
    assert np.all(u[:3] == 0.0)
    assert np.isnan(u[3]) and np.isnan(m2[3])
    ur, mr = jfused_lion._lion_leaf_jnp(jnp.asarray(g), jnp.asarray(m), 0.9, 0.99)
    np.testing.assert_array_equal(np.isnan(u), np.isnan(np.asarray(ur)))
    _lion_check(g, m, u, m2, ur, mr)
    ur, mr = _interpret(jfused_lion.fused_lion_kernel, jnp.asarray(g), jnp.asarray(m),
                        0.9, 0.99)
    np.testing.assert_array_equal(np.isnan(u), np.isnan(np.asarray(ur)))
    _lion_check(g, m, u, m2, ur, mr, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", ["adam", "lion"])
def test_transformations_match_jax_step_for_step(name):
    """scale_by_fused_adam / scale_by_fused_lion over a dict of leaves, five
    steps, against the JAX package's transformations."""
    rng = np.random.default_rng(11)
    shapes = {"w": (64, 32), "b": (4096,), "c": (3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    if name == "adam":
        jtx, ttx = jfused_adam.scale_by_fused_adam(B1, B2, EPS), fused_adam.scale_by_fused_adam(
            B1, B2, EPS)
    else:
        jtx, ttx = jfused_lion.scale_by_fused_lion(0.9, 0.99), fused_lion.scale_by_fused_lion(
            0.9, 0.99)
    js, ts = jtx.init(jparams), ttx.init(tparams)
    moments = list(ts["mu"].values()) if name == "adam" else list(ts.values())
    assert multi_tensor.flat_span(moments) is not None   # one flat buffer, in order
    for step in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        m_prev = {k: v.clone() for k, v in ts.items()} if name == "lion" else None
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jparams)
        tu, ts = ttx.update({k: torch.from_numpy(v.copy()) for k, v in grads.items()}, ts,
                            tparams)
        for k in shapes:
            if name == "adam":
                _close(tu[k].numpy(), ju[k], 1e-5, 1e-7)
                _close(ts["mu"][k].numpy(), js.mu[k], 1e-6, 1e-12)
                _close(ts["nu"][k].numpy(), js.nu[k], 1e-6, 1e-12)
            else:
                _lion_check(grads[k], m_prev[k].numpy(), tu[k].numpy(), ts[k].numpy(),
                            ju[k], js.mu[k])
    if name == "adam":
        assert ts["count"] == int(js.count) == 5


def test_flat_span():
    flat = torch.arange(10.0)
    views = [flat[0:3].view(3, 1), flat[3:4], flat[4:10].view(2, 3)]
    span = multi_tensor.flat_span(views)
    assert span.data_ptr() == flat.data_ptr() and span.shape == (10,)
    assert multi_tensor.flat_span([flat[0:3], flat[4:10]]) is None        # a gap
    assert multi_tensor.flat_span([flat[3:4], flat[0:3]]) is None         # out of order
    assert multi_tensor.flat_span([flat[0:4], torch.arange(6.0)]) is None  # two buffers
    assert multi_tensor.flat_span([flat[0:6].view(2, 3).t()]) is None      # not contiguous


def test_prepare_reuses_its_table_for_the_same_tensors(monkeypatch):
    """With a cache, the same tensor objects get the table built for them
    the first time; other tensors, and a table that needs copies written
    back, are built anew.  (The table itself is built on the card only.)"""
    built = []

    def fake(kernel, lists, write_back=()):
        built.append(lists)
        return ("table", 1, 1, list(write_back))

    monkeypatch.setattr(multi_tensor, "_prepare", fake)
    flat = torch.zeros(10)
    g, m = [flat[:4], flat[4:]], [torch.zeros(4), torch.zeros(6)]
    cache = {}
    first = multi_tensor.prepare("k", [g, m], cache)
    assert multi_tensor.prepare("k", [list(g), list(m)], cache) is first
    assert len(built) == 1
    multi_tensor.prepare("k", [[flat[:4], flat[4:]], m], cache)   # new views
    multi_tensor.prepare("k", [g, m])                              # no cache
    assert len(built) == 3
    monkeypatch.setattr(multi_tensor, "_prepare",
                        lambda kernel, lists: fake(kernel, lists, [(g[0], g[0])]))
    cache = {}
    multi_tensor.prepare("k", [g, m], cache)
    assert not cache


LOSS_TOL = 1e-5


@pytest.mark.parametrize("name,wd", [("FusedAdam", 0.0), ("FusedAdam", 0.01),
                                     ("FusedLion", 0.0), ("FusedLion", 0.01)])
def test_engine_trajectory_matches_jax(name, wd):
    """FusedAdam puts the L2 term before the moments, FusedLion the decayed
    weights after its core, as the JAX factory chains them."""
    lr = 1e-3 if name == "FusedAdam" else 1e-4
    config = {"train_batch_size": 8, "gradient_clipping": 1.0,
              "optimizer": {"type": name, "params": {"lr": lr, "weight_decay": wd}}}
    jeng = _jax_engine(JaxGPTNeoX(JaxConfig.tiny()), config)
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    teng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                               config=config, model_parameters=start, device="cpu")
    core = [s for s in teng.opt_state if s is not None][0]   # weight decay has none
    moments = core["mu"] if name == "FusedAdam" else core
    assert list(moments) == teng._order           # the engine's order, one buffer
    assert multi_tensor.flat_span(list(moments.values())) is not None
    rng = np.random.default_rng(4)
    for step in range(4):
        toks = rng.integers(0, 256, (8, 17))
        batch = {"input_ids": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        lj = float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in batch.items()}))
        lt = float(teng.train_batch(batch=batch))
        assert abs(lt - lj) <= LOSS_TOL * abs(lj), (name, wd, step, lj, lt)
