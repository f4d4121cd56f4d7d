"""The port's ZeRO-Infinity chunk stream (``runtime/zero/infinity.py``) on
the CPU: ``tiny()`` in 2 chunks, fp32, against the JAX engine's device Adam
(no clipping: the chunk stream clips nothing, as in the JAX package) and
against the port's host-update engine (the native CPU Adam over host
masters), on the weights the JAX package's ``GPTNeoXPipe.init(PRNGKey(3))``
gives, mapped to the flat model as the JAX package's
``test_matches_host_update_flat_engine`` maps them
(``tests/unit/runtime/zero/test_infinity.py:58-73``), within that test's
bound (``rtol=2e-4, atol=2e-4``).  The Llama family streams against the JAX
Llama engine's device Adam from that engine's own initial weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.models.gpt_neox_pipe import GPTNeoXPipe
from deeperspeed_tpu.models.llama import Llama as JaxLlama
from deeperspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deeperspeed_tpu.parallel.topology import MeshTopology
from deeperspeed_tpu_torch.comm.memplan import HBMBudgetError
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, Llama, LlamaConfig
from deeperspeed_tpu_torch.models import params_from_jax
from deeperspeed_tpu_torch.models.llama import params_from_jax as llama_params_from_jax
from deeperspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine
import torch_threads  # noqa: F401  (torch at one intra-op thread)

BATCH = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").example_batch(batch_size=8, seq_len=16)


@pytest.fixture(scope="module")
def pipe_tree():
    """The JAX pipe's stacked init, mapped to the flat model's flax tree."""
    tiny = JaxConfig.tiny()
    pipe = GPTNeoXPipe(tiny, num_stages=2)
    full = jax.tree_util.tree_map(
        np.asarray, pipe.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    flat = {"embed_in": full["embed"]["embed_in"],
            "final_layer_norm": full["head"]["final_layer_norm"],
            "embed_out": full["head"]["embed_out"]}
    L = tiny.num_layers
    for i in range(L):
        s, l = divmod(i, L // 2)
        flat[f"layers_{i}"] = jax.tree_util.tree_map(lambda x: x[s, l], full["stages"])
    return flat


@pytest.fixture(scope="module")
def pipe_weights(pipe_tree):
    """:func:`pipe_tree` as a port state dict."""
    return params_from_jax(pipe_tree)


def _one_device():
    """A JAX mesh of one device: the stream's batch is one process's."""
    return MeshTopology(dp=1, devices=jax.devices()[:1])


def _jax_losses(tree, steps, gas=1):
    """The JAX engine's device Adam (lr 1e-3, no clipping) from ``tree`` on
    :data:`BATCH`: its losses over ``steps`` steps."""
    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": gas,
           "gradient_clipping": 0.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 0}}
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=cfg,
                               model_parameters=tree, mesh=_one_device())
    batch = {k: jnp.asarray(v.numpy()) for k, v in BATCH.items()}
    return [float(jeng.train_batch(batch=batch)) for _ in range(steps)]


def _engine(tmp_path, params, model=None, **kw):
    model = model or GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=11)
    kw.setdefault("compute_dtype", torch.float32)
    return ZeroInfinityEngine(model, nvme_path=str(tmp_path), num_chunks=2, lr=1e-3,
                              params=params, device="cpu", **kw)


def test_matches_the_host_update_engine_on_the_jax_pipes_weights(pipe_tree, pipe_weights,
                                                                 tmp_path):
    """3 steps against the JAX engine's device Adam from the same flax tree
    and against the port's host update, within the JAX package's bound."""
    want = _jax_losses(pipe_tree, 3)
    eng = _engine(tmp_path / "inf", pipe_weights)
    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 0, "offload_optimizer": {
               "device": "cpu", "host_update": True}}}
    ref, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config=cfg, model_parameters=pipe_weights, device="cpu")
    got = []
    for step in range(3):
        li, lr = eng.train_batch(BATCH), float(ref.train_batch(batch=BATCH))
        np.testing.assert_allclose(li, lr, rtol=2e-4, atol=2e-4, err_msg=f"step {step}")
        got.append(li)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got[-1] < got[0]
    stats = eng.swap_stats
    assert stats["peak_device_param_bytes"] < stats["total_param_bytes"]
    # every step reads the parameters twice (forward and recompute) and
    # writes masters, moments and the compute copy
    assert stats["bytes_read"] > stats["total_param_bytes"]
    assert stats["bytes_written"] > stats["total_param_bytes"]
    assert stats["io_wait_s"] >= 0 and stats["waited_bandwidth_gbps"] > 0
    eng.close()


def test_gradient_accumulation_matches_one_big_batch(pipe_tree, pipe_weights, tmp_path):
    """gas 2 over the fp32 accumulators on disk equals one gas-1 step on the
    whole batch (the JAX package's bounds), and its 2 steps are the JAX
    engine's at gas 2."""
    want = _jax_losses(pipe_tree, 2, gas=2)
    e1 = _engine(tmp_path / "a", pipe_weights)
    e2 = _engine(tmp_path / "b", pipe_weights)
    l1 = e1.train_batch(BATCH)
    l2 = e2.train_batch(BATCH, gradient_accumulation_steps=2)
    np.testing.assert_allclose(l2, l1, rtol=5e-3, atol=5e-3)
    for name in ("c0", "c1", "embed", "head"):
        for x, y in zip(e1.master(name), e2.master(name)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=5e-5)
    got = [l2, e2.train_batch(BATCH, gradient_accumulation_steps=2)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    e1.close()
    e2.close()


def test_llama_family_streams_too(tmp_path):
    """Llama ``tiny()`` in 2 chunks: 4 steps against the JAX Llama engine's
    device Adam from that engine's initial weights."""
    cfg = {"train_batch_size": 4, "gradient_clipping": 0.0,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 0}}
    jeng, *_ = jdst.initialize(model=JaxLlama(JaxLlamaConfig.tiny()), config=cfg,
                               mesh=_one_device())
    start = llama_params_from_jax(jax.device_get(jeng.state["master_params"]))
    toks = np.random.default_rng(0).integers(0, 256, size=(4, 17))
    batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    want = [float(jeng.train_batch(batch={k: jnp.asarray(v, jnp.int32)
                                          for k, v in batch.items()})) for _ in range(4)]
    eng = ZeroInfinityEngine(Llama(LlamaConfig.tiny(), device="cpu"), nvme_path=str(tmp_path),
                             num_chunks=2, lr=1e-3, compute_dtype=torch.float32,
                             params=start, device="cpu")
    losses = [eng.train_batch(batch) for _ in range(4)]
    np.testing.assert_allclose(losses, want, rtol=2e-4, atol=2e-4)
    assert losses[-1] < losses[0]
    s = eng.swap_stats
    assert s["peak_device_param_bytes"] < s["total_param_bytes"]
    eng.close()
    with pytest.raises(NotImplementedError, match="tie_embeddings"):
        ZeroInfinityEngine(Llama(LlamaConfig.tiny_opt(), device="cpu"),
                           nvme_path=str(tmp_path), device="cpu")


def test_schedules_and_budget(pipe_weights, tmp_path):
    """``off`` streams as ``static`` does; ``static`` with a budget below
    two units raises ``HBMBudgetError``; ``auto`` plans the stream
    (``tests/test_torch_infinity_plan.py`` holds it against static and the
    JAX engine); another schedule is refused."""
    eng = _engine(tmp_path / "off", pipe_weights, memory_schedule="off")
    assert eng.swap_stats["memory_schedule"] == "off" and eng.mem_plan is None
    eng.close()
    with pytest.raises(HBMBudgetError, match="static placement"):
        _engine(tmp_path / "tight", pipe_weights, hbm_budget_bytes=1024)
    eng = _engine(tmp_path / "auto", pipe_weights, memory_schedule="auto")
    assert eng.mem_plan.hbm_budget_bytes == 0 and eng.mem_plan.resident == ()
    assert eng.swap_stats["planned_prefetch_depth"] == eng.mem_plan.prefetch_depth == 1
    eng.close()
    with pytest.raises(ValueError, match="auto|static|off"):
        _engine(tmp_path / "bad", pipe_weights, memory_schedule="planned")


@pytest.mark.parametrize("family", ["neox", "llama"])
def test_stage_models_stream_in_their_stages(family, tmp_path):
    """ZeRO-Infinity over ``GPTNeoXPipe`` / ``LlamaPipe`` (2 stages, a chunk
    each, no pipeline processes): 3 steps against the JAX
    ``ZeroInfinityEngine`` over the same stage model from its own init
    (``PRNGKey(3)``) within this file's bound, and bit for bit the port's
    flat stream at ``num_chunks = num_stages`` on the same weights (losses
    and every unit's masters)."""
    from deeperspeed_tpu.models.llama_pipe import LlamaPipe as JaxLlamaPipe
    from deeperspeed_tpu.runtime.zero.infinity import ZeroInfinityEngine as JaxInfinity
    from deeperspeed_tpu_torch.models import gpt_neox, llama
    from deeperspeed_tpu_torch.models.gpt_neox_pipe import GPTNeoXPipe as PortNeoXPipe
    from deeperspeed_tpu_torch.models.llama_pipe import LlamaPipe as PortLlamaPipe

    if family == "neox":
        jpipe, mod = GPTNeoXPipe(JaxConfig.tiny(), num_stages=2), gpt_neox
        spec, flat = (PortNeoXPipe(GPTNeoXConfig.tiny(), 2, device="cpu"),
                      GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"))
    else:
        jpipe, mod = JaxLlamaPipe(JaxLlamaConfig.tiny(), num_stages=2), llama
        spec, flat = (PortLlamaPipe(LlamaConfig.tiny(), 2, device="cpu"),
                      Llama(LlamaConfig.tiny(), device="cpu"))
    tree = jax.tree_util.tree_map(
        np.asarray, jpipe.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    weights = mod.pipe_params_from_jax(tree, 0, num_stages=1)
    jeng = JaxInfinity(jpipe, nvme_path=str(tmp_path / "jax"), lr=1e-3,
                       compute_dtype=jnp.float32, seed=3)
    want = [float(jeng.train_batch({k: jnp.asarray(v.numpy()) for k, v in BATCH.items()}))
            for _ in range(3)]
    jeng.close()
    engines = [ZeroInfinityEngine(model, nvme_path=str(tmp_path / name), lr=1e-3,
                                  compute_dtype=torch.float32, params=weights, device="cpu",
                                  **kw)
               for name, model, kw in (("pipe", spec, {}), ("flat", flat, {"num_chunks": 2}))]
    got = [[eng.train_batch(BATCH) for _ in range(3)] for eng in engines]
    assert engines[0].chunks == 2 and got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=2e-4, atol=2e-4)
    assert got[0][-1] < got[0][0]
    for name in ("embed", "c0", "c1", "head"):
        for x, y in zip(*(eng.master(name) for eng in engines)):
            assert torch.equal(x, y), name
    for eng in engines:
        eng.close()
    with pytest.raises(ValueError, match="streams in its 2 stages, not 4 chunks"):
        ZeroInfinityEngine(spec, nvme_path=str(tmp_path / "bad"), num_chunks=4, device="cpu")
