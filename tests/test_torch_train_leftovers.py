"""The rest of the single-card training path of the PyTorch port against
the JAX engine on the CPU: block recompute (``remat`` through
``activation_checkpointing``), ``data_types.grad_accum_dtype``, the legacy
``forward`` / ``backward`` / ``step`` API, and dropout.

The JAX engine's initial masters are carried across with
``params_from_jax`` and both engines see the same numpy batches.
Tolerances: ``LOSS_TOL`` of ``test_torch_train.py`` (fp32 1e-5 relative,
summation order only; bf16 1e-3).  Dropout masks come from different
random streams in the two frameworks, so dropout is held against the JAX
engine in evaluation (no dropout) and by statistics and reproducibility;
remat with dropout must equal no remat bit for bit, and the legacy API must
equal ``train_batch`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.ops.attention.core import _reference_attention, keep_mask
import torch_threads  # noqa: F401  (torch at one intra-op thread)

LOSS_TOL = {"fp32": 1e-5, "bf16": 1e-3}
# 16 rows: the JAX engine spreads each microbatch over the tests' 8 CPU devices
BASE = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


def _jax_engine(model, config, **kw):
    """The JAX engine, its step counter placed on the mesh as its first step
    leaves it: the second step then reuses the first's compile instead of
    tracing again.  The values are the same."""
    jeng, *_ = jdst.initialize(model=model, config=config, **kw)
    mesh = jax.tree.leaves(jeng.state["master_params"])[0].sharding.mesh
    jeng.state["step"] = jax.device_put(jeng.state["step"], NamedSharding(mesh, P()))
    return jeng



def _engines(config, jdtype=jnp.float32, tdtype=torch.float32, **model_kw):
    jeng = _jax_engine(JaxGPTNeoX(JaxConfig.tiny(dtype=jdtype, **model_kw)), config)
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    teng, *_ = tdst.initialize(
        model=GPTNeoX(GPTNeoXConfig.tiny(dtype=tdtype, **model_kw), device="cpu"),
        config=config, model_parameters=start, device="cpu")
    return jeng, teng, start


def _batch(rng, rows=16, seq=16):
    toks = rng.integers(0, 256, (rows, seq + 1))
    return {"input_ids": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_remat_matches_jax():
    """activation_checkpointing turns block recompute on in both engines;
    the trajectories agree as without it."""
    config = {**BASE, "activation_checkpointing": {"partition_activations": True}}
    jeng, teng, _ = _engines(config)
    assert jeng.module.config.remat and teng.module.config.remat
    rng = np.random.default_rng(0)
    for step in range(3):
        b = _batch(rng)
        lj, lt = float(jeng.train_batch(batch=_jax(b))), float(teng.train_batch(batch=b))
        assert abs(lt - lj) <= LOSS_TOL["fp32"] * abs(lj), (step, lj, lt)


def test_grad_accum_dtype_matches_jax():
    """bf16 training with bf16 accumulation: each microbatch's gradients
    (the fp32 embedding's too) are cast to bf16, summed and divided by gas
    in bf16."""
    config = {**BASE, "data_types": {"grad_accum_dtype": "bf16"}, "bf16": {"enabled": True}}
    jeng, teng, _ = _engines(config, jnp.bfloat16, torch.bfloat16)
    assert teng._acc_flat.dtype == torch.bfloat16 and teng._grad_flat.dtype == torch.float32
    rng = np.random.default_rng(1)
    for step in range(4):
        b = _batch(rng)
        lj, lt = float(jeng.train_batch(batch=_jax(b))), float(teng.train_batch(batch=b))
        assert abs(lt - lj) <= LOSS_TOL["bf16"] * abs(lj), (step, lj, lt)
    assert teng.get_global_grad_norm() == pytest.approx(jeng.get_global_grad_norm(),
                                                        rel=LOSS_TOL["bf16"])


def _legacy_step(eng, batch, gas=2):
    """One step through forward/backward/step; the mean loss as
    ``train_batch`` takes it (fp32)."""
    rows = len(batch["input_ids"]) // gas
    losses = []
    for i in range(gas):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        losses.append(eng.backward(eng.forward(mb)).detach().float())
        assert eng.is_gradient_accumulation_boundary() == (i == gas - 1)
    eng.step()
    return float(torch.stack(losses).mean())


@pytest.mark.parametrize("mode", ["fp32", "bf16_accum", "fp16"])
def test_legacy_api_equals_train_batch_bit_for_bit(mode):
    """forward/backward/step over gas microbatches and train_batch share the
    accumulation and the step: the same masters, bit for bit, and the same
    fp16 skip (a non-finite loss in step 2) and loss scale."""
    config = dict(BASE)
    if mode == "bf16_accum":
        config.update(bf16={"enabled": True}, data_types={"grad_accum_dtype": "bf16"})
    if mode == "fp16":
        config["fp16"] = {"enabled": True, "initial_scale_power": 8, "hysteresis": 1}
    dtype = {"fp32": torch.float32, "bf16_accum": torch.bfloat16,
             "fp16": torch.float16}[mode]
    engines = [tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(dtype=dtype), device="cpu",
                                             seed=5), config=config, device="cpu")[0]
               for _ in range(2)]
    rng = np.random.default_rng(2)
    for step in range(3):
        b = _batch(rng)
        if mode == "fp16" and step == 1:
            b["loss_mask"] = np.ones((16, 16), np.float32)
            b["loss_mask"][1, 3] = np.inf
        lt = float(engines[0].train_batch(batch=b))
        ll = _legacy_step(engines[1], b)
        assert lt == ll or (np.isnan(lt) and np.isnan(ll))
    a, b = engines
    for name in a.master_params:
        assert torch.equal(a.master_params[name], b.master_params[name]), name
    assert a.get_loss_scale() == b.get_loss_scale()
    assert (a.global_steps, a.step_count, a.skipped_steps, a.micro_steps) == \
        (b.global_steps, b.step_count, b.skipped_steps, b.micro_steps)
    if mode == "fp16":
        assert a.skipped_steps == 1 and a.get_loss_scale() == 2.0 ** 7


def test_legacy_api_matches_jax():
    jeng, teng, _ = _engines(BASE)
    rng = np.random.default_rng(3)
    for step in range(3):
        b = _batch(rng)
        lt = _legacy_step(teng, b)
        lj = []
        for i in range(2):
            loss = jeng.forward({k: jnp.asarray(v[i * 8:(i + 1) * 8]) for k, v in b.items()})
            jeng.backward(loss)
            lj.append(float(loss))
        jeng.step()
        lj = sum(lj) / 2
        assert abs(lt - lj) <= LOSS_TOL["fp32"] * abs(lj), (step, lj, lt)
    assert teng.global_steps == jeng.global_steps == 3
    teng.zero_grad()
    teng.allreduce_gradients()
    with pytest.raises(RuntimeError, match="no accumulated gradients"):
        teng.step()


def _dropout_model(remat, rate=0.1, seed=7):
    return GPTNeoX(GPTNeoXConfig.tiny(hidden_dropout=rate, attention_dropout=rate,
                                      remat=remat), device="cpu", seed=seed)


def test_remat_with_dropout_equals_no_remat_bit_for_bit():
    """The recompute sets the generator back to its state at the block's
    entry, so it draws the forward's masks again: the gradients equal those
    without recompute bit for bit, and so do later draws."""
    batch = _dropout_model(False).example_batch(4, 24)
    grads, after = [], []
    for remat in (False, True):
        model = _dropout_model(remat)
        rng = torch.Generator().manual_seed(11)
        loss = model.loss_fn()(model, batch, rng)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        after.append(torch.rand(4, generator=rng))
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
    assert torch.equal(after[0], after[1])


def test_remat_with_dropout_engine_trajectories_equal():
    config = {**BASE, "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3}}}
    losses = []
    for ac in ({}, {"activation_checkpointing": {"cpu_checkpointing": True}}):
        eng = tdst.initialize(model=_dropout_model(False), config={**config, **ac},
                              device="cpu")[0]
        rng = np.random.default_rng(4)
        losses.append([float(eng.train_batch(batch=_batch(rng))) for _ in range(3)])
        assert eng.module.config.remat == bool(ac)
    assert losses[0] == losses[1]


def test_dropout_is_reproducible_from_the_seed_and_off_in_eval():
    config = {**BASE, "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3}}}
    runs = []
    for seed in (1234, 1234, 99):
        eng = tdst.initialize(model=_dropout_model(False), config={**config, "seed": seed},
                              device="cpu")[0]
        rng = np.random.default_rng(5)
        runs.append([float(eng.train_batch(batch=_batch(rng))) for _ in range(2)])
        ev = _batch(rng)
        assert float(eng.eval_batch(batch=ev)) == float(eng.eval_batch(batch=ev))
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_dropout_eval_matches_jax():
    """Evaluation draws no dropout in either engine: the same weights give
    the same loss."""
    config = {**BASE, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    jeng, teng, _ = _engines(config, hidden_dropout=0.1, attention_dropout=0.1)
    b = _batch(np.random.default_rng(6))
    lj, lt = float(jeng.eval_batch(batch=_jax(b))), float(teng.eval_batch(batch=b))
    assert abs(lt - lj) <= LOSS_TOL["fp32"] * abs(lj)


def test_dropout_masks_keep_one_minus_rate_scaled():
    """Keep fraction within 4 sigma of 1 - p, kept entries scaled by
    1 / (1 - p): the hidden dropout on the residual stream and the
    attention dropout on the probabilities."""
    p, n = 0.1, 200_000
    rng = torch.Generator().manual_seed(0)
    keep = keep_mask((n,), p, rng, "cpu")
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(keep.float().mean()) - (1 - p)) < 4 * sigma
    blk = GPTNeoX(GPTNeoXConfig.tiny(hidden_dropout=p), device="cpu").layers[0]
    x = torch.randn(4, 64, 64)
    pos = torch.arange(64).expand(4, 64)
    with torch.no_grad():
        plain = blk(x, pos)
        dropped = blk(x, pos, rng=torch.Generator().manual_seed(1))
    kept = dropped != 0
    frac = float(kept.float().mean())
    assert abs(frac - (1 - p)) < 4 * (p * (1 - p) / kept.numel()) ** 0.5
    torch.testing.assert_close(dropped[kept], (plain / (1 - p))[kept])
    q, k, v = (torch.randn(2, 32, 4, 16) for _ in range(3))
    ones = torch.ones_like(v)
    with torch.no_grad():
        out = _reference_attention(q, k, ones, dropout_rate=p,
                                   generator=torch.Generator().manual_seed(2))
    # each output row is the sum of its kept probabilities / (1 - p)
    assert abs(float(out.mean()) - 1.0) < 0.02
    torch.testing.assert_close(_reference_attention(q, k, v, dropout_rate=p),
                               _reference_attention(q, k, v))  # no generator: no dropout


def test_activation_checkpointing_maps_to_remat(monkeypatch):
    from deeperspeed_tpu_torch.runtime import engine as engine_module

    warnings = []
    monkeypatch.setattr(engine_module.logger, "warning", warnings.append)
    for ac in ({"number_checkpoints": 2}, {"cpu_checkpointing": True}):
        eng = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config={**BASE, "activation_checkpointing": ac},
                              device="cpu")[0]
        assert eng.module.config.remat
    assert len(warnings) == 1 and "cpu_checkpointing" in warnings[0]
    eng = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=BASE,
                          device="cpu")[0]
    assert not eng.module.config.remat


def test_accumulate_zeroes_parameters_without_gradients():
    """A parameter with no gradient in a microbatch (a block that PLD or
    random-LTD skipped) adds nothing, and starts a step's sum at zero,
    not at the last step's."""
    eng = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=BASE,
                          device="cpu")[0]
    eng._acc_flat.fill_(123.0)                 # a previous step's sum
    first = eng._params[0]
    for count in (1, 2):
        eng._accumulate((first.float() ** 2).sum(), None)
        assert torch.equal(eng._acc_views[0], count * 2 * first.detach().float())
        assert all(not bool(v.any()) for v in eng._acc_views[1:])
