"""The training slice of the PyTorch port against the JAX engine on the CPU:
``initialize(model=GPTNeoX(tiny), config)`` in both packages, the JAX
engine's initial ``master_params`` carried across with ``params_from_jax``,
and the same numpy batches fed to both.

Tolerances:

* fp32: per-step losses within 1e-5 relative (the two agree to ~1e-7:
  summation order only).  Final masters: per parameter, the summed
  absolute difference within 1e-5 of the summed absolute change over the
  run (~1e-6 seen).  The key bias entries outside the rotary dims are left
  out: a constant added to every key leaves the softmax unchanged, so their
  true gradient is zero and Adam turns the frameworks' different rounding
  noise into O(lr) steps of either sign.
* bf16: losses within 1e-3 relative (each product rounds its inputs to
  2^-8; after 8 steps the two trajectories differ by ~2e-4).
* fp16: losses within 2e-4 relative (2^-11 rounding; ~2e-5 seen), and the
  step with a non-finite loss is skipped with the scale halved in both.
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
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}
LOSS_TOL = {"fp32": 1e-5, "bf16": 1e-3, "fp16": 2e-4}
BASE = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "gradient_clipping": 1.0,
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 4, "warmup_max_lr": 1e-3}}}


def _engines(config, mode="fp32", **model_kw):
    jdt, tdt = DTYPES[mode]
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny(dtype=jdt, **model_kw)),
                               config=config)
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    teng, *_ = tdst.initialize(
        model=GPTNeoX(GPTNeoXConfig.tiny(dtype=tdt, **model_kw), device="cpu"),
        config=config, model_parameters=start, device="cpu")
    return jeng, teng, start


def _batch(rng, rows=16, seq=32, bad=False):
    toks = rng.integers(0, 256, (rows, seq + 1))
    mask = np.ones((rows, seq), np.float32)
    if bad:
        mask[3, 5] = np.inf          # a non-finite loss, hence non-finite grads
    return {"input_ids": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), "loss_mask": mask}


def _step_both(jeng, teng, batch):
    lj = float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in batch.items()}))
    lt = float(teng.train_batch(batch=batch))
    return lj, lt


def _masters_agree(jeng, teng, start, tol=1e-5):
    final = params_from_jax(jax.device_get(jeng.state["master_params"]))
    cfg = teng.module.config
    D, rot = cfg.head_dim, int(cfg.head_dim * cfg.rotary_pct)
    for name, want in final.items():
        got = teng.master_params[name].detach().float()
        keep = torch.ones_like(want, dtype=torch.bool)
        if name.endswith("query_key_value.bias"):
            keep.view(cfg.num_heads, 3 * D)[:, D + rot:2 * D] = False
        diff = (got - want).abs()[keep].sum()
        moved = (want - start[name]).abs()[keep].sum()
        assert diff <= tol * moved + 1e-12, (name, float(diff), float(moved))


def test_fp32_trajectory_and_masters_match_jax():
    jeng, teng, start = _engines(BASE)
    rng = np.random.default_rng(0)
    for step in range(8):
        lj, lt = _step_both(jeng, teng, _batch(rng))
        assert abs(lt - lj) <= LOSS_TOL["fp32"] * abs(lj), (step, lj, lt)
    assert teng.global_steps == 8 and teng.step_count == int(jeng.state["step"])
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert teng.get_global_grad_norm() == pytest.approx(jeng.get_global_grad_norm(),
                                                        rel=1e-5)
    _masters_agree(jeng, teng, start)
    ev = _batch(rng)
    want = float(jeng.eval_batch(batch={k: jnp.asarray(v) for k, v in ev.items()}))
    assert float(teng.eval_batch(batch=ev)) == pytest.approx(want, rel=1e-6)


def test_bf16_trajectory_matches_jax():
    config = {**BASE, "bf16": {"enabled": True}}
    jeng, teng, _ = _engines(config, "bf16")
    # the compute copy: every weight in bf16 but the input embedding
    dtypes = {n: p.dtype for n, p in teng.module.named_parameters()}
    assert dtypes.pop("embed_in.weight") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    assert all(m.dtype == torch.float32 for m in teng.master_params.values())
    rng = np.random.default_rng(1)
    for step in range(8):
        lj, lt = _step_both(jeng, teng, _batch(rng))
        assert abs(lt - lj) <= LOSS_TOL["bf16"] * abs(lj), (step, lj, lt)


def test_fp16_overflow_skips_the_step_and_halves_the_scale():
    config = {**BASE, "fp16": {"enabled": True, "initial_scale_power": 8,
                               "hysteresis": 1}}
    jeng, teng, _ = _engines(config, "fp16")
    rng = np.random.default_rng(2)
    for step in range(5):
        lj, lt = _step_both(jeng, teng, _batch(rng, bad=step == 2))
        assert teng.get_loss_scale() == jeng.get_loss_scale()
        assert teng.step_count == int(jeng.state["step"])
        if step == 2:
            assert np.isnan(lj) and np.isnan(lt)
            assert teng.skipped_steps == jeng.skipped_steps == 1
            assert teng.get_loss_scale() == 2.0 ** 7
        else:
            assert abs(lt - lj) <= LOSS_TOL["fp16"] * abs(lj), (step, lj, lt)
    assert teng.step_count == 4 and teng.global_steps == 5


def test_microbatch_forms_give_one_step():
    """A full batch, a list of gas microbatches and an iterator of them are
    the same step, and the same evaluation."""
    rng = np.random.default_rng(3)
    batch = _batch(rng)
    halves = [{k: v[i * 8:(i + 1) * 8] for k, v in batch.items()} for i in range(2)]
    train, evals = [], []
    for form in (lambda: batch, lambda: halves, lambda: iter(halves)):
        eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                                  config=BASE, device="cpu")
        evals.append(float(eng.eval_batch(batch=form())))
        train.append(float(eng.train_batch(batch=form())))
    assert train == [train[0]] * 3 and evals == [evals[0]] * 3


def test_client_optimizer_and_schedule_callables():
    """``optimizer=`` takes a transformation whose updates already carry
    the learning rate (added to the masters, optax's convention) and
    ``lr_scheduler=`` a callable of the step: each gives the same masters
    as the config that means the same thing."""
    from deeperspeed_tpu_torch.runtime.optimizers import GradientTransformation

    rng = np.random.default_rng(6)
    batches = [_batch(rng, rows=8, seq=16) for _ in range(2)]
    sgd = {"train_batch_size": 8, "optimizer": {"type": "SGD", "params": {"lr": 1e-2}}}
    adam = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    client = GradientTransformation(
        lambda params: None,
        lambda updates, state, params=None: ({n: -1e-2 * g for n, g in updates.items()},
                                             state))
    pairs = [(dict(config=sgd), dict(config={"train_batch_size": 8}, optimizer=client)),
             (dict(config=adam), dict(config=adam, lr_scheduler=lambda step: 1e-3))]
    for want_kw, got_kw in pairs:
        masters = []
        for kw in (want_kw, got_kw):
            eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                                      device="cpu", **kw)
            for b in batches:
                eng.train_batch(batch=b)
            masters.append(eng.master_params)
        for name, want in masters[0].items():
            torch.testing.assert_close(masters[1][name], want, rtol=1e-6, atol=1e-7)


def test_tree_helpers_match_jax():
    from deeperspeed_tpu.utils import tree as jax_tree
    from deeperspeed_tpu_torch.utils import tree

    rng = np.random.default_rng(8)
    leaves = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32),
                    "d": np.arange(4, dtype=np.int32)}}
    jtree = {"a": jnp.asarray(leaves["a"]), "b": {k: jnp.asarray(v)
                                                  for k, v in leaves["b"].items()}}
    ttree = {"a": torch.from_numpy(leaves["a"]),
             "b": {k: torch.from_numpy(v) for k, v in leaves["b"].items()}}
    assert float(tree.tree_global_norm(ttree)) == pytest.approx(
        float(jax_tree.tree_global_norm(jtree)), rel=1e-6)
    cast = tree.tree_cast(ttree, torch.bfloat16)
    jcast = jax_tree.tree_cast(jtree, jnp.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"]["d"].dtype == torch.int32
    np.testing.assert_array_equal(cast["b"]["c"].float().numpy(),
                                  np.asarray(jcast["b"]["c"], np.float32))
    zeros = tree.tree_zeros_like(ttree)
    assert all(float(z.abs().sum()) == 0 for z in tree.tree_leaves(zeros))


OPTIMIZERS = [
    ("AdamW", {"lr": 1e-3, "weight_decay": 0.1}, {}),
    ("Adam", {"lr": 1e-3, "weight_decay": 0.01}, {}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 0.01}, {}),
    ("SGD", {"lr": 1e-2}, {}),
    ("MuAdam", {"lr": 1e-3}, {"mup_base_width": 32}),
    ("MuAdamW", {"lr": 1e-3, "weight_decay": 0.1}, {"mup_base_width": 32}),
    ("MuSGD", {"lr": 1e-2, "momentum": 0.9}, {"mup_base_width": 32}),
    ("Lion", {"lr": 1e-4, "weight_decay": 0.1}, {}),
    ("Adagrad", {"lr": 1e-2}, {}),
    ("Lamb", {"lr": 1e-3, "weight_decay": 0.01}, {}),
]


@pytest.mark.parametrize("name,params,model_kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(OPTIMIZERS)])
def test_optimizer_trajectory_matches_jax(name, params, model_kw):
    config = {"train_batch_size": 8, "gradient_clipping": 1.0,
              "optimizer": {"type": name, "params": params}}
    jeng, teng, _ = _engines(config, **model_kw)
    rng = np.random.default_rng(4)
    for step in range(4):
        lj, lt = _step_both(jeng, teng, _batch(rng, rows=8, seq=16))
        assert abs(lt - lj) <= LOSS_TOL["fp32"] * abs(lj), (name, step, lj, lt)


@pytest.mark.parametrize("key,value", [
    # pipelines run, pp x tp and pp x sp too; the blocks of Queue A 8 wait
    ("elasticity", {"enabled": True}),
    ("eigenvalue", {"enabled": True}),
    ("comm", {"quantized": {"enabled": True}, "compression": {}}),
    # the pipeline block is read; a key it does not declare is refused
    ("pipeline", {"stages": 2, "activation_partitioning": True}),
    ("hybrid_engine", {"enabled": True}),
    ("flops_profiler", {"enabled": True}),
    ("comm", {"overlap": {"enabled": True}, "compression": {}}),
    ("compression_training", {"weight_quantization": {}}),
])
def test_unported_config_raises(key, value):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                        config={**BASE, key: value}, device="cpu")


@pytest.mark.parametrize("schedule", [{"hbm_budget_bytes": 1 << 30}, {"mode": "auto"},
                                      {"memory": "auto"}])
def test_planner_keys_are_accepted(schedule):
    """The cost-model schedule, the memory planner and its budget, once
    refused, build an engine; like the JAX engine's, they count only under
    ``comm.overlap.enabled``."""
    for enabled in (True, False):
        cfg = {**BASE, "comm": {"overlap": {"enabled": enabled, "schedule": schedule}}}
        eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                                  config=cfg, device="cpu")
        on = {**{"mode": "manual", "memory": "static", "hbm_budget_bytes": None},
              **schedule} if enabled else {"mode": "off", "memory": "off",
                                           "hbm_budget_bytes": None}
        assert (eng._schedule_mode, eng._memory_mode, eng._hbm_budget_bytes) == \
            (on["mode"], on["memory"], on["hbm_budget_bytes"])
        assert (eng._sched_plan is not None) == (on["mode"] == "auto")


class _PipeMpu:
    """A Megatron mpu that describes two pipeline stages."""

    def get_pipe_parallel_world_size(self):
        return 2


def _stage_model():
    from deeperspeed_tpu_torch.models.gpt_neox_pipe import GPTNeoXPipe

    return GPTNeoXPipe(GPTNeoXConfig.tiny(), 1, device="cpu")


@pytest.mark.parametrize("case", ["moe", "mesh", "mpu", "pipeline_module"])
def test_unported_model_features_raise(case):
    """What models and pipelines refuse: the JAX package's refusals of MoE
    and of ulysses / ring inside a stage model, in its words, and the
    ``auto`` schedule over a stage model (it waits for a reference whose own
    ``auto`` runs), also beside an mpu, naming its ROADMAP item.  (MoE and
    pipelines under sequence parallelism's default mode train.)"""
    from deeperspeed_tpu_torch.models.gpt_neox_pipe import GPTNeoXPipe

    auto = {**BASE, "comm": {"overlap": {"enabled": True, "schedule": {"mode": "auto"}}}}
    if case == "moe":
        with pytest.raises(NotImplementedError, match="MoE under the compiled pipeline"):
            GPTNeoXPipe(GPTNeoXConfig.tiny(moe_num_experts=4), 1, device="cpu")
    elif case == "mesh":
        with pytest.raises(NotImplementedError, match="sequence parallelism inside the "
                                                      "compiled pipeline"):
            GPTNeoXPipe(GPTNeoXConfig.tiny(seq_parallel_mode="ring"), 1, device="cpu")
    elif case == "pipeline_module":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdst.initialize(model=_stage_model(), device="cpu", config=auto)
    else:
        # an mpu is superseded by the mesh, pipeline stages or not
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdst.initialize(model=_stage_model(), device="cpu", mpu=_PipeMpu(), config=auto)


def test_chunked_loss_and_dataloader_raise(monkeypatch):
    """The chunked loss refuses MoE (the JAX package's rule).  The loader
    prefetches what comm.overlap asks for, without a log line, and the
    batches it yields are the loader's without the prefetch; an mpu is
    accepted, superseded by the mesh."""
    from deeperspeed_tpu_torch.runtime import engine as engine_module
    from deeperspeed_tpu_torch.runtime.dataloader import DevicePrefetchingLoader

    model = GPTNeoX(GPTNeoXConfig.tiny(ce_chunk_tokens=64), device="cpu")
    model.replace_config(moe_num_experts=4)
    with pytest.raises(NotImplementedError, match="ce_chunk_tokens with MoE is not supported yet"):
        model.loss_fn()
    toks = np.random.default_rng(9).integers(0, 256, (16, 9))
    data = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    lines = []
    monkeypatch.setattr(engine_module, "log_dist", lambda msg, ranks=None: lines.append(msg))
    losses = []
    for comm_cfg in ({}, {"comm": {"overlap": {"enabled": True, "prefetch_depth": 2}}}):
        eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                                  config={**BASE, **comm_cfg}, training_data=data,
                                  device="cpu", mpu=object())
        losses.append([float(eng.train_batch()) for _ in range(2)])
    assert not [m for m in lines if "prefetch_depth" in m]
    assert isinstance(eng._prefetcher, DevicePrefetchingLoader)
    assert losses[0] == losses[1]


@pytest.mark.parametrize("kw", [{}, {"hidden_size": 256, "num_heads": 4,
                                     "num_layers": 3, "vocab_size": 512}])
def test_model_size_and_flops_match_jax(kw):
    cfg = dict(hidden_size=64, num_layers=2, num_heads=4, vocab_size=256,
               max_seq_len=64)
    cfg.update(kw)
    jm = JaxGPTNeoX(JaxConfig(**cfg))
    tm = GPTNeoX(GPTNeoXConfig(**cfg), device="cpu")
    assert tm.num_params() == jm.num_params() == sum(p.numel() for p in tm.parameters())
    assert tm.flops_per_token() == jm.flops_per_token()
