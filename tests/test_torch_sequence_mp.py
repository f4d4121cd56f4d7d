"""Sequence parallelism beside the other model layouts: Llama, MoE and the
pipeline engines of the PyTorch port at ``sp`` 2 (four ``gloo`` processes,
``torch_dp_worker.py``) against the JAX engines on ``MeshTopology(...,
sp=2, devices=jax.devices()[:n])``.

* Llama ``tiny()`` at dp 2 x sp 2: the family has no ``seq_parallel_mode``,
  so its attention takes the default mode's exchange (the local queries
  over the gathered keys and values), against the JAX engine's GSPMD run.
* MoE (GPT-NeoX ``tiny()`` with 4 experts on both blocks, top-1 under
  capacity pressure without RTS, ``test_torch_moe_ep.py``'s, under
  ``ulysses``) at ep 2 x sp 2 and dp 2 x sp 2: the routing is global over
  every token of the step and keeps them in the batch's row-major order, so
  the capacity, the kept set and ``l_aux`` are the JAX engine's (one run at
  ep 2 x sp 2, whose losses the JAX engine gives at dp 2 x sp 2 too).
* pp 2 x sp 2: ``PipelineEngine`` over ``GPTNeoXPipe(tiny(), 2)`` (mode
  None, 1f1b; stage s at sp rank t sends to stage s + 1 at sp rank t)
  against the JAX ``PipelineEngine``, and the interpreted engine over the
  token stack with a tied embedding and head (its layers whole on both sp
  ranks) against the JAX ``InterpretedPipelineEngine`` at pp 2 x sp 2.

Tolerances (the engine tests'): losses and grad norms within 1e-5
relative in fp32, as PRs 22-23 held the pipelines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeperspeed_tpu as jdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.models.gpt_neox_pipe import GPTNeoXPipe as JaxNeoXPipe
from deeperspeed_tpu.models.llama import Llama as JaxLlama
from deeperspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.models import llama as tllama
from deeperspeed_tpu_torch.models import params_from_jax
from torch_dp_worker import start
from torch_layout_common import BASE, by_run
from test_torch_pipe_mp import _batches, _canonical, _pipe_module, _run as _pipe_run
import torch_threads  # noqa: F401  (torch at one intra-op thread)

ROWS, SEQ, STEPS = 8, 16, 3
MOE = {"moe_num_experts": 4, "moe_expert_interval": 1, "moe_use_rts": False,
       "moe_capacity_factor": 0.75, "moe_aux_loss_coef": 0.5}
NEOX_PIPE = {**BASE, "gradient_accumulation_steps": 4}
TOKENS = {**BASE, "train_batch_size": 16, "zero_optimization": {"stage": 1},
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}


def _cfg(stage=0):
    return {**BASE, "zero_optimization": {"stage": stage, "param_persistence_threshold": 1000}}


def _flat_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _train_runs():
    return [
        {"name": "llama", "family": "llama", "weights": "lw", "config": _cfg(2),
         "dtype": "fp32", "steps": STEPS, "mesh": {"dp": 2, "sp": 2}},
        {"name": "moe-ep2", "weights": "mw", "config": _cfg(0), "dtype": "fp32",
         "steps": STEPS, "mesh": {"ep": 2, "sp": 2},
         "model": {**MOE, "seq_parallel_mode": "ulysses"}},
        {"name": "moe-dp2", "weights": "mw", "config": _cfg(1), "dtype": "fp32",
         "steps": STEPS, "mesh": {"dp": 2, "sp": 2},
         "model": {**MOE, "seq_parallel_mode": "ulysses"}},
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence_mp")
    saved_mesh = jtopo._GLOBAL_MESH
    try:
        flat_b = _flat_batches(31)
        # the weights every package starts from: the JAX inits
        llama_tree = jax.device_get(JaxLlama(JaxLlamaConfig.tiny()).init(
            jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"])
        moe_tree = jax.device_get(JaxGPTNeoX(JaxConfig.tiny(**MOE)).init(
            jax.random.PRNGKey(4), jnp.zeros((1, SEQ), jnp.int32))["params"])
        pipe_tree = jax.device_get(JaxNeoXPipe(JaxConfig.tiny(), num_stages=2).init(
            jax.random.PRNGKey(7), jnp.zeros((1, SEQ), jnp.int32))["params"])
        arrays = {**{f"lw/{k}": v.numpy() for k, v in tllama.params_from_jax(llama_tree).items()},
                  **{f"mw/{k}": v.numpy() for k, v in params_from_jax(moe_tree).items()}}
        for i, b in enumerate(flat_b):
            arrays.update({f"b{i}/{k}": v for k, v in b.items()})
        pipe_b, tok_w, tok_b = _batches("neox", 3, 1), _canonical("tokens", 3), \
            _batches("tokens", 3, 5)
        pipes = [_pipe_run("neox-sp2", "neox", 2, NEOX_PIPE, 3, pipe_b, pipe_tree, sp=2),
                 _pipe_run("tokens-sp2", "tokens", 2, TOKENS, 3, tok_b, tok_w, sp=2)]
        for _, a in pipes:
            arrays.update(a)
        spec = {"kind": ["moe", "pipe"], "n_batches": STEPS, "moe_runs": _train_runs(),
                "pipe_runs": [r for r, _ in pipes]}
        finish = start(spec, arrays, tmp, world=4)
        jax_out = {}
        m = jtopo.MeshTopology(dp=2, sp=2, devices=jax.devices()[:4])
        for name, model, tree in (
                ("llama", JaxLlama(JaxLlamaConfig.tiny()), llama_tree),
                ("moe", JaxGPTNeoX(JaxConfig.tiny(seq_parallel_mode="ulysses", **MOE)),
                 moe_tree)):
            mesh = m if name == "llama" else jtopo.MeshTopology(
                ep=2, sp=2, devices=jax.devices()[:4])
            jeng = jdst.initialize(model=model, config=_cfg(0), mesh=mesh,
                                   model_parameters=tree)[0]
            jax_out[name] = _jax_train(jeng, flat_b)
        pmesh = jtopo.MeshTopology(pp=2, sp=2, devices=jax.devices()[:4])
        jeng = jdst.initialize(
            model=JaxNeoXPipe(JaxConfig.tiny(), num_stages=2), mesh=pmesh,
            model_parameters=jax.tree_util.tree_map(jnp.asarray, pipe_tree),
            config={**NEOX_PIPE, "mesh": {"pipe_parallel_size": 2,
                                          "sequence_parallel_size": 2}})[0]
        jax_out["neox-sp2"] = _jax_train(jeng, pipe_b)
        jeng = jdst.initialize(model=_pipe_module("tokens"), mesh=pmesh, config={
            **TOKENS, "mesh": {"pipe_parallel_size": 2, "sequence_parallel_size": 2}})[0]
        jeng._load_canonical_master(tok_w)
        jax_out["tokens-sp2"] = (np.array([float(jeng.train_batch(batch=b)) for b in tok_b]),
                                 None)
        got = finish()
    finally:
        jtopo.set_mesh(saved_mesh)
    names = [r["name"] for r in spec["moe_runs"]] + [r["name"] for r in spec["pipe_runs"]]
    return jax_out, by_run(got, names)


def _jax_train(jeng, batches):
    losses, norms = [], []
    for b in batches:
        losses.append(float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in b.items()})))
        norms.append(jeng.get_global_grad_norm())
    return np.array(losses), np.array(norms)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), (got, want)


def test_llama_at_dp2_sp2_matches_the_jax_engine(runs):
    jax_out, port = runs
    for r in port["llama"]:
        np.testing.assert_array_equal(r["losses"], port["llama"][0]["losses"])
    _close(port["llama"][0]["losses"], jax_out["llama"][0])
    _close(port["llama"][0]["grad_norms"], jax_out["llama"][1])


@pytest.mark.parametrize("name", ["moe-ep2", "moe-dp2"])
def test_moe_routing_is_global_over_the_sequence_slices(runs, name):
    """ep 2 x sp 2 and dp 2 x sp 2: the JAX engine's losses and grad norms
    (capacity pressure: the kept set depends on the token order)."""
    jax_out, port = runs
    _close(port[name][0]["losses"], jax_out["moe"][0])
    _close(port[name][0]["grad_norms"], jax_out["moe"][1])


def test_stage_model_at_pp2_sp2_matches_the_jax_pipeline_engine(runs):
    jax_out, port = runs
    ranks = port["neox-sp2"]
    assert sorted(int(r["stage"]) for r in ranks) == [0, 0, 1, 1]
    _close(ranks[0]["losses"], jax_out["neox-sp2"][0])
    _close(ranks[0]["norms"], jax_out["neox-sp2"][1])


def test_interpreted_at_pp2_sp2_matches_the_jax_engine(runs):
    """The interpreted engine runs its layers whole on both sp ranks (the
    JAX engine's sp 2 losses are its sp 1 losses)."""
    jax_out, port = runs
    for r in port["tokens-sp2"]:
        np.testing.assert_array_equal(r["losses"], port["tokens-sp2"][0]["losses"])
    _close(port["tokens-sp2"][0]["losses"], jax_out["tokens-sp2"][0])
