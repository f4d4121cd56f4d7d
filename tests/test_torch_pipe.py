"""The pipeline's stage models and entry points in the PyTorch port, in one
process on the CPU.

* ``GPTNeoXPipe`` and ``LlamaPipe`` (Llama-2 ``tiny``, Mistral's GQA and
  window, untied OPT) against the JAX ``GPTNeoXPipe`` / ``LlamaPipe`` on
  ``tiny()`` weights carried across (``pipe_params_from_jax``): ``embed``,
  every stage's ``stage_forward``, ``head`` and ``loss_from_logits`` within
  1e-5 in fp32; ``pipe_params_from_jax`` / ``pipe_params_to_jax`` round
  trip bit for bit.  A stage draws the flat model's weights of its part
  and no more (its peak bytes while it builds, below the whole model's).
* A one-stage pipeline engine gives the flat engine's bits (losses, grad
  norms, masters, the evaluation loss; its logits without ``compute_loss``
  within 1e-5), under both schedules.
* The refusals, in the JAX package's words where it has them: MoE and
  sequence parallelism in a stage model, ZeRO stage 3, tied Llama
  embeddings, a schedule typo, a mesh ``pp`` other than the stages, the
  micro-level API; what the reference does not run over a pipeline (qgZ,
  1-bit Adam) and what waits for a reference that runs it (the ``auto``
  schedule); the host update's own refusals on a stage; and
  ``initialize``'s routing by ``pipeline.executor``.
* pp x tp's layout: the mesh's tp, pp and data-parallel groups are the JAX
  ``MeshTopology``'s at pp 2 x tp 2 and pp 2 x dp 2 x tp 2, and a stage's
  tp split (``param_partition_rules``, ``pipe_params_from_jax`` with
  ``tp_rank`` / ``tp_size``) is the flat model's, joined back bit for bit.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxNeoXConfig
from deeperspeed_tpu.models.gpt_neox_pipe import GPTNeoXPipe as JaxNeoXPipe
from deeperspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deeperspeed_tpu.models.llama_pipe import LlamaPipe as JaxLlamaPipe
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, LlamaConfig
from deeperspeed_tpu_torch.models import gpt_neox, llama
from deeperspeed_tpu_torch.models.gpt_neox import GPTNeoXBlock
from deeperspeed_tpu_torch.models.gpt_neox_pipe import GPTNeoXPipe
from deeperspeed_tpu_torch.models.llama_pipe import LlamaPipe
from deeperspeed_tpu_torch.models.simple import Block, InProj, OutProj, mse_loss
from deeperspeed_tpu_torch.runtime.config import DeeperSpeedConfig
from deeperspeed_tpu_torch.runtime.pipe.engine import PipelineEngine, PipelineError
from deeperspeed_tpu_torch.runtime.pipe.interpreted import InterpretedPipelineEngine
from deeperspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule
import torch_threads  # noqa: F401  (torch at one intra-op thread)

ATOL = 1e-5
STAGES = 2
FAMILIES = {
    "neox": (JaxNeoXPipe, JaxNeoXConfig.tiny, GPTNeoXPipe, GPTNeoXConfig.tiny, {}, gpt_neox),
    "llama": (JaxLlamaPipe, JaxLlamaConfig.tiny, LlamaPipe, LlamaConfig.tiny, {}, llama),
    "mistral": (JaxLlamaPipe, JaxLlamaConfig.tiny_mistral, LlamaPipe,
                LlamaConfig.tiny_mistral, {}, llama),
    "opt": (JaxLlamaPipe, JaxLlamaConfig.tiny_opt, LlamaPipe, LlamaConfig.tiny_opt,
            {"tie_embeddings": False}, llama),
}
CONFIG = {"train_batch_size": 8, "gradient_accumulation_steps": 4,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_pair(family):
    jcls, jcfg, tcls, tcfg, kw, mod = FAMILIES[family]
    jmodel = jcls(dataclasses.replace(jcfg(**kw), num_layers=4), num_stages=STAGES)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 24)).astype(np.int32)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(tokens))["params"])
    spec = tcls(dataclasses.replace(tcfg(**kw), num_layers=4), num_stages=STAGES,
                device="cpu")
    stages = []
    for s in range(STAGES):
        stage = spec.build_stage(s)
        stage.load_state_dict(mod.pipe_params_from_jax(params, s))
        stages.append(stage)
    return jmodel, params, spec, stages, tokens, mod


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stage_functions_match_the_jax_stage_model(family):
    jmodel, params, spec, stages, tokens, mod = _jax_pair(family)
    B, S = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    tpos = torch.arange(S).expand(B, S)
    with torch.no_grad():
        x_ref = jmodel.embed(params, jnp.asarray(tokens))
        x = stages[0].embed(torch.from_numpy(tokens).long())
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=ATOL)
        for s in range(STAGES):
            sp = jax.tree_util.tree_map(lambda a: a[s], params["stages"])
            x_ref = jmodel.stage_forward(sp, x_ref, positions)
            x = stages[s].stage_forward(x, tpos)
            np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=ATOL, rtol=ATOL)
        logits_ref = jmodel.head(params, x_ref)
        logits = stages[-1].head(x)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=ATOL,
                                   rtol=ATOL)
        labels = np.roll(tokens, -1, axis=1)
        mask = (np.arange(S) % 3 != 0).astype(np.float32)[None].repeat(B, 0)
        loss_ref = jmodel.loss_from_logits(logits_ref, jnp.asarray(labels), jnp.asarray(mask))
        loss = stages[-1].loss_from_logits(logits, torch.from_numpy(labels),
                                           torch.from_numpy(mask))
        assert abs(float(loss) - float(loss_ref)) <= ATOL
        # the engine's calls: forward_stage chains, stage_loss is the loss
        mb = {"input_ids": torch.from_numpy(tokens).long(),
              "labels": torch.from_numpy(labels).long(), "loss_mask": torch.from_numpy(mask)}
        y = stages[0].forward_stage(mb["input_ids"], mb)
        y = stages[1].forward_stage(y, mb)
        assert abs(float(stages[1].stage_loss(y, mb)) - float(loss_ref)) <= ATOL
    # the weights round trip bit for bit, and the stage models draw the
    # flat model's weights
    back = mod.pipe_params_to_jax([st.state_dict() for st in stages])
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: np.asarray(t), back))[0])
    assert flat_ref.keys() == flat_back.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_back[k], v)
    for s in range(STAGES):
        again = mod.pipe_params_from_jax(_np_tree(back), s)
        for n, t in stages[s].state_dict().items():
            assert torch.equal(again[n], t), n


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the operators under it made and that
    are still alive, and their peak (a storage is counted once, when an
    operator first returns it, and let go when it dies)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = set()

    def _free(self, ptr, nbytes):
        self.live -= nbytes
        self._seen.discard(ptr)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                st = t.untyped_storage()
                if st.data_ptr() not in self._seen and st.nbytes():
                    self._seen.add(st.data_ptr())
                    self.live += st.nbytes()
                    weakref.finalize(st, self._free, st.data_ptr(), st.nbytes())
                    self.peak = max(self.peak, self.live)
        return out


def test_stage_model_draws_the_flat_models_weights():
    """Each stage draws the flat model's weights of its own part (GPT-NeoX
    and Llama), and while it draws holds no more than its stage and the
    draw of one tensor (the largest, with ``trunc_normal_``'s temporaries):
    below the whole model."""
    for family in ("neox", "llama"):
        _, _, tcls, tcfg, kw, _ = FAMILIES[family]
        cfg = dataclasses.replace(tcfg(**kw), num_layers=4)
        spec = tcls(cfg, 2, device="cpu", seed=5)
        flat = spec.FLAT(cfg, device="cpu", seed=5)
        whole = sum(t.nbytes for t in flat.parameters())
        largest = max(flat.parameters(), key=lambda t: t.numel())
        with _LiveBytes() as one:
            torch.nn.init.trunc_normal_(torch.empty(largest.shape), 0.0, 0.1, -0.2, 0.2,
                                        generator=torch.Generator())
        ref = flat.state_dict()
        for s in range(2):
            with _LiveBytes() as seen:
                stage = spec.build_stage(s)
            mine = sum(t.nbytes for t in stage.parameters())
            assert mine < seen.peak <= mine + one.peak < whole, \
                (family, s, seen.peak, mine, whole)
            for n, t in stage.state_dict().items():
                if n.startswith("layers."):
                    n = f"layers.{int(n.split('.')[1]) + 2 * s}." + n.split(".", 2)[2]
                assert torch.equal(ref[n], t), (family, n)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_one_stage_engine_gives_the_flat_engines_bits(schedule):
    spec = GPTNeoXPipe(GPTNeoXConfig.tiny(), 1, device="cpu")
    batch = spec.example_batch(8, 16)
    batch["loss_mask"] = (torch.arange(16) % 4 != 1).float().expand(8, 16).contiguous()
    eng, *_ = tdst.initialize(model=spec, device="cpu",
                              config={**CONFIG, "pipeline": {"schedule": schedule}})
    flat, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                               config=CONFIG, device="cpu")
    assert isinstance(eng, PipelineEngine) and eng.is_first_stage() and eng.is_last_stage()
    for _ in range(3):
        assert float(eng.train_batch(batch=batch)) == float(flat.train_batch(batch=batch))
        assert eng.get_global_grad_norm() == flat.get_global_grad_norm()
    assert float(eng.eval_batch(batch=batch)) == float(flat.eval_batch(batch=batch))
    with torch.no_grad():
        logits = flat.module(batch["input_ids"])
    torch.testing.assert_close(eng.eval_batch(batch=batch, compute_loss=False), logits,
                               rtol=1e-5, atol=1e-5)
    mine, ref = eng.full_master_params(), flat.full_master_params()
    for n, t in mine.items():
        assert torch.equal(t, ref[n]), n
    assert eng.peak_live_inputs() == 1
    with pytest.raises(PipelineError, match="Only train_batch"):
        eng.forward(batch)
    with pytest.raises(PipelineError, match="Only train_batch"):
        eng.backward()
    with pytest.raises(PipelineError, match="Only train_batch"):
        eng.step()


def _raises(exc, match, **kw):
    with pytest.raises(exc, match=match):
        tdst.initialize(device="cpu", **kw)


def test_refusals():
    with pytest.raises(NotImplementedError, match="MoE under the compiled pipeline"):
        GPTNeoXPipe(GPTNeoXConfig.tiny(moe_num_experts=4), 2, device="cpu")
    for mode in ("ulysses", "ring"):
        with pytest.raises(NotImplementedError, match="sequence parallelism inside"):
            GPTNeoXPipe(GPTNeoXConfig.tiny(seq_parallel_mode=mode), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="tie_embeddings under the compiled"):
        LlamaPipe(LlamaConfig.tiny_opt(), 2, device="cpu")
    spec = GPTNeoXPipe(GPTNeoXConfig.tiny(), 1, device="cpu")
    _raises(NotImplementedError, "ZeRO-3 does not compose", model=spec,
            config={**CONFIG, "zero_optimization": {"stage": 3}})
    _raises(PipelineError, "is not one of", model=spec,
            config={**CONFIG, "pipeline": {"schedule": "1F1B"}})
    _raises(PipelineError, "mesh pp=1 != model stages=2",
            model=GPTNeoXPipe(GPTNeoXConfig.tiny(), 2, device="cpu"), config=CONFIG)
    _raises(NotImplementedError, "the reference does not run them", model=spec,
            config={**CONFIG, "comm": {"quantized": {"enabled": True}}})
    _raises(ValueError, "the qgZ hops run over", model=spec,
            config={**CONFIG, "comm": {"quantized": {"enabled": True, "intra_axis": "pp"}}})
    # pp x sp runs (mode None); an sp that does not divide the processes not
    _raises(ValueError, "sequence_parallel_size 2 does not divide", model=spec,
            config={**CONFIG, "mesh": {"sequence_parallel_size": 2}})


def _neox_blocks():
    cfg = GPTNeoXConfig.tiny()
    return PipelineModule([LayerSpec(GPTNeoXBlock, cfg) for _ in range(2)], num_stages=1)


def _mlp_stack():
    return PipelineModule([LayerSpec(InProj), LayerSpec(Block), LayerSpec(Block),
                           LayerSpec(OutProj)], num_stages=1, loss_fn=mse_loss,
                          partition_method="uniform")


def test_executor_routing():
    cfg = dict(CONFIG)
    auto = tdst.initialize(model=_neox_blocks(), config=cfg, device="cpu")[0]
    assert type(auto) is PipelineEngine
    assert type(tdst.initialize(model=_mlp_stack(), config=cfg, device="cpu")[0]) \
        is InterpretedPipelineEngine
    forced = {**cfg, "pipeline": {"executor": "interpreted"}}
    assert type(tdst.initialize(model=_mlp_stack(), config=forced, device="cpu")[0]) \
        is InterpretedPipelineEngine
    _raises(PipelineError, "compiled pipeline requires", model=_mlp_stack(),
            config={**cfg, "pipeline": {"executor": "compiled"}})
    _raises(ValueError, "needs a PipelineModule",
            model=GPTNeoXPipe(GPTNeoXConfig.tiny(), 1, device="cpu"), config=forced)
    _raises(ValueError, "expected 'auto', 'compiled' or 'interpreted'", model=_mlp_stack(),
            config={**cfg, "pipeline": {"executor": "eager"}})
    _raises(ValueError, "remove the loss_fn", model=_mlp_stack(), config=forced,
            loss_fn=mse_loss)
    _raises(ValueError, "model_parameters= is not supported", model=_mlp_stack(),
            config=forced, model_parameters={})
    compiled = {**cfg, "pipeline": {"executor": "compiled"}}
    _raises(PipelineError, "differing configs", config=compiled, model=PipelineModule(
        [LayerSpec(GPTNeoXBlock, GPTNeoXConfig.tiny()),
         LayerSpec(GPTNeoXBlock, GPTNeoXConfig.tiny(max_seq_len=32))], num_stages=1))
    _raises(PipelineError, "says num_layers=2", config=compiled, model=PipelineModule(
        [LayerSpec(GPTNeoXBlock, GPTNeoXConfig.tiny())] * 3, num_stages=1))


@pytest.mark.parametrize("sizes", [{"pp": 2, "tp": 2}, {"pp": 2, "dp": 2, "tp": 2}])
def test_mesh_groups_match_the_jax_mesh(sizes, monkeypatch):
    """Rank ``r`` is JAX device ``r``: each tp group (a stage's), pp group
    (the ranks of one (dp, tp) coordinate) and data-parallel group is the
    JAX mesh's row of devices along that axis."""
    from deeperspeed_tpu.parallel.topology import MeshTopology as JaxMesh
    from deeperspeed_tpu_torch.comm.comm import _GROUP_AXES
    from deeperspeed_tpu_torch.parallel import topology as ttopo

    world = int(np.prod(list(sizes.values())))
    monkeypatch.setattr(ttopo, "_world_size", lambda: world)
    mine = ttopo.MeshTopology(**sizes)
    grid = np.vectorize(lambda d: d.id)(JaxMesh(**sizes, devices=jax.devices()[:world])
                                        .mesh.devices)
    axes = list(ttopo.ALL_AXES)
    for name in ("tp", "pp", "dp"):
        along = [axes.index(a) for a in _GROUP_AXES[name]]
        rows = np.moveaxis(grid, along, list(range(-len(along), 0)))
        want = sorted(sorted(r.reshape(-1).tolist())
                      for r in rows.reshape(-1, int(np.prod([grid.shape[i] for i in along]))))
        assert sorted(mine.groups(_GROUP_AXES[name])) == want, name
    # the pp group joins one (dp, tp) coordinate: the same tp rank on every stage
    for group in mine.groups(_GROUP_AXES["pp"]):
        coords = [mine.coords(r) for r in group]
        assert [c["pp"] for c in coords] == list(range(sizes["pp"]))
        assert len({(c["dp"], c["tp"]) for c in coords}) == 1


@pytest.mark.parametrize("family", ["neox", "mistral"])
def test_tp_split_stages_are_the_flat_models(family):
    """A stage's tensor-parallel rules are the flat model's on its own
    parameters; ``pipe_params_from_jax`` at ``tp_rank`` / ``tp_size`` gives
    each rank's slices, which ``pipe_params_to_jax`` joins back bit for bit."""
    jmodel, params, spec, stages, _, mod = _jax_pair(family)
    from deeperspeed_tpu_torch.parallel.tensor_parallel import partition_dims

    flat_rules = spec.FLAT(spec.config, device="meta").param_partition_rules()
    for s, stage in enumerate(stages):
        names = list(stage.state_dict())
        rules = stage.param_partition_rules()
        assert rules and all(r in flat_rules for r in rules)
        dims = partition_dims(names, rules)
        assert dims == partition_dims(names, flat_rules)
        assert ("embed_in.weight" in dims or "embed_tokens.weight" in dims) == (s == 0)
        ranks = [mod.pipe_params_from_jax(params, s, tp_rank=r, tp_size=2) for r in range(2)]
        whole = mod.pipe_params_from_jax(params, s)
        for n, t in whole.items():
            if n in dims:
                assert torch.equal(torch.cat([r[n] for r in ranks], dims[n]), t), n
                assert ranks[0][n].shape[dims[n]] * 2 == t.shape[dims[n]]
            else:
                assert torch.equal(ranks[1][n], t), n
    back = mod.pipe_params_to_jax(
        [[mod.pipe_params_from_jax(params, s, tp_rank=r, tp_size=2) for r in range(2)]
         for s in range(STAGES)])
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: np.asarray(t), back))[0])
    assert flat_ref.keys() == flat_back.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_back[k], v)
    if family == "mistral":
        with pytest.raises(ValueError, match="num_kv_heads 2 is not divisible by tp=4"):
            stages[0].check_tensor_parallel(4)
        stages[0].check_tensor_parallel(2)


@pytest.mark.parametrize("case", ["onebit", "auto", "auto-config", "host-zero1",
                                  "host-fp16", "host-lamb"])
def test_pipeline_refusals_that_stay(case):
    """Over a pipeline: 1-bit Adam is refused because the reference does not
    run it; the ``auto`` schedule waits for a reference whose own ``auto``
    runs (in the engine, and in the config once ``pipe_parallel_size`` > 1);
    the host update keeps the JAX engine's refusals (ZeRO-0, no fp16, the
    Adam family) on each stage."""
    spec = GPTNeoXPipe(GPTNeoXConfig.tiny(), 1, device="cpu")
    host = {"device": "cpu", "host_update": True}
    auto = {"comm": {"overlap": {"enabled": True, "schedule": {"mode": "auto"}}}}
    if case == "onebit":
        _raises(NotImplementedError, "the reference does not run them", model=spec,
                config={**CONFIG, "optimizer": {"type": "OneBitAdam"}})
    elif case == "auto":
        _raises(NotImplementedError, "waits for a reference whose own 'auto'", model=spec,
                config={**CONFIG, **auto})
    elif case == "auto-config":
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A, 'Pipelines'.*waits"):
            DeeperSpeedConfig(
                {**CONFIG, **auto, "mesh": {"pipe_parallel_size": 2}}, world_size=1)
    elif case == "host-zero1":
        _raises(NotImplementedError, "requires zero stage 0", model=spec, config={
            **CONFIG, "zero_optimization": {"stage": 1, "offload_optimizer": host}})
    elif case == "host-fp16":
        _raises(NotImplementedError, "does not compose with fp16", model=spec, config={
            **CONFIG, "fp16": {"enabled": True},
            "zero_optimization": {"stage": 0, "offload_optimizer": host}})
    else:
        _raises(NotImplementedError, "supports Adam/AdamW/CPUAdam", model=spec, config={
            **CONFIG, "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 0, "offload_optimizer": host}})
