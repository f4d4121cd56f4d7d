"""The pipeline engines over several processes: the PyTorch port's stage
processes (``gloo``, ``torch_dp_worker.py``'s ``pipe`` job) against the JAX
package's ``PipelineEngine`` and ``InterpretedPipelineEngine`` on
``MeshTopology(pp=2[, dp=2 | tp=2], devices=jax.devices()[:n])``, from the
same weights and batches.

Two spawns, both started before the first JAX run and joined after the JAX
runs; the world-4 runs that load the JAX engines' checkpoints wait for a
file the test process writes once they are saved:

* world 2 (``pp`` 2): GPT-NeoX ``tiny()`` at gas 4, 3 steps, under
  ``1f1b`` and ``gpipe`` in fp32 (losses and grad norms within 1e-5
  relative, final masters' summed difference within 1e-5 of their summed
  change, as ``test_torch_zero.py`` holds them) and ``1f1b`` in bf16 (the
  JAX pipe tests' bf16 tolerance: losses within 1e-3, grad norms within 0.1
  relative / 3e-3 absolute, masters within 0.1 of their change); ``peak_live_inputs``
  (1F1B at most ``S - s``, GPipe ``M``); the ``1f1b`` run saves after 2
  steps, a JAX engine loads that checkpoint bit for bit, and a ``pp`` 1 x
  ``dp`` 2 engine loads it and takes step 3 to the same loss; the host
  update on each stage (``offload_optimizer.host_update``, ZeRO-0) within
  2e-5 of the JAX engine's host update, its checkpoints across packages
  both ways (masters bit for bit, the next step's loss).
* world 4: pp 2 x tp 2 (each stage split over its tp group) under ``1f1b``
  and ``gpipe`` on GPT-NeoX and under ``1f1b`` on Mistral ``tiny`` (GQA),
  within 2e-4 of the JAX ``PipelineEngine`` at pp 2 x tp 2 (losses, grad
  norms, masters joined over tp); its checkpoint loads in a JAX engine at
  pp 2 (bit for bit, and step 3's loss) and in the port at pp 1 x tp 1,
  and the JAX pp 2 checkpoint loads at pp 2 x tp 2; at pp 2 x dp 2 and
  ZeRO-2 the pinned-host and NVMe tiers give the run without offload bit
  for bit; the interpreted engine at pp 2 x tp 2 (layers whole on both tp
  ranks) gives its tp 1 losses within 1e-6 and the JAX engine's at tp 2;
  the interpreted engine on the MLP stack with a tied block across the
  stages at pp 2 x dp 2, ZeRO-2 (4 steps: losses, norms, masters within
  1e-5; ``eval_batch`` with ``bcast_loss`` true and false), a token stack
  with a tied embedding and head under the curriculum's seqlen at ZeRO-1,
  the same in fp16 with an inf written into stage 0's masters (every stage
  skips and halves its scale); checkpoints: the port's ZeRO-2 save loads
  in the JAX engine (bit for bit) and at ``pp`` 1 x ``dp`` 4 (the next
  steps' losses), the JAX engine's loads in the port (bit for bit, and the
  next step's loss), its universal export loads through
  ``load_universal_into_interpreted``, and the JAX ``PipelineEngine``'s
  checkpoint loads in the port's at ``pp`` 2 x ``dp`` 2.

Each spawn first runs ``comm.send_next`` and ``comm.ppermute`` over its
world.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeperspeed_tpu as jdst
from deeperspeed_tpu.checkpoint.universal import ds_to_universal
from deeperspeed_tpu.runtime.checkpointing import _host_master_tree
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.models.gpt_neox_pipe import GPTNeoXPipe as JaxNeoXPipe
from deeperspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deeperspeed_tpu.models.llama_pipe import LlamaPipe as JaxLlamaPipe
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu.runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from torch_dp_worker import start
import torch_threads  # noqa: F401  (torch at one intra-op thread)

HID, OUT, VOCAB = 16, 8, 32
GAS = 4
BASE = {"gradient_accumulation_steps": GAS, "gradient_clipping": 1.0,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
NEOX = {**BASE, "train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
MLP = {**BASE, "train_batch_size": 16, "zero_optimization": {"stage": 2}}
CURRICULUM = {"enabled": True, "params": {
    "curriculum_type": "seqlen", "min_difficulty": 4, "max_difficulty": 16,
    "schedule_type": "fixed_linear",
    "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 4}}}
TOKENS = {**BASE, "train_batch_size": 16, "zero_optimization": {"stage": 1},
          "curriculum_learning": CURRICULUM}
FP16 = {**TOKENS, "fp16": {"enabled": True, "initial_scale_power": 8, "hysteresis": 1},
        "zero_optimization": {"stage": 2}}
F32, BF16 = {"rtol": 1e-5, "atol": 1e-6}, {"rtol": 1e-3, "atol": 1e-3}
# pp x tp against the JAX pipeline, which computes each stage whole while the
# port splits it (``test_torch_tp.py``'s TOL); the host update's relative
# bound (``test_torch_offload_host.py``'s)
TP, HOST = {"rtol": 2e-4, "atol": 0.0}, {"rtol": 2e-5, "atol": 0.0}
BF16_GRADS = {"rtol": 0.1, "atol": 3e-3}


class InProj(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(HID, name="proj")(x)


class Block(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return x + fnn.Dense(HID, name="fc")(jnp.tanh(x))


class OutProj(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(OUT, name="head")(x)


def mse(out, y):
    return jnp.mean(jnp.square(out.astype(jnp.float32) - y.astype(jnp.float32)))


def ce(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def decode(module, params, x):
    return x @ params["embedding"].T.astype(x.dtype)


def _pipe_module(kind):
    if kind == "mlp":
        specs = [LayerSpec(InProj), TiedLayerSpec("blk", Block), TiedLayerSpec("blk", Block),
                 LayerSpec(OutProj)]
        pm = PipelineModule(specs, num_stages=2, loss_fn=mse, partition_method="uniform")
        pm.example_input = lambda: np.zeros((2, HID), np.float32)
    else:
        specs = [TiedLayerSpec("emb", fnn.Embed, VOCAB, HID), LayerSpec(Block),
                 LayerSpec(Block), TiedLayerSpec("emb", fnn.Embed, VOCAB, HID,
                                                 forward_fn=decode)]
        pm = PipelineModule(specs, num_stages=2, loss_fn=ce, partition_method="uniform")
        pm.example_input = lambda: np.zeros((2, 16), np.int32)
    return pm


def _dense(rng, i, o):
    return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}


def _canonical(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        return {"layers": {"layer_0": {"proj": _dense(rng, HID, HID)},
                           "layer_3": {"head": _dense(rng, HID, OUT)}},
                "tied": {"blk": {"fc": _dense(rng, HID, HID)}}}
    return {"layers": {"layer_1": {"fc": _dense(rng, HID, HID)},
                       "layer_2": {"fc": _dense(rng, HID, HID)}},
            "tied": {"emb": {"embedding": (rng.standard_normal((VOCAB, HID)) / 4)
                             .astype(np.float32)}}}


def _flat(tree, prefix=""):
    """The leaves of ``tree`` by '/'-joined name, copied (a host-update
    engine's master tree holds the arrays its next step updates in place)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.array(v)})
    return out


def _batches(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "neox":
        toks = rng.integers(0, 256, (n, 8, 17))
        return [{"input_ids": t[:, :-1].astype(np.int64), "labels": t[:, 1:].astype(np.int64)}
                for t in toks]
    if kind == "mlp":
        return [{"x": rng.standard_normal((16, HID)).astype(np.float32),
                 "y": rng.standard_normal((16, OUT)).astype(np.float32)} for _ in range(n)]
    toks = rng.integers(0, VOCAB, (n, 16, 16))
    return [{"x": t, "y": np.roll(t, -1, axis=1)} for t in toks]


def _run(name, model, pp, config, steps, data, weights, **kw):
    return {"name": name, "model": model, "pp": pp, "config": config, "steps": steps,
            **kw}, {**{f"d/{name}/{i}/{k}": v for i, b in enumerate(data) for k, v in b.items()},
                    **{f"w/{name}/{k}": v for k, v in _flat(weights).items()}}


def _spawn(runs, tmp, world):
    spec = {"kind": "pipe", "pipe_runs": [r for r, _ in runs]}
    arrays = {k: v for _, a in runs for k, v in a.items()}
    tmp.mkdir()
    return start(spec, arrays, tmp, world=world)


def _jax_neox(schedule, dtype, weights, batches, tp=1, family="neox", extra=None):
    mesh = jtopo.MeshTopology(pp=2, tp=tp, devices=jax.devices()[:2 * tp])
    cfg = {**NEOX, **(extra or {}), "pipeline": {"schedule": schedule},
           "mesh": {"pipe_parallel_size": 2, "model_parallel_size": tp}}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    kind = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    model = (JaxNeoXPipe(JaxConfig.tiny(dtype=kind), num_stages=2) if family == "neox"
             else JaxLlamaPipe(JaxLlamaConfig.tiny_mistral(dtype=kind), num_stages=2))
    eng = jdst.initialize(model=model, config=cfg, mesh=mesh,
                          model_parameters=jax.tree_util.tree_map(jnp.asarray, weights))[0]
    losses, norms = [], []
    for b in batches:
        losses.append(float(eng.train_batch(batch=b)))
        norms.append(eng.get_global_grad_norm())
    master = _host_master_tree(eng) if getattr(eng, "_host_adam", None) else \
        eng.state["master_params"]
    return eng, np.array(losses), np.array(norms), _flat(jax.device_get(master))


def _jax_interp(kind, config, weights, batches, dp=2, tp=1):
    mesh = jtopo.MeshTopology(pp=2, dp=dp, tp=tp, devices=jax.devices()[:2 * dp * tp])
    eng = jdst.initialize(model=_pipe_module(kind), mesh=mesh, config={
        **config, "mesh": {"pipe_parallel_size": 2, "model_parallel_size": tp}})[0]
    eng._load_canonical_master(weights)
    losses = [eng.train_batch(batch=b) for b in batches]
    return eng, np.array(losses), eng.get_global_grad_norm()


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    saved = jtopo._GLOBAL_MESH
    try:
        return _pipes(tmp_path_factory.mktemp("pipe"))
    finally:
        # the JAX engines set the process-global mesh; later files build
        # on their own
        jtopo.set_mesh(saved)


def _pipes(tmp):
    jmodel = JaxNeoXPipe(JaxConfig.tiny(), num_stages=2)
    neox_w = jax.device_get(jmodel.init(jax.random.PRNGKey(7), jnp.zeros((1, 16), jnp.int32))
                            ["params"])
    mistral_w = jax.device_get(JaxLlamaPipe(JaxLlamaConfig.tiny_mistral(), num_stages=2).init(
        jax.random.PRNGKey(8), jnp.zeros((1, 16), jnp.int32))["params"])
    neox_b = _batches("neox", 4, 1)
    mlp_w, tok_w = _canonical("mlp", 2), _canonical("tokens", 3)
    mlp_b, tok_b = _batches("mlp", 5, 4), _batches("tokens", 4, 5)
    pck, jck, ptck = str(tmp / "port_pipe"), str(tmp / "jax_pipe"), str(tmp / "port_pipe_tp")
    ick, jick, uni = str(tmp / "port_interp"), str(tmp / "jax_interp"), str(tmp / "universal")
    ready = str(tmp / "jax_saved")       # the JAX checkpoints the world-4 runs load
    hck, jhck, host_ready = str(tmp / "port_host"), str(tmp / "jax_host"), str(tmp / "host_saved")
    host = {"zero_optimization": {"stage": 0, "offload_optimizer": {
        "device": "cpu", "host_update": True}}}
    z2 = {**NEOX, "zero_optimization": {"stage": 2}}
    nvme = {"device": "nvme", "nvme_path": str(tmp / "nvme"), "buffer_count": 2}
    world2 = [
        _run("neox-1f1b", "neox", 2, NEOX, 3, neox_b[:3], neox_w, save=pck, save_after=2),
        _run("neox-gpipe", "neox", 2, {**NEOX, "pipeline": {"schedule": "gpipe"}}, 3,
             neox_b[:3], neox_w),
        _run("neox-bf16", "neox", 2, {**NEOX, "bf16": {"enabled": True}}, 3, neox_b[:3],
             neox_w, dtype="bf16"),
        _run("neox-pp1", "neox", 1, NEOX, 1, neox_b[2:3], neox_w, load=pck),
        _run("neox-host", "neox", 2, {**NEOX, **host}, 3, neox_b[:3], neox_w, save=hck,
             save_after=2),
        _run("neox-host-jax", "neox", 2, {**NEOX, **host}, 1, neox_b[3:4], neox_w, load=jhck,
             wait=host_ready),
    ]
    world4 = [
        _run("neox-tp-1f1b", "neox", 2, NEOX, 3, neox_b[:3], neox_w, tp=2, save=ptck,
             save_after=2),
        _run("neox-tp-gpipe", "neox", 2, {**NEOX, "pipeline": {"schedule": "gpipe"}}, 3,
             neox_b[:3], neox_w, tp=2),
        _run("mistral-tp", "mistral", 2, NEOX, 3, neox_b[:3], mistral_w, tp=2),
        _run("neox-pp1-tp", "neox", 1, {**NEOX, "gradient_accumulation_steps": 2}, 1,
             neox_b[2:3], neox_w, load=ptck),
        _run("neox-z2", "neox", 2, z2, 2, neox_b[:2], neox_w),
        _run("neox-z2-cpu", "neox", 2, {**z2, "zero_optimization": {
            "stage": 2, "offload_optimizer": {"device": "cpu"}}}, 2, neox_b[:2], neox_w),
        _run("neox-z2-nvme", "neox", 2, {**z2, "zero_optimization": {
            "stage": 2, "offload_optimizer": nvme}}, 2, neox_b[:2], neox_w),
        _run("mlp-tp", "mlp", 2, MLP, 4, mlp_b[:4], mlp_w, tp=2),
        _run("mlp-z2", "mlp", 2, MLP, 4, mlp_b[:4], mlp_w, save=ick, save_after=2),
        _run("mlp-pp1", "mlp", 1, MLP, 2, mlp_b[2:4], {}, load=ick),
        _run("tokens", "tokens", 2, TOKENS, 4, tok_b, tok_w),
        _run("tokens-fp16", "tokens", 2, FP16, 2, tok_b[:2], tok_w, poison=0),
        _run("mlp-jax", "mlp", 2, MLP, 1, mlp_b[4:5], {}, load=jick, wait=ready),
        _run("mlp-universal", "mlp", 2, MLP, 1, mlp_b[4:5], {}, universal=uni),
        _run("neox-jax", "neox", 2, NEOX, 1, neox_b[3:4], neox_w, load=jck),
        _run("neox-tp-jax", "neox", 2, NEOX, 1, neox_b[3:4], neox_w, tp=2, load=jck),
    ]
    # both groups start before any JAX run; the world-4 runs that load the
    # JAX checkpoints wait for them
    wait2 = _spawn(world2, tmp / "w2", 2)
    wait4 = _spawn(world4, tmp / "w4", 4)
    out = {"neox_w": _flat(neox_w), "mistral_w": _flat(mistral_w)}
    for name, sched, dtype in (("neox-1f1b", "1f1b", "fp32"), ("neox-gpipe", "gpipe", "fp32"),
                               ("neox-bf16", "1f1b", "bf16")):
        eng, losses, norms, final = _jax_neox(sched, dtype, neox_w, neox_b[:3])
        out[f"jax/{name}"] = (losses, norms, final)
        if name == "neox-1f1b":
            eng.save_checkpoint(jck)
            out["jax/neox-next"] = float(eng.train_batch(batch=neox_b[3]))
            out["jax/neox-saved"] = final
        if name == "neox-gpipe":
            reader = eng
    jeng, losses, norm = _jax_interp("mlp", MLP, mlp_w, mlp_b[:4])
    out["jax/mlp"] = (losses, norm, _flat(jeng._canonical_master_host()),
                      jeng.eval_batch(batch=mlp_b[0]))
    jeng.save_checkpoint(jick)
    ds_to_universal(jick, uni)
    open(ready, "w").close()
    out["jax/mlp-next"] = float(jeng.train_batch(batch=mlp_b[4]))
    _, losses, norm = _jax_interp("tokens", TOKENS, tok_w, tok_b)
    out["jax/tokens"] = (losses, norm)
    # pp 2 x tp 2 (each stage computed whole by the JAX pipeline), the host
    # update over pp 2, the interpreted engine at tp 2
    out["jax/neox-tp"] = _jax_neox("1f1b", "fp32", neox_w, neox_b[:3], tp=2)[1:]
    out["jax/mistral-tp"] = _jax_neox("1f1b", "fp32", mistral_w, neox_b[:3], tp=2,
                                      family="mistral")[1:]
    jhost, *out["jax/neox-host"] = _jax_neox("1f1b", "fp32", neox_w, neox_b[:3], extra=host)
    jhost.save_checkpoint(jhck)
    open(host_ready, "w").close()
    out["jax/neox-host-next"] = float(jhost.train_batch(batch=neox_b[3]))
    _, losses, norm = _jax_interp("mlp", MLP, mlp_w, mlp_b[:4], dp=1, tp=2)
    out["jax/mlp-tp"] = (losses, norm)

    out["port2"] = wait2()
    # the port's pipe checkpoints in a JAX engine: pp 2, then pp 2 x tp 2
    # and the step after it
    reader.load_checkpoint(pck)
    out["jax/loaded-port-pipe"] = _flat(jax.device_get(reader.state["master_params"]))
    # the port's host-update pipe checkpoint in the JAX host-update engine
    jhost.load_checkpoint(hck)
    out["jax/loaded-port-host"] = _flat(_host_master_tree(jhost))
    out["jax/loaded-port-host-next"] = float(jhost.train_batch(batch=neox_b[2]))
    out["port4"] = wait4()
    reader.load_checkpoint(ptck)
    out["jax/loaded-port-pipe-tp"] = _flat(jax.device_get(reader.state["master_params"]))
    out["jax/loaded-port-pipe-tp-next"] = float(reader.train_batch(batch=neox_b[2]))
    jeng, *_ = _jax_interp("mlp", MLP, mlp_w, [])
    jeng.load_checkpoint(ick)
    out["jax/loaded-port-interp"] = _flat(jeng._canonical_master_host())
    out["jax/loaded-port-interp-losses"] = np.array(
        [jeng.train_batch(batch=b) for b in mlp_b[2:4]])
    return out


def _masters(res, run, key="final"):
    prefix = f"{run}/{key}/"
    return {k[len(prefix):]: v for k, v in res[0].items() if k.startswith(prefix)}


def _close_masters(mine, ref, start, tol):
    """As ``test_torch_zero.py``: per parameter, the summed |difference|
    within ``tol`` of the summed change from the start, the key-bias
    entries outside the rotary dims left out (their true gradient is
    zero)."""
    cfg = JaxConfig.tiny()
    D, rot = cfg.hidden_size // cfg.num_heads, int(cfg.hidden_size // cfg.num_heads
                                                   * cfg.rotary_pct)
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        keep = np.ones(v.shape, bool)
        if k.endswith("query_key_value/bias"):
            keep.reshape(-1, cfg.num_heads, 3 * D)[..., D + rot:2 * D] = False
        diff = np.abs(mine[k] - v)[keep].sum()
        moved = np.abs(v - start[k])[keep].sum()
        assert diff <= tol * moved + 1e-12, (k, float(diff), float(moved))


@pytest.mark.parametrize("run", ["neox-1f1b", "neox-gpipe", "neox-bf16"])
def test_stage_model_runs_match_the_jax_pipeline_engine(pipes, run):
    losses, norms, final = pipes[f"jax/{run}"]
    tol = BF16 if run.endswith("bf16") else F32
    for rank in pipes["port2"]:
        np.testing.assert_allclose(rank[f"{run}/losses"], losses, **tol)
        np.testing.assert_allclose(rank[f"{run}/norms"], norms,
                                   **(BF16_GRADS if run.endswith("bf16") else F32))
    _close_masters(_masters(pipes["port2"], run), final, pipes["neox_w"],
                   BF16_GRADS["rtol"] if run.endswith("bf16") else F32["rtol"])
    peaks = [int(rank[f"{run}/peaks"][-1]) for rank in pipes["port2"]]
    assert peaks == ([GAS, GAS] if run == "neox-gpipe" else [2, 1])


def test_point_to_point_permutations(pipes):
    """``send_next`` shifts each rank's tensor to the next rank of the ring;
    ``ppermute`` over pairs (0 -> 1, 2 -> 3) gives the destinations their
    source's tensor and the others zeros, as ``jax.lax.ppermute`` does."""
    for key in ("port2", "port4"):
        ranks = pipes[key]
        n = len(ranks)
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res["ring"], np.full(3, (r - 1) % n))
            np.testing.assert_array_equal(res["pairs"], np.full(2, r if r % 2 else 0))


def test_stage_model_checkpoints_cross_packages_and_pp(pipes):
    port2, port4 = pipes["port2"], pipes["port4"]
    saved = _masters(port2, "neox-1f1b", "saved")
    loaded = pipes["jax/loaded-port-pipe"]
    assert saved.keys() == loaded.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    # pp 2 -> pp 1 x dp 2: step 3 from the step-2 checkpoint
    loss3 = port2[0]["neox-1f1b/losses"][2]
    np.testing.assert_allclose(port2[0]["neox-pp1/losses"], [loss3], rtol=1e-5)
    assert _masters(port2, "neox-pp1", "loaded").keys() == saved.keys()
    # the JAX engine's checkpoint at pp 2 x dp 2, then a 4th step
    jax_saved = pipes["jax/neox-saved"]
    for k, v in _masters(port4, "neox-jax", "loaded").items():
        np.testing.assert_array_equal(v, jax_saved[k], err_msg=k)
    for rank in port4:
        np.testing.assert_allclose(rank["neox-jax/losses"], [pipes["jax/neox-next"]], rtol=1e-5)


def test_interpreted_zero2_over_pp_and_dp_matches_the_jax_engine(pipes):
    losses, norm, final, ev = pipes["jax/mlp"]
    port4 = pipes["port4"]
    for rank in port4:
        np.testing.assert_allclose(rank["mlp-z2/losses"], losses, **F32)
        np.testing.assert_allclose(rank["mlp-z2/norms"][-1], norm, **F32)
        np.testing.assert_allclose(rank["mlp-z2/eval"], ev, **F32)
        last = rank["mlp-z2/stage"] == 1
        assert np.isnan(rank["mlp-z2/eval_last"]) != last
        if last:
            assert rank["mlp-z2/eval_last"] == rank["mlp-z2/eval"]
    _close_masters(_masters(port4, "mlp-z2"), final, _flat(_canonical("mlp", 2)), F32["rtol"])
    # the 1F1B memory bound: stage 0 keeps at most 2 inputs, stage 1 one
    assert sorted(int(r["mlp-z2/peaks"][-1]) for r in port4) == [1, 1, 2, 2]


def test_interpreted_tied_tokens_under_the_curriculum_and_fp16(pipes):
    losses, norm = pipes["jax/tokens"]
    for rank in pipes["port4"]:
        np.testing.assert_allclose(rank["tokens/losses"], losses, **F32)
        np.testing.assert_allclose(rank["tokens/norms"][-1], norm, **F32)
        skipped, scale_ratio, kept = rank["tokens-fp16/poison"]
        assert skipped == 1 and scale_ratio == 0.5 and kept == 1.0
        assert np.isfinite(rank["tokens-fp16/losses"]).all()


def test_interpreted_checkpoints_cross_packages_pp_and_universal(pipes):
    port4 = pipes["port4"]
    saved = _masters(port4, "mlp-z2", "saved")
    loaded = pipes["jax/loaded-port-interp"]
    assert saved.keys() == loaded.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    after = port4[0]["mlp-z2/losses"][2:]
    np.testing.assert_allclose(pipes["jax/loaded-port-interp-losses"], after, **F32)
    for rank in port4:
        np.testing.assert_allclose(rank["mlp-pp1/losses"], after, **F32)
    _, _, final, _ = pipes["jax/mlp"]
    for run in ("mlp-jax", "mlp-universal"):
        got = _masters(port4, run, "loaded")
        assert got.keys() == final.keys()
        for k, v in final.items():
            np.testing.assert_array_equal(got[k], v, err_msg=(run, k))
        for rank in port4:
            np.testing.assert_allclose(rank[f"{run}/losses"], [pipes["jax/mlp-next"]], **F32)


@pytest.mark.parametrize("run", ["neox-tp-1f1b", "neox-tp-gpipe", "mistral-tp"])
def test_pp_x_tp_matches_the_jax_pipeline_engine(pipes, run):
    """pp 2 x tp 2 (four processes, each stage split over its tp group):
    losses, grad norms and the final masters joined over tp against the
    JAX ``PipelineEngine`` at pp 2 x tp 2 under 1f1b (GPT-NeoX, and
    Mistral's GQA with one KV head a rank)."""
    losses, norms, final = pipes["jax/mistral-tp" if run == "mistral-tp" else "jax/neox-tp"]
    port4 = pipes["port4"]
    for rank in port4:
        np.testing.assert_allclose(rank[f"{run}/losses"], losses, **TP)
        np.testing.assert_allclose(rank[f"{run}/norms"], norms, **TP)
    start = pipes["mistral_w" if run == "mistral-tp" else "neox_w"]
    _close_masters(_masters(port4, run), final, start, TP["rtol"])
    # rank r is stage r // 2: 1F1B keeps S - s inputs, GPipe M
    peaks = [int(rank[f"{run}/peaks"][-1]) for rank in port4]
    assert peaks == ([GAS] * 4 if run.endswith("gpipe") else [2, 2, 1, 1])
    assert [int(rank[f"{run}/stage"]) for rank in port4] == [0, 0, 1, 1]


def test_pp_x_tp_checkpoints_cross_packages_pp_and_tp(pipes):
    """The pp 2 x tp 2 checkpoint holds the JAX ``PipelineEngine``'s whole
    tree: a JAX engine at pp 2 loads it bit for bit and takes step 3 to the
    port's loss, and so does the port at pp 1 x tp 1 (dp 4); the JAX pp 2
    checkpoint loads into the port at pp 2 x tp 2 bit for bit and takes the
    JAX engine's next step."""
    port4 = pipes["port4"]
    saved = _masters(port4, "neox-tp-1f1b", "saved")
    loaded = pipes["jax/loaded-port-pipe-tp"]
    assert saved.keys() == loaded.keys() == pipes["neox_w"].keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    loss3 = port4[0]["neox-tp-1f1b/losses"][2]
    np.testing.assert_allclose(pipes["jax/loaded-port-pipe-tp-next"], loss3, **TP)
    for rank in port4:
        np.testing.assert_allclose(rank["neox-pp1-tp/losses"], [loss3], **TP)
    assert _masters(port4, "neox-pp1-tp", "loaded").keys() == saved.keys()
    jax_saved = pipes["jax/neox-saved"]
    for k, v in _masters(port4, "neox-tp-jax", "loaded").items():
        np.testing.assert_array_equal(v, jax_saved[k], err_msg=k)
    for rank in port4:
        np.testing.assert_allclose(rank["neox-tp-jax/losses"], [pipes["jax/neox-next"]], **TP)


def test_interpreted_at_tp2_runs_its_stages_whole(pipes):
    """The interpreted engine at pp 2 x tp 2 keeps each stage's layers whole
    on both tp ranks, as the JAX engine does: its losses and grad norms are
    tp 1's (pp 2 x dp 2) within 1e-6 and the JAX interpreted engine's at
    pp 2 x tp 2."""
    losses, norm = pipes["jax/mlp-tp"]
    for rank in pipes["port4"]:
        np.testing.assert_allclose(rank["mlp-tp/losses"], rank["mlp-z2/losses"],
                                   rtol=1e-6, atol=0.0)
        np.testing.assert_allclose(rank["mlp-tp/norms"], rank["mlp-z2/norms"],
                                   rtol=1e-6, atol=0.0)
        np.testing.assert_allclose(rank["mlp-tp/losses"], losses, **F32)
        np.testing.assert_allclose(rank["mlp-tp/norms"][-1], norm, **F32)


def test_host_update_over_pp_matches_the_jax_host_update(pipes):
    """pp 2 with ``offload_optimizer.host_update`` (ZeRO-0): each stage
    process updates its stage on the host; losses, grad norms and the final
    masters against the JAX ``PipelineEngine``'s host update."""
    losses, norms, final = pipes["jax/neox-host"]
    port2 = pipes["port2"]
    for rank in port2:
        assert rank["neox-host/tiers"].tolist() == [True, False, False]
        np.testing.assert_allclose(rank["neox-host/losses"], losses, **HOST)
        np.testing.assert_allclose(rank["neox-host/norms"], norms, **HOST)
    _close_masters(_masters(port2, "neox-host"), final, pipes["neox_w"], HOST["rtol"])


def test_host_update_checkpoints_cross_packages_over_pp(pipes):
    """The host update's pipe checkpoints (masters and the native Adam's
    moments): the port's pp 2 save loads in the JAX engine's host update
    bit for bit and takes step 3 to the port's loss; the JAX engine's loads
    in the port's stage processes bit for bit and takes its next step."""
    port2 = pipes["port2"]
    saved = _masters(port2, "neox-host", "saved")
    loaded = pipes["jax/loaded-port-host"]
    assert saved.keys() == loaded.keys() == pipes["neox_w"].keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    np.testing.assert_allclose(pipes["jax/loaded-port-host-next"],
                               port2[0]["neox-host/losses"][2], **HOST)
    _, _, final = pipes["jax/neox-host"]
    for k, v in _masters(port2, "neox-host-jax", "loaded").items():
        np.testing.assert_array_equal(v, final[k], err_msg=k)
    for rank in port2:
        assert rank["neox-host-jax/tiers"].tolist() == [True, False, False]
        np.testing.assert_allclose(rank["neox-host-jax/losses"],
                                   [pipes["jax/neox-host-next"]], **HOST)


def test_offload_tiers_over_pp_give_the_device_runs_bits(pipes):
    """pp 2 x dp 2 at ZeRO-2: the pinned-host tier and the NVMe tier give
    the run without offload bit for bit (losses, norms, final masters);
    each NVMe rank swaps into a folder of its own."""
    port4 = pipes["port4"]
    for tier, flags in (("cpu", [False, True, False]), ("nvme", [False, True, True])):
        run = f"neox-z2-{tier}"
        for rank in port4:
            assert rank[f"{run}/tiers"].tolist() == flags
            for key in ("losses", "norms"):
                np.testing.assert_array_equal(rank[f"{run}/{key}"], rank[f"neox-z2/{key}"])
        got, want = _masters(port4, run), _masters(port4, "neox-z2")
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=(run, k))
    dirs = [str(rank["neox-z2-nvme/swap_dir"]) for rank in port4]
    assert len(set(dirs)) == 4 and all(d.startswith("engine_") for d in dirs)
