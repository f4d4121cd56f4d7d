"""One process of a data-parallel run of the PyTorch port on the CPU, for
the tests that hold it against the JAX package (``test_torch_zero.py``,
``test_torch_comm.py``, ``test_torch_wire_*.py``).  It imports only the
port.

    python tests/torch_dp_worker.py RANK WORLD RENDEZVOUS_FILE JOB.npz OUT.npz

``JOB.npz`` holds ``spec`` (JSON) and the arrays it names; the worker joins
a ``gloo`` group through ``file://RENDEZVOUS_FILE`` and writes its results
to ``OUT.npz``.  ``spec["kind"]`` names a job kind, or lists several to
run in turn.  Job kinds:

* ``train``: for each run, a GPT-NeoX ``tiny()`` engine from the weights
  ``w/<param>`` trains on the global batches ``b<i>/<key>`` (or, with
  ``training_data``, on the columns ``d/<key>``), on ``spec["device"]``
  (the CPU by default); it records the losses, the grad norms, the
  elements of the masters, optimizer state and stage-3 partitions it
  holds, the calls of B5 (its plain version, or the kernel's launches on
  the card), the warnings, and on rank 0 the final fp32 masters; a run
  with ``legacy`` steps through ``forward``/``backward``/``step`` (its
  losses are this rank's), one with ``eval`` also records ``eval_batch``
  of the first batch after training; every run records each step's
  ``comm_footprint`` and the comms logger's rows (JSON), and one with
  ``reload`` saves a checkpoint after training and records 1-bit Adam's
  error feedback before the save and after a fresh engine loads it; a run
  may name its ``mesh`` (``MeshTopology`` sizes: ``tp``, ``zshard``; the
  default is data-parallel over the world), extra ``GPTNeoXConfig``
  fields (``model``), ``reuse_model`` (the previous run's model object,
  as the JAX tests pass one model to two engines) and ``capture_grads``
  (each parameter's mean gradient before and after the first step's
  reduction, ``pre/<param>`` and ``post/<param>``) and ``bypass_blocks``
  (blocks whose forward passes its input through), ``family`` ("llama":
  Llama ``tiny()``) and ``weights`` (the prefix of its initial weights in
  place of ``w``); under ``schedule.mode: auto`` it also records the plan
  and the first planned step's statistics (``schedule``, JSON), and every
  run the seed of its training generator;
* ``comm``: each case runs one collective on this rank's input
  ``x/<case>/<rank>`` (with ``two_level`` ``[n_inter, n_intra]``, over the
  groups of ``comm.new_two_level_groups``; ``onebit`` cases chain
  ``steps`` calls of ``onebit_all_reduce``, carrying the error);
* ``ckpt``: for each run, an engine as ``train`` makes it (``model`` holds
  extra ``GPTNeoXConfig`` fields, ``mesh`` the mesh) first loads the checkpoint directory
  ``load`` if it names one, then trains on the batches ``steps`` lists
  (their indices), saving into ``save`` after ``save_after`` of them (a
  ``load`` waits for the file ``wait`` where the run names one); at
  ``loaded``, ``saved`` and ``final`` it records the state: on rank 0 the
  whole masters and optimizer state under the checkpoint's names
  (``m/<name>``, ``o/<name>``), on every rank its generator state, loss
  scale, counters and loader position;
* ``moe``: the configurations ``spec["refusals"]`` lists (each a
  ``config``, ``model`` fields and a ``mesh``) must fail to initialize:
  their errors are recorded as ``refusal<i>``; then the runs of
  ``spec["moe_runs"]`` as ``train`` runs them (a run's ``model`` holds the
  MoE fields, its ``mesh`` the ``ep`` axis), so that one spec can hold
  ``ckpt`` runs too;
* ``llama``: a Llama ``tiny()`` engine from the weights ``w/<param>``
  trains at ``spec["train"]["config"]`` (its ``mesh`` block sets ``tp``) on
  the batches ``b<i>/<key>`` and records its losses; then the v1 engine
  (``init_inference`` at ``spec["generate"]["config"]``) on the weights
  ``g/<param>`` generates greedily from the prompts ``p`` (mask ``pm``) and
  records the tokens, and the logits of ``engine(p)``;
* ``pipe``: for each run of ``spec["pipe_runs"]``, a pipeline engine at
  ``pp`` stages and ``tp`` (default 1) tensor-parallel ranks a stage (the
  data-parallel degree what the world leaves): a stage
  model (``neox``: GPT-NeoX ``tiny()``, ``mistral``: Llama ``tiny_mistral()``,
  at ``dtype``) from the JAX pipe tree ``w/<run>/<path>``, or a
  ``PipelineModule`` (``mlp``: the MLP stack with a tied block across the
  stages, ``tokens``: a tied embedding and head around two blocks) whose
  canonical tree ``w/<run>/<path>`` it loads after building; it first loads
  the checkpoint ``load`` (or, ``universal``, a universal export) if the run
  names one (after the file ``wait``, if it names one, exists), then trains on the batches ``d/<run>/<i>/<key>``, saving into
  ``save`` after ``save_after`` steps (``sp``: the sequence-parallel
  degree, default 1); it records the losses, grad norms,
  ``peak_live_inputs``, loss scale and skipped steps, ``eval_batch`` with
  ``bcast_loss`` true and false, the whole masters (rank 0: ``loaded``,
  ``saved``, ``final``), and with ``poison`` a step after an inf is written
  into stage ``poison``'s first master (whether every rank skipped it and
  kept its masters), and which offload tiers ran (host update, pinned host,
  NVMe; the NVMe swap folder's name); first, ``comm.send_next`` and a
  ``comm.ppermute`` of pairs over the world (``ring``, ``pairs``);
* ``seq``: the sequence-parallel functions over ``MeshTopology(sp=world)``
  on each rank's slice of the global arrays ``x``, ``q``, ``k``, ``v``
  (the upstream gradient ``w``): the all-to-all and its inverse,
  ``DistributedAttention``, ``ulysses_attention``, ring attention (causal
  and full) with its input gradients, the default mode's gathered keys;
  then each model of ``spec["models"]`` (weights ``<name>/w/<param>``)
  bound to the ``sp`` group: its loss on the rank's slice of ``ids`` /
  ``labels`` and its parameter gradients.
"""


import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu_torch import comm
from deeperspeed_tpu_torch.comm import compressed
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.ops.cuda_utils import LAUNCHES
from deeperspeed_tpu_torch.ops.quantizer import fused
from deeperspeed_tpu_torch.parallel import MeshTopology
from deeperspeed_tpu_torch.runtime import checkpointing as ck
from deeperspeed_tpu_torch.runtime import engine as engine_module
from deeperspeed_tpu_torch.runtime.zero import quantized
from deeperspeed_tpu_torch.utils.tree import tree_leaves

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _counting_b5():
    calls = [0]
    plain = fused._dequant_reduce_plain

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    fused._dequant_reduce_plain = counted
    return calls


def _train(spec, job, rank, out):
    calls = _counting_b5()
    device = spec.get("device", "cpu")
    warnings = []
    engine_module.logger.warning = lambda msg, *a: warnings.append(msg % a if a else msg)
    start = {k[2:]: torch.from_numpy(job[k]) for k in job.files if k.startswith("w/")}
    keys = sorted({k.split("/", 1)[1] for k in job.files if k.startswith("b0/")})
    batches = [{key: job[f"b{i}/{key}"] for key in keys}
               for i in range(spec["n_batches"])]
    model = None
    for run in spec["runs"]:
        name = run["name"]
        if not run.get("reuse_model"):
            model = _model(run, device)
        for i in run.get("bypass_blocks", ()):
            # the block passes its input through: its parameters get no gradient
            model.layers[i].forward = lambda x, *args, **kwargs: x
        data = None
        if run.get("training_data"):
            data = {k[2:]: job[k] for k in job.files if k.startswith("d/")}
        warnings.clear()
        comm.comms_logger.comms_dict.clear()
        comm.comms_logger.group_sizes.clear()
        comm.STAGED.clear()
        eng, *_ = tdst.initialize(model=model, config=run["config"],
                                  model_parameters=_weights(job, run, start),
                                  training_data=data, device=device, mesh=_mesh(run))
        if run.get("capture_grads"):
            _capture_grads(eng, name, out)
        calls[0] = 0
        LAUNCHES.clear()
        losses, norms, b5, footprints = [], [], [], []
        for step in range(run["steps"]):
            if run.get("legacy"):
                loss = _legacy_step(eng, batches[step])
            else:
                loss = eng.train_batch() if data is not None else eng.train_batch(
                    batch=batches[step])
            losses.append(float(loss))
            norms.append(eng.get_global_grad_norm())
            footprints.append(eng.comm_footprint)
            b5.append(calls[0] + LAUNCHES["dequant_reduce"])
            calls[0] = 0
            LAUNCHES.clear()
        if run.get("eval"):
            out[f"{name}/eval"] = np.array(float(eng.eval_batch(batch=batches[0])))
        out[f"{name}/losses"] = np.array(losses)
        out[f"{name}/grad_norms"] = np.array(norms)
        out[f"{name}/b5_calls"] = np.array(b5)
        out[f"{name}/seed"] = np.array(eng._rng.initial_seed())
        out[f"{name}/master_numel"] = sum(t.numel() for t in eng.master_params.values())
        out[f"{name}/opt_numel"] = sum(t.numel() for t in tree_leaves(eng.opt_state)
                                       if isinstance(t, torch.Tensor))
        out[f"{name}/shard_numel"] = sum(
            g.shard.numel() for _, _, _, g in eng._compute if g is not None)
        out[f"{name}/tp_numel"] = sum(math.prod(shape) for r in eng.plan.regions
                                      for shape in r.shapes)
        out[f"{name}/staged"] = np.array(json.dumps(dict(comm.STAGED)))
        out[f"{name}/warnings"] = np.array(json.dumps(list(warnings)))
        out[f"{name}/footprints"] = np.array(json.dumps(footprints))
        out[f"{name}/comms_rows"] = np.array(json.dumps(comm.log_summary(show_straggler=True)))
        out[f"{name}/group_sizes"] = np.array(json.dumps(
            {op: sorted(n) for op, n in comm.comms_logger.group_sizes.items()}))
        if eng.scheduled_step is not None:
            plan, sched = eng._sched_plan, eng.scheduled_step
            out[f"{name}/schedule"] = np.array(json.dumps({
                "grad_schedule": plan.grad_schedule, "bucket_mb": plan.bucket_mb,
                "tag": plan.tag, "n_hoisted": sched.n_hoisted,
                "n_collectives": sched.n_collectives,
                "hook_sites": [s.primitive for s in sched.sites if s.path == ("hook",)
                               for _ in range(s.repeats)],
                "step_sites": [[s.primitive, s.n_elems] for s in sched.sites
                               if s.path == ("step",) for _ in range(s.repeats)],
                "per_micro": eng._per_micro}))
        final = eng.full_master_params()
        # a gather by name gives the same whole tensors (tp slices joined)
        named = sorted(eng._tp_dims)[:2] + [n for n in eng._order if n not in eng._tp_dims][:1]
        got = eng.gather_whole(eng.master_params, names=named)
        out[f"{name}/named_gather_whole"] = np.array(
            all(torch.equal(got[n], final[n]) for n in named))
        if rank == 0:
            for param, t in final.items():
                out[f"{name}/final/{param}"] = t.cpu().numpy()
        if run.get("reload"):
            _reload(eng, run, name, model, start, device, out)


def _weights(job, run, start):
    """The run's initial weights: ``w/<param>``, or ``<weights>/<param>``
    where the run names another prefix."""
    prefix = run.get("weights")
    if prefix is None:
        return start
    return {k[len(prefix) + 1:]: torch.from_numpy(job[k]) for k in job.files
            if k.startswith(prefix + "/")}


def _wait(run):
    """Wait for the file ``run["wait"]`` (the test process writes it once
    what the run reads exists)."""
    if not run.get("wait"):
        return
    deadline = time.monotonic() + 600
    while not os.path.exists(run["wait"]):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{run['name']}: {run['wait']} never came")
        time.sleep(0.05)


def _model(run, device="cpu"):
    """The run's model: GPT-NeoX ``tiny()``, or with ``family`` "llama"
    Llama ``tiny()``, at ``dtype`` with the ``model`` fields."""
    if run.get("family") == "llama":
        from deeperspeed_tpu_torch.models import Llama, LlamaConfig

        return Llama(LlamaConfig.tiny(dtype=DTYPES[run["dtype"]], **run.get("model", {})),
                     device=device)
    return GPTNeoX(GPTNeoXConfig.tiny(dtype=DTYPES[run["dtype"]], **run.get("model", {})),
                   device=device)


def _mesh(run):
    return MeshTopology(**run["mesh"]) if run.get("mesh") else None


def _capture_grads(eng, name, out):
    """Each stage-0 parameter's mean gradient over the microbatches before
    the first step's reduction and its mean over the ranks after it."""
    reduce = eng._reduce

    def capture(divisor):
        names = [n for r in eng.plan.regions for n in r.names]
        views = dict(zip(names, eng._acc_views))
        if not any(k.startswith(f"{name}/pre/") for k in out):
            for n, v in views.items():
                out[f"{name}/pre/{n}"] = (v / divisor).numpy().copy()
            reduce(divisor)
            for n, v in views.items():
                out[f"{name}/post/{n}"] = v.numpy().copy()
            return
        reduce(divisor)

    eng._reduce = capture


def _reload(eng, run, name, model, start, device, out):
    """Save ``eng``, load the checkpoint into a fresh engine: 1-bit Adam's
    error feedback before the save and after the load, and whether the
    loaded masters equal the saved ones."""
    ckpt = run["reload"]
    out[f"{name}/error_before"] = np.array(float(eng._onebit_error.abs().max()))
    eng.save_checkpoint(ckpt)
    fresh = GPTNeoX(GPTNeoXConfig.tiny(dtype=DTYPES[run["dtype"]]), device=device, seed=9)
    eng2, *_ = tdst.initialize(model=fresh, config=run["config"], device=device)
    eng2._onebit_error.fill_(1.0)
    eng2.load_checkpoint(ckpt)
    out[f"{name}/error_after"] = np.array(float(eng2._onebit_error.abs().max()))
    out[f"{name}/reload_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(eng.master_params.values(),
                                          eng2.master_params.values())))


def _legacy_step(eng, batch):
    """One step through ``forward``/``backward``/``step`` over gas global
    microbatches; returns the mean of this rank's microbatch losses."""
    gas = eng.gradient_accumulation_steps()
    per = len(batch["input_ids"]) // gas
    losses = []
    for i in range(gas):
        loss = eng.forward({k: v[i * per:(i + 1) * per] for k, v in batch.items()})
        eng.backward(loss)
        losses.append(float(loss))
    eng.step()
    return sum(losses) / gas


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _record(eng, rank, out, key):
    """The engine's state under ``key`` (the gathers are collectives)."""
    whole = {**_flat(ck.reference_masters(eng), f"{key}/m"),
             **_flat(ck.reference_opt_state(eng), f"{key}/o")}
    if rank == 0:
        out.update(whole)
    out[f"{key}/rng"] = eng._rng.get_state().numpy().copy()
    out[f"{key}/loss_scale"] = np.array([float(getattr(eng.loss_scale_state, f))
                                         for f in ck._LOSS_SCALE_FIELDS])
    out[f"{key}/counters"] = np.array([eng.step_count, eng.global_steps,
                                       eng.global_samples, eng.micro_steps,
                                       eng.skipped_steps])
    dl = eng.training_dataloader
    out[f"{key}/loader"] = np.array(json.dumps(dl.state_dict() if dl is not None else None))


def _ckpt(spec, job, rank, out):
    start = {k[2:]: torch.from_numpy(job[k]) for k in job.files if k.startswith("w/")}
    keys = sorted({k.split("/", 1)[1] for k in job.files if k.startswith("b0/")})
    batches = [{key: job[f"b{i}/{key}"] for key in keys}
               for i in range(spec["n_batches"])]
    for run in spec["runs"]:
        name = run["name"]
        model = _model(run)
        data = ({k[2:]: job[k] for k in job.files if k.startswith("d/")}
                if run.get("training_data") else None)
        eng, *_ = tdst.initialize(model=model, config=run["config"],
                                  model_parameters=_weights(job, run, start),
                                  training_data=data, device="cpu", mesh=_mesh(run))
        if run.get("load"):
            _wait(run)
            eng.load_checkpoint(run["load"])
            _record(eng, rank, out, f"{name}/loaded")
        losses = []
        for j, i in enumerate(run["steps"]):
            if run.get("save") and j == run["save_after"]:
                eng.save_checkpoint(run["save"])
                _record(eng, rank, out, f"{name}/saved")
            loss = eng.train_batch() if data is not None else eng.train_batch(batch=batches[i])
            losses.append(float(loss))
        if run.get("save") and run["save_after"] == len(run["steps"]):
            eng.save_checkpoint(run["save"])
            _record(eng, rank, out, f"{name}/saved")
        out[f"{name}/losses"] = np.array(losses)
        _record(eng, rank, out, f"{name}/final")


def _comm(spec, job, rank, out):
    group = comm.get_data_parallel_group()
    intra = inter = None
    if spec.get("two_level"):
        intra, inter = comm.new_two_level_groups(*spec["two_level"])
    for case in spec["cases"]:
        x = torch.from_numpy(job[f"x/{case['name']}/{rank}"])
        kw = {"group_size": case.get("group_size", 128), "wire_dtype": case.get("wire")}
        groups = {"intra_group": intra, "inter_group": None if case.get("intra_only")
                  else inter}
        if case["op"] == "all_to_all_untiled":
            y = comm.all_to_all(x, group, split_axis=case["split"],
                                concat_axis=case["concat"], tiled=False)
        elif case["op"] == "onebit":
            err = None
            for i in range(case["steps"]):
                c = x[i].reshape(-1) if err is None else x[i].reshape(-1) + err.reshape(-1)
                out[f"{case['name']}/{i}/packed"] = compressed._pack_signs(
                    torch.nn.functional.pad(c >= 0, (0, (-c.numel()) % 8))).numpy()
                y, err = compressed.onebit_all_reduce(x[i], group, err)
                out[f"{case['name']}/{i}/y"] = y.numpy()
                out[f"{case['name']}/{i}/err"] = err.numpy()
            continue
        elif case["op"].startswith("two_level_"):
            op = case["op"][len("two_level_"):]
            comm.comms_logger.begin_step()
            if op == "all_reduce_quantized":
                y = comm.all_reduce_quantized(x, op=case.get("reduce", "sum"), **groups, **kw)
            elif op == "reduce_scatter_quantized":
                y = comm.reduce_scatter_quantized(x, **groups, **kw)
            elif op.startswith("hierarchical_"):
                y = getattr(compressed, op)(x, intra, inter, **kw)
            else:
                y = getattr(quantized, op)(x, intra_group=intra, inter_group=inter, **kw)
            out[f"{case['name']}/footprint"] = np.array(json.dumps(comm.comms_logger.end_step()))
        elif case["op"] == "all_reduce_quantized":
            y = comm.all_reduce_quantized(x, op=case.get("reduce", "sum"), group=group, **kw)
        elif case["op"] == "reduce_scatter_quantized":
            y = comm.reduce_scatter_quantized(x, group=group, **kw)
        elif case["op"].startswith("qgz_"):
            y = getattr(quantized, case["op"])(x, intra_group=group, **kw)
        else:
            y = compressed.quantized_reduce_scatter(x, group, **kw)
        out[case["name"]] = y.numpy()


def _moe(spec, job, rank, out):
    for i, case in enumerate(spec.get("refusals", [])):
        try:
            tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(**case["model"]), device="cpu"),
                            config=case["config"], device="cpu", mesh=_mesh(case))
            msg = ""
        except (ValueError, NotImplementedError) as e:
            msg = f"{type(e).__name__}: {e}"
        out[f"refusal{i}"] = np.array(msg)
    _train({**spec, "runs": spec["moe_runs"]}, job, rank, out)


def _llama(spec, job, rank, out):
    from deeperspeed_tpu_torch.models import Llama, LlamaConfig

    train = spec["train"]
    start = {k[2:]: torch.from_numpy(job[k]) for k in job.files if k.startswith("w/")}
    eng, *_ = tdst.initialize(model=Llama(LlamaConfig.tiny(), device="cpu"),
                              config=train["config"], model_parameters=start, device="cpu")
    out["train/losses"] = np.array([
        float(eng.train_batch(batch={"input_ids": torch.from_numpy(job[f"b{i}/input_ids"]),
                                     "labels": torch.from_numpy(job[f"b{i}/labels"])}))
        for i in range(train["steps"])])
    out["train/heads"] = np.array(eng.module.layers[0].attention.q_proj.weight.shape[0]
                                  // LlamaConfig.tiny().head_dim)
    gen = spec["generate"]
    weights = {k[2:]: torch.from_numpy(job[k]) for k in job.files if k.startswith("g/")}
    model = Llama(LlamaConfig.tiny(), device="cpu")
    model.load_state_dict(weights)
    inf = tdst.init_inference(model, gen["config"], device="cpu")
    out["generate/tokens"] = inf.generate(job["p"], attention_mask=job["pm"],
                                          max_new_tokens=gen["new"]).numpy()
    out["generate/logits"] = inf(job["p"]).numpy()
    out["generate/cache_heads"] = np.array(inf._new_cache(1, 8).layers[0][0].shape[2])


def _pipe_model(run):
    from deeperspeed_tpu_torch.models import LlamaConfig
    from deeperspeed_tpu_torch.models import simple
    from deeperspeed_tpu_torch.models.gpt_neox_pipe import GPTNeoXPipe
    from deeperspeed_tpu_torch.models.llama_pipe import LlamaPipe
    from deeperspeed_tpu_torch.runtime.pipe.module import (LayerSpec, PipelineModule,
                                                           TiedLayerSpec)

    kind, pp, dtype = run["model"], run["pp"], DTYPES[run.get("dtype", "fp32")]
    if kind == "neox":
        return GPTNeoXPipe(GPTNeoXConfig.tiny(dtype=dtype), pp, device="cpu")
    if kind == "mistral":
        return LlamaPipe(LlamaConfig.tiny_mistral(dtype=dtype), pp, device="cpu")
    if kind == "mlp":
        specs = [LayerSpec(simple.InProj), TiedLayerSpec("blk", simple.Block),
                 TiedLayerSpec("blk", simple.Block), LayerSpec(simple.OutProj)]
        loss = simple.mse_loss
    else:
        specs = [TiedLayerSpec("emb", simple.Embed, 32, 16), LayerSpec(simple.Block),
                 LayerSpec(simple.Block),
                 TiedLayerSpec("emb", simple.Embed, 32, 16, forward_fn=simple.embed_decode)]
        loss = simple.ce_loss
    return PipelineModule(specs, num_stages=pp, loss_fn=loss, partition_method="uniform")


def _unflat(job, prefix):
    tree = {}
    for k in job.files:
        if k.startswith(prefix):
            node = tree
            *parents, last = k[len(prefix):].split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = job[k]
    return tree


def _pipe(spec, job, rank, out):
    from deeperspeed_tpu_torch.checkpoint import universal

    world = comm.get_world_group()
    out["ring"] = comm.send_next(torch.full((3,), float(rank)), world).numpy()
    perm = [(i, (i + 1) % world.size()) for i in range(0, world.size(), 2)]
    out["pairs"] = comm.ppermute(torch.full((2,), float(rank + 1)), perm, world).numpy()
    for run in spec["pipe_runs"]:
        name, pp = run["name"], run["pp"]
        _wait(run)
        model = _pipe_model(run)
        tree = _unflat(job, f"w/{name}/")
        stage = rank // (comm.get_world_size() // pp)
        config = {**run["config"], "mesh": {"pipe_parallel_size": pp,
                                            "model_parallel_size": run.get("tp", 1),
                                            "sequence_parallel_size": run.get("sp", 1)}}
        start = (model.params_from_jax(tree, stage) if hasattr(model, "params_from_jax")
                 else None)
        eng, *_ = tdst.initialize(model=model, config=config, model_parameters=start,
                                  device="cpu")
        if start is None and tree:
            ck.load_reference_masters(eng, tree)
        if run.get("load"):
            eng.load_checkpoint(run["load"])
            _record_masters(eng, rank, out, f"{name}/loaded")
        if run.get("universal"):
            universal.load_universal_into_interpreted(eng, run["universal"])
            _record_masters(eng, rank, out, f"{name}/loaded")
        losses, norms, peaks = [], [], []
        for i in range(run["steps"]):
            if run.get("save") and i == run["save_after"]:
                eng.save_checkpoint(run["save"])
                _record_masters(eng, rank, out, f"{name}/saved")
            batch = {k.split("/")[-1]: job[k] for k in job.files
                     if k.startswith(f"d/{name}/{i}/")}
            losses.append(float(eng.train_batch(batch=batch)))
            norms.append(eng.get_global_grad_norm())
            peaks.append(eng.peak_live_inputs())
        out[f"{name}/losses"] = np.array(losses)
        out[f"{name}/norms"] = np.array(norms)
        out[f"{name}/peaks"] = np.array(peaks)
        out[f"{name}/stage"] = np.array(eng.stage_id)
        out[f"{name}/tiers"] = np.array([eng._host_adam is not None, eng._offload,
                                         eng._opt_swapper is not None])
        if eng._opt_swapper is not None:
            out[f"{name}/swap_dir"] = np.array(os.path.basename(eng._opt_swapper.dir))
        batch = {k.split("/")[-1]: job[k] for k in job.files if k.startswith(f"d/{name}/0/")}
        out[f"{name}/eval"] = np.array(float(eng.eval_batch(batch=batch)))
        last = eng.eval_batch(batch=batch, bcast_loss=False)
        out[f"{name}/eval_last"] = np.array(np.nan if last is None else float(last))
        _record_masters(eng, rank, out, f"{name}/final")
        if run.get("poison") is not None:
            before = {n_: t.clone() for n_, t in eng.master_params.items()}
            scale = eng.get_loss_scale()
            if eng.stage_id == run["poison"]:
                first = next(iter(eng.master_params.values()))
                first.view(-1)[0] = float("inf")
                eng._refresh_compute()
            eng.train_batch(batch=batch)
            kept = all(torch.equal(t, before[n_]) or eng.stage_id == run["poison"]
                       for n_, t in eng.master_params.items())
            out[f"{name}/poison"] = np.array([eng.skipped_steps, eng.get_loss_scale() / scale,
                                              float(kept)])


def _seq(spec, job, rank, out):
    """The sequence-parallel functions and models over the ``sp`` group of
    ``MeshTopology(sp=world)``: each rank takes its slice (dim 1) of the
    global arrays and records its outputs and input gradients."""
    from deeperspeed_tpu_torch import sequence
    from deeperspeed_tpu_torch.models import Llama, LlamaConfig
    from deeperspeed_tpu_torch.ops.attention.core import _reference_attention

    tdst.parallel.set_mesh(MeshTopology(sp=comm.get_world_size()))
    group = comm.get_sequence_parallel_group()
    p = group.size()

    def local(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        per = t.shape[1] // p
        return t[:, rank * per:(rank + 1) * per].contiguous()

    x = local(job["x"])
    y = sequence.single_all_to_all(x, 2, 1, group)
    out["a2a/y"], out["a2a/z"] = y.numpy(), sequence.single_all_to_all(y, 1, 2, group).numpy()
    q, k, v, w = (local(job[n]) for n in ("q", "k", "v", "w"))
    dense = _reference_attention
    out["dist/out"] = sequence.DistributedAttention(dense, group)(q, k, v, causal=True).numpy()
    out["uly/out"] = sequence.ulysses_attention(dense, q, k, v, group=group,
                                                causal=True).numpy()
    for causal in (True, False):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = sequence.ring_attention(*qkv, group=group, causal=causal)
        (o * w).sum().backward()
        for n, t in zip(("out", "dq", "dk", "dv"), [o] + [t.grad for t in qkv]):
            out[f"ring/{causal}/{n}"] = t.detach().numpy()
    kv = [t.clone().requires_grad_(True) for t in (k, v)]
    kg, vg, _, start = sequence.gathered_keys(*kv, group)
    o = dense(q, kg, vg, causal=True)
    (o * w).sum().backward()
    out["gathered/out"] = o.detach().numpy()
    out["gathered/dk"], out["gathered/dv"] = kv[0].grad.numpy(), kv[1].grad.numpy()
    out["gathered/start"] = np.array(start)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kg, vg, _, _ = sequence.gathered_keys(*qkv[1:], group)
    o = sequence.padded_attention(dense, qkv[0], kg, vg)
    (o * w).sum().backward()
    for n, t in zip(("out", "dq", "dk", "dv"), [o] + [t.grad for t in qkv]):
        out[f"padded/{n}"] = t.detach().numpy()
    ids, labels = local(job["ids"]), local(job["labels"])
    for case in spec["models"]:
        name = case["name"]
        weights = {k[len(name) + 3:]: torch.from_numpy(job[k]) for k in job.files
                   if k.startswith(f"{name}/w/")}
        if case["family"] == "llama":
            cfg = getattr(LlamaConfig, case.get("preset", "tiny"))(**case.get("model", {}))
            model = Llama(cfg, device="cpu")
        else:
            model = GPTNeoX(GPTNeoXConfig.tiny(**case.get("model", {})), device="cpu")
        model.load_state_dict(weights)
        sequence.bind_sequence_parallel(model, group)
        loss = model.loss_fn()(model, {"input_ids": ids, "labels": labels})
        loss.backward()
        out[f"{name}/loss"] = loss.detach().numpy()
        for n, prm in model.named_parameters():
            if prm.grad is not None:
                out[f"{name}/grad/{n}"] = prm.grad.numpy()


def _record_masters(eng, rank, out, key):
    whole = _flat(ck.reference_masters(eng), f"{key}")
    if rank == 0:
        out.update(whole)


def main():
    rank, world, rendezvous, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    tdst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                          world_size=world, timeout=120)
    job = np.load(job_path)
    spec = json.loads(str(job["spec"]))
    out = {}
    kinds = spec["kind"] if isinstance(spec["kind"], list) else [spec["kind"]]
    for kind in kinds:
        {"train": _train, "comm": _comm, "ckpt": _ckpt, "llama": _llama, "moe": _moe,
         "pipe": _pipe, "seq": _seq}[kind](
            spec, job, rank, out)
    np.savez(out_path, **out)
    comm.destroy()


def spawn(spec, arrays, tmp_path, world=2, timeout=600):
    """Run ``world`` workers on ``spec`` and ``arrays`` (called by the
    tests); returns each rank's results as a dict.  Raises with a failed
    worker's error output, after stopping the others."""
    return start(spec, arrays, tmp_path, world, timeout)()


def start(spec, arrays, tmp_path, world=2, timeout=600):
    """:func:`spawn` started: returns the call that waits for the workers
    and returns their results (the test process works meanwhile)."""
    job = tmp_path / "job.npz"
    np.savez(job, spec=np.array(json.dumps(spec)), **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    logs = [tmp_path / f"worker{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r), str(world),
                 str(tmp_path / "rendezvous"), str(job), str(tmp_path / f"out{r}.npz")],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout

    def finish():
        try:
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"worker {r} exited {p.returncode}:\n"
                                   f"{logs[r].read_text()[-6000:]}")
        return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]

    return finish


if __name__ == "__main__":
    main()
