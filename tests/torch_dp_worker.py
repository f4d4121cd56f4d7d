"""One process of a data-parallel run of the PyTorch port on the CPU, for
the tests that hold it against the JAX package (``test_torch_zero.py``,
``test_torch_comm.py``).  It imports only the port.

    python tests/torch_dp_worker.py RANK WORLD RENDEZVOUS_FILE JOB.npz OUT.npz

``JOB.npz`` holds ``spec`` (JSON) and the arrays it names; the worker joins
a ``gloo`` group through ``file://RENDEZVOUS_FILE`` and writes its results
to ``OUT.npz``.  Job kinds:

* ``train``: for each run, a GPT-NeoX ``tiny()`` engine from the weights
  ``w/<param>`` trains on the global batches ``b<i>/<key>`` (or, with
  ``training_data``, on the columns ``d/<key>``), on ``spec["device"]``
  (the CPU by default); it records the losses, the grad norms, the
  elements of the masters, optimizer state and stage-3 partitions it
  holds, the calls of B5 (its plain version, or the kernel's launches on
  the card), the warnings, and on rank 0 the final fp32 masters; a run
  with ``legacy`` steps through ``forward``/``backward``/``step`` (its
  losses are this rank's), one with ``eval`` also records ``eval_batch``
  of the first batch after training;
* ``comm``: each case runs one quantized collective on this rank's input
  ``x/<case>/<rank>``.
"""

import json
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
from deeperspeed_tpu_torch.runtime import engine as engine_module
from deeperspeed_tpu_torch.runtime.zero import quantized
from deeperspeed_tpu_torch.utils.tree import tree_leaves

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


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
    for run in spec["runs"]:
        name = run["name"]
        model = GPTNeoX(GPTNeoXConfig.tiny(dtype=DTYPES[run["dtype"]]), device=device)
        data = None
        if run.get("training_data"):
            data = {k[2:]: job[k] for k in job.files if k.startswith("d/")}
        warnings.clear()
        eng, *_ = tdst.initialize(model=model, config=run["config"], model_parameters=start,
                                  training_data=data, device=device)
        calls[0] = 0
        LAUNCHES.clear()
        losses, norms, b5 = [], [], []
        for step in range(run["steps"]):
            if run.get("legacy"):
                loss = _legacy_step(eng, batches[step])
            else:
                loss = eng.train_batch() if data is not None else eng.train_batch(
                    batch=batches[step])
            losses.append(float(loss))
            norms.append(eng.get_global_grad_norm())
            b5.append(calls[0] + LAUNCHES["dequant_reduce"])
            calls[0] = 0
            LAUNCHES.clear()
        if run.get("eval"):
            out[f"{name}/eval"] = np.array(float(eng.eval_batch(batch=batches[0])))
        out[f"{name}/losses"] = np.array(losses)
        out[f"{name}/grad_norms"] = np.array(norms)
        out[f"{name}/b5_calls"] = np.array(b5)
        out[f"{name}/master_numel"] = sum(t.numel() for t in eng.master_params.values())
        out[f"{name}/opt_numel"] = sum(t.numel() for t in tree_leaves(eng.opt_state)
                                       if isinstance(t, torch.Tensor))
        out[f"{name}/shard_numel"] = sum(
            g.shard.numel() for _, _, _, g in eng._compute if g is not None)
        out[f"{name}/warnings"] = np.array(json.dumps(list(warnings)))
        final = eng.full_master_params()
        if rank == 0:
            for param, t in final.items():
                out[f"{name}/final/{param}"] = t.cpu().numpy()


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


def _comm(spec, job, rank, out):
    group = comm.get_data_parallel_group()
    for case in spec["cases"]:
        x = torch.from_numpy(job[f"x/{case['name']}/{rank}"])
        kw = {"group_size": case.get("group_size", 128), "wire_dtype": case["wire"]}
        if case["op"] == "all_reduce_quantized":
            y = comm.all_reduce_quantized(x, op=case.get("reduce", "sum"), group=group, **kw)
        elif case["op"] == "reduce_scatter_quantized":
            y = comm.reduce_scatter_quantized(x, group=group, **kw)
        elif case["op"].startswith("qgz_"):
            y = getattr(quantized, case["op"])(x, intra_group=group, **kw)
        else:
            y = compressed.quantized_reduce_scatter(x, group, **kw)
        out[case["name"]] = y.numpy()


def main():
    rank, world, rendezvous, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    tdst.init_distributed("gloo", init_method=f"file://{rendezvous}", rank=rank,
                          world_size=world, timeout=120)
    job = np.load(job_path)
    spec = json.loads(str(job["spec"]))
    out = {}
    {"train": _train, "comm": _comm}[spec["kind"]](spec, job, rank, out)
    np.savez(out_path, **out)
    comm.destroy()


def spawn(spec, arrays, tmp_path, world=2, timeout=600):
    """Run ``world`` workers on ``spec`` and ``arrays`` (called by the
    tests); returns each rank's results as a dict.  Raises with a failed
    worker's error output, after stopping the others."""
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
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
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


if __name__ == "__main__":
    main()
