"""Checkpoints of the PyTorch port over two processes on the CPU (``gloo``,
``torch_dp_worker.py``'s ``ckpt`` job), one pair of workers for every case:

* port -> port at world 2, ZeRO stages 0-3: an engine trains 2 steps,
  saves and trains 2 more; a fresh engine at the same world and stage loads
  and trains the same 2.  Losses, whole masters and optimizer state, each
  rank's generator, loss scale, counters and loader position are equal bit
  for bit: in fp32 with dropout and ``training_data=`` at every stage, in
  fp16 with an overflow just after the save (stage 2) and with FusedAdam in
  bf16 (stage 1).
* across world sizes: a save at world 2 / stage 2 loads at world 1 (this
  process) into the masters and moments the workers held, bit for bit; a
  save at world 1 loads at world 2 / stage 3 likewise.
"""

import json

import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.runtime import checkpointing as ck
from torch_dp_worker import spawn

N_BATCHES = 5      # the last one overflows: the fp16 run takes it after the save
DROPOUT = {"hidden_dropout": 0.1, "attention_dropout": 0.1}
BASE = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 4, "warmup_max_lr": 1e-3}}}
FP16 = {"fp16": {"enabled": True, "initial_scale_power": 8, "hysteresis": 1}}


def _zero(stage):
    return {"zero_optimization": {"stage": stage, "param_persistence_threshold": 1000}}


RESUMES = {
    **{f"stage{s}": ({**BASE, **_zero(s)}, "fp32", DROPOUT, True) for s in range(4)},
    "stage2-fp16-overflow": ({**BASE, **_zero(2), **FP16}, "fp16", {}, False),
    "stage1-bf16-fusedadam": ({**BASE, **_zero(1), "bf16": {"enabled": True},
                               "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3}}},
                              "bf16", {}, False),
}


def _batches(rng):
    out = []
    for i in range(N_BATCHES):
        toks = rng.integers(0, 256, (16, 33))
        mask = np.ones((16, 32), np.float32)
        if i == N_BATCHES - 1:
            mask[3, 5] = np.inf       # a non-finite loss, hence non-finite grads
        out.append({"input_ids": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32), "loss_mask": mask})
    return out


def _state(eng):
    """This process's engine as the workers record it (rank 0's keys)."""
    out = {}
    for prefix, tree in (("m", ck.reference_masters(eng)), ("o", ck.reference_opt_state(eng))):
        def walk(node, name):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{name}/{k}")
                else:
                    out[f"{name}/{k}"] = np.array(
                        v.detach().cpu() if isinstance(v, torch.Tensor) else v)
        walk(tree, prefix)
    return out


def _whole(rank0, key):
    """Rank 0's record of the whole masters and optimizer state at ``key``."""
    return {k[len(key) + 1:]: v for k, v in rank0.items()
            if k.startswith(f"{key}/m/") or k.startswith(f"{key}/o/")}


def _assert_equal(got, want):
    assert got.keys() == want.keys() and want, sorted(set(got) ^ set(want))[:5]
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_dp")
    rng = np.random.default_rng(21)
    batches = _batches(rng)
    toks = rng.integers(0, 256, (6 * 16, 33))
    data = {"input_ids": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    start = {n: p.detach().clone() for n, p in
             GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=9).named_parameters()}

    # world 1: 2 steps, saved for the workers to load at world 2 / stage 3
    one, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config=BASE, model_parameters=start, device="cpu")
    for b in batches[:2]:
        one.train_batch(batch=b)
    one.save_checkpoint(str(tmp / "world1"))

    spec_runs = []
    for name, (config, dtype, model, loader) in RESUMES.items():
        common = {"config": config, "dtype": dtype, "model": model, "training_data": loader}
        after = [N_BATCHES - 1 if "overflow" in name else 2, 3]
        spec_runs += [{"name": f"{name}/first", **common, "steps": [0, 1] + after,
                       "save": str(tmp / name), "save_after": 2},
                      {"name": f"{name}/second", **common, "load": str(tmp / name),
                       "steps": after}]
    spec_runs += [
        {"name": "to_world1", "config": {**BASE, **_zero(2)}, "dtype": "fp32",
         "steps": [0, 1], "save": str(tmp / "world2"), "save_after": 2},
        {"name": "from_world1", "config": {**BASE, **_zero(3)}, "dtype": "fp32",
         "load": str(tmp / "world1"), "steps": [3]},
    ]
    arrays = {f"w/{n}": t.numpy() for n, t in start.items()}
    arrays.update({f"b{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    arrays.update({f"d/{k}": v for k, v in data.items()})
    ranks = spawn({"kind": "ckpt", "n_batches": N_BATCHES, "runs": spec_runs}, arrays, tmp)
    return {"ranks": ranks, "tmp": tmp, "one": one, "batches": batches}


@pytest.mark.parametrize("name", list(RESUMES))
def test_world2_resume_is_bit_exact(runs, name):
    for rank, out in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(out[f"{name}/second/losses"],
                                      out[f"{name}/first/losses"][2:])
        for key in ("rng", "loss_scale", "counters"):
            np.testing.assert_array_equal(out[f"{name}/second/loaded/{key}"],
                                          out[f"{name}/first/saved/{key}"])
            np.testing.assert_array_equal(out[f"{name}/second/final/{key}"],
                                          out[f"{name}/first/final/{key}"])
        assert str(out[f"{name}/second/final/loader"]) == str(out[f"{name}/first/final/loader"])
    r0, r1 = runs["ranks"]
    _assert_equal(_whole(r0, f"{name}/second/loaded"), _whole(r0, f"{name}/first/saved"))
    _assert_equal(_whole(r0, f"{name}/second/final"), _whole(r0, f"{name}/first/final"))
    # the ranks draw different dropout masks, from their own generators
    assert not np.array_equal(r0[f"{name}/first/final/rng"], r1[f"{name}/first/final/rng"])
    if name.startswith("stage") and name[5:].isdigit():
        loader = json.loads(str(r0[f"{name}/first/final/loader"]))
        assert loader["batch_idx"] == 8       # 4 steps of gas 2 microbatches
    if "overflow" in name:
        counters = r0[f"{name}/first/final/counters"]
        assert counters[4] == 1 and counters[0] == 3          # one skip, 3 updates


def test_world2_stage2_save_loads_at_world1(runs):
    r0 = runs["ranks"][0]
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=2),
                              config=BASE, device="cpu")
    eng.load_checkpoint(str(runs["tmp"] / "world2"))
    _assert_equal(_state(eng), _whole(r0, "to_world1/saved"))
    assert [eng.step_count, eng.global_steps] == list(r0["to_world1/saved/counters"][:2])


def test_world1_save_loads_at_world2_stage3(runs):
    one = runs["one"]
    want = _state(one)
    r0, r1 = runs["ranks"]
    _assert_equal(_whole(r0, "from_world1/loaded"), want)
    for out in (r0, r1):
        assert list(out["from_world1/loaded/counters"][:2]) == [one.step_count,
                                                                one.global_steps]
    # and trains on: the same step at world 1 gives the same loss to 1e-5
    loss = float(one.train_batch(batch=runs["batches"][3]))
    assert abs(r0["from_world1/losses"][0] - loss) <= 1e-5 * abs(loss)
