"""The PyTorch port's data loading against the JAX package's on the CPU:
``DeeperSpeedDataLoader`` batches over two epochs (shuffled from the seed,
``set_epoch``, ``state_dict`` resume, the JAX loader's shards put
together, collate functions),
``RepeatingLoader``, and the engine fed through ``training_data=`` with
``train_batch()`` taking no arguments, against the JAX engine fed the same
dataset (losses within ``LOSS_TOL["fp32"]``, 1e-5 relative).  Both loaders
are numpy: their batches must be equal, element for element.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.runtime import dataloader as jloader
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.runtime import dataloader as tloader
import torch_threads  # noqa: F401  (torch at one intra-op thread)


def _jax_engine(model, config, **kw):
    """The JAX engine, its step counter placed on the mesh as its first step
    leaves it: the second step then reuses the first's compile instead of
    tracing again.  The values are the same."""
    jeng, *_ = jdst.initialize(model=model, config=config, **kw)
    mesh = jax.tree.leaves(jeng.state["master_params"])[0].sharding.mesh
    jeng.state["step"] = jax.device_put(jeng.state["step"], NamedSharding(mesh, P()))
    return jeng



def _columns(n=30, seq=8, seed=0):
    toks = np.random.default_rng(seed).integers(0, 256, (n, seq + 1))
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


def _datasets():
    cols = _columns()
    rows = [{k: v[i] for k, v in cols.items()} for i in range(30)]
    pairs = [(cols["input_ids"][i], cols["labels"][i]) for i in range(30)]

    def collate(examples):           # takes the list of examples, as in the JAX loader
        return {k: np.stack([e[k] for e in examples]) + 1 for k in examples[0]}

    return {"columns": (cols, None), "dict rows": (rows, None), "tuple rows": (pairs, None),
            "collate": (rows, collate)}


def _assert_batches_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(_datasets()))
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_equal_jax_over_two_epochs(name, drop_last):
    data, collate = _datasets()[name]
    kw = dict(batch_size=4, collate_fn=collate, drop_last=drop_last, seed=7)
    ours, theirs = tloader.DeeperSpeedDataLoader(data, **kw), \
        jloader.DeeperSpeedDataLoader(data, num_shards=1, **kw)
    assert len(ours) == len(theirs) == (7 if drop_last else 8)
    for epoch in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) and ours.epoch == theirs.epoch == epoch + 1
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)
    ours.set_epoch(5)
    theirs.set_epoch(5)
    _assert_batches_equal(next(iter(ours)), next(iter(theirs)))


def test_state_dict_resumes_where_jax_resumes():
    cols = _columns()
    for stop in (3, 7):               # mid-epoch, and after the epoch's last batch
        ours = tloader.DeeperSpeedDataLoader(cols, batch_size=4, seed=3)
        it = iter(ours)
        for _ in range(stop):
            next(it)
        state = ours.state_dict()
        resumed = tloader.DeeperSpeedDataLoader(cols, batch_size=4, seed=3)
        resumed.load_state_dict(state)
        theirs = jloader.DeeperSpeedDataLoader(cols, batch_size=4, seed=3, num_shards=1)
        theirs.load_state_dict(state)
        assert resumed.epoch == theirs.epoch and state == {"epoch": 0, "batch_idx": stop}
        for a, b in zip(resumed, theirs):
            _assert_batches_equal(a, b)
        # the uninterrupted run's next batches are the resumed run's
        rest = list(it) + list(iter(ours))
        again = tloader.DeeperSpeedDataLoader(cols, batch_size=4, seed=3)
        again.load_state_dict(state)
        for a, b in zip(again, rest):
            _assert_batches_equal(a, b)


def test_shards_and_repeating_loader_match_jax():
    """The one-process loader yields each global batch whole: the JAX
    loader's two shards of it, one after the other; with two shards, each
    process's slice equals the JAX loader's shard."""
    cols = _columns(32)
    shards = [jloader.DeeperSpeedDataLoader(cols, batch_size=8, seed=1, num_shards=2,
                                            shard_index=index) for index in range(2)]
    ours = list(tloader.DeeperSpeedDataLoader(cols, batch_size=8, seed=1))
    for a, b0, b1 in zip(ours, *shards):
        assert len(a["input_ids"]) == 8
        _assert_batches_equal(a, {k: np.concatenate([b0[k], b1[k]]) for k in a})
    for index in range(2):
        mine = tloader.DeeperSpeedDataLoader(cols, batch_size=8, seed=1, num_shards=2,
                                             shard_index=index)
        theirs = jloader.DeeperSpeedDataLoader(cols, batch_size=8, seed=1, num_shards=2,
                                               shard_index=index)
        for a, b in zip(mine, theirs):
            assert len(a["input_ids"]) == 4
            _assert_batches_equal(a, b)
    loader = tloader.DeeperSpeedDataLoader(cols, batch_size=8, seed=1)
    ours, theirs = tloader.RepeatingLoader(loader), jloader.RepeatingLoader(
        jloader.DeeperSpeedDataLoader(cols, batch_size=8, seed=1, num_shards=1))
    assert len(ours) == len(theirs) == 4
    for _ in range(10):               # 2.5 epochs
        _assert_batches_equal(next(ours), next(theirs))
    with pytest.raises(ValueError):   # a global batch that does not split
        tloader.DeeperSpeedDataLoader(cols, batch_size=9, num_shards=2)


def test_engine_training_data_matches_jax():
    """initialize(training_data=, collate_fn=) and train_batch() without
    arguments: the engine's loader draws gas microbatches a step from the
    persistent iterator, across the epoch boundary, as the JAX engine
    does."""
    cols = {k: v.astype(np.int32) for k, v in _columns(48, 16, seed=4).items()}
    data = [{k: v[i] for k, v in cols.items()} for i in range(48)]

    def collate(examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}

    config = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
              "gradient_clipping": 1.0, "seed": 21,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    jeng = _jax_engine(JaxGPTNeoX(JaxConfig.tiny()), config, training_data=data,
                       collate_fn=collate)
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    teng, _, loader, _ = tdst.initialize(
        model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=config,
        model_parameters=start, training_data=data, collate_fn=collate, device="cpu")
    assert loader is teng.training_dataloader and len(loader) == 6   # 3 steps an epoch
    for step in range(4):
        lj, lt = float(jeng.train_batch()), float(teng.train_batch())
        assert abs(lt - lj) <= 1e-5 * abs(lj), (step, lj, lt)
    assert loader.epoch == 1
    with pytest.raises(ValueError, match="no data"):
        tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=config,
                        device="cpu")[0].train_batch()


def test_deepspeed_io_curriculum_sampling_matches_jax(tmp_path):
    """data_efficiency.data_sampling: the loader draws from the easiest
    prefix of a metric-sorted order (a saved index), ramped by the
    curriculum scheduler."""
    cols = _columns(64, 8, seed=5)
    path = tmp_path / "sorted_index.npy"
    np.save(path, np.argsort(cols["input_ids"].sum(1), kind="stable"))
    config = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "curriculum_learning": {"enabled": True, "params": {
                  "curriculum_type": "vocab", "min_difficulty": 2, "max_difficulty": 10,
                  "schedule_type": "fixed_linear",
                  "schedule_config": {"total_curriculum_step": 6, "difficulty_step": 1}}},
              "data_efficiency": {"enabled": True, "seed": 9,
                                  "data_sampling": {"enabled": True,
                                                    "sorted_index_path": str(path)}}}
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=config)
    teng = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=config,
                           device="cpu")[0]
    ours = teng.deepspeed_io(cols, data_sampler=None)
    theirs = jeng.deepspeed_io(cols)
    np.testing.assert_array_equal(ours.sampler.sorted_index, np.load(path))
    assert ours.sampler.draws_per_step == theirs.sampler.draws_per_step == 2
    for a, b in zip(ours, theirs):
        _assert_batches_equal(a, b)
    assert ours.sampler.state_dict() == theirs.sampler.state_dict()
