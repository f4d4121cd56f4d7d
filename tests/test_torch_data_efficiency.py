"""The PyTorch port's data-efficiency stack against the JAX package's on the
CPU: the curriculum scheduler, progressive layer drop's theta, the
random-LTD scheduler and token ops, the curriculum data sampler, the
indexed dataset and the data analyzer (numpy modules copied into the port:
their values must be equal), and the engine's seqlen truncation, layer drop
and token dropping against the JAX engine's.

Random draws differ between the frameworks, so the stochastic parts are
held with their draws injected through a seam (random-LTD's token indices),
at a setting that draws nothing (theta 1), and by statistics.  Losses:
``LOSS_TOL["fp32"]`` of ``test_torch_train.py`` (1e-5 relative).
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
from deeperspeed_tpu.runtime import progressive_layer_drop as jpld
from deeperspeed_tpu.runtime.config import CurriculumParams as JaxCurriculumParams
from deeperspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jcurriculum
from deeperspeed_tpu.runtime.data_pipeline.data_routing import basic_layer as jltd
from deeperspeed_tpu.runtime.data_pipeline.data_routing import scheduler as jltd_sched
from deeperspeed_tpu.runtime.data_pipeline.data_sampling import data_analyzer as janalyzer
from deeperspeed_tpu.runtime.data_pipeline.data_sampling import data_sampler as jsampler
from deeperspeed_tpu.runtime.data_pipeline.data_sampling import indexed_dataset as jindexed
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deeperspeed_tpu_torch.runtime.config import CurriculumParams
from deeperspeed_tpu_torch.runtime.data_pipeline import curriculum_scheduler as tcurriculum
from deeperspeed_tpu_torch.runtime.data_pipeline.data_routing import basic_layer as tltd
from deeperspeed_tpu_torch.runtime.data_pipeline.data_routing import scheduler as tltd_sched
from deeperspeed_tpu_torch.runtime.data_pipeline.data_sampling import data_analyzer as tanalyzer
from deeperspeed_tpu_torch.runtime.data_pipeline.data_sampling import data_sampler as tsampler
from deeperspeed_tpu_torch.runtime.data_pipeline.data_sampling import indexed_dataset as tindexed
import torch_threads  # noqa: F401  (torch at one intra-op thread)

LOSS_TOL = 1e-5
SCHEDULES = {
    "fixed_linear": {"total_curriculum_step": 40, "difficulty_step": 8},
    "fixed_root": {"total_curriculum_step": 40, "difficulty_step": 4, "root_degree": 3},
    "fixed_discrete": {"difficulty": [8, 24, 64], "max_step": [5, 17]},
}


def _jax_engine(model, config, **kw):
    """The JAX engine, its step counter placed on the mesh as its first step
    leaves it: the second step then reuses the first's compile instead of
    tracing again.  The values are the same."""
    jeng, *_ = jdst.initialize(model=model, config=config, **kw)
    mesh = jax.tree.leaves(jeng.state["master_params"])[0].sharding.mesh
    jeng.state["step"] = jax.device_put(jeng.state["step"], NamedSharding(mesh, P()))
    return jeng



def _schedulers(kind):
    params = dict(curriculum_type="seqlen", min_difficulty=8, max_difficulty=64,
                  schedule_type=kind, schedule_config=SCHEDULES[kind])
    return (tcurriculum.CurriculumScheduler(CurriculumParams(**params)),
            jcurriculum.CurriculumScheduler(JaxCurriculumParams(**params)))


@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_curriculum_difficulty_equals_jax(kind):
    ours, theirs = _schedulers(kind)
    for step in range(60):
        assert ours.update_difficulty(step) == theirs.update_difficulty(step), (kind, step)
        assert ours.is_fully_ramped(step) == theirs.is_fully_ramped(step)


def test_pld_theta_and_ltd_tokens_equal_jax():
    ours, theirs = tpld.ProgressiveLayerDrop(0.4, 0.01), jpld.ProgressiveLayerDrop(0.4, 0.01)
    a = tltd_sched.RandomLTDScheduler(min_tokens=8, max_tokens=100, total_steps=30,
                                      step_size=6)
    b = jltd_sched.RandomLTDScheduler(min_tokens=8, max_tokens=100, total_steps=30,
                                      step_size=6)
    for step in range(50):
        assert ours.update_state(step) == theirs.update_state(step)
        assert a.update(step) == b.update(step)
    assert ours.get_state() == theirs.get_state()


def test_data_sampler_indices_equal_jax():
    order = np.random.default_rng(0).permutation(50)
    samplers = []
    for curriculum, sampler in ((tcurriculum, tsampler), (jcurriculum, jsampler)):
        sched = curriculum.CurriculumScheduler(CurriculumParams(
            min_difficulty=2, max_difficulty=20, schedule_type="fixed_linear",
            schedule_config={"total_curriculum_step": 10, "difficulty_step": 2}))
        samplers.append(sampler.DeeperSpeedDataSampler(
            50, 8, curriculum_scheduler=sched, sorted_index=order, seed=3,
            data_parallel_rank=1, data_parallel_size=2, draws_per_step=2))
    ours, theirs = samplers
    for _ in range(30):
        np.testing.assert_array_equal(ours.next_local_indices(), theirs.next_local_indices())
    state = ours.state_dict()
    assert state == theirs.state_dict()
    ours.load_state_dict(state)
    theirs.load_state_dict(state)
    np.testing.assert_array_equal(ours.next_batch_indices(), theirs.next_batch_indices())


def test_indexed_dataset_and_analyzer_equal_jax(tmp_path):
    docs = [np.random.default_rng(i).integers(0, 500, 3 + 5 * i) for i in range(7)]
    for build, read, tag in ((tindexed, jindexed, "ours"), (jindexed, tindexed, "theirs")):
        builder = build.MMapIndexedDatasetBuilder(str(tmp_path / tag), dtype=np.uint16)
        for d in docs:
            builder.add_item(d)
        builder.finalize()
        ds = read.MMapIndexedDataset(str(tmp_path / tag))
        assert len(ds) == 7 and list(ds.sizes) == [len(d) for d in docs]
        for d, got in zip(docs, ds):
            np.testing.assert_array_equal(got, d)
    ds = tindexed.MMapIndexedDataset(str(tmp_path / "ours"))
    acc_t, rare_t = tanalyzer.vocab_rarity_metric_factory(500)
    acc_j, rare_j = janalyzer.vocab_rarity_metric_factory(500)
    for d in ds:
        acc_t(d)
        acc_j(d)
    for metric in ((tanalyzer.seqlen_metric, janalyzer.seqlen_metric), (rare_t, rare_j)):
        got = tanalyzer.DataAnalyzer(ds, metric[0], str(tmp_path / "a"), "m").run()
        want = janalyzer.DataAnalyzer(ds, metric[1], str(tmp_path / "b"), "m").run()
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    for w in range(2):
        tanalyzer.DistributedDataAnalyzer(ds, save_path=str(tmp_path / "d"), num_workers=2,
                                          worker_id=w).run_map()
    values, order = tanalyzer.DistributedDataAnalyzer(ds, save_path=str(tmp_path / "d"),
                                                      num_workers=2).run_reduce()
    want = janalyzer.DataAnalyzer.load(str(tmp_path / "d"), "seqlen")
    np.testing.assert_array_equal(values, want[0])
    np.testing.assert_array_equal(order, want[1])


def test_ltd_gather_and_scatter_equal_jax_at_given_indices():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    sub = rng.standard_normal((3, 6, 4)).astype(np.float32)
    idx = np.sort(np.stack([rng.permutation(10)[:6] for _ in range(3)]), axis=-1)
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    np.testing.assert_array_equal(tltd.take_tokens(tx, ti).numpy(),
                                  np.asarray(jnp.take_along_axis(x, idx[..., None], axis=1)))
    np.testing.assert_array_equal(
        tltd.random_ltd_scatter(tx, torch.from_numpy(sub), ti).numpy(),
        np.asarray(jltd.random_ltd_scatter(jnp.asarray(x), jnp.asarray(sub), jnp.asarray(idx))))
    picked, drawn = tltd.random_ltd_gather(tx, 4, torch.Generator().manual_seed(0))
    assert picked.shape == (3, 4, 4) and drawn.shape == (3, 4)
    assert bool((drawn[:, 1:] > drawn[:, :-1]).all()) and int(drawn.max()) < 10
    # every token is drawn equally often: 4 of 10 per row
    counts = torch.zeros(10)
    gen = torch.Generator().manual_seed(1)
    for _ in range(500):
        counts += torch.bincount(tltd.sample_token_indices(gen, 1, 10, 4)[0], minlength=10)
    sigma = (500 * 0.4 * 0.6) ** 0.5
    assert bool(((counts - 200).abs() < 4 * sigma).all()), counts


def test_random_ltd_forward_matches_jax_with_injected_indices(monkeypatch):
    """The middle block runs on the given token subset at its own positions
    and is scattered back: with the same indices in both packages, the same
    loss."""
    cfg = dict(hidden_size=64, num_layers=3, num_heads=4, vocab_size=256, max_seq_len=64)
    jmodel = JaxGPTNeoX(JaxConfig(**cfg))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    model = GPTNeoX(GPTNeoXConfig(**cfg), device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 21))
    batch = {"input_ids": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    idx = np.sort(np.stack([rng.permutation(20)[:12] for _ in range(2)]), axis=-1)
    monkeypatch.setattr(jltd, "sample_token_indices", lambda *a: jnp.asarray(idx))
    monkeypatch.setattr(tltd, "sample_token_indices",
                        lambda *a, **k: torch.from_numpy(idx))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jax.jit(lambda p, key: jmodel.loss_fn()(p, jbatch, key, random_ltd_tokens=12))(
        params, jax.random.PRNGKey(3)))
    got = model.loss_fn()(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.Generator().manual_seed(3), random_ltd_tokens=12)
    full = float(model.loss_fn()(model, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(float(got) - want) <= LOSS_TOL * abs(want)
    assert abs(float(got) - full) > 1e-4          # the subset changed the middle block


def _engine_pair(extra, steps, seq=32):
    config = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
              "gradient_clipping": 1.0,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}, **extra}
    jeng = _jax_engine(JaxGPTNeoX(JaxConfig.tiny()), config)
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    teng = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"), config=config,
                           model_parameters=start, device="cpu")[0]
    rng = np.random.default_rng(5)
    for step in range(steps):
        toks = rng.integers(0, 256, (16, seq + 1))
        b = {"input_ids": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32),
             "loss_mask": np.ones((16, seq), np.float32)}
        lj = float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in b.items()}))
        lt = float(teng.train_batch(batch=b))
        assert abs(lt - lj) <= LOSS_TOL * abs(lj), (extra, step, lj, lt)
    return jeng, teng


def test_engine_data_efficiency_matches_jax():
    """Curriculum seqlen (each step's batch cut to 16, then 24, then 32
    tokens), PLD at theta 1 (every block kept: its draws change nothing)
    and random-LTD at a budget of at least the whole sequence (no token
    dropped): the trajectory equals the JAX engine's, and the three
    schedulers step alike."""
    extra = {"curriculum_learning": {"enabled": True, "params": {
                 "curriculum_type": "seqlen", "min_difficulty": 16, "max_difficulty": 32,
                 "schedule_type": "fixed_linear",
                 "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 8}}},
             "progressive_layer_drop": {"enabled": True, "theta": 1.0, "gamma": 0.01},
             "data_efficiency": {"enabled": True, "data_routing": {"random_ltd": {
                 "enabled": True, "random_ltd_schedule": {
                     "min_value": 32, "max_value": 64,
                     "schedule_config": {"require_steps": 4, "seq_per_step": 8}}}}}}
    jeng, teng = _engine_pair(extra, 4)
    assert teng.curriculum_scheduler.get_current_difficulty() == \
        jeng.curriculum_scheduler.get_current_difficulty() == 32
    assert teng.progressive_layer_drop.get_state() == jeng.progressive_layer_drop.get_state()
    assert teng.random_ltd_scheduler.current_tokens == \
        jeng.random_ltd_scheduler.current_tokens == 64


def test_layer_drop_keeps_blocks_at_the_scheduled_rate():
    """Block i > 0 survives with probability 1 - (i+1)/L (1 - theta): at
    theta 0 and L 2 block 1 never survives, so the output is block 0's."""
    model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 12)))
    with torch.no_grad():
        dropped = model(ids, rng=torch.Generator().manual_seed(0), pld_theta=0.0,
                        return_hidden=True)
        x = model.embed_in(ids)
        pos = torch.arange(12).expand(2, 12)
        want = model.final_layer_norm(model.layers[0](x, pos))
        kept = model(ids, rng=torch.Generator().manual_seed(0), pld_theta=1.0,
                     return_hidden=True)
    torch.testing.assert_close(dropped, want, rtol=0, atol=0)
    torch.testing.assert_close(kept, model(ids, return_hidden=True), rtol=0, atol=0)
