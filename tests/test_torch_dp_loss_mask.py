"""Two repairs of the port's data-parallel training, on the CPU.

* The masked loss over ranks: with ``loss_mask`` rows that give the ranks
  unequal token counts, the port at world 2 (two ``gloo`` processes,
  ``torch_dp_worker.py``) must train the JAX engine's function at dp = 2,
  one masked mean over the global rows of each microbatch, not a mean of
  the ranks' means.  Held at ZeRO stages 0-3 through ``train_batch`` (and
  ``eval_batch`` after training), and at stage 0 through the legacy
  ``forward``/``backward``/``step``; and at world 1 with gas 2 in this
  process.  Tolerance: fp32 losses, first grad norm and eval loss within
  1e-5 relative (``test_torch_zero.py``'s: the two packages differ only in
  summation order).
* The rank's card: ``LOCAL_RANK`` picks ``cuda:{LOCAL_RANK}`` and
  ``init_distributed("nccl")`` makes it the current device; a faked card
  count stands in for a host with several GPUs.
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
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch import accelerator
from deeperspeed_tpu_torch.comm import comm as tcomm
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from torch_dp_worker import start as start_workers
import torch_threads  # noqa: F401  (torch at one intra-op thread)

STEPS = 3
ROWS, SEQ = 8, 16
TOL = 1e-5
BASE = {"train_batch_size": ROWS, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
# the share of live tokens in each row of a microbatch of 4 rows: rank 0
# holds the first two rows, rank 1 the last two
ROW_DENSITY = (0.9, 0.7, 0.25, 0.1)


def _config(stage):
    return {**BASE, "zero_optimization": {"stage": stage,
                                          "param_persistence_threshold": 1000}}


def _batches():
    rng = np.random.default_rng(21)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        density = np.tile(ROW_DENSITY, ROWS // len(ROW_DENSITY))[:, None]
        mask = (rng.random((ROWS, SEQ)) < density).astype(np.float32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask})
    return out


def _jax_run(stage, batches, dp):
    """(losses, grad norms, eval loss after training, initial masters)."""
    saved = jtopo._GLOBAL_MESH
    try:
        mesh = jtopo.MeshTopology(dp=dp, devices=jax.devices()[:dp])
        jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=_config(stage),
                                   mesh=mesh)
        start = params_from_jax(jax.device_get(jeng.state["master_params"]))
        losses, norms = [], []
        for b in batches:
            losses.append(float(jeng.train_batch(batch={k: jnp.asarray(v)
                                                        for k, v in b.items()})))
            norms.append(jeng.get_global_grad_norm())
        ev = float(jeng.eval_batch(batch={k: jnp.asarray(v) for k, v in batches[0].items()}))
    finally:
        jtopo.set_mesh(saved)
    return np.array(losses), np.array(norms), ev, start


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    batches = _batches()
    jax_runs = {0: _jax_run(0, batches, 2)}
    start = jax_runs[0][3]
    arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    runs = [{"name": f"stage{s}", "config": _config(s), "dtype": "fp32", "steps": STEPS,
             "eval": True} for s in range(4)]
    runs.append({"name": "legacy", "config": _config(0), "dtype": "fp32", "steps": STEPS,
                 "legacy": True})
    # the workers run while the other stages' JAX engines train
    wait = start_workers({"kind": "train", "n_batches": STEPS, "runs": runs}, arrays,
                         tmp_path_factory.mktemp("mask"))
    jax_runs.update({stage: _jax_run(stage, batches, 2) for stage in range(1, 4)})
    return batches, jax_runs, wait()


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))


def test_masks_give_the_ranks_unequal_counts(world2):
    """The batches make the fault show: the ranks' token counts differ in
    every microbatch, so the mean of the ranks' masked means differs from
    the global masked mean."""
    batches, _, _ = world2
    for b in batches:
        for mb in np.split(b["loss_mask"], 2):
            r0, r1 = mb[:2].sum(), mb[2:].sum()
            assert r0 > 2 * r1 > 0


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_masked_loss_is_the_global_mean(world2, stage):
    _, jax_runs, ranks = world2
    jl, jn, jev, _ = jax_runs[stage]
    r0, r1 = (r and {k[7:]: v for k, v in r.items() if k.startswith(f"stage{stage}/")}
              for r in ranks)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    assert np.all(_rel(r0["losses"], jl) <= TOL), (r0["losses"], jl)
    assert _rel(r0["grad_norms"][0], jn[0]) <= TOL, (r0["grad_norms"], jn)
    assert float(r0["eval"]) == float(r1["eval"])
    assert _rel(r0["eval"], jev) <= TOL, (float(r0["eval"]), jev)


def test_masked_loss_through_the_legacy_api(world2):
    """forward/backward/step: each rank's forward returns its weighted
    loss, whose mean over ranks is the global masked mean."""
    _, jax_runs, ranks = world2
    jl, jn, _, _ = jax_runs[0]
    r0, r1 = ({k[7:]: v for k, v in r.items() if k.startswith("legacy/")} for r in ranks)
    mean = (r0["losses"] + r1["losses"]) / 2
    assert np.all(_rel(mean, jl) <= TOL), (mean, jl)
    assert not np.allclose(r0["losses"], r1["losses"])
    assert _rel(r0["grad_norms"][0], jn[0]) <= TOL


def test_masked_loss_at_world_one_with_gas_two(world2):
    batches, _, _ = world2
    jl, jn, jev, start = _jax_run(0, batches, 1)
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config=_config(0), model_parameters=start, device="cpu")
    losses, norms = [], []
    for b in batches:
        losses.append(float(eng.train_batch(batch=b)))
        norms.append(eng.get_global_grad_norm())
    assert np.all(_rel(losses, jl) <= TOL), (losses, jl)
    assert _rel(norms[0], jn[0]) <= TOL
    assert _rel(float(eng.eval_batch(batch=batches[0])), jev) <= TOL


@pytest.fixture
def two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    return monkeypatch


def test_local_rank_picks_the_rank_card(two_cards):
    two_cards.delenv("LOCAL_RANK", raising=False)
    assert accelerator.resolve_device(None) == torch.device("cuda")
    two_cards.setenv("LOCAL_RANK", "1")
    assert accelerator.resolve_device(None) == torch.device("cuda", 1)
    assert accelerator.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert accelerator.resolve_device("cpu") == torch.device("cpu")


def test_local_rank_beyond_the_cards_raises(two_cards):
    two_cards.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match=r"LOCAL_RANK 3 .* 2 CUDA device"):
        accelerator.resolve_device(None)


@pytest.mark.parametrize("backend,local,want", [("nccl", "1", [1]), ("nccl", None, []),
                                                ("gloo", "1", [])])
def test_init_distributed_sets_the_rank_card(two_cards, backend, local, want):
    """On nccl, the LOCAL_RANK card becomes current before the group forms;
    gloo (processes sharing a card) and a run without LOCAL_RANK keep it."""
    set_to, joined = [], []
    if local is None:
        two_cards.delenv("LOCAL_RANK", raising=False)
    else:
        two_cards.setenv("LOCAL_RANK", local)
    two_cards.setattr(torch.cuda, "set_device", set_to.append)
    two_cards.setattr(tcomm.dist, "is_initialized", lambda: False)
    two_cards.setattr(tcomm.dist, "init_process_group",
                      lambda *a, **k: joined.append(set_to[:]))
    tcomm.init_distributed(backend, rank=1, world_size=2)
    assert set_to == want and joined == [want]
