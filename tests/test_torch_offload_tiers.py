"""The optimizer state's pinned-host and NVMe tiers
(``offload_optimizer.device: "cpu"`` / ``"nvme"``) on the CPU, at ZeRO
stages 0-3, in one process and in two (``torch_dp_worker.py``): each run
held against the same run without offload, within the JAX package's bound
(``test_zero_extensions.py``: ``rtol=1e-5, atol=1e-6``).  The tiers move
where the state lives, not what is computed, so the port's runs agree bit
for bit.  On the CPU the "device" copies are CPU tensors of their own, so
the copies in and out still run.
"""

import os

import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.utils.tree import tree_leaves
from torch_dp_worker import spawn
import torch_threads  # noqa: F401  (torch at one intra-op thread)

STEPS = 3
ROWS, SEQ = 8, 16
BASE = {"train_batch_size": ROWS, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


def _batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1))
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _config(stage, tier=None, path=None, **off):
    zero = {"stage": stage, "param_persistence_threshold": 1000}
    if tier is not None:
        zero["offload_optimizer"] = {"device": tier, **off}
        if tier == "nvme":
            zero["offload_optimizer"]["nvme_path"] = str(path)
    return {**BASE, "zero_optimization": zero}


def _engine(config, optimizer=None):
    cfg = config if optimizer is None else {**config, "optimizer": optimizer}
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=2),
                              config=cfg, device="cpu")
    return eng


def _losses(eng):
    return [float(eng.train_batch(batch=b)) for b in _batches()]


@pytest.fixture(scope="module")
def baselines():
    """Each stage's losses without offload."""
    return {s: _losses(_engine(_config(s))) for s in range(4)}


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_tier_matches_the_run_without_offload(stage, tier, baselines, tmp_path):
    eng = _engine(_config(stage, tier, tmp_path))
    losses = _losses(eng)
    np.testing.assert_allclose(losses, baselines[stage], rtol=1e-5, atol=1e-6)
    assert losses == baselines[stage]
    # the masters and the optimizer state live on the host, in one pinned
    # (here plain) buffer each
    assert eng._master_flat.device.type == "cpu"
    state = [t for t in tree_leaves(eng.opt_state) if isinstance(t, torch.Tensor)]
    assert {t.untyped_storage().data_ptr() for t in state} == {
        eng._opt_home.untyped_storage().data_ptr()}
    stats = eng.offload_stats
    assert stats["h2d_bytes"] == stats["d2h_bytes"] == 4 * (
        eng._master_flat.numel() + eng._opt_home.numel())
    if tier == "nvme":
        eng.destroy()


def test_nvme_swap_directory_eval_and_destroy(baselines, tmp_path):
    """``pipeline_write: false``: the state is on disk between steps (its
    host memory freed) and read back while the next step's gradients are
    computed; ``eval_batch`` does not touch it; ``destroy()`` removes the
    swapper's own directory."""
    eng = _engine(_config(2, "nvme", tmp_path, pipeline_write=False))
    root = tmp_path / "zero_opt_swap"
    batches = _batches()
    losses = [float(eng.train_batch(batch=batches[0]))]
    swap = eng._opt_swapper
    assert os.listdir(root) == [os.path.basename(swap.dir)]
    # the state in one piece a thread of the pool (buffer_count, 4)
    files = sorted(os.listdir(swap.dir))
    assert files == [f"opt_piece_{i}.bin" for i in range(4)]
    assert sum(os.path.getsize(os.path.join(swap.dir, f)) for f in files) == \
        4 * eng._opt_home.numel()
    assert swap.swapped_out and eng._opt_home.untyped_storage().nbytes() == 0
    ev = float(eng.eval_batch(batch=batches[0]))
    assert swap.swapped_out and np.isfinite(ev)
    losses += [float(eng.train_batch(batch=b)) for b in batches[1:]]
    assert losses == baselines[2]
    assert swap.stats["bytes_read"] == 2 * 4 * eng._opt_home.numel()
    eng.destroy()
    assert not os.path.isdir(swap.dir) and os.listdir(root) == []


def test_nvme_pipelined_write_waits_at_the_next_swap_in(baselines, tmp_path):
    """``pipeline_write`` (the default): the swap-out returns with its
    writes in flight, the next step's swap-in waits for them and reads
    nothing back; a save swaps the state in first."""
    eng = _engine(_config(1, "nvme", tmp_path))
    waits = []
    swap = eng._opt_swapper
    real_wait = swap._wait
    swap._wait = lambda what: (waits.append((what, swap._write_pending)), real_wait(what))[1]
    batches = _batches()
    losses = [float(eng.train_batch(batch=batches[0]))]
    assert waits == [] and swap._write_pending
    losses.append(float(eng.train_batch(batch=batches[1])))
    assert waits == [("write", True)]
    eng.save_checkpoint(str(tmp_path / "ck"))
    assert not swap.swapped_out
    losses.append(float(eng.train_batch(batch=batches[2])))
    assert losses == baselines[1] and swap.stats["bytes_read"] == 0
    eng.destroy()


def test_fused_adam_on_the_pinned_tier(tmp_path):
    """FusedAdam's flat moment buffers (B6's plain version on the CPU) stay
    one buffer on the host tier, and train as without it."""
    opt = {"type": "FusedAdam", "params": {"lr": 1e-3}}
    assert _losses(_engine(_config(2, "cpu"), opt)) == _losses(_engine(_config(2), opt))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Two processes: every stage without offload, on the pinned tier and
    on the NVMe tier."""
    tmp = tmp_path_factory.mktemp("offload_dp")
    runs = []
    for stage in range(4):
        for tier in (None, "cpu", "nvme"):
            cfg = _config(stage, tier, tmp / f"swap{stage}")
            runs.append({"name": f"s{stage}-{tier}", "config": cfg, "dtype": "fp32",
                         "steps": STEPS})
    model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu", seed=2)
    arrays = {f"w/{n}": p.detach().numpy() for n, p in model.named_parameters()}
    for i, b in enumerate(_batches()):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    return spawn({"kind": "train", "runs": runs, "n_batches": STEPS}, arrays, tmp)


@pytest.mark.parametrize("stage", range(4))
def test_world2_tiers_match_the_run_without_offload(world2, stage):
    r0, r1 = world2
    want = r0[f"s{stage}-None/losses"]
    for tier in ("cpu", "nvme"):
        got = r0[f"s{stage}-{tier}/losses"]
        np.testing.assert_array_equal(got, r1[f"s{stage}-{tier}/losses"])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        held = int(r0[f"s{stage}-{tier}/master_numel"])
        assert held == int(r0[f"s{stage}-None/master_numel"])
        assert int(r0[f"s{stage}-{tier}/opt_numel"]) == 2 * held
