"""The rest of multi-process training's layout in the PyTorch port, against
the JAX package on the CPU: ``TiledLinear``, the prefetching loader, and
the three paths the port refused over several processes until now --
progressive layer drop, LAMB at stages 1-3 and the chunked loss at stage
3 -- plus the engine's two-hop qgZ over an intra axis of one process.

* ``TiledLinear`` (in-process): forward and grads equal to the matrix its
  tiles assemble, and to the JAX package's flax ``TiledLinear`` with the
  same tiles, at (in_splits, out_splits) (1, 1), (2, 3) and (4, 2), within
  1e-6; under the engine at stage 3 each tile is its own unit, gathered
  alone.
* The prefetching loader (in-process, world 1): losses bit-identical with
  ``comm.overlap.prefetch_depth`` 2 and without, and a save / resume with
  the prefetcher running re-delivers the batches it had buffered.
* Two ``gloo`` processes (``torch_dp_worker.py``) against the JAX engine at
  dp 2 (2 CPU devices), fp32 GPT-NeoX ``tiny()``, 3 steps: PLD whose
  schedule drops block 1 on every step (the same in both packages) within
  1e-5; PLD with a fair coin for block 1, equal to the port at world 1
  within 1e-5 (every rank, and one process, draws the same coins); LAMB at
  stages 1-3 within 1e-5 of the JAX LAMB run (its trust ratios need whole
  parameters); the chunked loss at stage 3, losses and grad norms within
  1e-5; qgZ with ``intra_axis: zshard`` (one process) runs the two-hop
  schedule with a trivial hop, as the JAX engine does, its losses within
  1e-3 of the JAX engine's (``test_torch_zero.py``'s qgZ tolerance).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.runtime.zero.tiling import TiledLinear as JaxTiledLinear
from deeperspeed_tpu.telemetry import wire as jwire
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch.runtime.dataloader import DevicePrefetchingLoader
from deeperspeed_tpu_torch.runtime.zero import stage3
from deeperspeed_tpu_torch.runtime.zero.tiling import TiledLinear
from torch_dp_worker import start as start_workers
from torch_layout_common import (BASE, STEPS, arrays_for, batches, by_run, config,
                                 jax_run)
import torch_threads  # noqa: F401  (torch at one intra-op thread)


# ------------------------------------------------------------------ tiling
@pytest.mark.parametrize("splits", [(1, 1), (2, 3), (4, 2)])
def test_tiled_linear_matches_dense_and_jax(splits):
    n_in, n_out = splits
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    cot = rng.standard_normal((3, 12)).astype(np.float32)
    lin = TiledLinear(16, 12, n_in, n_out, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for b in lin.biases.values():
            b.copy_(torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32)))
    tree = {k: v.detach().numpy().copy() for k, v in lin.tile_tree().items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lin(xt)
    (y * torch.from_numpy(cot)).sum().backward()

    # the assembled dense matrix
    w = TiledLinear.assemble_full_kernel({k: torch.from_numpy(v) for k, v in tree.items()},
                                         n_in, n_out)
    bias = torch.cat([torch.from_numpy(tree[f"bias_{j}"]) for j in range(n_out)])
    xd = torch.from_numpy(x).requires_grad_(True)
    yd = xd @ w + bias
    (yd * torch.from_numpy(cot)).sum().backward()
    torch.testing.assert_close(y, yd, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xt.grad, xd.grad, rtol=1e-6, atol=1e-6)

    # the JAX package's module with the same tiles
    jmod = JaxTiledLinear(features=12, in_splits=n_in, out_splits=n_out)
    params = {"params": {k: jnp.asarray(v) for k, v in tree.items()}}

    def f(p, xx):
        return jnp.sum(jmod.apply(p, xx) * cot)

    jy = jmod.apply(params, jnp.asarray(x))
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-6, atol=1e-6)
    for name, t in lin.tile_tree().items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp["params"][name]),
                                   rtol=1e-6, atol=1e-6)


class _TiledModel(torch.nn.Module):
    """An embedding, a TiledLinear and the loss the engine trains."""

    def __init__(self):
        super().__init__()
        self.embed = torch.nn.Embedding(32, 16)
        self.proj = TiledLinear(16, 32, 2, 2, generator=torch.Generator().manual_seed(2))

    def forward(self, ids):
        return self.proj(self.embed(ids))

    def loss_fn(self):
        def loss(model, batch, rng=None):
            logits = model(batch["input_ids"])
            return torch.nn.functional.cross_entropy(logits.reshape(-1, 32),
                                                     batch["labels"].reshape(-1))
        return loss


def test_tiled_linear_gathers_one_tile_at_a_time_at_stage3(monkeypatch):
    """Stage 3: each tile is a unit of its own, gathered alone around its
    product (never two tiles' weights swapped in at once), and the losses
    are stage 0's."""
    live, peak = [0], [0]
    inner = stage3._swapped

    def counting(module, tensors):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            with inner(module, tensors):
                live[0] += 1
                peak[0] = max(peak[0], live[0])
                try:
                    yield
                finally:
                    live[0] -= 1
        return ctx()

    monkeypatch.setattr(stage3, "_swapped", counting)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 32, (8, 9))
    batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    losses = {}
    for stage in (0, 3):
        torch.manual_seed(0)
        model = _TiledModel()
        cfg = {**BASE, "zero_optimization": {"stage": stage,
                                             "param_persistence_threshold": 16}}
        eng, *_ = tdst.initialize(model=model, config=cfg, device="cpu")
        losses[stage] = [float(eng.train_batch(batch=batch)) for _ in range(2)]
        if stage == 3:
            units = [g.region.unit for _, _, _, g in eng._compute if g is not None]
            assert sorted(units) == ["embed"] + [f"proj.tiles.kernel_{i}_{j}"
                                                 for i in range(2) for j in range(2)]
    assert peak[0] == 1
    np.testing.assert_allclose(losses[3], losses[0], rtol=1e-6)


# ---------------------------------------------------------------- prefetch
def _loader_engine(depth, **extra):
    toks = np.random.default_rng(9).integers(0, 256, (64, 9))
    data = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    comm_cfg = ({"comm": {"overlap": {"enabled": True, "prefetch_depth": depth}}}
                if depth else {})
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config={**BASE, **comm_cfg, **extra}, training_data=data,
                              device="cpu")
    return eng


def test_prefetch_depth_keeps_losses_bit_identical():
    plain, ahead = _loader_engine(0), _loader_engine(2)
    got = [[float(e.train_batch()) for _ in range(4)] for e in (plain, ahead)]
    assert got[0] == got[1]
    assert isinstance(ahead._prefetcher, DevicePrefetchingLoader)
    assert plain._prefetcher is None
    # two steps of gas 2 buffered ahead of the 4 trained
    assert ahead.training_dataloader.state_dict()["batch_idx"] == 4 * 2 + 2 * 2
    assert ahead._prefetcher.position()["batch_idx"] == 4 * 2


def test_prefetch_resume_redelivers_the_buffered_batches(tmp_path):
    first = _loader_engine(2)
    for _ in range(2):
        first.train_batch()
    first.save_checkpoint(str(tmp_path))
    want = [float(first.train_batch()) for _ in range(2)]
    second = _loader_engine(2)
    second.load_checkpoint(str(tmp_path))
    assert [float(second.train_batch()) for _ in range(2)] == want


def test_prefetching_loader_positions():
    pulled = []

    def source():
        for i in range(10):
            pulled.append(i)
            yield {"x": np.full((2,), i)}

    it = source()
    pf = DevicePrefetchingLoader(it, "cpu", depth=2, position_fn=lambda: len(pulled),
                                 pulls_per_batch=2)
    first = next(pf)
    assert [int(mb["x"][0]) for mb in first] == [0, 1]
    assert pf.position() == 2 and len(pulled) == 6
    assert [[int(mb["x"][0]) for mb in step] for step in pf] == [[2, 3], [4, 5], [6, 7],
                                                                 [8, 9]]


# ---------------------------------------------------- two processes vs JAX
def _pld(theta):
    return {**BASE, "progressive_layer_drop": {"enabled": True, "theta": theta,
                                               "gamma": 100.0}}


def _lamb(stage):
    return {**config(stage), "optimizer": {"type": "Lamb", "params": {
        "lr": 1e-3, "weight_decay": 0.01}}}


QGZ_TRIVIAL = {**BASE, "comm": {"quantized": {"enabled": True, "intra_axis": "zshard"}}}
CHUNK = {"ce_chunk_tokens": 24}
PORT = {"pld-drop": (_pld(0.0), {}), "pld-coin": (_pld(0.5), {}),
        **{f"lamb-s{s}": (_lamb(s), {}) for s in (1, 2, 3)},
        "chunk-s3": (config(3), CHUNK), "qgz-trivial": (QGZ_TRIVIAL, {})}
JAX = {"pld-drop": (_pld(0.0), {}), "lamb-s1": (_lamb(1), {}),
       "chunk-s3": (config(3), CHUNK), "qgz-trivial": (QGZ_TRIVIAL, {})}
HELD = {"lamb-s2": "lamb-s1", "lamb-s3": "lamb-s1"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch_list = batches()
    jax_out, start, wait = {}, None, None
    spec = {"kind": "train", "n_batches": STEPS, "runs": [
        {"name": name, "config": cfg, "dtype": "fp32", "steps": STEPS, "model": kw}
        for name, (cfg, kw) in PORT.items()]}
    for name, (cfg, kw) in JAX.items():
        *res, init = jax_run(cfg, {"dp": 2}, batch_list, kw)
        if start is None:
            # the workers run while the other JAX engines train
            start = init
            wait = start_workers(spec, arrays_for(start, batch_list),
                                 tmp_path_factory.mktemp("misc"), world=2)
        jax_out[name] = res
    ranks = wait()
    one, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config=_pld(0.5), model_parameters=start, device="cpu")
    world1 = [float(one.train_batch(batch=b)) for b in batch_list]
    return {"jax": jax_out, "port": by_run(ranks, PORT), "world1": np.array(world1)}


@pytest.mark.parametrize("name", ["pld-drop", "lamb-s1", "lamb-s2", "lamb-s3", "chunk-s3"])
def test_multi_process_paths_match_jax(runs, name):
    jl, jn, _ = runs["jax"][HELD.get(name, name)]
    r0, r1 = runs["port"][name]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norms"], jn, rtol=1e-5)


def test_layer_drop_draws_agree_across_ranks(runs):
    """A fair coin for block 1 each step: two processes train as one does,
    so both ranks dropped the blocks the single process dropped."""
    r0, _ = runs["port"]["pld-coin"]
    np.testing.assert_allclose(r0["losses"], runs["world1"], rtol=1e-5)


def test_qgz_intra_axis_of_one_process_is_a_trivial_hop(runs):
    jl = runs["jax"]["qgz-trivial"][0]
    r0, r1 = runs["port"]["qgz-trivial"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    assert abs(r0["losses"][0] - jl[0]) <= 1e-5 * abs(jl[0])
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-3)
    rec = [f for f in json.loads(str(r0["footprints"]))[0] if f["op"] == "all_reduce"]
    assert rec and rec[0]["variant"] == jwire.quantized_variant(1, 2, "int8")
