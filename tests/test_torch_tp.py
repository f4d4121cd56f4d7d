"""Tensor-parallel training of the PyTorch port against the JAX engine on
the CPU: tp 2 (world 2) and tp 2 x dp 2 (world 4), fp32 GPT-NeoX
``tiny()``, Adam, clip 1.0, gas 2, 3 steps.

The JAX engine runs ``MeshTopology(tp=2)`` and ``MeshTopology(dp=2, tp=2)``
on the first 2 and 4 devices of the CPU mesh (GSPMD over the Megatron
rules of ``param_partition_rules``); the port runs 2 and 4 ``gloo``
processes (``torch_dp_worker.py``), rank ``r = i_dp * 2 + i_tp``, each
engine making the whole model it is given tensor-parallel in place.  At
world 2 the same model object first trains at tp 1 (dp 2) and then goes
to ``initialize`` at tp 2, as the JAX test passes one model to both
engines.  The JAX stages differ only in where XLA places the state, so
stage 2 is held against the JAX run at stage 0 (stage 3 against stage 3).

Tolerances: losses and grad norms within 2e-4 relative (the JAX test
``test_gpt_neox_tp_parity``'s); the whole masters, gathered from the
ranks' partitions and tp slices after the last step, within 1e-5 of their
change (``torch_layout_common.masters_agree``).
"""

import numpy as np
import pytest

from torch_dp_worker import start as start_workers
from torch_layout_common import (STEPS, arrays_for, batches, by_run, config, jax_run,
                                 masters_agree)
import torch_threads  # noqa: F401  (torch at one intra-op thread)

TOL = 2e-4
CHUNK = {"ce_chunk_tokens": 24}


def _tp(cfg):
    return {**cfg, "mesh": {"model_parallel_size": 2}}


# world -> {run: (config, port mesh, model fields)}
PORT = {
    2: {"tp1": (config(0), None, {}),
        "s0": (_tp(config(0)), {"tp": 2}, {}),
        "s2": (_tp(config(2)), {"tp": 2}, {}),
        "s3": (_tp(config(3)), {"tp": 2}, {})},
    4: {"s0": (_tp(config(0)), {"tp": 2}, {}),
        "s2": ({**_tp(config(2)), "comms_logger": {"enabled": True}}, {"tp": 2}, {}),
        "s3": (_tp(config(3)), {"tp": 2}, {}),
        "chunk": (_tp(config(2)), {"tp": 2}, CHUNK)},
}
# (world, run) -> (JAX config, JAX mesh, model fields) it is held against
JAX = {
    (2, "s0"): (_tp(config(0)), {"tp": 2}, {}),
    (4, "s0"): (_tp(config(0)), {"dp": 2, "tp": 2}, {}),
    (4, "s3"): (_tp(config(3)), {"dp": 2, "tp": 2}, {}),
    (4, "chunk"): (_tp(config(2)), {"dp": 2, "tp": 2}, CHUNK),
}
HELD = {(2, "s2"): (2, "s0"), (2, "s3"): (2, "s0"), (4, "s2"): (4, "s0")}
CASES = [(w, r) for w in PORT for r in PORT[w] if r != "tp1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch_list = batches()
    jax_out, start, waits = {}, None, {}

    def spawned(world):
        table = PORT[world]
        spec = {"kind": "train", "n_batches": STEPS, "runs": [
            {"name": name, "config": cfg, "dtype": "fp32", "steps": STEPS, "mesh": mesh,
             "model": kw, "reuse_model": world == 2 and name == "s0"}
            for name, (cfg, mesh, kw) in table.items()]}
        return start_workers(spec, arrays_for(start, batch_list),
                             tmp_path_factory.mktemp(f"tp{world}"), world=world)

    first = next(iter(PORT))
    for key, (cfg, mesh, kw) in JAX.items():
        *res, init = jax_run(cfg, mesh, batch_list, kw)
        if start is None:
            # the first world's workers run while the other JAX engines train
            start = init
            waits[first] = spawned(first)
        jax_out[key] = res
    port = {}
    for world, table in PORT.items():
        ranks = (waits.pop(world) if world in waits else spawned(world))()
        port[world] = by_run(ranks, table)
    return {"jax": jax_out, "port": port, "start": start}


@pytest.mark.parametrize("world,name", CASES, ids=[f"world{w}-{r}" for w, r in CASES])
def test_tensor_parallel_matches_jax(runs, world, name):
    """Losses and grad norms within 2e-4 of the JAX engine's at the same
    mesh; every rank reports the same; the gathered masters agree."""
    jl, jn, jfinal = runs["jax"][HELD.get((world, name), (world, name))]
    got = runs["port"][world][name]
    for r in got[1:]:
        np.testing.assert_array_equal(r["losses"], got[0]["losses"])
    np.testing.assert_allclose(got[0]["losses"], jl, rtol=TOL)
    np.testing.assert_allclose(got[0]["grad_norms"], jn, rtol=TOL)
    masters_agree(jfinal, got[0], runs["start"])


@pytest.mark.parametrize("world", [2, 4])
def test_a_gather_by_name_joins_the_tp_slices(runs, world):
    """``gather_whole(names=...)`` gives the named parameters whole, tp
    slices joined, as the whole gather does, on every rank and stage."""
    for name, ranks in runs["port"][world].items():
        for r in ranks:
            assert bool(r["named_gather_whole"]), (world, name)


def test_same_model_at_tp1_and_tp2(runs):
    """One model object trains at tp 1 and then at tp 2 (world 2): the same
    losses within the JAX test's 2e-4."""
    tp1, tp2 = runs["port"][2]["tp1"][0], runs["port"][2]["s0"][0]
    np.testing.assert_allclose(tp2["losses"], tp1["losses"], rtol=TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_holds_its_share(runs, world):
    """Each rank holds its tp slice (half of every split matrix, the
    LayerNorms and row-parallel biases whole); at stage 2 a further
    1/dp of it as masters and moments."""
    total = sum(v.numel() for v in runs["start"].values())
    whole = sum(v.numel() for k, v in runs["start"].items()
                if "layernorm" in k or "layer_norm" in k
                or k.endswith(("attention.dense.bias", "4h_to_h.bias")))
    ranks = runs["port"][world]
    for r in ranks["s0"]:
        assert int(r["tp_numel"]) == (total - whole) // 2 + whole
        assert int(r["master_numel"]) == int(r["tp_numel"])
    dp = world // 2
    for r in ranks["s2"]:
        assert abs(int(r["master_numel"]) - int(r["tp_numel"]) / dp) <= dp
        assert int(r["opt_numel"]) == 2 * int(r["master_numel"])


def test_tensor_parallel_collectives_are_logged_apart(runs):
    """Every tp collective is logged under its own op name, ``tp_reduce``
    (two ranks), beside the gradient reduction's ``grad_reduce`` over the
    ZeRO group (two ranks of each tp slice)."""
    import json

    sizes = json.loads(str(runs["port"][4]["s2"][0]["group_sizes"]))
    assert sizes["tp_reduce"] == [2] and sizes["grad_reduce"] == [2]


class _Rank:
    """A tp group of two as ``shard_module`` reads it (no collective runs
    while it slices)."""

    def __init__(self, rank):
        self._rank = rank

    def size(self):
        return 2

    def rank(self):
        return self._rank


def test_params_carry_across_with_tp_slices():
    """``params_from_jax(tree, tp_rank, 2)`` gives what the engine's
    in-place sharding leaves each rank (``shard_module`` by the model's
    rules), and ``params_to_jax`` of the two ranks' dicts is the tree."""
    import torch

    from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
    from deeperspeed_tpu_torch.models.gpt_neox import params_to_jax
    from deeperspeed_tpu_torch.parallel.tensor_parallel import shard_module

    tree = params_to_jax({n: p.detach().clone() for n, p in
                          GPTNeoX(GPTNeoXConfig.tiny(), device="cpu").named_parameters()})
    slices = []
    for rank in range(2):
        model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu")
        dims = shard_module(model, model.param_partition_rules(), _Rank(rank))
        want = params_from_jax(tree, tp_rank=rank, tp_size=2)
        got = {n: p.detach() for n, p in model.named_parameters()}
        assert got.keys() == want.keys() and len(dims) == 4 * 2 + 2 + 2 * 2
        for n in want:
            assert torch.equal(got[n], want[n]), n
        slices.append(want)
    joined = params_to_jax(slices)
    flat = {}

    def walk(node, name, out):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{name}/{k}", out)
            else:
                out[f"{name}/{k}"] = np.asarray(v)

    walk(joined, "", flat)
    want_flat = {}
    walk(tree, "", want_flat)
    assert flat.keys() == want_flat.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], want_flat[k])
