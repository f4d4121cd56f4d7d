"""The sequence-parallel functions of the PyTorch port (``sequence/``)
against dense attention and the JAX package's ``sequence/`` (the
reference's tests' patterns, ``tests/unit/sequence/test_sequence_parallel.py``).

Two ``gloo`` processes (``torch_dp_worker.py``'s ``seq`` job, the mesh
``sp`` = 2) each take their slice of the sequence of the same global
arrays, made from a seed with numpy; the JAX side runs its functions in a
``shard_map`` over ``MeshTopology(sp=2, devices=jax.devices()[:2])``, or
its models on the whole sequence (the function GSPMD computes at any
``sp``):

* the all-to-all and its inverse, :class:`DistributedAttention` and
  ``ulysses_attention`` around dense attention, ring attention (causal and
  full) forward and its gradients, and the default mode's exchange (the
  local queries over the gathered keys and values, whose backward reduces
  the keys' and values' gradients back to their slices), and its form with
  the queries behind zero rows up to the keys' length;
* the single-block ring in one process;
* GPT-NeoX ``tiny()`` under each ``seq_parallel_mode`` and Llama
  ``tiny()`` / Mistral ``tiny_mistral()`` (the window measured from global
  positions) at sp 2: the mean of the ranks' losses and of their
  parameter gradients against the JAX model's loss and gradients;
* the JAX refusals: ring with attention dropout, an ``attention_mask``
  under ``ulysses`` or ``ring``, an unknown mode;
* the mesh's groups with ``sp`` against the JAX mesh's rows of devices at
  dp 2 x sp 2, sp 2 x tp 2, ep 2 x sp 2 and pp 2 x sp 2.

Tolerances (the reference tests'): 1e-5 for the attention functions, 1e-4
for the ring's gradients and the models' gradients, 2e-5 for the models'
losses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeperspeed_tpu import sequence as jseq
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.models.llama import Llama as JaxLlama
from deeperspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deeperspeed_tpu.ops.attention.core import _reference_attention as jax_dense
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch import sequence
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.models import llama as tllama
from torch_dp_worker import start
import torch_threads  # noqa: F401  (torch at one intra-op thread)

B, S, N, D = 2, 32, 4, 8
SP = 2
MODELS = [{"name": "neox-none", "family": "neox", "model": {}},
          {"name": "neox-ulysses", "family": "neox", "model": {"seq_parallel_mode": "ulysses"}},
          {"name": "neox-ring", "family": "neox", "model": {"seq_parallel_mode": "ring"}},
          {"name": "llama", "family": "llama", "preset": "tiny"},
          {"name": "mistral", "family": "llama", "preset": "tiny_mistral"}]


def _arrays():
    rng = np.random.default_rng(24)
    out = {n: rng.standard_normal((B, S, N, D)).astype(np.float32)
           for n in ("x", "q", "k", "v", "w")}
    toks = rng.integers(0, 256, (B, S + 1))
    out["ids"], out["labels"] = toks[:, :-1], toks[:, 1:]
    return out


def _jax_models():
    """Each model's JAX init, its loss and its gradients on the whole batch
    (``params_from_jax`` names)."""
    out = {}
    ids = jnp.zeros((1, S), jnp.int32)
    for case in MODELS:
        if case["family"] == "neox":
            model = JaxGPTNeoX(JaxConfig.tiny(**case["model"]))
            to_port = params_from_jax
        else:
            model = JaxLlama(getattr(JaxLlamaConfig, case["preset"])())
            to_port = tllama.params_from_jax
        params = model.init(jax.random.PRNGKey(5), ids)["params"]
        out[case["name"]] = (model, params, to_port)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    arrays = _arrays()
    models = _jax_models()
    for case in MODELS:
        _, params, to_port = models[case["name"]]
        arrays.update({f"{case['name']}/w/{k}": v.numpy()
                       for k, v in to_port(jax.device_get(params)).items()})
    finish = start({"kind": "seq", "models": MODELS}, arrays,
                   tmp_path_factory.mktemp("sequence"), world=SP)
    # the JAX losses and gradients while the workers run
    batch = {"input_ids": jnp.asarray(arrays["ids"]), "labels": jnp.asarray(arrays["labels"])}
    want = {name: jax.jit(jax.value_and_grad(model.loss_fn()))(params, batch)
            for name, (model, params, _) in models.items()}
    return arrays, models, want, finish()


def _joined(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _sp_mesh():
    return jtopo.MeshTopology(sp=SP, devices=jax.devices()[:SP])


def _shard_map(fn, mesh, n_in, out_specs):
    spec = P(None, "sp", None, None)
    return jax.jit(jax.shard_map(fn, mesh=mesh.mesh, in_specs=(spec,) * n_in,
                                 out_specs=out_specs, axis_names={"sp"}, check_vma=False))


def test_all_to_all_and_its_inverse_match_jax(both):
    arrays, _, _, ranks = both
    mesh = _sp_mesh()

    def body(x):
        y = jseq.single_all_to_all(x, 2, 1)
        return y, jseq.single_all_to_all(y, 1, 2)

    y, z = _shard_map(body, mesh, 1, (P(None, None, "sp", None), P(None, "sp", None, None)))(
        jnp.asarray(arrays["x"]))
    got_y = np.concatenate([r["a2a/y"] for r in ranks], axis=2)
    np.testing.assert_array_equal(got_y, np.asarray(y))
    np.testing.assert_array_equal(_joined(ranks, "a2a/z"), arrays["x"])
    np.testing.assert_array_equal(_joined(ranks, "a2a/z"), np.asarray(z))


@pytest.mark.parametrize("key", ["dist/out", "uly/out"])
def test_ulysses_matches_dense_and_jax(both, key):
    arrays, _, _, ranks = both
    q, k, v = (jnp.asarray(arrays[n]) for n in "qkv")
    dense = np.asarray(jax_dense(q, k, v, causal=True))
    attn = jseq.DistributedAttention(functools.partial(jax_dense, causal=True))
    want = np.asarray(_shard_map(attn, _sp_mesh(), 3, P(None, "sp", None, None))(q, k, v))
    got = _joined(ranks, key)
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_ring_grads(arrays, causal):
    q, k, v, w = (jnp.asarray(arrays[n]) for n in "qkvw")
    mesh = _sp_mesh()
    saved = jtopo._GLOBAL_MESH
    jtopo.set_mesh(mesh)
    try:
        def loss_ring(q, k, v):
            return jnp.sum(jseq.ring_attention_sharded(q, k, v, causal=causal) * w)

        out = jax.jit(functools.partial(jseq.ring_attention_sharded, causal=causal))(q, k, v)
        grads = jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(q, k, v)
    finally:
        jtopo.set_mesh(saved)

    def loss_dense(q, k, v):
        return jnp.sum(jax_dense(q, k, v, causal=causal) * w)

    dense = jax_dense(q, k, v, causal=causal)
    dgrads = jax.jit(jax.grad(loss_dense, argnums=(0, 1, 2)))(q, k, v)
    return out, grads, dense, dgrads


@pytest.mark.parametrize("causal", [True, False])
def test_ring_forward_and_grads_match_dense_and_jax(both, causal):
    arrays, _, _, ranks = both
    out, grads, dense, dgrads = _jax_ring_grads(arrays, causal)
    got = _joined(ranks, f"ring/{causal}/out")
    np.testing.assert_allclose(got, np.asarray(dense), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(out), rtol=1e-5, atol=1e-5)
    for n, g, dg in zip(("dq", "dk", "dv"), grads, dgrads):
        mine = _joined(ranks, f"ring/{causal}/{n}")
        np.testing.assert_allclose(mine, np.asarray(dg), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mine, np.asarray(g), rtol=1e-4, atol=1e-4)


def test_gathered_keys_give_dense_attention_and_its_grads(both):
    """The default mode's exchange: each rank's queries over the keys and
    values gathered up to its slice's end give dense causal attention, and
    the keys' and values' gradients come back to their slices."""
    arrays, _, _, ranks = both
    q, k, v = (torch.from_numpy(arrays[n]) for n in "qkv")
    kv = [t.clone().requires_grad_(True) for t in (k, v)]
    from deeperspeed_tpu_torch.ops.attention.core import _reference_attention

    dense = _reference_attention(q, *kv, causal=True)
    (dense * torch.from_numpy(arrays["w"])).sum().backward()
    assert [int(r["gathered/start"]) for r in ranks] == [0, S // SP]
    np.testing.assert_allclose(_joined(ranks, "gathered/out"), dense.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for n, t in zip(("dk", "dv"), kv):
        np.testing.assert_allclose(_joined(ranks, f"gathered/{n}"), t.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_padded_queries_give_dense_attention_and_its_grads(both):
    """The default mode's unmasked attention on the card's path: each
    rank's queries behind zero rows up to its slice's end (equal shapes, as
    the flash kernels take them) give dense causal attention; the queries'
    gradients are theirs alone, and the zero rows give the keys and values
    none."""
    arrays, _, _, ranks = both
    qkv = [torch.from_numpy(arrays[n]).requires_grad_(True) for n in "qkv"]
    from deeperspeed_tpu_torch.ops.attention.core import _reference_attention

    dense = _reference_attention(*qkv, causal=True)
    (dense * torch.from_numpy(arrays["w"])).sum().backward()
    assert [r["padded/out"].shape[1] for r in ranks] == [S // SP] * SP
    np.testing.assert_allclose(_joined(ranks, "padded/out"), dense.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for n, t in zip(("dq", "dk", "dv"), qkv):
        np.testing.assert_allclose(_joined(ranks, f"padded/{n}"), t.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_single_block_matches_jax_and_dense(causal):
    """p == 1 (no group): one block through the same online softmax, its
    backward the ring's, against the JAX ``ring_attention(axis_size=1)``."""
    arrays = _arrays()
    q, k, v, w = (arrays[n][:, :16] for n in "qkvw")
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = sequence.ring_attention(tq, tk, tv, None, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jseq.ring_attention(q, k, v, axis_size=1, causal=causal) * w)

    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want = jseq.ring_attention(jq, jk, jv, axis_size=1, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_dense(jq, jk, jv, causal=causal)),
                               rtol=1e-5, atol=1e-5)
    for t, g in zip((tq, tk, tv), jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", [c["name"] for c in MODELS])
def test_model_loss_and_grads_at_sp2_match_jax(both, name):
    _, models, want, ranks = both
    to_port = models[name][2]
    loss, grads = want[name]
    got = np.mean([float(r[f"{name}/loss"]) for r in ranks])
    np.testing.assert_allclose(got, float(loss), rtol=2e-5, atol=2e-5)
    for k, g in to_port(jax.device_get(grads)).items():
        mine = np.mean([r[f"{name}/grad/{k}"] for r in ranks], axis=0)
        g = g.numpy()
        np.testing.assert_allclose(mine, g, rtol=1e-4, atol=1e-4 * max(np.abs(g).max(), 1e-3),
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("sizes", [{"dp": 2, "sp": 2}, {"sp": 2, "tp": 2},
                                   {"ep": 2, "sp": 2}, {"pp": 2, "sp": 2}])
def test_mesh_groups_with_sp_match_the_jax_mesh(sizes, monkeypatch):
    """Rank ``r`` is JAX device ``r`` with ``sp`` just outside ``tp``: each
    group (sp, the ZeRO group over dp x zshard x ep x sp, the batch group
    without sp, tp, ep, pp) is the JAX mesh's row of devices along its
    axes."""
    from deeperspeed_tpu.parallel.topology import MeshTopology as JaxMesh
    from deeperspeed_tpu_torch.comm.comm import _GROUP_AXES
    from deeperspeed_tpu_torch.parallel import topology as ttopo

    world = int(np.prod(list(sizes.values())))
    monkeypatch.setattr(ttopo, "_world_size", lambda: world)
    mine = ttopo.MeshTopology(**sizes)
    grid = np.vectorize(lambda d: d.id)(JaxMesh(**sizes, devices=jax.devices()[:world])
                                        .mesh.devices)
    axes = list(ttopo.ALL_AXES)
    assert ttopo.ZERO_AXES == ("dp", "zshard", "ep", "sp")
    for name in ("sp", "dp", "batch", "tp", "ep", "pp", "expert_dp"):
        along = [axes.index(a) for a in _GROUP_AXES[name]]
        rows = np.moveaxis(grid, along, list(range(-len(along), 0)))
        want = sorted(sorted(r.reshape(-1).tolist())
                      for r in rows.reshape(-1, int(np.prod([grid.shape[i] for i in along]))))
        assert sorted(mine.groups(_GROUP_AXES[name])) == want, name
    assert mine.data_parallel_size == JaxMesh(
        **sizes, devices=jax.devices()[:world]).data_parallel_size


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_config_reads_the_sp_keys_as_the_jax_config_does(dtype):
    """``mesh.sequence_parallel_size`` and
    ``seq_parallel_communication_data_type`` (accepted; the JAX config
    records it and nothing there reads it), at a data-parallel world of 4 =
    dp 2 x sp 2; the micro batch over it; ``comm.quantized.intra_axis: sp``
    refused in the reference's words."""
    from deeperspeed_tpu.runtime.config import DeeperSpeedConfig as JaxDSConfig
    from deeperspeed_tpu_torch.runtime.config import DeeperSpeedConfig

    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
           "mesh": {"sequence_parallel_size": 2}}
    if dtype is not None:
        cfg["seq_parallel_communication_data_type"] = dtype
    mine, theirs = DeeperSpeedConfig(cfg, world_size=4), JaxDSConfig(cfg, world_size=4)
    assert mine.mesh_config.sequence_parallel_size == \
        theirs.mesh_config.sequence_parallel_size == 2
    assert theirs.seq_parallel_communication_data_type == (dtype or "fp32")
    assert not hasattr(mine, "seq_parallel_communication_data_type")
    assert mine.train_micro_batch_size_per_gpu == theirs.train_micro_batch_size_per_gpu == 1
    with pytest.raises(NotImplementedError, match="the reference does not run it .*dim 0"):
        DeeperSpeedConfig({**cfg, "comm": {"quantized": {"enabled": True,
                                                         "intra_axis": "sp"}}}, world_size=4)


def test_the_jax_refusals_stay():
    """Ring with attention dropout, an attention_mask under ulysses or
    ring, and an unknown mode, in the JAX package's words."""
    ids = torch.zeros((1, 8), dtype=torch.int64)
    ring = GPTNeoX(GPTNeoXConfig.tiny(seq_parallel_mode="ring", attention_dropout=0.1),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="ring attention does not support "
                                                  "attention_dropout"):
        ring.loss_fn()(ring, {"input_ids": ids, "labels": ids},
                       rng=torch.Generator().manual_seed(0))
    for mode in ("ulysses", "ring"):
        m = GPTNeoX(GPTNeoXConfig.tiny(seq_parallel_mode=mode), device="cpu")
        with pytest.raises(NotImplementedError, match="attention_mask .padded batches. is "
                                                      "not supported"):
            m(ids, attention_mask=torch.ones_like(ids))
    with pytest.raises(ValueError, match="unknown seq_parallel_mode"):
        GPTNeoXConfig.tiny(seq_parallel_mode="blockwise")
