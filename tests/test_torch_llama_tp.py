"""The Llama family at tensor-parallel 2 on the CPU: two ``gloo`` processes
of the PyTorch port (``torch_dp_worker.py``'s ``llama`` job, spawned once)
against the JAX package at ``MeshTopology(tp=2)`` on the same weights.

* Training: Llama ``tiny()`` (4 query heads on 2 KV heads: one KV head
  and its two query heads a rank), Adam, 3 steps, losses within 2e-4
  relative of the JAX engine's at tp 2 and at tp 1 (the JAX test
  ``test_tp_parity``).
* The v1 engine: ``generate`` at tp 2 gives the tokens of the port at tp 1
  and of the JAX engine at tp 2 (the JAX test
  ``test_tp_sharded_matches_single``), its gathered logits within 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeperspeed_tpu as jdst
from deeperspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deeperspeed_tpu.models.llama import Llama as JaxLlama
from deeperspeed_tpu.models.llama import LlamaConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.inference import InferenceEngine
from deeperspeed_tpu_torch.models import Llama, LlamaConfig
from deeperspeed_tpu_torch.models.llama import params_from_jax
from torch_dp_worker import spawn
import torch_threads  # noqa: F401  (torch at one intra-op thread)

TOL = 2e-4
LOGITS_TOL = 2e-5
STEPS, ROWS, SEQ, NEW = 3, 8, 16, 5
TRAIN = {"train_batch_size": ROWS, "gradient_clipping": 1.0,
         "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
TP2 = {"mesh": {"model_parallel_size": 2}}


def _jax_losses(mesh, batches):
    """The JAX engine's losses at ``mesh`` and its initial weights (drawn
    from the config's seed, so alike at every mesh)."""
    saved = jtopo._GLOBAL_MESH
    try:
        m = jtopo.MeshTopology(**mesh, devices=jax.devices()[:mesh.get("tp", 1)])
        cfg = {**TRAIN, **(TP2 if mesh.get("tp", 1) > 1 else {})}
        jeng, *_ = jdst.initialize(model=JaxLlama(JaxConfig.tiny()), config=cfg, mesh=m)
        start = params_from_jax(jax.device_get(jeng.state["master_params"]))
        losses = [float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in b.items()}))
                  for b in batches]
    finally:
        jtopo.set_mesh(saved)
    return np.array(losses), start


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests read; the JAX engines' global mesh is restored
    afterwards, as later tests in this process expect the default one."""
    saved = jtopo._GLOBAL_MESH
    try:
        return _runs(tmp_path_factory)
    finally:
        jtopo.set_mesh(saved)


def _runs(tmp_path_factory):
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int64)
        batches.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    j1, start = _jax_losses({"tp": 1}, batches)
    j2, start2 = _jax_losses({"tp": 2}, batches)
    # the v1 engine's weights: a JAX engine's own
    jinf = JaxEngine(model=JaxLlama(JaxConfig.tiny()), config={"dtype": "fp32"})
    gweights = params_from_jax(jax.device_get(jinf.params))
    prompts = rng.integers(1, 256, (2, 8)).astype(np.int64)
    mask = np.ones_like(prompts)
    mask[1, :3] = 0
    prompts = prompts * mask
    jinf2 = JaxEngine(model=JaxLlama(JaxConfig.tiny()),
                      config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
                      params=jax.tree_util.tree_map(np.asarray, jinf.params))
    jtoks = np.asarray(jinf2.generate(jnp.asarray(prompts), attention_mask=jnp.asarray(mask),
                                      max_new_tokens=NEW))
    arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
    arrays.update({f"g/{k}": v.numpy() for k, v in gweights.items()})
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    arrays.update(p=prompts, pm=mask)
    spec = {"kind": "llama", "train": {"config": {**TRAIN, **TP2}, "steps": STEPS},
            "generate": {"config": {"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
                         "new": NEW}}
    ranks = spawn(spec, arrays, tmp_path_factory.mktemp("llama_tp"), world=2)
    one = InferenceEngine(Llama(LlamaConfig.tiny(), device="cpu"), {"dtype": "fp32"},
                          params=gweights, device="cpu")
    return {"jax_tp1": j1, "jax_tp2": j2, "same_start": all(
                np.array_equal(start[k].numpy(), start2[k].numpy()) for k in start),
            "jax_tokens": jtoks, "ranks": ranks,
            "tp1_tokens": one.generate(prompts, attention_mask=mask,
                                       max_new_tokens=NEW).numpy(),
            "tp1_logits": one(prompts).numpy()}


def test_training_at_tp2_matches_jax(runs):
    """Both ranks report the same losses, within 2e-4 of the JAX engine's
    at tp 2 and at tp 1; each rank runs 2 of the 4 query heads."""
    assert runs["same_start"]
    r0, r1 = runs["ranks"]
    np.testing.assert_array_equal(r0["train/losses"], r1["train/losses"])
    np.testing.assert_allclose(r0["train/losses"], runs["jax_tp2"], rtol=TOL)
    np.testing.assert_allclose(r0["train/losses"], runs["jax_tp1"], rtol=TOL)
    assert int(r0["train/heads"]) == 2


def test_generate_at_tp2_matches_tp1_and_jax(runs):
    """Greedy tokens at tp 2 (left-padded prompts) equal tp 1's and the
    JAX engine's at tp 2 on every rank; the logits gathered over the
    vocabulary within 2e-5 of tp 1's; each rank's cache holds one KV head."""
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["generate/tokens"], runs["tp1_tokens"])
        np.testing.assert_array_equal(r["generate/tokens"], runs["jax_tokens"])
        np.testing.assert_allclose(r["generate/logits"], runs["tp1_logits"],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        assert int(r["generate/cache_heads"]) == 1
