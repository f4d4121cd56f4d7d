"""What the layout tests of the PyTorch port share (``test_torch_tp.py``,
``test_torch_mics_hpz.py``, ``test_torch_layout_misc.py``,
``test_torch_checkpoint_dp.py``): the JAX engine's run of a configuration
on a mesh of the 8-device CPU mesh's first devices, the batches, and the
tolerance on the final masters."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deeperspeed_tpu as jdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.parallel import topology as jtopo
from deeperspeed_tpu_torch.models import GPTNeoXConfig, params_from_jax

STEPS = 3
ROWS, SEQ = 8, 16
THRESHOLD = 1000            # stage 3 partitions tiny()'s matrices, keeps its vectors
BASE = {"train_batch_size": ROWS, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


def config(stage=0, **zero):
    return {**BASE, "zero_optimization": {"stage": stage,
                                          "param_persistence_threshold": THRESHOLD, **zero}}


def batches(seed=11, steps=STEPS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def jax_run(cfg, mesh, batch_list, model_kw=None, steps=STEPS):
    """The JAX engine on ``mesh`` (``MeshTopology`` sizes over the first
    devices): ``(losses, grad norms, final masters, initial masters)``, the
    masters as port state dicts."""
    saved = jtopo._GLOBAL_MESH
    n = int(np.prod(list(mesh.values())))
    try:
        m = jtopo.MeshTopology(**mesh, devices=jax.devices()[:n])
        jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny(**(model_kw or {}))),
                                   config=cfg, mesh=m)
        start = params_from_jax(jax.device_get(jeng.state["master_params"]))
        losses, norms = [], []
        for step in range(steps):
            losses.append(float(jeng.train_batch(
                batch={k: jnp.asarray(v) for k, v in batch_list[step].items()})))
            norms.append(jeng.get_global_grad_norm())
        final = params_from_jax(jax.device_get(jeng.state["master_params"]))
    finally:
        jtopo.set_mesh(saved)
    return np.array(losses), np.array(norms), final, start


def arrays_for(start, batch_list):
    arrays = {f"w/{k}": v.numpy() for k, v in start.items()}
    for i, b in enumerate(batch_list):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    return arrays


def by_run(ranks, names):
    """``{run: [rank results]}`` from the workers' flat results."""
    return {name: [{k[len(name) + 1:]: v for k, v in r.items() if k.startswith(name + "/")}
                   for r in ranks] for name in names}


def masters_agree(final, got, start, tol=1e-5):
    """As ``test_torch_zero.py``: per parameter, the summed |difference|
    within ``tol`` of the summed change, the key-bias entries outside the
    rotary dims left out (their true gradient is zero)."""
    cfg = GPTNeoXConfig.tiny()
    D, rot = cfg.head_dim, int(cfg.head_dim * cfg.rotary_pct)
    for name, want in final.items():
        keep = torch.ones_like(want, dtype=torch.bool)
        if name.endswith("query_key_value.bias"):
            keep.view(cfg.num_heads, 3 * D)[:, D + rot:2 * D] = False
        diff = (torch.from_numpy(got[f"final/{name}"]) - want).abs()[keep].sum()
        moved = (want - start[name]).abs()[keep].sum()
        assert diff <= tol * moved + 1e-12, (name, float(diff), float(moved))
