"""The port's host update (``offload_optimizer: {device: cpu, host_update:
true}``) against the JAX engine on the CPU: the native CPU Adam over host
fp32 masters and moments, the card (here the CPU device) holding only the
compute parameters.

The oracle is the JAX engine's device-side Adam, which the JAX package's
``test_host_update_matches_device_adam`` holds equal to its own host update
within ``rtol=2e-5, atol=1e-6``: the same weights (``params_from_jax``), the
JAX package's ``_cfg`` (batch 16, gas 2, clip 1.0, seed 7) and batches.
The JAX package's native builder is not called here.
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
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
import torch_threads  # noqa: F401  (torch at one intra-op thread)

HOST = {"stage": 0, "offload_optimizer": {"device": "cpu", "host_update": True}}


def _cfg(**extra):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "seed": 7}
    cfg.update(extra)
    return cfg


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's device Adam: 5 losses, its initial masters, the
    batch."""
    model = JaxGPTNeoX(JaxConfig.tiny())
    jeng, *_ = jdst.initialize(model=model, config=_cfg())
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    batch = {k: np.asarray(v) for k, v in model.example_batch(batch_size=16,
                                                             seq_len=32).items()}
    losses = [float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in batch.items()}))
              for _ in range(5)]
    return losses, start, batch


def _port(config, start, dtype=torch.float32):
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(dtype=dtype), device="cpu"),
                              config=config, model_parameters=start, device="cpu")
    return eng


def test_host_update_matches_jax_device_adam(jax_run):
    want, start, batch = jax_run
    eng = _port(_cfg(zero_optimization=HOST), start)
    got = [float(eng.train_batch(batch=batch)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    # nothing optimizer-sized in the engine: no optimizer state, the masters
    # on the host apart from the compute parameters
    assert eng.opt_state is None and eng._host_adam.t == 5
    m, v = next(iter(eng._host_adam._moments.values()))
    assert m.dtype == torch.float32 and m.abs().max() > 0
    for name, p in eng.module.named_parameters():
        assert eng.master_params[name].data_ptr() != p.data_ptr()
    assert eng._master_flat.device.type == "cpu"
    stats = eng.offload_stats
    assert stats["d2h_bytes"] == 4 * eng._grad_flat.numel()
    assert stats["h2d_bytes"] == 4 * eng._grad_flat.numel()      # fp32 compute


def test_wire_bf16_tracks_fp32(jax_run):
    """``wire_dtype: "bf16"`` halves the gradients' bytes to the host (the
    native Adam reads them as bf16) and tracks the fp32 wire (the JAX
    package's bound, 5e-3)."""
    _, start, batch = jax_run
    off = {**HOST, "offload_optimizer": {**HOST["offload_optimizer"], "wire_dtype": "bf16"}}
    e32 = _port(_cfg(zero_optimization=HOST), start)
    e16 = _port(_cfg(zero_optimization=off), start)
    l32 = [float(e32.train_batch(batch=batch)) for _ in range(3)]
    l16 = [float(e16.train_batch(batch=batch)) for _ in range(3)]
    assert e16._host_grad.dtype == torch.bfloat16
    assert e16.offload_stats["d2h_bytes"] * 2 == e32.offload_stats["d2h_bytes"]
    np.testing.assert_allclose(l16, l32, rtol=5e-3, atol=5e-3)


def test_bf16_compute_keeps_fp32_host_masters(jax_run):
    _, start, batch = jax_run
    eng = _port(_cfg(zero_optimization=HOST, bf16={"enabled": True}), start, torch.bfloat16)
    losses = [float(eng.train_batch(batch=batch)) for _ in range(3)]
    assert losses[-1] < losses[0]
    dtypes = {n: p.dtype for n, p in eng.module.named_parameters()}
    assert dtypes.pop("embed_in.weight") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    assert all(m.dtype == torch.float32 for m in eng.master_params.values())
    # the cast on the host: the copy up moves the compute bytes
    want = sum(p.numel() * p.element_size() for p in eng.module.parameters())
    assert eng.offload_stats["h2d_bytes"] == want < 4 * eng._grad_flat.numel()


@pytest.mark.parametrize("zero,extra,error,match", [
    ({"stage": 1, "offload_optimizer": {"device": "cpu", "host_update": True}}, {},
     NotImplementedError, "zero stage 0"),
    (HOST, {"fp16": {"enabled": True}}, NotImplementedError, "fp16"),
    (HOST, {"optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}}, NotImplementedError,
     "Adam/AdamW/CPUAdam"),
    ({"stage": 0, "offload_optimizer": {"device": "nvme", "nvme_path": "/nonexistent",
                                        "host_update": True}}, {},
     ValueError, "requires device 'cpu'"),
    ({"stage": 0, "offload_optimizer": {"device": "nvme"}}, {}, ValueError, "nvme_path"),
])
def test_host_update_refusals(zero, extra, error, match):
    with pytest.raises(error, match=match):
        _port(_cfg(zero_optimization=zero, **extra), None)


def test_host_update_refuses_several_processes(monkeypatch):
    """More than one process: the JAX engine's refusal (the gradients come
    to one host)."""
    from deeperspeed_tpu_torch import comm

    monkeypatch.setattr(comm, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        _port(_cfg(zero_optimization=HOST), None)
