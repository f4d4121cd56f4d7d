"""Checkpoints of the PyTorch port's training engine against the JAX engine
and against itself, on the CPU.

* Across packages: the JAX engine trains 3 steps of ``tiny()`` and saves;
  a fresh port engine loads the checkpoint (masters and moments equal to
  the JAX engine's bit for bit) and both train 3 more steps, within
  ``test_torch_train.py``'s loss tolerances; then the port saves, the JAX
  engine loads the port's checkpoint (its masters equal to the port's bit
  for bit) and both train 3 more.  For Adam, AdamW with weight decay, Lion,
  FusedAdam and SGD with momentum, in fp32 here, in bf16 and fp16 in
  ``test_torch_checkpoint_bf16.py`` and ``test_torch_checkpoint_fp16.py``
  (a file each, to keep each file's time short).
* The port against itself at ZeRO stages 0-3 (world 1): an engine trains 2
  steps, saves and trains 2 more; a fresh engine from other weights loads
  and trains the same 2 steps.  The losses, fp32 masters, optimizer state,
  loss scale, counters, loader position and generator state are equal bit
  for bit: with dropout and ``training_data=``; with FusedAdam in bf16; in
  fp16 with an overflow forced just after the save.
* The checkpoint written at step 0 by either package is the same bytes;
  a module without a flax tree of its own saves its dotted names nested.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.runtime import checkpointing as ck
import torch_threads  # noqa: F401  (torch at one intra-op thread)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}
LOSS_TOL = {"fp32": 1e-5, "bf16": 1e-3, "fp16": 2e-4}     # test_torch_train.py's
PRECISION = {"fp32": {}, "bf16": {"bf16": {"enabled": True}},
             "fp16": {"fp16": {"enabled": True, "initial_scale_power": 8,
                               "hysteresis": 1}}}
OPTIMIZERS = {
    "Adam": {"type": "Adam", "params": {"lr": 1e-3}},
    "AdamW": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    "Lion": {"type": "Lion", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "FusedAdam": {"type": "FusedAdam", "params": {"lr": 1e-3}},
    "SGD": {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9}},
}
BASE = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0,
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 4, "warmup_max_lr": 1e-3}}}


def _batch(rng, rows=16, seq=32, bad=False):
    toks = rng.integers(0, 256, (rows, seq + 1))
    mask = np.ones((rows, seq), np.float32)
    if bad:
        mask[3, 5] = np.inf          # a non-finite loss, hence non-finite grads
    return {"input_ids": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), "loss_mask": mask}


def _flat(tree, prefix=""):
    """'/'-joined names -> numpy copies."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _port_state(eng):
    """The port engine's masters and optimizer state under the checkpoint's
    names."""
    return _flat(ck.reference_masters(eng)), _flat(ck.reference_opt_state(eng))


def _jax_state(jeng):
    host = jax.device_get({"m": jeng.state["master_params"], "o": jeng.state["opt_state"]})
    return (_flat(host["m"]), _flat(serialization.to_state_dict(host["o"])))


def _assert_equal(got, want, what):
    assert got.keys() == want.keys(), (what, sorted(set(got) ^ set(want))[:5])
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), (what, k)


def cross_package(tmp_path, opt, mode):
    """JAX -> port -> JAX through checkpoints, as the module docstring says
    (shared with ``test_torch_checkpoint_bf16.py`` / ``_fp16.py``)."""
    config = {**BASE, "optimizer": OPTIMIZERS[opt], **PRECISION[mode]}
    jdt, tdt = DTYPES[mode]
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny(dtype=jdt)), config=config)
    rng = np.random.default_rng(11)

    def step_both(teng):
        b = _batch(rng)
        lj = float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in b.items()}))
        lt = float(teng.train_batch(batch=b))
        assert abs(lt - lj) <= LOSS_TOL[mode] * abs(lj), (opt, mode, lj, lt)

    for _ in range(3):
        jeng.train_batch(batch={k: jnp.asarray(v) for k, v in _batch(rng).items()})
    jeng.save_checkpoint(str(tmp_path / "jax"))

    # JAX -> port: a fresh port engine from other weights
    teng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(dtype=tdt), device="cpu",
                                             seed=5),
                               config=config, device="cpu")
    ckpt_dir, client = teng.load_checkpoint(str(tmp_path / "jax"))
    assert ckpt_dir.endswith("global_step3") and client == {}
    assert (teng.global_steps, teng.step_count) == (3, int(jeng.state["step"]))
    assert teng.global_samples == jeng.global_samples == 48
    assert teng.get_loss_scale() == jeng.get_loss_scale()
    masters, opt_state = _port_state(teng)
    jm, jo = _jax_state(jeng)
    _assert_equal(masters, jm, "masters after JAX -> port")
    _assert_equal(opt_state, jo, "optimizer state after JAX -> port")
    for _ in range(3):
        step_both(teng)

    # port -> JAX: the JAX engine takes the port's state
    teng.save_checkpoint(str(tmp_path / "port"))
    jeng.load_checkpoint(str(tmp_path / "port"))
    assert int(jeng.state["step"]) == teng.step_count and jeng.global_steps == 6
    jm, jo = _jax_state(jeng)
    masters, opt_state = _port_state(teng)
    _assert_equal(jm, masters, "masters after port -> JAX")
    _assert_equal(jo, opt_state, "optimizer state after port -> JAX")
    for _ in range(3):
        step_both(teng)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_jax_and_port_load_each_others_checkpoints(tmp_path, no_persistent_compile_cache, opt):
    cross_package(tmp_path, opt, "fp32")


@pytest.mark.parametrize("opt", ["Adam", "FusedAdam", "Lion", "SGD"])
def test_step0_checkpoint_is_the_jax_engines_bytes(tmp_path, opt):
    """The port's files are flax's serialization of the JAX engine's state:
    at step 0, from the same weights, the same bytes."""
    config = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
              "optimizer": OPTIMIZERS[opt]}
    jeng, *_ = jdst.initialize(model=JaxGPTNeoX(JaxConfig.tiny()), config=config)
    start = params_from_jax(jax.device_get(jeng.state["master_params"]))
    teng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                               config=config, model_parameters=start, device="cpu")
    jeng.save_checkpoint(str(tmp_path / "jax"))
    teng.save_checkpoint(str(tmp_path / "port"))
    for name in (ck.MODEL_FILE, ck.OPTIM_FILE):
        assert filecmp.cmp(tmp_path / "jax" / "global_step0" / name,
                           tmp_path / "port" / "global_step0" / name, shallow=False), name


# --------------------------------------------------------- port -> port
VARIANTS = {
    # dropout draws from the generator; the loader feeds the steps
    "fp32-dropout-loader": ({"optimizer": OPTIMIZERS["Adam"]},
                            {"hidden_dropout": 0.1, "attention_dropout": 0.1}),
    "bf16-fusedadam": ({"optimizer": OPTIMIZERS["FusedAdam"], **PRECISION["bf16"]}, {}),
    # the step after the save overflows: skipped, the scale halved
    "fp16-overflow": ({"optimizer": OPTIMIZERS["Adam"], **PRECISION["fp16"]}, {}),
}


def _snapshot(eng):
    masters, opt_state = _port_state(eng)
    ls = ck._loss_scale_tree(eng.loss_scale_state)
    return {"masters": masters, "opt": opt_state,
            "loss_scale": {k: v.item() for k, v in ls.items()},
            "counters": (eng.step_count, eng.global_steps, eng.global_samples,
                         eng.micro_steps, eng.skipped_steps),
            "rng": eng._rng.get_state().clone(),
            "loader": (eng.training_dataloader.state_dict()
                       if eng.training_dataloader is not None else None)}


def _assert_same_state(a, b, loader=True):
    """``loader``: compare the loader's position too (a loaded loader takes
    its position at its next batch)."""
    _assert_equal(a["masters"], b["masters"], "masters")
    _assert_equal(a["opt"], b["opt"], "optimizer state")
    assert a["loss_scale"] == b["loss_scale"]
    assert a["counters"] == b["counters"]
    assert torch.equal(a["rng"], b["rng"])
    assert not loader or a["loader"] == b["loader"]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_port_resume_is_bit_exact(tmp_path, stage, variant):
    extra, model_kw = VARIANTS[variant]
    mode = variant.split("-")[0]
    config = {**BASE, "zero_optimization": {"stage": stage,
                                            "param_persistence_threshold": 1000},
              **extra}
    rng = np.random.default_rng(3)
    loader = variant.endswith("loader")
    data = None
    if loader:
        toks = rng.integers(0, 256, (6 * 16, 33))
        data = {"input_ids": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
    batches = [_batch(rng, bad=variant == "fp16-overflow" and i == 2) for i in range(4)]

    def engine(seed):
        model = GPTNeoX(GPTNeoXConfig.tiny(dtype=DTYPES[mode][1], **model_kw),
                        device="cpu", seed=seed)
        return tdst.initialize(model=model, config=config, training_data=data,
                               device="cpu")[0]

    def step(eng, i):
        return float(eng.train_batch() if loader else eng.train_batch(batch=batches[i]))

    first = engine(0)
    for i in range(2):
        step(first, i)
    first.save_checkpoint(str(tmp_path), client_state={"note": "two steps"})
    saved = _snapshot(first)
    want = [step(first, i) for i in (2, 3)]
    if variant == "fp16-overflow":
        assert first.skipped_steps == 1 and np.isnan(want[0])

    second = engine(1)
    ckpt_dir, client = second.load_checkpoint(str(tmp_path))
    assert client == {"note": "two steps"}
    _assert_same_state(_snapshot(second), saved, loader=False)
    got = [step(second, i) for i in (2, 3)]
    np.testing.assert_array_equal(got, want)
    _assert_same_state(_snapshot(second), _snapshot(first))


def test_fused_adam_restore_keeps_its_flat_buffers(tmp_path):
    """A load copies into FusedAdam's flat moment buffers: their storage is
    the one B6's device table points at from the first step."""
    config = {**BASE, "optimizer": OPTIMIZERS["FusedAdam"]}
    eng, *_ = tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                              config=config, device="cpu")
    eng.train_batch(batch=_batch(np.random.default_rng(0)))
    eng.save_checkpoint(str(tmp_path))
    core = eng.opt_state[0]
    before = {(k, n): (t, t.data_ptr()) for k in ("mu", "nu") for n, t in core[k].items()}
    saved = {key: t.clone() for key, (t, _) in before.items()}
    eng.train_batch(batch=_batch(np.random.default_rng(1)))
    eng.load_checkpoint(str(tmp_path))
    core = eng.opt_state[0]
    for (k, n), (t, address) in before.items():
        assert core[k][n] is t and t.data_ptr() == address
        assert torch.equal(t, saved[k, n])


def test_module_without_reference_tree_nests_its_names(tmp_path):
    """A module without ``to_reference_tree`` (here a plain MLP under a
    client loss) is saved under its dotted names nested, untransposed."""
    def mlp(seed):
        torch.manual_seed(seed)
        return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                                   torch.nn.Linear(16, 4))

    def loss(model, batch, rng):
        return (model(batch["x"]) - batch["y"]).pow(2).mean()

    config = {"train_batch_size": 4, "optimizer": OPTIMIZERS["AdamW"]}
    rng = np.random.default_rng(6)
    batches = [{"x": rng.standard_normal((4, 8)).astype(np.float32),
                "y": rng.standard_normal((4, 4)).astype(np.float32)} for _ in range(3)]
    first = tdst.initialize(model=mlp(0), loss_fn=loss, config=config, device="cpu")[0]
    for b in batches[:2]:
        first.train_batch(batch=b)
    first.save_checkpoint(str(tmp_path))
    tree = ck.load_module_params(str(tmp_path))
    assert list(tree) == ["0", "2"] and list(tree["0"]) == ["bias", "weight"]
    assert np.array_equal(tree["0"]["weight"], first.master_params["0.weight"].numpy())
    second = tdst.initialize(model=mlp(1), loss_fn=loss, config=config, device="cpu")[0]
    second.load_checkpoint(str(tmp_path))
    _assert_equal(_port_state(second)[1], _port_state(first)[1], "optimizer state")
    assert float(second.train_batch(batch=batches[2])) == \
        float(first.train_batch(batch=batches[2]))
    _assert_equal(_port_state(second)[0], _port_state(first)[0], "masters")
