"""A long trajectory of the PyTorch port held against the JAX package's
recorded loss curves (``parity_curves.json``, written by
``tools/parity_run.py``), on the CPU.

The JAX side rebuilds ``parity_run.py``'s starting point: its config
(``_cfg``, seed 7), the initial fp32 masters of ``GPTNeoX(tiny())`` and its
8 batches, rotated.  The port trains the same weights
(``params_from_jax``) in fp32, bf16 and fp16 for the recorded 400 steps;
in fp16 the loss scale is forced to 2^30 at step 160, as ``parity_run.py``
does, so that step must skip and back off.  The fp16 run also saves at
step 150 and a fresh engine resumes from the checkpoint: the rest of its
curve equals the uninterrupted run's bit for bit.

Bounds: those ``tests/unit/test_trajectory_parity.py`` puts on the JAX
package's own pairs.  The port's fp32 curve against the recorded fp32 one
gets the compiled pipeline pair's (max relative 1e-2, mean 1e-3); bf16 and
fp16 against the recorded fp32 curve get the precision pairs' (bf16 mean
5e-2 and final 1e-1, fp16 mean 1.5e-1), with the skip and lag checks.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from tools import parity_run
import torch_threads  # noqa: F401  (torch at one intra-op thread)

RECORD = json.loads((Path(__file__).resolve().parents[1] / "parity_curves.json").read_text())
STEPS = RECORD["steps"]
BLOW_AT = max(1, int(STEPS * parity_run.OVERFLOW_STEP_FRAC))     # 160 of 400
SAVE_AT = 150
FP16 = {"enabled": True, "initial_scale_power": 16, "loss_scale_window": 200,
        "hysteresis": 1}


@pytest.fixture(scope="module")
def start():
    """``parity_run.transformer_curves``' p0 and batches, as numpy."""
    model = JaxGPTNeoX(JaxConfig.tiny())
    eng, *_ = jdst.initialize(model=model, config=parity_run._cfg())
    p0 = jax.device_get(eng.state["master_params"])
    batches = [{k: np.array(v) for k, v in b.items()}
               for b in parity_run._batches(model)]
    return params_from_jax(p0), batches


def _engine(start, **extra):
    weights, _ = start
    return tdst.initialize(model=GPTNeoX(GPTNeoXConfig.tiny(), device="cpu"),
                           config=parity_run._cfg(**extra),
                           model_parameters={n: t.clone() for n, t in weights.items()},
                           device="cpu")[0]


def _train(eng, batches, steps, blow_at=None, save=None):
    curve = []
    for i in steps:
        if save is not None and i == save[0]:
            eng.save_checkpoint(save[1])
        if i == blow_at:
            eng.loss_scale_state = dataclasses.replace(
                eng.loss_scale_state, scale=torch.tensor(2.0 ** 30))
            skipped = eng.skipped_steps
        curve.append(float(eng.train_batch(batch=batches[i % parity_run.N_BATCHES])))
        if i == blow_at:            # the forced scale overflows: skipped, halved
            assert eng.skipped_steps == skipped + 1
            assert eng.get_loss_scale() == 2.0 ** 29
    return curve


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-8)


def test_fp32_curve_matches_the_recorded_one(start):
    curve = _train(_engine(start), start[1], range(STEPS))
    rel = _rel(curve, RECORD["curves"]["fp32_flat"])
    print(f"fp32: max rel {rel.max():.3e}, mean rel {rel.mean():.3e}, "
          f"loss {curve[0]:.4f} -> {curve[-1]:.4f}")
    assert rel.max() < 1e-2 and rel.mean() < 1e-3, (rel.max(), rel.mean())
    assert curve[-1] < curve[0]


def test_bf16_curve_stays_within_the_recorded_envelope(start):
    curve = _train(_engine(start, bf16={"enabled": True}), start[1], range(STEPS))
    rel = _rel(curve, RECORD["curves"]["fp32_flat"])
    print(f"bf16: mean rel {rel.mean():.3e}, final rel {rel[-1]:.3e}")
    assert np.isfinite(curve).all() and curve[-1] < curve[0]
    assert rel.mean() < 5e-2 and rel[-1] < 1e-1, (rel.mean(), rel[-1])


def test_fp16_curve_with_overflow_and_resume(start, tmp_path):
    eng = _engine(start, fp16=FP16)
    curve = _train(eng, start[1], range(STEPS), blow_at=BLOW_AT,
                   save=(SAVE_AT, str(tmp_path)))
    fp32 = RECORD["curves"]["fp32_flat"]
    skipped = eng.skipped_steps
    assert skipped >= 1 and np.isfinite(eng.get_loss_scale())
    assert np.isfinite(curve).all() and curve[-1] < curve[0]
    rel = _rel(curve, fp32)
    print(f"fp16: mean rel {rel.mean():.3e}, final rel {rel[-1]:.3e}, skipped {skipped}, "
          f"final scale {eng.get_loss_scale()}")
    assert rel.mean() < 1.5e-1, rel.mean()
    # losing `skipped` optimizer steps may set the curve back by about that
    # many steps, never more than 2x (test_trajectory_parity.py's lag bound)
    lag_idx = max(0, STEPS - 1 - 2 * skipped)
    assert curve[-1] <= fp32[lag_idx] * 1.15, (curve[-1], fp32[lag_idx], skipped)

    resumed = _engine(start, fp16=FP16)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.global_steps == SAVE_AT
    rest = _train(resumed, start[1], range(SAVE_AT, STEPS), blow_at=BLOW_AT)
    np.testing.assert_array_equal(rest, curve[SAVE_AT:])
    assert resumed.skipped_steps == skipped
    assert resumed.get_loss_scale() == eng.get_loss_scale()
