"""The port's LR schedules against the JAX package's over a step range.
The JAX functions compute in fp32 on the device, the port's in Python
floats on the host: they agree to fp32 rounding, a few fp32 ulps where a
formula subtracts close terms (OneCycle's decay, 1 - x/y): rtol 2e-5."""

import numpy as np
import pytest

from deeperspeed_tpu.runtime import lr_schedules as jax_sched
from deeperspeed_tpu_torch.runtime import lr_schedules as sched
import torch_threads  # noqa: F401  (torch at one intra-op thread)

CASES = [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-5, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 15,
                  "decay_step_size": 5, "decay_lr_rate": 0.5}),
    ("OneCycle", {"cycle_min_lr": 1e-5, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 12}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_max_lr": 3e-4, "warmup_num_steps": 20,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 50, "warmup_max_lr": 1e-3,
                       "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 50, "warmup_num_steps": 10,
                        "warmup_min_ratio": 0.1, "cos_min_ratio": 0.01}),
    ("WarmupCosineLR", {"total_num_steps": 50, "warmup_num_steps": 10,
                        "warmup_type": "linear"}),
]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_schedule_matches_jax(name, params):
    base_lr = 6e-4 if name == "WarmupCosineLR" else None
    want_fn = jax_sched.get_lr_schedule_fn(name, params, base_lr=base_lr)
    got_fn = sched.get_lr_schedule_fn(name, params, base_lr=base_lr)
    steps = range(0, 70)
    want = np.array([float(want_fn(s)) for s in steps])
    got = np.array([got_fn(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-12)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        sched.get_lr_schedule_fn("Constant", {})
