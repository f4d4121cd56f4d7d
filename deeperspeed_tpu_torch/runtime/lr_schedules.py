"""LR schedules (counterpart of ``deeperspeed_tpu/runtime/lr_schedules.py``).

The same five families -- ``LRRangeTest``, ``OneCycle``, ``WarmupLR``,
``WarmupDecayLR``, ``WarmupCosineLR`` -- as pure functions ``step -> lr``
of a Python int, in Python floats.  The engine evaluates the schedule on
the host once per step; the JAX package evaluated it on the device in
fp32, so the two agree to fp32 rounding.
"""

import math

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


def _clip01(x):
    return min(max(x, 0.0), 1.0)


def _warmup_frac(step, warmup_num_steps, warmup_type):
    if warmup_type == "log":
        return math.log1p(min(step, warmup_num_steps)) / math.log(warmup_num_steps + 1)
    return min(step, warmup_num_steps) / warmup_num_steps


def lr_range_test_fn(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                     lr_range_test_step_rate=1.0, lr_range_test_staircase=False, **_):
    def fn(step):
        interval = step // lr_range_test_step_size if lr_range_test_staircase else (
            step / lr_range_test_step_size)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return fn


def one_cycle_fn(cycle_min_lr=0.0, cycle_max_lr=1e-3, cycle_first_step_size=2000,
                 cycle_second_step_size=None, decay_step_size=0, decay_lr_rate=0.0,
                 cycle_first_stair_count=0, cycle_second_stair_count=None, **_):
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size
    total = cycle_first_step_size + second

    def fn(step):
        if step <= cycle_first_step_size:
            lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (step / cycle_first_step_size)
        elif step > total:
            lr = cycle_min_lr
            if decay_step_size > 0:
                lr = cycle_min_lr * (1.0 / (1.0 + decay_lr_rate * (step - total)
                                            / decay_step_size))
        else:
            lr = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
                (step - cycle_first_step_size) / second)
        return max(lr, 0.0)

    return fn


def warmup_lr_fn(warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=1000,
                 warmup_type="log", **_):
    warmup_num_steps = max(2, warmup_num_steps)

    def fn(step):
        frac = _warmup_frac(step, warmup_num_steps, warmup_type)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _clip01(frac)

    return fn


def warmup_decay_lr_fn(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=1e-3,
                       warmup_num_steps=1000, warmup_type="log", **_):
    warm = warmup_lr_fn(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    warmup_num_steps = max(2, warmup_num_steps)

    def fn(step):
        if step < warmup_num_steps:
            return warm(step)
        decay = max(0.0, 1.0 - (step - warmup_num_steps)
                    / max(1.0, total_num_steps - warmup_num_steps))
        return warmup_max_lr * decay

    return fn


def warmup_cosine_lr_fn(total_num_steps, warmup_min_ratio=0.0, warmup_num_steps=1000,
                        cos_min_ratio=0.0001, warmup_type="log", base_lr=1.0, **_):
    warmup_num_steps = max(2, warmup_num_steps)

    def fn(step):
        if step < warmup_num_steps:
            wfrac = _warmup_frac(step, warmup_num_steps, warmup_type)
            return base_lr * (warmup_min_ratio + (1.0 - warmup_min_ratio) * _clip01(wfrac))
        progress = _clip01((step - warmup_num_steps)
                           / max(1.0, total_num_steps - warmup_num_steps))
        return base_lr * (cos_min_ratio + (1.0 - cos_min_ratio) * 0.5
                          * (1.0 + math.cos(math.pi * progress)))

    return fn


_SCHEDULE_FNS = {
    LR_RANGE_TEST: lr_range_test_fn,
    ONE_CYCLE: one_cycle_fn,
    WARMUP_LR: warmup_lr_fn,
    WARMUP_DECAY_LR: warmup_decay_lr_fn,
    WARMUP_COSINE_LR: warmup_cosine_lr_fn,
}


def get_lr_schedule_fn(name, params, base_lr=None):
    """A ``step -> lr`` function from a scheduler config block."""
    if name not in _SCHEDULE_FNS:
        raise ValueError(f"unknown lr schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    params = dict(params)
    if name == WARMUP_COSINE_LR and base_lr is not None:
        params.setdefault("base_lr", base_lr)
    return _SCHEDULE_FNS[name](**params)
