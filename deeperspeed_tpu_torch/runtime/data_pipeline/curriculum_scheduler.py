"""Curriculum learning difficulty scheduler (a copy of
``deeperspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``, plain
Python).

Equivalent of reference ``runtime/data_pipeline/curriculum_scheduler.py``
(``CurriculumScheduler``, 158 LoC): maps the global step to a difficulty
value (typically sequence length) under one of the schedule families the
reference supports -- ``fixed_linear``, ``fixed_root``, ``fixed_discrete``,
``custom``.  The engine truncates each batch's sequence dim to the current
difficulty (reference injects ``curriculum_seqlen`` into the model kwargs,
``engine.py:1814-1818``).
"""

import math


class CurriculumScheduler:
    def __init__(self, config):
        """``config``: CurriculumParams (curriculum_type, min/max_difficulty,
        schedule_type, schedule_config)."""
        self.config = config
        self.min_difficulty = config.min_difficulty
        self.max_difficulty = config.max_difficulty
        self.schedule_type = config.schedule_type
        sc = dict(config.schedule_config)
        self.current_difficulty = self.min_difficulty
        self.first_step = True

        if self.schedule_type == "fixed_linear":
            self.total_steps = sc.get("total_curriculum_step", 10000)
            self.difficulty_step = sc.get("difficulty_step", 8)
        elif self.schedule_type == "fixed_root":
            self.total_steps = sc.get("total_curriculum_step", 10000)
            self.difficulty_step = sc.get("difficulty_step", 8)
            self.root_degree = sc.get("root_degree", 2)
        elif self.schedule_type == "fixed_discrete":
            self.difficulties = list(sc.get("difficulty", [self.max_difficulty]))
            self.max_steps = list(sc.get("max_step", []))
            assert len(self.max_steps) == len(self.difficulties) - 1, (
                "fixed_discrete needs len(max_step) == len(difficulty) - 1")
        elif self.schedule_type == "custom":
            self._custom_fn = sc.get("difficulty_fn")
            assert callable(self._custom_fn), "custom schedule needs difficulty_fn"
        else:
            raise ValueError(f"unknown curriculum schedule {self.schedule_type!r}")

    def _root_progress(self, step, degree):
        frac = min(1.0, step / max(1, self.total_steps))
        return frac ** (1.0 / degree)

    def get_difficulty(self, global_step: int) -> int:
        if self.schedule_type == "fixed_linear":
            prog = min(1.0, global_step / max(1, self.total_steps))
        elif self.schedule_type == "fixed_root":
            prog = self._root_progress(global_step, self.root_degree)
        elif self.schedule_type == "fixed_discrete":
            d = self.difficulties[-1]
            for lim, diff in zip(self.max_steps, self.difficulties):
                if global_step < lim:
                    d = diff
                    break
            return int(d)
        else:  # custom
            return int(self._custom_fn(global_step))
        raw = self.min_difficulty + prog * (self.max_difficulty - self.min_difficulty)
        # quantize to difficulty_step (the reference rounds the same way so
        # compiled shapes change rarely)
        d = int(math.floor(raw / self.difficulty_step) * self.difficulty_step)
        return max(self.min_difficulty, min(self.max_difficulty, d))

    def update_difficulty(self, global_step: int) -> int:
        self.current_difficulty = self.get_difficulty(global_step)
        return self.current_difficulty

    def get_current_difficulty(self) -> int:
        return self.current_difficulty

    def is_fully_ramped(self, global_step: int) -> bool:
        return self.get_difficulty(global_step) >= self.max_difficulty
