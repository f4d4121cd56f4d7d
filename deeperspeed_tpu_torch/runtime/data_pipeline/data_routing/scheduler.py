"""Random-LTD token-budget scheduler (a copy of
``deeperspeed_tpu/runtime/data_pipeline/data_routing/scheduler.py``).

Equivalent of reference ``runtime/data_pipeline/data_routing/scheduler.py``:
ramps the number of tokens the middle layers actually process
(``random_ltd_layer_token_num``) from ``min_value`` up to the full sequence
length over ``total_layer_num`` steps, stepping by ``step_size`` so compiled
shapes change only at ramp boundaries.
"""


class RandomLTDScheduler:
    def __init__(self, min_tokens, max_tokens, total_steps, step_size=16,
                 schedule_type="fixed_linear"):
        assert schedule_type == "fixed_linear", "only fixed_linear is supported"
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.total_steps = max(1, total_steps)
        self.step_size = step_size
        self.current_tokens = min_tokens

    def get_tokens(self, global_step: int) -> int:
        frac = min(1.0, global_step / self.total_steps)
        raw = self.min_tokens + frac * (self.max_tokens - self.min_tokens)
        t = int(raw // self.step_size) * self.step_size
        return max(self.min_tokens, min(self.max_tokens, t))

    def update(self, global_step: int) -> int:
        self.current_tokens = self.get_tokens(global_step)
        return self.current_tokens
