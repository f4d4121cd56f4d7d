"""Progressive layer drop (PLD; a copy of
``deeperspeed_tpu/runtime/progressive_layer_drop.py``).

Equivalent of reference ``runtime/progressive_layer_drop.py:40``: the keep
probability ``theta_t = (1 - theta) * exp(-gamma * t) + theta`` ramps from 1
down to ``theta``; the engine recomputes it each step and the model drops
whole transformer blocks stochastically with per-layer probability scaled by
depth (deeper layers drop more, following the PLD paper the reference
implements).
"""

import math


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_theta(self, global_step: int) -> float:
        return (1.0 - self.theta) * math.exp(-self.gamma * global_step) + self.theta

    def update_state(self, global_step: int) -> float:
        self.current_theta = self.get_theta(global_step)
        return self.current_theta

    def get_state(self):
        return {"pld_enabled": True, "pld_theta": self.current_theta}
