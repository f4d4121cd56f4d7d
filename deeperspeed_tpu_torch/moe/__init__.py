"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis
(counterpart of ``deeperspeed_tpu/moe/``, reference ``deepspeed/moe/``)."""

from .layer import MoE  # noqa: F401
from .sharded_moe import MOELayer, TopKGate, top1gating, top2gating  # noqa: F401
from .mappings import drop_tokens, gather_tokens  # noqa: F401
