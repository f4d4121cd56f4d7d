"""Paged continuous-batching serving, PyTorch port (first slice).

Still to come: the scheduler (``DSScheduler``), speculative drafters, the
serving front end, replicas, disaggregation, the fabric, the host KV tier
and long-context sessions."""

from .blocked_allocator import BlockedAllocator  # noqa: F401
from .config import (DSStateManagerConfig, KVCacheConfig,  # noqa: F401
                     RaggedInferenceEngineConfig, SamplingConfig,
                     SpeculativeConfig)
from .engine_v2 import InferenceEngineV2, RoundOutputs  # noqa: F401
from .ragged_manager import DSSequenceDescriptor, DSStateManager  # noqa: F401
