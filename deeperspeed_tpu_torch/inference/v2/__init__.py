"""Paged continuous-batching serving, PyTorch port: the engine, the
scheduler and the speculative drafters.

Still to come: the serving front end, replicas, disaggregation, the fabric,
the host KV tier and long-context serving."""

from .blocked_allocator import BlockedAllocator  # noqa: F401
from .config import (DSStateManagerConfig, KVCacheConfig,  # noqa: F401
                     RaggedInferenceEngineConfig, SamplingConfig,
                     SpeculativeConfig)
from .engine_v2 import InferenceEngineV2, RoundOutputs  # noqa: F401
from .ragged_manager import DSSequenceDescriptor, DSStateManager  # noqa: F401
from .scheduler import (DSScheduler, RaggedRequest,  # noqa: F401
                        SchedulingResult, UnservableRequestError)
from .speculative import (CallableDrafter, NGramDrafter,  # noqa: F401
                          SpeculationGovernor, make_drafter)
