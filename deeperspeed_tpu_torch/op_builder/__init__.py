"""Native host routines (counterpart of ``deeperspeed_tpu/op_builder``):
the CPU optimizer steps and the async file IO pool of ``csrc/host/``,
built with the system C++ compiler at first use."""

from .async_io import AsyncIOBuilder  # noqa: F401
from .builder import CALLS, OpBuilder  # noqa: F401
from .cpu_adam import CPUAdamBuilder  # noqa: F401
