from .fused_adam import fused_adam_, scale_by_fused_adam  # noqa: F401
from .cpu_adam import DeeperSpeedCPUAdam, cpu_adam_available  # noqa: F401
