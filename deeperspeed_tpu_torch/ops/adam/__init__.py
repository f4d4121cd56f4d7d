from .fused_adam import fused_adam_, scale_by_fused_adam  # noqa: F401
