from .fused_lion import fused_lion_, scale_by_fused_lion  # noqa: F401
