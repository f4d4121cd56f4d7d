from .fused import fused_dequant_reduce  # noqa: F401
from .kv import byte_view, dequantize_kv, quantize_kv  # noqa: F401
