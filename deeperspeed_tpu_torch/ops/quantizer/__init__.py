from .kv import byte_view, dequantize_kv, quantize_kv  # noqa: F401
