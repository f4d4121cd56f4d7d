from .core import dot_product_attention  # noqa: F401
from .flash import flash_attention, flash_attention_supported, mha  # noqa: F401
from .paged import (paged_decode_attention,  # noqa: F401
                    paged_spec_decode_attention)
