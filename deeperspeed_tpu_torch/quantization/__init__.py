"""Block-scaled low-precision tensor type of the port: the paged KV cache,
the quantized collectives and the MoE dispatch's transport."""

from .block_scaled import (WIRE_DTYPES, BlockScaledTensor,  # noqa: F401
                           block_shape_error, canonical_dtype, group_shape,
                           qmax, wire_dtype)
