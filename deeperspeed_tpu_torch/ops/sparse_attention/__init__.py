from .sparse_attention import SparseSelfAttention, sparse_attention
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)

__all__ = ["sparse_attention", "SparseSelfAttention", "SparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig"]
