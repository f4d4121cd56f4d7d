from .gpt_neox import (DecodeCache, GPTNeoX, GPTNeoXConfig, params_from_jax,  # noqa: F401
                       params_to_jax)
from .llama import Llama, LlamaConfig, Mistral, OPT  # noqa: F401
