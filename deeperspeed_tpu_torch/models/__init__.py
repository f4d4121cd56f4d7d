from .gpt_neox import GPTNeoX, GPTNeoXConfig, params_from_jax  # noqa: F401
