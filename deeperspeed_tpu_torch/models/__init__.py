from .gpt_neox import GPTNeoX, GPTNeoXConfig, params_from_jax, params_to_jax  # noqa: F401
