"""Parameter placement for the v1 engine (counterpart of
``deeperspeed_tpu/inference/params.py``).

The JAX package resolves a module's partition rules to shardings and
materializes its weights there.  Here the model draws its own weights on
its device (``Llama`` on the card, from a CUDA generator), a given state
dict replaces them, and under tensor parallelism the whole model is made
tensor-parallel in place by its rules, as the training engine does
(``parallel/tensor_parallel.py`` ``shard_module``): each rank keeps its
slice of every split weight.
"""

from ..parallel.tensor_parallel import shard_module


def shard_module_params(module, group):
    """Make ``module`` tensor-parallel over ``group`` in place by its
    ``param_partition_rules()``; returns the split dims."""
    if not hasattr(module, "param_partition_rules"):
        raise ValueError("tensor-parallel inference needs a model with "
                         "param_partition_rules()")
    return shard_module(module, module.param_partition_rules(), group)
