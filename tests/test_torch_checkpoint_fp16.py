"""Checkpoints across packages in fp16: the JAX engine's checkpoint loads
into the port and the port's into the JAX engine, for each optimizer
(``test_torch_checkpoint.py`` says how)."""

import pytest

from test_torch_checkpoint import OPTIMIZERS, cross_package


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_jax_and_port_load_each_others_checkpoints_fp16(tmp_path,
                                                          no_persistent_compile_cache, opt):
    cross_package(tmp_path, opt, "fp16")
