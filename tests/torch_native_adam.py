"""Imported for its side effect by the port's test modules (through
``tests/torch_threads.py``): the JAX package's native ``cpu_adam`` library
built once, under a file lock, before any gated test module asks for it.

The JAX builder compiles into one fixed temporary file, and its lock holds
only within a process.  Test processes that collect together in a fresh
checkout (``pytest -n 6``) would each compile into that file; a process
whose load then fails keeps the failure cached and skips the test modules
that need the library (``tests/unit/runtime/test_host_update.py``,
``tests/unit/runtime/zero/test_infinity.py``,
``tests/unit/runtime/zero/test_memplan_infinity.py``).  The port's test
modules are collected before ``tests/unit/``, so building here, one
process at a time, leaves every process a finished library to load.

Where JAX is not installed (the card's machine, which runs the kernel tests
with ``--noconftest``) there is no JAX test to serve: nothing is imported
from the JAX package and nothing is built."""

import fcntl
import importlib.util
import os


def ensure_jax_cpu_adam():
    """Build the JAX package's ``cpu_adam`` library under a file lock (a
    second attempt finds the finished library) and forget any failed load
    the JAX loader cached; returns whether the library loads."""
    from deeperspeed_tpu.op_builder import CPUAdamBuilder
    from deeperspeed_tpu.op_builder.builder import OpBuilder
    from deeperspeed_tpu.ops.adam import cpu_adam as jax_cpu_adam_module

    builder = CPUAdamBuilder()
    lock_path = builder._lib_path() + ".lock"
    os.makedirs(os.path.dirname(lock_path), exist_ok=True)
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            try:
                builder.build()
            except RuntimeError:
                builder.build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    OpBuilder._cache.pop(builder.NAME, None)
    jax_cpu_adam_module._lib = None
    jax_cpu_adam_module._checked = False
    return jax_cpu_adam_module.cpu_adam_available()


AVAILABLE = False
if importlib.util.find_spec("jax") is not None:
    try:
        AVAILABLE = ensure_jax_cpu_adam()
    except (ImportError, OSError, RuntimeError):
        # no compiler here: the gated modules skip, as they did before
        pass
