"""Imported for its side effect by the port's test modules: torch at one
intra-op thread.  The suite's workers share the host's cores, and torch's
default (a thread a core) makes their threads spin against each other's.
It also imports ``torch_native_adam``, which builds the JAX package's native
Adam once, under a file lock, before any worker collects the modules that
need it (where JAX is installed; without it, nothing)."""

import torch

import torch_native_adam  # noqa: F401  (the JAX cpu_adam built under a lock)

torch.set_num_threads(1)
