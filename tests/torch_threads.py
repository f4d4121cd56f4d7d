"""Imported for its side effect by the port's test modules: torch at one
intra-op thread.  The suite's workers share the host's cores, and torch's
default (a thread a core) makes their threads spin against each other's."""

import torch

torch.set_num_threads(1)
