"""Accelerator selection (counterpart of ``deeperspeed_tpu/accelerator/real_accelerator.py``).

The device is the caller's choice, never a silent guess: entry points take
``device=None`` to mean CUDA, and raise when there is none, unless the
caller passes ``device="cpu"``.  Under a launcher that starts one process
per GPU (``LOCAL_RANK`` set, as the reference's launcher sets it), CUDA
means the process's own card, ``cuda:{LOCAL_RANK}``.
"""

import os

import torch

from .cuda_accelerator import CpuAccelerator, CudaAccelerator

_CUDA = CudaAccelerator()
_CPU = CpuAccelerator()


def local_cuda_index():
    """The card of this process under a one-process-per-GPU launcher:
    ``LOCAL_RANK`` as an int, None when it is not set.  Raises when it
    names a card the host does not have."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return None
    index, count = int(local), torch.cuda.device_count()
    if not 0 <= index < count:
        raise RuntimeError(f"LOCAL_RANK {index} names no card: this host has "
                           f"{count} CUDA device(s)")
    return index


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA (``cuda:{LOCAL_RANK}``
    when ``LOCAL_RANK`` is set).  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if device is None:
        index = local_cuda_index()
        if index is not None:
            dev = torch.device("cuda", index)
    return dev


def get_accelerator(device=None):
    """The accelerator of ``device`` (a device, a string, or None for CUDA)."""
    return _CPU if resolve_device(device).type == "cpu" else _CUDA
