"""Accelerator selection (counterpart of ``deeperspeed_tpu/accelerator/real_accelerator.py``).

The device is the caller's choice, never a silent guess: entry points take
``device=None`` to mean CUDA, and raise when there is none, unless the
caller passes ``device="cpu"``.
"""

import torch

from .cuda_accelerator import CpuAccelerator, CudaAccelerator

_CUDA = CudaAccelerator()
_CPU = CpuAccelerator()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA.  Raises when CUDA
    is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def get_accelerator(device=None):
    """The accelerator of ``device`` (a device, a string, or None for CUDA)."""
    return _CPU if resolve_device(device).type == "cpu" else _CUDA
