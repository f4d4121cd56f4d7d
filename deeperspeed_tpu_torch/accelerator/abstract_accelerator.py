"""Platform abstraction (counterpart of ``deeperspeed_tpu/accelerator/abstract_accelerator.py``).

PyTorch is explicit about devices: every tensor names the device it lives
on, so the accelerator is thin.  It names its device and answers the one
question the kernel wrappers ask, :meth:`use_cuda_kernels` (the port's
``use_pallas_kernels``).
"""

import abc

import torch


class Accelerator(abc.ABC):
    _name: str = None

    @abc.abstractmethod
    def device(self, device_index=None) -> torch.device:
        ...

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    @abc.abstractmethod
    def use_cuda_kernels(self):
        """Whether the hand-written CUDA kernels run (True exactly for
        tensors on a CUDA device); otherwise each wrapper takes its plain
        PyTorch version."""

    def name(self):
        return self._name
