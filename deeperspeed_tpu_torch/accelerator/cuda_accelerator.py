"""CUDA accelerator and its CPU twin (counterpart of
``deeperspeed_tpu/accelerator/tpu_accelerator.py``)."""

import torch

from .abstract_accelerator import Accelerator


class CudaAccelerator(Accelerator):
    _name = "cuda"

    def device(self, device_index=None):
        return torch.device("cuda" if device_index is None
                            else f"cuda:{device_index}")

    def device_count(self):
        return torch.cuda.device_count()

    def use_cuda_kernels(self):
        return True


class CpuAccelerator(Accelerator):
    """Host CPU: runs the tests, with every kernel's plain version."""

    _name = "cpu"

    def device(self, device_index=None):
        return torch.device("cpu")

    def device_count(self):
        return 1

    def use_cuda_kernels(self):
        return False
