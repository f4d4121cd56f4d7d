"""The host optimizer library ``csrc/host/cpu_adam.cpp`` (counterpart of
``deeperspeed_tpu/op_builder/cpu_adam.py``): the Adam/AdamW, Adagrad and
Lion steps."""

import ctypes

from .builder import OpBuilder

_f32p = ctypes.POINTER(ctypes.c_float)
_f, _i64 = ctypes.c_float, ctypes.c_int64


class CPUAdamBuilder(OpBuilder):
    NAME = "dst_cpu_adam"

    def sources(self):
        return ["cpu_adam.cpp"]

    def _declare(self, lib):
        lib.dst_cpu_adam_step.argtypes = ([_f32p, ctypes.c_void_p, ctypes.c_int] + [_f32p] * 2
                                          + [_i64] + [_f] * 7 + [ctypes.c_int])
        lib.dst_cpu_adam_step.restype = None
        lib.dst_cpu_adagrad_step.argtypes = [_f32p] * 3 + [_i64] + [_f] * 3
        lib.dst_cpu_adagrad_step.restype = None
        lib.dst_cpu_lion_step.argtypes = [_f32p] * 3 + [_i64] + [_f] * 4
        lib.dst_cpu_lion_step.restype = None
