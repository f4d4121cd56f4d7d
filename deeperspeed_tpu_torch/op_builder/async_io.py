"""The async file IO library ``csrc/host/aio.cpp`` (counterpart of
``deeperspeed_tpu/op_builder/async_io.py``)."""

import ctypes

from .builder import OpBuilder

_vp, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


class AsyncIOBuilder(OpBuilder):
    NAME = "dst_aio"

    def sources(self):
        return ["aio.cpp"]

    def extra_compile_args(self):
        return ["-pthread"]

    def _declare(self, lib):
        lib.dst_aio_create.argtypes = [_i]
        lib.dst_aio_create.restype = _vp
        lib.dst_aio_destroy.argtypes = [_vp]
        lib.dst_aio_destroy.restype = None
        lib.dst_aio_pwrite.argtypes = [_vp, ctypes.c_char_p, _vp, _i64, _i]
        lib.dst_aio_pwrite.restype = None
        lib.dst_aio_pwrite_fd.argtypes = [_vp, _i, _vp, _i64]
        lib.dst_aio_pwrite_fd.restype = None
        lib.dst_aio_pread.argtypes = [_vp, ctypes.c_char_p, _vp, _i64]
        lib.dst_aio_pread.restype = None
        lib.dst_aio_wait.argtypes = [_vp]
        lib.dst_aio_wait.restype = _i
        lib.dst_aio_pending.argtypes = [_vp]
        lib.dst_aio_pending.restype = _i
