"""A handle over the native async file IO pool (counterpart of
``deeperspeed_tpu/ops/aio/aio_handle.py``; the library is
``csrc/host/aio.cpp``).

Whole-file reads and writes drain on the pool's threads while the caller
goes on: :meth:`AsyncIOHandle.async_pwrite` and :meth:`async_pread` submit,
:meth:`wait` blocks until every submitted request has finished and returns 0
or the negative errno of the first that failed.  Buffers are contiguous CPU
tensors (any dtype) or bytes-like objects; the handle keeps each submitted
buffer alive until the next :meth:`wait`, the library's lifetime contract.
A write lands under a temporary name, is fsync'd (``fsync=True``) and
renamed into place, so ``wait() == 0`` means every submitted file is
durable; :meth:`async_pwrite_fd` writes only the bytes to a file the caller
opened (the async checkpoint writer, whose opens, fsyncs and renames go
through its own seam).  The library is built at first use; a failed build
raises.
"""

import ctypes

import numpy as np
import torch

from ...op_builder.builder import CALLS


def _library():
    from ...op_builder import AsyncIOBuilder

    return AsyncIOBuilder().load()


def aio_available():
    """True when the native library builds and loads on this host."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


def _address(buf, writable):
    """(address, nbytes, object to keep alive) of a contiguous CPU tensor or
    a bytes-like object, without a copy."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError(f"aio: a contiguous CPU tensor, got {buf.device} "
                             f"{'contiguous' if buf.is_contiguous() else 'strided'}")
        return buf.data_ptr(), buf.numel() * buf.element_size(), buf
    arr = np.frombuffer(buf, dtype=np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("aio: a read needs a writable buffer")
    return arr.ctypes.data, arr.nbytes, (buf, arr)


class AsyncIOHandle:
    """Thread-pooled async file IO; buffers stay alive until :meth:`wait`."""

    def __init__(self, num_threads=4):
        self._lib = _library()
        self._h = self._lib.dst_aio_create(int(num_threads))
        self._live_buffers = []

    def close(self):
        if self._h is not None:
            self.wait()
            self._lib.dst_aio_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def async_pwrite(self, data, path, fsync=True):
        """Submit a whole-file write of ``data`` (a CPU tensor or bytes-like)."""
        addr, nbytes, keep = _address(data, writable=False)
        self._live_buffers.append(keep)
        self._lib.dst_aio_pwrite(self._h, str(path).encode(), addr, nbytes,
                                 1 if fsync else 0)
        CALLS["aio_pwrite"] += 1

    def async_pwrite_fd(self, data, fd):
        """Submit a write of ``data`` from offset 0 of the open descriptor
        ``fd``: only the bytes; its fsync, close and rename stay the
        caller's, after :meth:`wait`."""
        addr, nbytes, keep = _address(data, writable=False)
        self._live_buffers.append(keep)
        self._lib.dst_aio_pwrite_fd(self._h, int(fd), addr, nbytes)
        CALLS["aio_pwrite"] += 1

    def async_pread(self, buffer, path):
        """Submit a whole-file read into ``buffer`` (a contiguous CPU tensor
        or a writable bytes-like object of the file's size)."""
        addr, nbytes, keep = _address(buffer, writable=True)
        self._live_buffers.append(keep)
        self._lib.dst_aio_pread(self._h, str(path).encode(), addr, nbytes)
        CALLS["aio_pread"] += 1

    def read_bytes(self, path, nbytes):
        """Read ``nbytes`` of ``path`` into a new ``bytearray`` (waits for
        the whole queue); raises ``OSError`` with the request's errno."""
        buf = bytearray(nbytes)
        self.async_pread(buf, path)
        rc = self.wait()
        if rc != 0:
            raise OSError(-rc, f"async read of {path} failed", str(path))
        return buf

    def wait(self):
        """Block until the queue drains; 0 on success, -errno on failure."""
        rc = self._lib.dst_aio_wait(self._h)
        self._live_buffers.clear()
        return rc

    @property
    def pending(self):
        return self._lib.dst_aio_pending(self._h)
