"""The optimizer state's host and NVMe tiers (counterpart of
``deeperspeed_tpu/runtime/swap_tensor.py``).

``offload_optimizer.device: "cpu"``: each rank's fp32 masters and optimizer
state live in pinned host memory between steps (:func:`pin_into_one`
re-homes a set of tensors into one pinned buffer, in place); for the update
:class:`DeviceCopies` makes a device copy of each host buffer (one copy a
buffer), the engine's device update runs on those, and
:meth:`DeviceCopies.write_back` copies them back (``non_blocking``, one
sync).  ``"nvme"`` adds :class:`OptimizerStateSwapper`: between steps the
optimizer state goes to files on ``nvme_path`` through the native aio pool
(``ops/aio``).  The engine submits the swap-in's reads at the start of a
step (:meth:`OptimizerStateSwapper.prefetch`), so they run on the pool's
threads while the card computes the gradients, and waits for them before
the update (:meth:`swap_in`).  ``pipeline_write`` (the default) leaves the
swap-out's fsync'd writes in flight until the next swap-in waits for them,
keeping the host copy alive meanwhile (the aio pool holds the buffers until
its wait), so that swap-in reads nothing; ``pipeline_write: false`` waits
inside the swap-out and then frees the host memory, so that the state is
durably on disk between steps and the next swap-in reads it back.

Each swapper owns a subdirectory of its own under the swap directory (two
engines sharing an ``nvme_path`` never clobber each other's files), removed
by :meth:`OptimizerStateSwapper.close` (the engine's ``destroy()``) or, at
the latest, by a finalizer.  The native library is required: without it
the swapper raises, with no Python file IO in its place.
"""

import os
import shutil
import tempfile
import time
import weakref

import torch


def pin_into_one(tensors, pin):
    """Move ``tensors`` (CPU tensors of one dtype) into one new host buffer,
    pinned when ``pin``, in place: each tensor object keeps its identity,
    shape and strides and now views the buffer.  Returns the buffer (1-D)."""
    tensors = list(tensors)
    total = sum(t.numel() for t in tensors)
    home = torch.empty(total, dtype=tensors[0].dtype if tensors else torch.float32,
                       pin_memory=pin)
    off = 0
    for t in tensors:
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError("pin_into_one: contiguous CPU tensors only")
        n = t.numel()
        home[off:off + n].copy_(t.reshape(-1))
        t.set_(home.untyped_storage(), off, t.shape, t.stride())
        off += n
    return home


def _base(t):
    """A 1-D tensor over the whole storage of ``t``."""
    storage = t.untyped_storage()
    n = storage.nbytes() // t.element_size()
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(storage, 0, (n,))


class DeviceCopies:
    """Device copies of host tensors for one update: :meth:`__call__` gives
    a tensor's copy (a view, at the same offset and strides, of a device
    copy of its whole host buffer, made once per buffer), :meth:`tree` the
    copies of a nested state, :meth:`host` maps copies back to the host
    tensors, and :meth:`write_back` copies every device buffer to its host
    buffer.  ``h2d_bytes`` / ``d2h_bytes`` count what moved."""

    def __init__(self, device):
        self.device = device
        self._bases = {}        # host storage address -> (host base, device base)
        self._host_of = {}      # id(device view) -> host tensor
        self.h2d_bytes = self.d2h_bytes = 0

    def __call__(self, t):
        key = t.untyped_storage().data_ptr()
        if key not in self._bases:
            host = _base(t)
            self._bases[key] = (host, host.to(self.device, non_blocking=True))
            self.h2d_bytes += host.numel() * host.element_size()
        dev = self._bases[key][1].as_strided(t.shape, t.stride(), t.storage_offset())
        self._host_of[id(dev)] = t
        return dev

    def tree(self, tree):
        """``tree`` (dicts, lists, tuples of tensors and other leaves) with
        each tensor replaced by its device copy."""
        if isinstance(tree, torch.Tensor):
            return self(tree)
        if isinstance(tree, dict):
            return {k: self.tree(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.tree(v) for v in tree)
        return tree

    def host(self, tree):
        """The inverse of :meth:`tree` on a state that an update returned:
        each device copy back to its host tensor (an update rewrites its
        state in place, so every tensor in it is a copy made here)."""
        if isinstance(tree, torch.Tensor):
            if id(tree) not in self._host_of:
                raise RuntimeError("offload: the update made a new state tensor; "
                                   "the host tier keeps the state in place")
            return self._host_of[id(tree)]
        if isinstance(tree, dict):
            return {k: self.host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.host(v) for v in tree)
        return tree

    def write_back(self):
        """Copy every device buffer back to its host buffer, one sync."""
        for host, dev in self._bases.values():
            host.copy_(dev, non_blocking=True)
            self.d2h_bytes += host.numel() * host.element_size()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._bases.clear()
        self._host_of.clear()


class OptimizerStateSwapper:
    """Whole-state swap of host buffers (contiguous CPU tensors) through the
    native aio pool of ``num_threads`` threads: each buffer is cut into
    ``num_threads`` contiguous pieces, a file each, so that every thread of
    the pool writes and reads."""

    def __init__(self, swap_dir, num_threads=4, pipeline_write=True):
        from ..ops.aio import AsyncIOHandle

        os.makedirs(swap_dir, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="engine_", dir=swap_dir)
        self.pipeline_write = pipeline_write
        # the files are scratch state: reclaim the directory when the swapper
        # is collected or the interpreter exits, if close() did not
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, ignore_errors=True)
        self._handle = AsyncIOHandle(num_threads)
        self._handle_threads = max(1, int(num_threads))
        self._tensors = None        # the buffers swapped out
        self._nbytes = []
        self._write_pending = False
        self._released = False      # host memory freed (pipeline_write false)
        self._read_started = None   # host clock of the prefetch's submission
        self.stats = {"bytes_written": 0, "bytes_read": 0, "write_s": 0.0,
                      "write_wait_s": 0.0, "read_s": 0.0, "read_wait_s": 0.0,
                      "read_hidden_s": 0.0}

    @property
    def swapped_out(self):
        return self._tensors is not None

    def _path(self, i):
        return os.path.join(self.dir, f"opt_piece_{i}.bin")

    def _pieces(self):
        """The buffers' pieces, in file order (views: made anew after a
        release re-allocates the buffers)."""
        return [piece for t in self._tensors
                for piece in torch.tensor_split(t.view(-1), self._handle_threads)]

    def _wait(self, what):
        rc = self._handle.wait()
        if rc != 0:
            raise OSError(-rc, f"optimizer swap {what} failed: {os.strerror(-rc)}")

    def swap_out(self, tensors):
        """Submit an fsync'd write of each buffer; with ``pipeline_write``
        return at once (the buffers stay alive until the next swap-in),
        else wait for the writes and free the buffers' host memory."""
        self._tensors = list(tensors)
        self._nbytes = [t.numel() * t.element_size() for t in self._tensors]
        t0 = time.perf_counter()
        for i, piece in enumerate(self._pieces()):
            self._handle.async_pwrite(piece, self._path(i), fsync=True)
        self.stats["bytes_written"] += sum(self._nbytes)
        self._write_pending = True
        if not self.pipeline_write:
            self._wait("write")
            self._write_pending = False
            self.stats["write_s"] += time.perf_counter() - t0
            for t in self._tensors:
                t.untyped_storage().resize_(0)
            self._released = True

    def prefetch(self):
        """Start reading a released state back into its (re-allocated)
        buffers, on the pool's threads; a no-op when nothing is released
        or the reads already run."""
        if not (self.swapped_out and self._released) or self._read_started is not None:
            return
        self._read_started = time.perf_counter()
        for t, n in zip(self._tensors, self._nbytes):
            t.untyped_storage().resize_(n)
        for i, piece in enumerate(self._pieces()):
            self._handle.async_pread(piece, self._path(i))
        self.stats["bytes_read"] += sum(self._nbytes)

    def swap_in(self):
        """Make the state resident: wait for a pipelined swap-out's writes
        (the buffers were kept, so nothing is read), or for the reads of
        :meth:`prefetch` (started here if it was not called)."""
        if not self.swapped_out:
            return
        t0 = time.perf_counter()
        if self._write_pending:
            self._wait("write")
            self._write_pending = False
            self.stats["write_wait_s"] += time.perf_counter() - t0
        if self._released:
            self.prefetch()
            self._wait("read")
            t1 = time.perf_counter()
            self.stats["read_s"] += t1 - self._read_started
            self.stats["read_wait_s"] += t1 - t0
            self.stats["read_hidden_s"] += max(0.0, t0 - self._read_started)
            self._read_started = None
            self._released = False
        self._tensors = None

    def close(self):
        if self._handle is not None:
            self._handle.close()
            self._handle = None
        self._cleanup()      # remove the swap directory now
