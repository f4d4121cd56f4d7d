"""Checkpoint storage engines with a transactional commit protocol
(counterpart of ``deeperspeed_tpu/runtime/checkpoint_engine/
checkpoint_engine.py``, pure Python, kept as the port's own copy).

``NativeCheckpointEngine`` writes bytes with atomic file IO;
``AsyncCheckpointEngine`` hands the writes to a background thread pool so
the step loop is not blocked on disk, and ``commit(tag)`` is the barrier
that makes a tag durable before the ``latest`` pointer moves.  (The JAX
package's async engine can also route through its native AIO module; the
port writes from the thread pool only.)

Durability protocol: ``create(tag)`` opens a transaction; every ``save()``
goes tmp + fsync + rename and records the payload's sha256;
``commit(tag)`` writes a ``manifest.json`` listing every artifact's
checksum (itself tmp + fsync + rename), then reads each file back and
verifies it against the recorded digest.  A tag directory without a
verifying manifest is not committed: the load path
(``runtime/checkpointing.py``) treats it as corrupt and walks back to the
newest valid tag.

All byte-level IO goes through the module-level ``_io_open`` /
``_io_fsync`` / ``_io_replace`` seam, so a fault-injection harness can
inject torn writes, EIO, bit flips and mid-save kills without touching the
code under test.  A payload is any bytes-like object (the codec's encoder
returns a ``memoryview``); reads return a ``bytearray``, which the decoder
views without copying.
"""

import concurrent.futures
import hashlib
import json
import os
import time

from ...utils.logging import logger

MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 1

# fault-injection seam: a test harness swaps these to inject deterministic
# storage faults; production behavior is the plain builtins
_io_open = open
_io_fsync = os.fsync
_io_replace = os.replace


def _fsync_dir(path):
    """fsync the directory so a rename is durable across power loss (no-op
    where directories can't be opened, e.g. some network filesystems)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        _io_fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(data, path):
    """tmp + fsync + rename + dir-fsync: the file at ``path`` is either the
    old content or the complete new content, never a torn prefix."""
    tmp = path + ".tmp"
    f = _io_open(tmp, "wb")
    try:
        f.write(data)
        f.flush()
        _io_fsync(f.fileno())
    finally:
        f.close()
    _io_replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def read_file_bytes(path):
    """The file's bytes in a ``bytearray`` (writable, so arrays decoded
    from it are views a tensor can wrap without a copy)."""
    with _io_open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = bytearray(size)
        n = f.readinto(buf) if size else 0
        if n != size:
            raise OSError(f"short read of {path}: {n} of {size} bytes")
        return buf


def file_sha256(path, chunk_bytes=1 << 22):
    h = hashlib.sha256()
    with _io_open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def read_manifest(ckpt_dir):
    """The tag's commit record, or None when the tag was never committed
    (interrupted save, or a legacy pre-manifest checkpoint)."""
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.isfile(path):
        return None
    try:
        return json.loads(read_file_bytes(path).decode())
    except (OSError, ValueError) as e:
        logger.warning(f"[ckpt] unreadable manifest {path}: {e}")
        return None


def verify_manifest(ckpt_dir, manifest=None):
    """Recompute every artifact's checksum against the manifest.

    Returns ``(ok, errors)``; ``errors`` names each missing/mismatched file
    so a corrupt tag is diagnosed, not just rejected."""
    if manifest is None:
        manifest = read_manifest(ckpt_dir)
    if manifest is None:
        return False, [f"no {MANIFEST_FILE} in {ckpt_dir} (tag not committed)"]
    errors = []
    for name, entry in manifest.get("files", {}).items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.isfile(path):
            errors.append(f"{name}: missing")
            continue
        size = os.path.getsize(path)
        if entry.get("bytes") is not None and size != entry["bytes"]:
            errors.append(f"{name}: size {size} != recorded {entry['bytes']}")
            continue
        try:
            digest = file_sha256(path)
        except OSError as e:
            errors.append(f"{name}: unreadable ({e})")
            continue
        if digest != entry.get("sha256"):
            errors.append(f"{name}: sha256 {digest[:12]}... != recorded "
                          f"{str(entry.get('sha256'))[:12]}...")
    return not errors, errors


class CheckpointEngine:
    """ABC: byte-level storage for checkpoint artifacts.

    Subclasses implement the write transport; the transaction bookkeeping
    (per-save checksum record -> verified manifest commit) is shared here.
    """

    def __init__(self, config_params=None):
        self.config_params = config_params
        self._txn = {}        # abspath -> (sha256, nbytes) for the open tag
        self.commit_info = {}  # stats of the last commit (bytes, verify time)

    def create(self, tag):
        """Start a checkpoint under ``tag`` (opens the transaction)."""
        self._txn = {}

    def makedirs(self, path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)

    def _record(self, data, path):
        self._txn[os.path.abspath(path)] = (
            hashlib.sha256(data).hexdigest(), len(data))

    def save(self, data: bytes, path: str):
        raise NotImplementedError

    def load(self, path: str) -> bytes:
        return read_file_bytes(path)

    def commit(self, tag) -> bool:
        """Make ``tag`` durable; must complete before 'latest' is updated."""
        raise NotImplementedError

    def _commit_manifest(self, tag):
        """Write the manifest for every artifact saved since ``create(tag)``,
        then read each file back and verify its checksum.  True only when
        every byte that was handed to ``save()`` is provably on disk."""
        txn, self._txn = self._txn, {}
        if not txn:
            return True  # nothing written (e.g. a non-writer process)
        dirs = {os.path.dirname(p) for p in txn}
        if len(dirs) != 1:
            logger.error(f"[ckpt] tag {tag} spans {len(dirs)} directories; "
                         "refusing to commit a split transaction")
            return False
        ckpt_dir = dirs.pop()
        files = {os.path.basename(p): {"sha256": h, "bytes": n}
                 for p, (h, n) in txn.items()}
        t0 = time.perf_counter()
        try:
            atomic_write_bytes(
                json.dumps({"version": MANIFEST_VERSION, "tag": str(tag),
                            "files": files}, sort_keys=True).encode(),
                os.path.join(ckpt_dir, MANIFEST_FILE))
            ok, errors = verify_manifest(ckpt_dir)
        except OSError as e:
            ok, errors = False, [f"manifest write failed: {e}"]
        self.commit_info = {
            "verify_seconds": time.perf_counter() - t0,
            "bytes": sum(n for _, n in txn.values()),
            "files": len(files),
            "errors": errors,
        }
        if not ok:
            logger.error(f"[ckpt] commit verification FAILED for tag {tag}: "
                         f"{'; '.join(errors)}")
        return ok


class NativeCheckpointEngine(CheckpointEngine):
    """Synchronous atomic file IO."""

    def create(self, tag):
        super().create(tag)
        logger.info(f"[native ckpt] start checkpoint {tag}")

    def save(self, data, path):
        self._record(data, path)
        atomic_write_bytes(data, path)

    def commit(self, tag):
        return self._commit_manifest(tag)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background-thread writes; ``commit`` joins them.

    The step loop hands off host bytes and keeps running; the verified
    manifest commit gives the same durability point the synchronous engine
    does.  A failed commit tears down the thread pool and rebuilds it so no
    wedged writer or leftover future leaks into the next tag's transaction.
    """

    def __init__(self, config_params=None, max_workers=4):
        super().__init__(config_params)
        self._max_workers = max_workers
        self._pending = []
        self._pool = self._make_pool()

    def _make_pool(self):
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=self._max_workers, thread_name_prefix="dst-ckpt")

    def create(self, tag):
        super().create(tag)
        if self._pending:
            # a previous tag's failed commit left work in flight; it must
            # not be mistaken for this tag's writes
            logger.warning(f"[async ckpt] {len(self._pending)} stale writes "
                           "pending at create(); resetting writer pool")
            self._reset_pool()
        logger.info(f"[async ckpt] start checkpoint {tag}")

    def _write(self, data, path):
        atomic_write_bytes(data, path)

    def save(self, data, path):
        self._record(data, path)
        self._pending.append(self._pool.submit(self._write, data, path))

    def commit(self, tag):
        pending, self._pending = self._pending, []
        ok = True
        for fut in concurrent.futures.as_completed(pending):
            exc = fut.exception()
            if exc is not None:
                logger.error(f"[async ckpt] write failed: {exc}")
                ok = False
        if not ok:
            # the pool may hold queued/wedged writes from the failed tag;
            # rebuild it so the next tag starts from a clean transaction
            self._reset_pool()
            self._txn = {}
            return False
        return self._commit_manifest(tag)

    def _reset_pool(self):
        try:
            self._pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        self._pool = self._make_pool()
        self._pending = []


def get_checkpoint_engine(checkpoint_config=None):
    """The storage engine a ``CheckpointConfig`` names: ``writer`` "native"
    (the default) or "async" (``async_save`` is a shorthand for it)."""
    params = getattr(checkpoint_config, "parallel_write", None) or {}
    kind = "native"
    if checkpoint_config is not None:
        kind = getattr(checkpoint_config, "writer", None) or (
            "async" if getattr(checkpoint_config, "async_save", False) else "native")
    if kind == "async":
        return AsyncCheckpointEngine(params)
    if kind != "native":
        raise ValueError(f"unknown checkpoint writer '{kind}' (expected 'native' or 'async')")
    return NativeCheckpointEngine(params)
