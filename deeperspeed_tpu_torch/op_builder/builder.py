"""Build and load a native host library (counterpart of
``deeperspeed_tpu/op_builder/builder.py``).

A builder compiles its C++ sources under ``deeperspeed_tpu_torch/csrc/host``
with the system ``g++`` on ``PATH`` (``$CXX`` only without one), ``-O3
-march=native -fopenmp -shared -fPIC -std=c++17`` (the JAX builder's
flags), into ``.build/torch_kernels/`` at the repository root and binds the
library with ``ctypes``.  The library is named
by a hash of its sources, the flags, the compiler and the host CPU (whose
instructions ``-march=native`` picks), so an edited source is rebuilt and a
library built on another machine is never loaded.  Each process compiles to
a temporary name of its own and then renames it into place, so concurrent
processes never load half a file.  Nothing builds at import time, and a
failed build raises: no path falls back to a plain version.

:data:`CALLS` counts the calls each wrapper makes into a library, by
routine, as ``ops/cuda_utils.py`` ``LAUNCHES`` counts kernel launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / "torch_kernels"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

# native calls per routine; a caller sets them to 0 with CALLS.clear()
CALLS = Counter()

_LOCK = threading.Lock()


def _host_identity():
    """What ``-march=native`` depends on: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return os.uname().machine


class OpBuilder:
    """Compile-and-load of one native library (a C ABI ``.so``)."""

    NAME = "base"
    _cache = {}

    def sources(self):
        """Source file names under ``csrc/host``."""
        raise NotImplementedError

    def extra_compile_args(self):
        return []

    def compiler(self):
        # the system g++ first: a ``$CXX`` may name a compiler installed
        # without OpenMP (no libgomp spec file), which -fopenmp needs
        return shutil.which("g++") or os.environ.get("CXX") or shutil.which("clang++")

    def _cmd(self, out):
        return [self.compiler(), *CXX_FLAGS, *self.extra_compile_args(),
                *(str(CSRC / s) for s in self.sources()), "-o", str(out)]

    def target(self):
        h = hashlib.sha256()
        for s in self.sources():
            h.update((CSRC / s).read_bytes())
        h.update(" ".join(self._cmd("")).encode())
        h.update(_host_identity().encode())
        return BUILD_DIR / f"lib{self.NAME}-{h.hexdigest()[:16]}.so"

    def build(self):
        """Compile the sources unless built; returns the library's path."""
        if self.compiler() is None:
            raise RuntimeError(f"{self.NAME}: no C++ compiler (g++ or clang++) on PATH")
        target = self.target()
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(self._cmd(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build of {self.NAME} failed (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, target)   # atomic: a concurrent loader never sees half a file
        return target

    def load(self):
        """The bound ``ctypes`` library, built if needed (once a process)."""
        with _LOCK:
            lib = OpBuilder._cache.get(self.NAME)
            if lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                OpBuilder._cache[self.NAME] = lib
        return lib

    def _declare(self, lib):
        """Set argtypes / restype on the library's functions."""
