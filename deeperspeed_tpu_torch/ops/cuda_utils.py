"""Build, load and launch the hand-written Hopper kernels (``csrc/*.cu``).

Counterpart of ``deeperspeed_tpu/ops/pallas_utils.py``: the one place that
knows how a kernel reaches the device.  Each ``csrc/<name>.cu`` is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, at first use, into ``.build/torch_kernels/`` at the repository
root, and loaded with ``ctypes``.  Libraries are named by a hash of their
sources and flags, so an edited kernel is rebuilt and a built one reused.
Nothing here runs at import time: this module imports on a machine with no
CUDA toolkit, where the wrappers take their plain PyTorch versions for CPU
tensors and never reach the build.

Every wrapper counts its launches in :data:`LAUNCHES` (a plain integer per
kernel), so a run can show that its main path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

# masking sentinel of the TPU kernels (finite: -inf breaks the exp/max algebra)
NEG_INF = -1e30

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel wrapper; a caller sets them to 0 with LAUNCHES.clear()
LAUNCHES = Counter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_vp, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signature of every exported function, per source file
_SIGNATURES = {
    "layer_norm": {
        "dst_layer_norm_fwd": ([_vp, _vp, _vp, _vp, _i, _i, _f, _i, _i, _i,
                                _vp], _i),
        "dst_layer_norm_bwd": ([_vp] * 7 + [_i, _i, _f, _i, _i, _i, _i, _vp],
                               _i),
    },
    "flash_attention": {
        "dst_flash_fwd": ([_vp] * 5 + [_i] * 6 + [_vp], _i),
        "dst_flash_bwd_dq": ([_vp] * 7 + [_i] * 6 + [_vp], _i),
        "dst_flash_bwd_dkv": ([_vp] * 8 + [_i] * 6 + [_vp], _i),
    },
    "paged_attention": {
        "dst_paged_decode": ([_vp] * 8 + [_i] * 5 + [_f, _i, _i, _vp], _i),
        "dst_paged_spec_decode": ([_vp] * 8 + [_i] * 6 + [_f, _i, _i, _vp],
                                  _i),
    },
    "topk": {
        "dst_sorted_topk": ([_vp, _vp, _vp, _i, _i, _i, _vp], _i),
    },
    "fused_optimizers": {
        "dst_fused_adam": ([_vp, _i, _ll] + [_f] * 7 + [_vp], _i),
        "dst_fused_lion": ([_vp, _i, _ll] + [_f] * 4 + [_vp], _i),
    },
    "dequant_reduce": {
        "dst_dequant_reduce": ([_vp, _vp, _vp, _i, _ll, _ll, _ll, _i, _vp], _i),
    },
    "activations": {
        "dst_gelu_fwd": ([_vp, _vp, _ll, _i, _vp], _i),
        "dst_gelu_bwd": ([_vp, _vp, _vp, _ll, _i, _vp], _i),
    },
    "softmax": {
        "dst_softmax_fwd": ([_vp, _vp, _ll, _i, _f, _i, _vp], _i),
        "dst_softmax_bwd": ([_vp, _vp, _vp, _ll, _i, _f, _i, _vp], _i),
    },
    "sparse_attention": {
        "dst_sparse_fwd": ([_vp] * 6 + [_i] * 7 + [_f, _i, _vp], _i),
        "dst_sparse_bwd_dq": ([_vp] * 8 + [_i] * 7 + [_f, _i, _vp], _i),
        "dst_sparse_bwd_dkv": ([_vp] * 9 + [_i] * 7 + [_f, _i, _vp], _i),
    },
}

_loaded = {}


def dtype_code(dtype):
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32, bfloat16 or float16, not {dtype}")
    return _DTYPE_CODES[dtype]


def _nvcc():
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _target(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None):
    """Compile the named kernel sources (all of ``_SIGNATURES`` by default),
    one ``nvcc`` process each, all started together.  Already built
    libraries are skipped.  Returns ``{name: (seconds, compiler log)}``;
    raises if any compile fails."""
    names = list(_SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, jobs, logs = _nvcc(), {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            logs[name] = (0.0, "cached")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = (time.perf_counter() - t0, out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build([name])
        lib = ctypes.CDLL(str(target))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def stream_of(t):
    """PyTorch's current stream on ``t``'s (CUDA) device, as the raw
    ``cudaStream_t`` handle (an int, which ``ctypes`` passes as a pointer).
    Reads the handle without building a ``torch.cuda.Stream`` object, as
    PyTorch's own kernel launchers do."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t):
    """``t``'s data pointer, an int that ``ctypes`` passes as a pointer."""
    return t.data_ptr()


def check(err, kernel):
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1


def require_cuda(kernel, *tensors, dtype=None):
    """Validate what a kernel takes: every tensor on one CUDA device and
    contiguous; ``dtype``, when given, shared by all of them."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {dev}, not on a CUDA device")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{kernel}: expected {dtype}, got {t.dtype}")
