"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its kernel wrappers launch their own kernels on CUDA tensors, and
chip_smoke.py refuses to run without a card."""

import importlib
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deeperspeed_tpu_torch.accelerator.cuda_accelerator import CudaAccelerator
from deeperspeed_tpu_torch.ops.adam import fused_adam
from deeperspeed_tpu_torch.ops.attention import flash, paged
from deeperspeed_tpu_torch.ops.lion import fused_lion
from deeperspeed_tpu_torch.ops.quantizer import fused
from deeperspeed_tpu_torch.ops.sampling import topk
import torch_threads  # noqa: F401  (torch at one intra-op thread)
# the package exports the function under the module's name
sparse_attention = importlib.import_module(
    "deeperspeed_tpu_torch.ops.sparse_attention.sparse_attention")
from deeperspeed_tpu_torch.ops.transformer import activations, normalize, softmax

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "deeperspeed_tpu_torch"


def _run(code_or_args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    args = code_or_args if isinstance(code_or_args, list) \
        else [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_no_jax():
    out = _run(
        "import sys\n"
        "import deeperspeed_tpu_torch, deeperspeed_tpu_torch.inference.v2\n"
        "import deeperspeed_tpu_torch.models, deeperspeed_tpu_torch.runtime.engine\n"
        "import deeperspeed_tpu_torch.ops.attention.flash\n"
        "import deeperspeed_tpu_torch.utils.tree\n"
        "import deeperspeed_tpu_torch.quantization\n"
        "import deeperspeed_tpu_torch.ops.quantizer\n"
        "import deeperspeed_tpu_torch.telemetry.trace\n"
        "import deeperspeed_tpu_torch.telemetry.serving\n"
        "import deeperspeed_tpu_torch.inference.v2.scheduler\n"
        "import deeperspeed_tpu_torch.inference.v2.speculative\n"
        "import deeperspeed_tpu_torch.ops.adam, deeperspeed_tpu_torch.ops.lion\n"
        "import deeperspeed_tpu_torch.ops.multi_tensor\n"
        "import deeperspeed_tpu_torch.runtime.dataloader\n"
        "import deeperspeed_tpu_torch.runtime.progressive_layer_drop\n"
        "import deeperspeed_tpu_torch.runtime.data_pipeline\n"
        "import deeperspeed_tpu_torch.runtime.data_pipeline.data_routing\n"
        "import deeperspeed_tpu_torch.runtime.data_pipeline.data_sampling\n"
        "import deeperspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_analyzer\n"
        "import deeperspeed_tpu_torch.comm, deeperspeed_tpu_torch.comm.compressed\n"
        "import deeperspeed_tpu_torch.comm.comms_logging, deeperspeed_tpu_torch.comm.overlap\n"
        "import deeperspeed_tpu_torch.telemetry.wire\n"
        "import deeperspeed_tpu_torch.parallel, deeperspeed_tpu_torch.ops.quantizer.fused\n"
        "import deeperspeed_tpu_torch.runtime.zero.sharding\n"
        "import deeperspeed_tpu_torch.runtime.zero.stage3\n"
        "import deeperspeed_tpu_torch.runtime.zero.quantized\n"
        "import deeperspeed_tpu_torch.utils.recompute\n"
        "import deeperspeed_tpu_torch.ops.transformer.activations\n"
        "import deeperspeed_tpu_torch.ops.transformer.softmax\n"
        "import deeperspeed_tpu_torch.ops.transformer.transformer\n"
        "import deeperspeed_tpu_torch.ops.sparse_attention\n"
        "import deeperspeed_tpu_torch.ops.sparse_attention.sparsity_config\n"
        "import deeperspeed_tpu_torch.checkpoint, deeperspeed_tpu_torch.checkpoint.msgpack_codec\n"
        "import deeperspeed_tpu_torch.checkpoint.zero_to_fp32\n"
        "import deeperspeed_tpu_torch.runtime.checkpointing\n"
        "import deeperspeed_tpu_torch.runtime.checkpoint_engine\n"
        "import deeperspeed_tpu_torch.parallel.tensor_parallel\n"
        "import deeperspeed_tpu_torch.runtime.zero.tiling\n"
        "import deeperspeed_tpu_torch.runtime.initialize\n"
        "import deeperspeed_tpu_torch.moe, deeperspeed_tpu_torch.moe.sharded_moe\n"
        "import deeperspeed_tpu_torch.moe.experts, deeperspeed_tpu_torch.moe.layer\n"
        "import deeperspeed_tpu_torch.moe.mappings\n"
        "import deeperspeed_tpu_torch.models.llama, deeperspeed_tpu_torch.inference\n"
        "import deeperspeed_tpu_torch.inference.engine, deeperspeed_tpu_torch.inference.config\n"
        "import deeperspeed_tpu_torch.inference.params\n"
        "import deeperspeed_tpu_torch.inference.quantization\n"
        "import deeperspeed_tpu_torch.op_builder, deeperspeed_tpu_torch.ops.aio\n"
        "import deeperspeed_tpu_torch.ops.adam.cpu_adam\n"
        "import deeperspeed_tpu_torch.runtime.swap_tensor\n"
        "import deeperspeed_tpu_torch.runtime.zero.infinity\n"
        "import deeperspeed_tpu_torch.comm.memplan\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack',\n"
        "                                                   'deeperspeed_tpu')]\n"
        "print('LOADED', bad)")
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


BANNED = [
    (re.compile(r"^\s*(import|from)\s+(jax|flax|msgpack)\b", re.M), "imports JAX"),
    (re.compile(r"^\s*(import|from)\s+deeperspeed_tpu(\.|\s)", re.M),
     "imports the JAX package"),
    (re.compile(r"scaled_dot_product_attention"), "names a library attention"),
    (re.compile(r"torch\.compile"), "uses torch.compile"),
]


def test_port_sources_are_clean():
    files = [p for p in PACKAGE.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert len(files) > 20
    for path in files:
        text = path.read_text()
        for pattern, why in BANNED:
            assert not pattern.search(text), f"{path.relative_to(ROOT)} {why}"


def test_chip_smoke_and_tools_import_no_jax():
    """chip_smoke.py and the port's tools may name the library yardsticks
    they time, but import nothing of JAX or of the JAX package."""
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("torch_*.py"))]
    assert len(files) >= 3 and ROOT / "tools" / "torch_offload_phase.py" in files
    for path in files:
        text = path.read_text()
        for pattern, why in BANNED[:2]:
            assert not pattern.search(text), f"{path.relative_to(ROOT)} {why}"


@pytest.mark.parametrize("fn,kernel", [
    (normalize._ln_cuda, "layer_norm"),
    (normalize._ln_bwd_cuda, "layer_norm_bwd"),
    (flash._fwd_cuda, "flash_fwd"),
    (flash._dq_cuda, "flash_bwd_dq"),
    (flash._dkv_cuda, "flash_bwd_dkv"),
    (paged._decode_cuda, "paged_decode"),
    (paged._spec_decode_cuda, "paged_spec_decode"),
    (paged._decode_cuda, "paged_decode_q"),
    (paged._spec_decode_cuda, "paged_spec_decode_q"),
    (topk._topk_cuda, "sorted_topk"),
    (fused_adam._adam_cuda, "fused_adam"),
    (fused_lion._lion_cuda, "fused_lion"),
    (fused._dequant_reduce_cuda, "dequant_reduce"),
    (activations._gelu_cuda, "gelu_fwd"),
    (activations._dgelu_cuda, "gelu_bwd"),
    (sparse_attention._fwd_cuda, "sparse_fwd"),
    (sparse_attention._dq_cuda, "sparse_bwd_dq"),
    (sparse_attention._dkv_cuda, "sparse_bwd_dkv"),
])
def test_cuda_branch_launches_its_own_kernel(fn, kernel):
    """Each wrapper's CUDA branch calls its ctypes launch, counts it, and
    reaches for no library operator or plain version."""
    src = inspect.getsource(fn)
    assert "library(" in src and f'check(err, "{kernel}")' in src
    for banned in ("torch.nn.functional", "F.", "torch.topk", "torch.sort",
                   "softmax", "einsum", "_reference", "_ref(", "matmul",
                   "scaled_dot_product", "_plain", "_foreach", "torch.optim"):
        assert banned not in src, f"{fn.__name__} uses {banned}"


@pytest.mark.parametrize("fn,kernel", [(softmax._fwd_cuda, "softmax_fwd"),
                                       (softmax._bwd_cuda, "softmax_bwd")])
def test_softmax_cuda_branch_launches_its_own_kernel(fn, kernel):
    """B8's CUDA branch (its library is named ``softmax``, so the word
    itself is not banned here): its own launch, no library softmax."""
    src = inspect.getsource(fn)
    assert "library(" in src and f'check(err, "{kernel}")' in src
    for banned in ("torch.nn.functional", "F.", "torch.softmax", ".softmax(",
                   "_softmax_backward_data", "_ref(", "exp(", "einsum", "_plain"):
        assert banned not in src, f"{fn.__name__} uses {banned}"


@pytest.mark.parametrize("call,plain", [
    (lambda: activations.gelu_tanh(torch.ones(4, requires_grad=True)).sum().backward(),
     (activations, "_gelu_ref")),
    (lambda: softmax.fused_softmax(torch.ones(2, 4)), (softmax, "_softmax_ref")),
    (lambda: sparse_attention.sparse_attention(*[torch.ones(1, 32, 1, 16)] * 3,
                                               [[1, 1], [1, 1]]),
     (sparse_attention, "_fwd_reference")),
])
def test_new_wrappers_on_cuda_launch_or_raise(monkeypatch, call, plain):
    """Where the accelerator runs the kernels, B8, B9 and B10 go to their
    CUDA branch, which launches or raises (here: the tensors are not on a
    card); they never fall back to the plain version."""
    module, name = plain
    calls = []
    monkeypatch.setattr(module, "get_accelerator", lambda device=None: CudaAccelerator())
    monkeypatch.setattr(module, name, lambda *a: calls.append(a))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        call()
    assert not calls


@pytest.mark.parametrize("module,step,plain,args", [
    (fused_adam, "fused_adam_", "_adam_leaf_update_plain", 4),
    (fused_lion, "fused_lion_", "_lion_leaf_plain", 2),
])
def test_fused_optimizers_on_cuda_launch_or_raise(monkeypatch, module, step, plain, args):
    """Where the accelerator runs the kernels, the fused optimizers go to
    their CUDA branch, which launches or raises (here: the tensors are not
    on a card); they never fall back to the plain version."""
    calls = []
    monkeypatch.setattr(module, "get_accelerator", lambda device=None: CudaAccelerator())
    monkeypatch.setattr(module, plain, lambda *a, **k: calls.append(a))
    tensors = [[torch.full((5,), 3.0)]] + [[torch.ones(5)] for _ in range(args // 2)]
    extra = (1,) if args == 4 else ()
    with pytest.raises(ValueError, match="not on a CUDA device"):
        getattr(module, step)(*tensors, *extra)
    assert not calls
    monkeypatch.undo()
    getattr(module, step)(*tensors, *extra)        # a CPU tensor takes the plain version
    assert float(tensors[1][0][0]) != 1.0          # the moment moved


def test_dequant_reduce_on_cuda_launches_or_raises(monkeypatch):
    """Where the accelerator runs the kernels, B5's wrapper goes to its CUDA
    branch, which launches or raises (here: the tensors are not on a card);
    it never falls back to the plain version."""
    from deeperspeed_tpu_torch.quantization import BlockScaledTensor

    t = BlockScaledTensor.quantize(torch.randn(2, 4, 128), "int8", 128)
    calls = []
    monkeypatch.setattr(fused, "get_accelerator", lambda device=None: CudaAccelerator())
    monkeypatch.setattr(fused, "_dequant_reduce_plain", lambda *a: calls.append(a))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fused.fused_dequant_reduce(t)
    assert not calls
    monkeypatch.undo()
    assert fused.fused_dequant_reduce(t).shape == (4, 128)   # CPU: the plain version


def test_chip_smoke_needs_the_card_and_the_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run([sys.executable, str(ROOT / "chip_smoke.py")])
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = _run([sys.executable, str(alone)], cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_host_routines_call_their_native_libraries(monkeypatch, tmp_path):
    """The CPU Adam wrapper calls the native library of
    ``csrc/host/cpu_adam.cpp`` (and no plain version); the aio handle
    submits to its own pool of ``csrc/host/aio.cpp``.  Neither builds at
    import; each counts its calls."""
    from deeperspeed_tpu_torch import op_builder
    from deeperspeed_tpu_torch.ops.adam import cpu_adam
    from deeperspeed_tpu_torch.ops.aio import aio_handle

    for fn, routine in ((cpu_adam.cpu_adam_step_, "dst_cpu_adam_step"),
                        (cpu_adam.cpu_adagrad_step_, "dst_cpu_adagrad_step"),
                        (cpu_adam.cpu_lion_step_, "dst_cpu_lion_step")):
        src = inspect.getsource(fn)
        assert f"_library().{routine}(" in src and "CALLS[" in src
        assert "_plain" not in src and "torch." not in src.split('"""')[-1]
    for method, routine in (("async_pwrite", "dst_aio_pwrite"),
                            ("async_pwrite_fd", "dst_aio_pwrite_fd"),
                            ("async_pread", "dst_aio_pread")):
        src = inspect.getsource(getattr(aio_handle.AsyncIOHandle, method))
        assert f"self._lib.{routine}(self._h" in src and "open(" not in src
    calls = []
    real = cpu_adam._library

    def spy():
        lib = real()
        calls.append(lib)
        return lib

    monkeypatch.setattr(cpu_adam, "_library", spy)
    p, m, v = torch.ones(5), torch.zeros(5), torch.zeros(5)
    op_builder.CALLS.clear()
    cpu_adam.cpu_adam_step_(p, torch.ones(5), m, v, 0.1, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001,
                            True)
    assert len(calls) == 1 and op_builder.CALLS["cpu_adam"] == 1 and float(p[0]) < 1.0
    h = aio_handle.AsyncIOHandle(num_threads=1)
    assert h._lib is aio_handle._library()
    h.async_pwrite(b"x", str(tmp_path / "x.bin"))
    assert h.wait() == 0 and op_builder.CALLS["aio_pwrite"] == 1
    h.close()
    src = (PACKAGE / "op_builder" / "builder.py").read_text()
    assert ".tmp" in src and "os.getpid()" in src and "os.replace" in src
