"""DeeperSpeedCPUAdam: the optimizer step on the host cores (counterpart of
``deeperspeed_tpu/ops/adam/cpu_adam.py``), over host-resident fp32 state.

With the optimizer state offloaded (``offload_optimizer.host_update``,
ZeRO-Infinity) the update runs in the native library of
``csrc/host/cpu_adam.cpp`` (SIMD loops over every core) instead of on the
card.  :class:`DeeperSpeedCPUAdam` keeps the JAX class's API: ``step(params,
grads, lr=)`` over dicts of tensors by name, updating each parameter in place
(contiguous fp32 CPU tensors, ideally pinned), its moments in ``_moments``
by the same names, the step count in ``t``.  The Adagrad and Lion steps of
the same library are :func:`cpu_adagrad_step_` and :func:`cpu_lion_step_`.

These routines take CPU tensors only and raise on any other; the library is
built at first use, and a failed build raises.  Beside each native step is
its plain PyTorch version (``*_plain``), the same formula with the C++
loop's operations in its order, which the tests hold the library against.
"""

import ctypes

import torch

from ...op_builder.builder import CALLS

_f32p = ctypes.POINTER(ctypes.c_float)
# the gradient types the native Adam reads, by its ``g_bf16`` flag
_ADAM_GRADS = (torch.float32, torch.bfloat16)


def _library():
    from ...op_builder import CPUAdamBuilder

    return CPUAdamBuilder().load()


def cpu_adam_available():
    """True when the native library builds and loads on this host."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(t, what):
    if t.device.type != "cpu":
        raise ValueError(f"{what}: the host routines take CPU tensors, not {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what}: a contiguous float32 tensor is updated in place, "
                         f"got {t.dtype} {'contiguous' if t.is_contiguous() else 'strided'}")
    return ctypes.cast(t.data_ptr(), _f32p)


def _grad(g, n, what, dtypes=(torch.float32,)):
    """``g``, a contiguous CPU tensor of ``n`` elements in one of ``dtypes``
    (the library reads it in place: nothing is copied or widened here)."""
    if g.device.type != "cpu":
        raise ValueError(f"{what}: the host routines take CPU tensors, not {g.device}")
    if g.dtype not in dtypes or not g.is_contiguous():
        raise ValueError(f"{what}: a contiguous gradient in {dtypes}, got {g.dtype} "
                         f"{'contiguous' if g.is_contiguous() else 'strided'}")
    if g.numel() != n:
        raise ValueError(f"{what}: gradient of {g.numel()} elements for {n}")
    return g.reshape(-1)


def _bias_corrections(b1, b2, t):
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def cpu_adam_step_(p, g, m, v, lr, b1, b2, eps, weight_decay, bc1, bc2, adamw):
    """One Adam (``adamw`` False: L2 decay on the gradient) or AdamW step of
    the native library over flat fp32 CPU tensors, in place.  The gradient
    is fp32 or bf16 (a bf16 wire's): the library widens it in its sweep."""
    n = p.numel()
    g = _grad(g, n, "cpu_adam", _ADAM_GRADS)
    p_, m_, v_ = (_f32(t, "cpu_adam") for t in (p, m, v))
    if m.numel() != n or v.numel() != n:
        raise ValueError(f"cpu_adam: moments of {m.numel()} / {v.numel()} elements for {n}")
    _library().dst_cpu_adam_step(p_, g.data_ptr(), _ADAM_GRADS.index(g.dtype), m_, v_, n,
                                 lr, b1, b2, eps, weight_decay, bc1, bc2, 1 if adamw else 0)
    CALLS["cpu_adam"] += 1


def cpu_adagrad_step_(p, g, h, lr, eps, weight_decay):
    """One Adagrad step of the native library, in place."""
    n = p.numel()
    g = _grad(g, n, "cpu_adagrad")
    ptrs = [_f32(t, "cpu_adagrad") for t in (p, g, h)]
    if h.numel() != n:
        raise ValueError(f"cpu_adagrad: accumulator of {h.numel()} elements for {n}")
    _library().dst_cpu_adagrad_step(*ptrs, n, lr, eps, weight_decay)
    CALLS["cpu_adagrad"] += 1


def cpu_lion_step_(p, g, m, lr, b1, b2, weight_decay):
    """One Lion step of the native library, in place (sign(0) = 0)."""
    n = p.numel()
    g = _grad(g, n, "cpu_lion")
    ptrs = [_f32(t, "cpu_lion") for t in (p, g, m)]
    if m.numel() != n:
        raise ValueError(f"cpu_lion: moment of {m.numel()} elements for {n}")
    _library().dst_cpu_lion_step(*ptrs, n, lr, b1, b2, weight_decay)
    CALLS["cpu_lion"] += 1


# ---------------------------------------------------------------- plain forms

def cpu_adam_step_plain(p, g, m, v, lr, b1, b2, eps, weight_decay, bc1, bc2, adamw):
    """The plain version of :func:`cpu_adam_step_`, in the C++ loop's order:
    the moments, then (m / bc1) / (sqrt(v / bc2) + eps) as products by the
    reciprocals, the decay coupled or decoupled."""
    f = torch.float32
    grad = g.reshape(p.shape).to(f)
    if not adamw and weight_decay > 0.0:
        grad = grad + weight_decay * p
    m.mul_(b1).add_((1.0 - b1) * grad)
    v.mul_(b2).add_((1.0 - b2) * grad * grad)
    one = torch.ones((), dtype=f)
    inv_bc1, inv_bc2 = one / torch.tensor(bc1, dtype=f), one / torch.tensor(bc2, dtype=f)
    update = (m * inv_bc1) / (torch.sqrt(v * inv_bc2) + eps)
    if adamw and weight_decay > 0.0:
        update = update + weight_decay * p
    p.sub_(lr * update)


def cpu_adagrad_step_plain(p, g, h, lr, eps, weight_decay):
    """The plain version of :func:`cpu_adagrad_step_`."""
    grad = g.reshape(p.shape).to(torch.float32)
    if weight_decay > 0.0:
        grad = grad + weight_decay * p
    h.add_(grad * grad)
    p.sub_(lr * grad / (torch.sqrt(h) + eps))


def cpu_lion_step_plain(p, g, m, lr, b1, b2, weight_decay):
    """The plain version of :func:`cpu_lion_step_` (sign(0) = 0)."""
    grad = g.reshape(p.shape).to(torch.float32)
    update = torch.sign(b1 * m + (1.0 - b1) * grad)
    if weight_decay > 0.0:
        update = update + weight_decay * p
    p.sub_(lr * update)
    m.mul_(b2).add_((1.0 - b2) * grad)


# ------------------------------------------------------------------ optimizers

class DeeperSpeedCPUAdam:
    """In-place Adam/AdamW over flat fp32 CPU tensors (one per name)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adamw_mode=True):
        _library()                      # build now: a failed build raises here
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.t = 0
        self._moments = {}

    def _state_for(self, key, p):
        if key not in self._moments:
            pin = p.is_pinned()
            self._moments[key] = tuple(
                torch.zeros(p.numel(), dtype=torch.float32, pin_memory=pin)
                for _ in range(2))
        return self._moments[key]

    def step(self, params, grads, lr=None):
        """One step: ``params`` name -> contiguous fp32 CPU tensor, updated in
        place from ``grads`` (same names; fp32 or bf16)."""
        self.t += 1
        lr = self.lr if lr is None else lr
        bc1, bc2 = _bias_corrections(self.b1, self.b2, self.t)
        for key, p in params.items():
            m, v = self._state_for(key, p)
            cpu_adam_step_(p, grads[key], m, v, lr, self.b1, self.b2, self.eps,
                           self.weight_decay, bc1, bc2, self.adamw_mode)
        return params

