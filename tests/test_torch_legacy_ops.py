"""The legacy transformer ops of the PyTorch port against the JAX package on
the CPU: tanh-GELU (B9), the fused softmax (B8), the encoder layer
``DeeperSpeedTransformerLayer``, and a two-layer stack trained by both
engines.

The same numpy inputs go through both packages; where the JAX function
reaches its Pallas kernel, it runs with ``use_pallas=True`` in interpret
mode, as ``tests/unit/ops/test_transformer_kernels.py`` runs it.  Layer
weights cross with ``layer_params_from_jax``.

Tolerances:

* fp32: the JAX tests' (B9 forward rtol 1e-5 / atol 1e-6, its grad 1e-4 /
  1e-5; B8 forward 1e-5 / 1e-6, grad 1e-4 / 1e-5); the layer 1e-5 / 1e-5
  on its output and 1e-4 / 1e-5 on every gradient (summation order of
  64-256-wide products only); the stack's losses within 1e-4 relative
  (``chip_smoke.py`` phase 8's rule).
* fp16 / bf16: one ulp of the element's type (2^-10 / 2^-7 relative) plus
  an absolute floor of one ulp at the output's unit scale: both sides
  compute in fp32 and round once, so they may differ by one rounding.
* the fp16 layer: its fp16 products round their outputs to 2^-11, and the
  two frameworks sum the products in another order, so the output is held
  to one fp16 ulp of its largest magnitude (1e-3) and each gradient to five
  of its own (5e-3: the backward chains three products; up to 2.4e-4 and
  1.7e-3 seen).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as jdst
import deeperspeed_tpu_torch as tdst
from chip_smoke import legacy_loss, legacy_stack
from deeperspeed_tpu.ops.transformer import bias_gelu as jax_bias_gelu
from deeperspeed_tpu.ops.transformer import fused_softmax as jax_softmax
from deeperspeed_tpu.ops.transformer import gelu_tanh as jax_gelu
from deeperspeed_tpu.ops.transformer import transformer as jtr
from deeperspeed_tpu_torch.ops.transformer import bias_gelu, fused_softmax, gelu_tanh
from deeperspeed_tpu_torch.ops.transformer import transformer as ttr
import torch_threads  # noqa: F401  (torch at one intra-op thread)

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "fp16": (np.float16, jnp.float16, torch.float16),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
ULP = {"fp16": 2 ** -10, "bf16": 2 ** -7}


def _inputs(seed, shape, mode, scale=1.0):
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal(shape).astype(np.float32) * s for s in (scale, 1.0))
    _, jdt, tdt = DTYPES[mode]
    return ((jnp.asarray(x, jdt), jnp.asarray(dy, jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)))


def _agree(got, want, mode, rtol, atol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if mode != "fp32":
        rtol, atol = ULP[mode], ULP[mode]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _torch_vjp(fn, x, dy):
    x = x.clone().requires_grad_()
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, dy)
    return y, dx


@pytest.mark.parametrize("mode", ["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("shape", [(1000,), (7, 333), (2, 16, 128)])
def test_gelu_matches_jax(shape, mode):
    (jx, jdy), (tx, tdy) = _inputs(5, shape, mode, scale=3.0)
    jy, vjp = jax.vjp(lambda a: jax_gelu(a, use_pallas=True), jx)
    y, dx = _torch_vjp(gelu_tanh, tx, tdy)
    assert y.dtype == tx.dtype and dx.dtype == tx.dtype
    _agree(y, jy, mode, 1e-5, 1e-6)
    _agree(dx, vjp(jdy)[0], mode, 1e-4, 1e-5)


def test_bias_gelu_matches_jax():
    (jx, _), (tx, _) = _inputs(6, (4, 64), "fp32")
    b = np.linspace(-1, 1, 64, dtype=np.float32)
    _agree(bias_gelu(tx, torch.from_numpy(b)),
           jax_bias_gelu(jx, jnp.asarray(b), use_pallas=True), "fp32", 1e-5, 1e-6)


@pytest.mark.parametrize("mode", ["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("shape,scale", [((3, 7, 128), 0.5), ((5, 100), 0.125),
                                         ((2, 4, 256), 1.0), ((6, 1000), 0.125)])
def test_softmax_matches_jax(shape, scale, mode):
    """Widths that are and are not multiples of 128: the JAX kernel runs at
    every width in interpret mode, and the port's kernel takes any."""
    (jx, jdy), (tx, tdy) = _inputs(4, shape, mode, scale=4.0)
    jy, vjp = jax.vjp(lambda a: jax_softmax(a, scale=scale, use_pallas=True), jx)
    y, dx = _torch_vjp(lambda a: fused_softmax(a, scale), tx, tdy)
    assert y.dtype == tx.dtype
    _agree(y, jy, mode, 1e-5, 1e-6)
    _agree(dx, vjp(jdy)[0], mode, 1e-4, 1e-5)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_softmax_special_rows_match_jax(mode):
    """A row of -inf, a row with a NaN, a half-masked row and a row with +inf:
    the port's forward gives the JAX kernel's values and NaN rows (the
    kernel B8 is held to the same plain version on the card)."""
    x = 4 * np.random.default_rng(8).standard_normal((5, 256)).astype(np.float32)
    x[0] = -np.inf
    x[1, 100] = np.nan
    x[2, :128] = -np.inf
    x[3, 255] = np.inf
    _, jdt, tdt = DTYPES[mode]
    jy = jax_softmax(jnp.asarray(x, jdt), scale=0.125, use_pallas=True)
    y = fused_softmax(torch.from_numpy(x).to(tdt), 0.125)
    _agree(y, jy, mode, 1e-5, 1e-6)
    assert y[[0, 1, 3]].float().isnan().all() and not y[[2, 4]].float().isnan().any()


# ---------------------------------------------------------------- the layer
H, HEADS, B, S = 64, 4, 2, 16


def _configs(**kw):
    kw = {"hidden_size": H, "heads": HEADS, "intermediate_size": 4 * H,
          "attn_dropout_ratio": 0.0, "hidden_dropout_ratio": 0.0, **kw}
    return jtr.DeeperSpeedTransformerConfig(**kw), ttr.DeeperSpeedTransformerConfig(**kw)


def _mask(rows, seq, seed):
    """A key-padding mask: each row keeps a seeded prefix of at least half."""
    keep = np.random.default_rng(seed).integers(seq // 2, seq + 1, rows)
    return (np.arange(seq)[None] < keep[:, None]).astype(np.int32)


def _flat_grads_jax(tree):
    """{port parameter name: numpy grad} from a flax grad tree of one layer."""
    out = {}
    for mod, leaves in tree.items():
        for name, g in leaves.items():
            g = np.asarray(g, np.float32)
            if name == "kernel":
                out[f"{mod}.weight"] = g.T
            else:
                out[f"{mod}.{'weight' if name == 'scale' else 'bias'}"] = g
    return out


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("pre_ln", [True, False], ids=["preln", "postln"])
def test_layer_matches_jax(pre_ln, masked, fp16):
    jcfg, tcfg = _configs(pre_layer_norm=pre_ln, fp16=fp16)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    dy = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = _mask(B, S, 8) if masked else None
    jlayer = jtr.DeeperSpeedTransformerLayer(jcfg)
    params = jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    jmask = None if mask is None else jnp.asarray(mask)
    jy, vjp = jax.vjp(lambda p, a: jlayer.apply({"params": p}, a, jmask), params,
                      jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy, jy.dtype))

    layer = ttr.DeeperSpeedTransformerLayer(tcfg, device="cpu")
    layer.load_state_dict(ttr.layer_params_from_jax(jax.device_get(params)))
    tx = torch.from_numpy(x).requires_grad_()
    y = layer(tx, None if mask is None else torch.from_numpy(mask))
    assert y.dtype == torch.float32          # fp32 stream, as the JAX layer promotes
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(y, [tx, *layer.parameters()], torch.from_numpy(dy))
    want = {"x": np.asarray(jgx), **_flat_grads_jax(jax.device_get(jgp))}
    got = {"x": grads[0], **dict(zip(names, grads[1:]))}
    assert sorted(got) == sorted(want)
    jy = np.asarray(jy)
    if fp16:
        np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0,
                                   atol=1e-3 * np.abs(jy).max())
    else:
        np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5, atol=1e-5)
    for name, w in want.items():
        g = got[name].numpy()
        if fp16:
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 * np.abs(w).max() + 1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


def test_layer_params_from_jax_refuses_unmapped_leaves():
    jcfg, _ = _configs()
    params = jtr.DeeperSpeedTransformerLayer(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4, H)))["params"]
    tree = jax.device_get(params)
    assert set(ttr.layer_params_from_jax(tree)) == set(
        dict(ttr.DeeperSpeedTransformerLayer(_configs()[1], device="cpu").named_parameters()))
    with pytest.raises(ValueError, match="unmapped"):
        ttr.layer_params_from_jax({**tree, "extra": {"kernel": np.zeros((2, 2))}})


def test_layer_dropout_draws_from_the_generator():
    """Dropout only with a generator; one seed gives one draw."""
    _, tcfg = _configs(attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1)
    layer = ttr.DeeperSpeedTransformerLayer(tcfg, device="cpu", seed=1)
    x = torch.randn(B, S, H, generator=torch.Generator().manual_seed(0))
    plain = layer(x)
    a, b = (layer(x, rng=torch.Generator().manual_seed(9)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert torch.equal(layer(x), plain)


# ------------------------------------------------------ the stack, trained
class _JaxStack(nn.Module):
    config: jtr.DeeperSpeedTransformerConfig
    n_layers: int = 2

    @nn.compact
    def __call__(self, x, mask=None):
        for i in range(self.n_layers):
            x = jtr.DeeperSpeedTransformerLayer(self.config, name=f"layers_{i}")(x, mask)
        return x


def _stack_batches(steps, rows, masked):
    rng = np.random.default_rng(13)
    out = []
    for i in range(steps):
        b = {"x": rng.standard_normal((rows, S, H)).astype(np.float32),
             "y": rng.standard_normal((rows, S, H)).astype(np.float32)}
        if masked:
            b["mask"] = _mask(rows, S, 20 + i)
        out.append(b)
    return out


@pytest.mark.parametrize("pre_ln,masked", [(True, False), (False, True)],
                         ids=["preln-nomask", "postln-mask"])
def test_stack_trains_as_in_jax(pre_ln, masked):
    """A 2-layer stack, 3 Adam steps (clip 1.0) of the mean square against a
    seeded target through ``initialize(model_parameters=..., loss_fn=...)``
    in both packages."""
    jcfg, tcfg = _configs(pre_layer_norm=pre_ln)
    config = {"train_batch_size": 8, "gradient_clipping": 1.0,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    jstack = _JaxStack(jcfg)
    params = jstack.init(jax.random.PRNGKey(1), jnp.ones((1, S, H)))["params"]

    def jloss(p, mb, rng):
        out = jstack.apply({"params": p}, mb["x"], mb.get("mask"))
        return jnp.mean((out.astype(jnp.float32) - mb["y"]) ** 2)

    jeng, *_ = jdst.initialize(model=jstack, config=config, model_parameters=params,
                               loss_fn=jloss)
    tree = jax.device_get(params)
    start = {f"layers.{i}.{k}": v for i in range(2)
             for k, v in ttr.layer_params_from_jax(tree[f"layers_{i}"]).items()}
    teng, *_ = tdst.initialize(model=legacy_stack(torch, tcfg, 2, "cpu"), config=config,
                               model_parameters=start, loss_fn=legacy_loss, device="cpu")
    for step, b in enumerate(_stack_batches(3, 8, masked)):
        jl = float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in b.items()}))
        tl = float(teng.train_batch(batch=b))
        assert abs(tl - jl) <= 1e-4 * abs(jl), (step, tl, jl)
        if step == 0:
            jn, tn = jeng.get_global_grad_norm(), teng.get_global_grad_norm()
            assert abs(tn - jn) <= 1e-4 * jn, (tn, jn)
