"""MoE of the PyTorch port against the JAX package's, in one process on the
CPU: the gating functions with the JAX draws handed in, the MoE layer
(Residual-MoE and the quantized transport too), GPT-NeoX with MoE blocks
through ``params_from_jax``, and three engine steps against the JAX
engine.

Tolerances.  Masks, locations, counts and the kept set equal the JAX
package's bit for bit; ``l_aux`` and the combine weights within 1e-6
relative, since the two packages' softmax (their ``exp``) can round one
ulp apart.  The MoE layer's output and gradients, and the model's logits,
loss and gradients, within 1e-5 in fp32 (the JAX model tests' tolerance).
The engines' losses within 1e-5 relative; their final masters within the
layout tolerance of ``torch_layout_common.masters_agree`` (1e-5 of the
change), and within 1e-2 of it under the quantized transport: the
gradient of the JAX round trip reaches the tokens through the scales only,
its cotangent rounded to bf16, so two summation orders can round it one
bf16 step apart, which Adam's normalized steps carry into the masters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as tdst
from deeperspeed_tpu.models.gpt_neox import GPTNeoX as JaxGPTNeoX
from deeperspeed_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig
from deeperspeed_tpu.moe import sharded_moe as jmoe
from deeperspeed_tpu.moe.layer import MoE as JaxMoE
from deeperspeed_tpu.quantization import BlockScaledTensor as JaxBST
from deeperspeed_tpu_torch.models import GPTNeoX, GPTNeoXConfig, params_from_jax
from deeperspeed_tpu_torch.models.gpt_neox import params_to_jax
from deeperspeed_tpu_torch.moe import MoE, mappings, top1gating, top2gating
from deeperspeed_tpu_torch.moe.sharded_moe import multiplicative_jitter
from torch_layout_common import BASE, batches, jax_run, masters_agree
import torch_threads  # noqa: F401  (torch at one intra-op thread)

S, E, H = 64, 4, 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _logits(seed=0, skew=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, E)).astype(np.float32)
    x[:, 0] += skew            # pile tokens on expert 0: capacity binds
    return x


def _top1_draws(key, rsample, rts):
    """The draws ``top1gating`` makes from ``key``, in its order."""
    gumbel = priority = None
    if rsample:
        key, sub = jax.random.split(key)
        gumbel = jax.random.gumbel(sub, (S, E), jnp.float32)
    if rts:
        key, sub = jax.random.split(key)
        priority = jax.random.uniform(sub, (S,), jnp.float32)
    return gumbel, priority


def _same_gate(j, t, k):
    np.testing.assert_array_equal(np.asarray(j.dispatch_mask), t.dispatch_mask.numpy())
    np.testing.assert_array_equal(np.asarray(j.exp_counts), t.exp_counts.numpy())
    np.testing.assert_allclose(np.asarray(j.combine_weights), t.combine_weights.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(j.l_aux), float(t.l_aux), rtol=1e-6)
    # locations: where each kept choice lands, from the dense mask
    want = np.asarray(j.dispatch_mask)
    for c in range(k):
        rows = t.kept[:, c].nonzero().squeeze(1)
        assert want[rows, t.expert[rows, c], t.location[rows, c]].all()
    assert int(t.kept.sum()) == int(want.sum())


TOP1 = {
    "capacity-rts": dict(skew=2.0, rts=True),
    "capacity-rsample-rts": dict(skew=2.0, rts=True, rsample=True),
    "capacity-order": dict(skew=2.0),
    "used-token": dict(skew=1.0, used=True),
    "no-drop": dict(skew=2.0, drop=False),
    "min-capacity": dict(cf=0.05, min_capacity=6),
}


@pytest.mark.parametrize("case", list(TOP1))
def test_top1gating_matches_jax(case):
    kw = TOP1[case]
    logits = _logits(1, kw.get("skew", 0.0))
    used = (np.random.default_rng(2).random(S) > 0.3).astype(np.float32) \
        if kw.get("used") else None
    key = jax.random.PRNGKey(7)
    rsample, rts = kw.get("rsample", False), kw.get("rts", False)
    args = dict(capacity_factor=kw.get("cf", 1.0), min_capacity=kw.get("min_capacity", 4),
                noisy_gate_policy="RSample" if rsample else None,
                drop_tokens=kw.get("drop", True), use_rts=rts)
    j = jmoe.top1gating(jnp.asarray(logits), used_token=None if used is None
                        else jnp.asarray(used), rng=key if (rsample or rts) else None,
                        **args)
    gumbel, priority = _top1_draws(key, rsample, rts)
    t = top1gating(_t(logits), used_token=None if used is None else _t(used),
                   gumbel=None if gumbel is None else _t(gumbel),
                   priority=None if priority is None else _t(priority), **args)
    _same_gate(j, t, 1)
    if kw.get("skew") and kw.get("drop", True):
        assert int(t.kept.sum()) < S          # capacity really binds


@pytest.mark.parametrize("case", ["capacity-gumbel", "capacity-plain", "no-drop"])
def test_top2gating_matches_jax(case):
    logits = _logits(3, 2.0)
    key = jax.random.PRNGKey(5)
    noisy = case == "capacity-gumbel"
    drop = case != "no-drop"
    j = jmoe.top2gating(jnp.asarray(logits), 0.5, 4, drop_tokens=drop,
                        rng=key if noisy else None)
    gumbel = None
    if noisy:
        gumbel = _t(jax.random.gumbel(jax.random.split(key)[1], (S, E), jnp.float32))
    t = top2gating(_t(logits), 0.5, 4, drop_tokens=drop, gumbel=gumbel)
    _same_gate(j, t, 2)
    assert (int(t.kept.sum()) < 2 * S) == drop


def test_multiplicative_jitter_with_the_jax_draw():
    x = np.random.default_rng(8).normal(size=(S, H)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jmoe.multiplicative_jitter(jnp.asarray(x), key)
    noise = jax.random.uniform(key, x.shape, jnp.float32, 1.0 - 1e-2, 1.0 + 1e-2)
    np.testing.assert_array_equal(multiplicative_jitter(_t(x), noise=_t(noise)).numpy(),
                                  np.asarray(want))


def test_gather_and_drop_tokens(monkeypatch):
    """``gather_tokens`` / ``drop_tokens`` over a tp group: the identity at
    tp 1; at tp 2 (rank 1, the peer's shard faked) the gather concatenates
    in rank order and its backward keeps this rank's slice, the drop the
    reverse."""
    x = torch.randn(2, 3, 4, requires_grad=True)
    assert mappings.gather_tokens(x) is x and mappings.drop_tokens(x) is x

    class Two:
        def size(self):
            return 2

        def rank(self):
            return 1

    peer = torch.randn(2, 3, 4)
    monkeypatch.setattr(mappings, "_gather", lambda t, dim, group: torch.cat([peer, t], dim))
    y = mappings.gather_tokens(x, dim=1, group=Two())
    assert torch.equal(y, torch.cat([peer, x.detach()], 1))
    (y * torch.arange(6.0)[None, :, None]).sum().backward()
    assert torch.equal(x.grad, torch.arange(3.0, 6.0)[None, :, None].expand(2, 3, 4))
    full = torch.randn(2, 6, 4, requires_grad=True)
    z = mappings.drop_tokens(full, dim=1, group=Two())
    assert torch.equal(z, full.detach()[:, 3:])
    z.sum().backward()          # the other rank's gradient: the faked peer shard
    assert torch.equal(full.grad, torch.cat([peer, torch.ones(2, 3, 4)], 1))


# ------------------------------------------------------------- the layer
def _moe_from_jax(tree, moe):
    """Load the JAX MoE subtree ``tree`` into the port's ``moe``."""
    sd = {"gate.wg.weight": _t(tree["gate"]["wg"]["kernel"]).T}
    for lin in ("dense_h_to_4h", "dense_4h_to_h"):
        sd[f"experts.{lin}.weight"] = _t(tree["experts"][lin]["kernel"]).transpose(1, 2)
        sd[f"experts.{lin}.bias"] = _t(tree["experts"][lin]["bias"])
        if "mlp" in tree:
            sd[f"mlp.{lin}.weight"] = _t(tree["mlp"][lin]["kernel"]).T
            sd[f"mlp.{lin}.bias"] = _t(tree["mlp"][lin]["bias"])
    if "coefficient" in tree:
        sd["coefficient.weight"] = _t(tree["coefficient"]["kernel"]).T
        sd["coefficient.bias"] = _t(tree["coefficient"]["bias"])
    moe.load_state_dict({k: v.contiguous() for k, v in sd.items()})


LAYERS = {
    "k1": dict(k=1),
    "k1-residual": dict(k=1, use_residual=True),
    "k2-eval": dict(k=2, train=False, eval_capacity_factor=0.5),
    "k1-int8": dict(k=1, quantized_alltoall=True, quantized_group_size=16),
    "k1-fp8": dict(k=1, quantized_alltoall=True, quantized_alltoall_dtype="fp8",
                   quantized_group_size=16),
}


@pytest.mark.parametrize("case", list(LAYERS))
def test_moe_layer_forward_and_grads_match_jax(case):
    kw = dict(LAYERS[case])
    train = kw.pop("train", True)
    jl = JaxMoE(hidden_size=H, num_experts=E, capacity_factor=0.75, min_capacity=4,
                use_rts=False, **kw)
    x = np.random.default_rng(4).normal(size=(2, S // 2, H)).astype(np.float32)
    r = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)["params"]

    def jloss(p, xx):
        out, l_aux, _ = jl.apply({"params": p}, xx, train=train)
        return jnp.sum(out * r) + 3.0 * l_aux, out

    (jv, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    moe = MoE(H, num_experts=E, capacity_factor=0.75, min_capacity=4, use_rts=False, **kw)
    _moe_from_jax(jax.device_get(params), moe)
    xt = _t(x).requires_grad_(True)
    out, l_aux, counts = moe(xt, train=train, rng=torch.Generator() if train else None)
    loss = (out * _t(r)).sum() + 3.0 * l_aux
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    grads = {n: p.grad.numpy() for n, p in moe.named_parameters()}
    np.testing.assert_allclose(grads["gate.wg.weight"].T,
                               np.asarray(jgp["gate"]["wg"]["kernel"]), rtol=1e-5, atol=1e-5)
    for lin in ("dense_h_to_4h", "dense_4h_to_h"):
        np.testing.assert_allclose(grads[f"experts.{lin}.weight"].transpose(0, 2, 1),
                                   np.asarray(jgp["experts"][lin]["kernel"]),
                                   rtol=1e-5, atol=1e-5)
    if "use_residual" in kw:
        np.testing.assert_allclose(grads["coefficient.weight"].T,
                                   np.asarray(jgp["coefficient"]["kernel"]),
                                   rtol=1e-5, atol=1e-5)
    assert int(counts.sum()) == S * kw["k"]


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_transport_round_trip_equals_jax(dtype):
    """The dispatch's block-scaled round trip on the dispatched rows equals
    the JAX package's on its [E, C, M] buffer, row for row."""
    rows = np.random.default_rng(6).normal(size=(3, 10, 64)).astype(np.float32) * 4
    j = JaxBST.quantize(jnp.asarray(rows), dtype, 32).dequantize(jnp.float32)
    moe = MoE(64, num_experts=2, quantized_alltoall=True, quantized_group_size=32,
              quantized_alltoall_dtype=dtype)
    t = moe._dispatch_transport(_t(rows).reshape(-1, 64), torch.float32)
    np.testing.assert_array_equal(t.numpy().reshape(rows.shape), np.asarray(j))


# ------------------------------------------------------------- the model
MODELS = {
    "interval1-k1": dict(moe_expert_interval=1),
    "interval2-k1-residual": dict(moe_expert_interval=2, moe_use_residual=True),
    "interval1-k2-eval": dict(moe_expert_interval=1, moe_top_k=2,
                              moe_eval_capacity_factor=0.5),
    "interval2-k2-eval": dict(moe_expert_interval=2, moe_top_k=2),
}


def _moe_kw(extra):
    return {"moe_num_experts": 4, "moe_use_rts": False, "moe_capacity_factor": 0.75,
            "moe_aux_loss_coef": 0.1, **extra}


@pytest.mark.parametrize("case", list(MODELS))
def test_gpt_neox_moe_matches_jax(case):
    """Logits, loss (with the aux term) and every gradient through
    ``params_from_jax``; top-2 in evaluation (its training draws come from
    each package's own generator)."""
    kw = _moe_kw(MODELS[case])
    train = "eval" not in case
    jm = JaxGPTNeoX(JaxConfig.tiny(**kw))
    batch = batches(seed=13, steps=1)[0]
    ids = jnp.asarray(batch["input_ids"])
    params = jm.init(jax.random.PRNGKey(1), ids)["params"]
    jloss = jm.loss_fn()
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jloss(p, {k: jnp.asarray(v) for k, v in
                                                            batch.items()},
                                                        deterministic=not train)))(params)
    jlogits = jax.jit(jm.apply)({"params": params}, ids)
    tree = jax.device_get(params)
    model = GPTNeoX(GPTNeoXConfig.tiny(**kw), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    loss = model.loss_fn()(model, tb, torch.Generator() if train else None)
    loss.backward()
    with torch.no_grad():
        logits = model(tb["input_ids"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    want = dict(_leaves(jax.device_get(jg)))
    got = dict(_leaves(grads))
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path].numpy(), np.asarray(g), rtol=1e-5, atol=1e-5,
                                   err_msg=path)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("residual", [False, True])
def test_params_to_jax_inverts_and_counts_match(residual):
    """``params_to_jax`` is the exact inverse of ``params_from_jax`` on an
    MoE tree, ``num_params`` and ``flops_per_token`` equal the JAX model's,
    and the whole tree's leaves are the port's parameters."""
    kw = dict(moe_num_experts=4, moe_expert_interval=1, moe_use_residual=residual)
    jm = JaxGPTNeoX(JaxConfig.tiny(**kw))
    tree = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.ones((1, 8), jnp.int32))["params"])
    sd = params_from_jax(tree)
    back = params_to_jax(sd)
    want = dict(_leaves(tree))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(v), err_msg=path)
    model = GPTNeoX(GPTNeoXConfig.tiny(**kw), device="cpu")
    model.load_state_dict(sd)
    assert model.num_params() == jm.num_params() == sum(p.numel() for p in model.parameters())
    assert model.flops_per_token() == jm.flops_per_token()
    half = params_from_jax(tree, ep_rank=1, ep_size=2)
    name = "layers.0.moe.experts.dense_h_to_4h.weight"
    assert torch.equal(half[name], sd[name][2:])


def test_pythia_160m_moe8_count():
    """Pythia-160M-MoE-8 (chip_smoke.py's configuration): the JAX count."""
    kw = dict(moe_num_experts=8, moe_expert_interval=2)
    assert GPTNeoX.num_params(type("M", (), {"config": GPTNeoXConfig.pythia_160m(**kw)})()) \
        == JaxGPTNeoX(JaxConfig.pythia_160m(**kw)).num_params() == 360_701_952


# ------------------------------------------------------------- the engine
ENGINE = {
    "stage0-residual": ({**BASE}, dict(moe_use_residual=True)),
    "stage2-bf16": ({**BASE, "bf16": {"enabled": True},
                     "zero_optimization": {"stage": 2}}, {}),
    "stage3-int8": ({**BASE, "zero_optimization": {"stage": 3,
                                                   "param_persistence_threshold": 1000},
                     "comm": {"quantized": {"moe_alltoall": True, "group_size": 32}}}, {}),
}


@pytest.mark.parametrize("case", list(ENGINE))
def test_engine_steps_match_jax(case):
    """Three steps of the port's engine against the JAX engine (one device,
    global routing under capacity pressure)."""
    cfg, extra = ENGINE[case]
    kw = _moe_kw({"moe_expert_interval": 1, "moe_aux_loss_coef": 0.5, **extra})
    blist = batches()
    jl, jn, jfinal, start = jax_run(cfg, {"dp": 1}, blist, model_kw=kw)
    dtype = torch.bfloat16 if "bf16" in case else torch.float32
    model = GPTNeoX(GPTNeoXConfig.tiny(dtype=dtype, **kw), device="cpu")
    eng, *_ = tdst.initialize(model=model, config=cfg, model_parameters=start, device="cpu")
    losses = [float(eng.train_batch(batch={k: torch.from_numpy(v.astype(np.int64))
                                           for k, v in b.items()})) for b in blist]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(losses, jl, rtol=tol)
    if dtype == torch.float32:
        got = {f"final/{k}": v.numpy() for k, v in eng.full_master_params().items()}
        masters_agree(jfinal, got, start, tol=1e-2 if "int8" in case else 1e-5)
    assert any(int(m.last_gate.kept.sum()) < m.last_gate.kept.numel()
               for m in model.moe_layers())      # capacity binds


def test_chunked_loss_with_moe_is_refused_in_jax_words():
    model = GPTNeoX(GPTNeoXConfig.tiny(ce_chunk_tokens=16, moe_num_experts=4), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="ce_chunk_tokens with MoE is not supported yet"):
        model.loss_fn()
