"""Optimizer factory (counterpart of ``deeperspeed_tpu/runtime/optimizers.py``).

The JAX package builds its optimizers as optax chains; here each optax
transformation it uses is written out as plain tensor ops over dicts of
tensors (name -> tensor), with optax's formulas in optax's order, so the
tests can hold the port tightly against the JAX engine.  This is not
``torch.optim``.  A transformation is ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)``; ``updates`` come in
as the gradients and are rewritten in place (the engine does not read its
gradients after the update).  The learning rate is applied by the engine,
``master - lr * update``, as in the JAX engine.

Ops run as ``torch._foreach_*`` over every tensor at once, so a step is a
few multi-tensor launches rather than a few per tensor.  ``FusedAdam`` and
``FusedLion`` take the cores of ``ops/adam`` and ``ops/lion`` instead:
kernels B6 and B7, one launch a step over flat moment buffers.  MuAdam and
AdamW stay unfused, as in the JAX package.

For checkpoints each transformation also has ``export(state, tree)``, its
state as the nested dict flax makes of the optax state
(``flax.serialization.to_state_dict``: a chain's states under ``"0"``,
``"1"``, ...; a NamedTuple's fields in order; ``count`` an int32 0-d
array), and ``restore(state, saved, load) -> state``, which loads such a
dict back *in place*.  ``tree(per_param)`` turns a dict of the state's
per-parameter tensors into the reference tree of whole arrays, and
``load(saved_tree, per_param)`` copies one back into the existing tensors
(``copy_``; never rebinding them: B6 and B7 keep the device addresses of
their flat buffers from the first step).
"""

import dataclasses

import numpy as np
import torch

from ..utils.tree import tree_zeros_like
from .constants import (
    ADAGRAD_OPTIMIZER,
    ADAM_OPTIMIZER,
    ADAMW_OPTIMIZER,
    CPU_ADAM_OPTIMIZER,
    FUSED_ADAM_OPTIMIZER,
    FUSED_LION_OPTIMIZER,
    LAMB_OPTIMIZER,
    LION_OPTIMIZER,
    MUADAM_OPTIMIZER,
    MUADAMW_OPTIMIZER,
    MUSGD_OPTIMIZER,
    ONEBIT_ADAM_OPTIMIZER,
    SGD_OPTIMIZER,
)


def _no_export(state, tree):
    """A stateless transformation's state: optax's EmptyState, ``{}``."""
    if state is not None:
        raise NotImplementedError("this transformation keeps state but has no export: "
                                  "its checkpoint would drop it")
    return {}


def _no_restore(state, saved, load):
    return state


@dataclasses.dataclass
class GradientTransformation:
    init: callable
    update: callable
    export: callable = _no_export
    restore: callable = _no_restore


def _count(n):
    return np.asarray(n, np.int32)


def _lists(*dicts):
    names = list(dicts[0])
    return names, [[d[n] for n in names] for d in dicts]


def identity():
    return GradientTransformation(lambda params: None,
                                  lambda updates, state, params=None: (updates, state))


def chain(*transforms):
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

    def export(state, tree):
        return {str(i): t.export(s, tree) for i, (t, s) in enumerate(zip(transforms, state))}

    def restore(state, saved, load):
        return [t.restore(s, saved[str(i)], load)
                for i, (t, s) in enumerate(zip(transforms, state))]

    return GradientTransformation(init, update, export, restore)


def add_decayed_weights(weight_decay):
    """``u + wd * p`` on matrices and embeddings, not on vectors (biases,
    norm scales): optax ``add_decayed_weights`` under the JAX package's
    ``default_weight_decay_mask``."""
    def update(updates, state, params=None):
        names = [n for n in updates if params[n].dim() >= 2]
        if names:
            torch._foreach_add_([updates[n] for n in names],
                                [params[n] for n in names], alpha=weight_decay)
        return updates, state

    # optax's MaskedState around an empty AddDecayedWeightsState
    return GradientTransformation(lambda params: None, update,
                                  lambda state, tree: {"inner_state": {}})


def _bias_correction(decay, count):
    # optax: 1 - decay**count in fp32
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count)))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    """optax ``scale_by_adam``: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 +
    b2 nu, u = (mu / bc1) / (sqrt(nu / bc2) + eps)."""
    def init(params):
        return {"count": 0, "mu": tree_zeros_like(params), "nu": tree_zeros_like(params)}

    def update(updates, state, params=None):
        names, (g, mu, nu) = _lists(updates, state["mu"], state["nu"])
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        count = state["count"] + 1
        denom = torch._foreach_div(nu, _bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(mu, _bias_correction(b1, count))
        torch._foreach_div_(u, denom)
        torch._foreach_copy_(g, u)
        return updates, {**state, "count": count}

    return GradientTransformation(init, update, export_adam, restore_adam)


def export_adam(state, tree):
    """optax ``ScaleByAdamState(count, mu, nu)``."""
    return {"count": _count(state["count"]), "mu": tree(state["mu"]),
            "nu": tree(state["nu"])}


def restore_adam(state, saved, load):
    load(saved["mu"], state["mu"])
    load(saved["nu"], state["nu"])
    return {**state, "count": int(saved["count"])}


def scale_by_mup(multipliers):
    """Per-leaf LR multiplier (the μP width scaling of MuAdam/MuSGD)."""
    def update(updates, state, params=None):
        names = list(updates)
        torch._foreach_mul_([updates[n] for n in names],
                            [float(multipliers[n]) for n in names])
        return updates, state

    return GradientTransformation(lambda params: None, update)


def trace(decay):
    """optax ``trace`` (heavy-ball momentum): t = g + decay t; u = t."""
    def init(params):
        return tree_zeros_like(params)

    def update(updates, state, params=None):
        names, (g, t) = _lists(updates, state)
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, g)
        torch._foreach_copy_(g, t)
        return updates, state

    def restore(state, saved, load):
        load(saved["trace"], state)
        return state

    return GradientTransformation(init, update, lambda state, tree: {"trace": tree(state)},
                                  restore)


def scale_by_lion(b1=0.9, b2=0.99):
    """optax ``scale_by_lion``: u = sign((1-b1) g + b1 mu); mu = (1-b2) g + b2 mu.
    The state is optax's ``ScaleByLionState(count, mu)``."""
    def init(params):
        return {"count": 0, "mu": tree_zeros_like(params)}

    def update(updates, state, params=None):
        names, (g, mu) = _lists(updates, state["mu"])
        u = torch._foreach_mul(mu, b1)
        torch._foreach_add_(u, g, alpha=1 - b1)
        torch._foreach_sign_(u)
        torch._foreach_mul_(mu, b2)
        torch._foreach_add_(mu, g, alpha=1 - b2)
        torch._foreach_copy_(g, u)
        return updates, {**state, "count": state["count"] + 1}

    def export(state, tree):
        return {"count": _count(state["count"]), "mu": tree(state["mu"])}

    def restore(state, saved, load):
        load(saved["mu"], state["mu"])
        return {**state, "count": int(saved["count"])}

    return GradientTransformation(init, update, export, restore)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7):
    """optax ``scale_by_rss`` (Adagrad): s += g^2; u = g * rsqrt(s + eps)
    where s > 0, else 0."""
    def init(params):
        return {n: torch.full_like(p, initial_accumulator_value)
                for n, p in params.items()}

    def update(updates, state, params=None):
        for n, g in updates.items():
            s = state[n]
            s.addcmul_(g, g)
            g.mul_(torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s)))
        return updates, state

    def restore(state, saved, load):
        load(saved["sum_of_squares"], state)
        return state

    return GradientTransformation(
        init, update, lambda state, tree: {"sum_of_squares": tree(state)}, restore)


def scale_by_trust_ratio():
    """optax ``scale_by_trust_ratio(min_norm=0)``: u * ||p|| / ||u|| per
    leaf, 1 where either norm is 0."""
    def update(updates, state, params=None):
        for n, u in updates.items():
            pn = torch.linalg.vector_norm(params[n])
            un = torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            u.mul_(ratio)
        return updates, state

    return GradientTransformation(lambda params: None, update)


def _adam_like(cfg, adamw=False, mup_multipliers=None, use_fused=False):
    if use_fused:
        # B6 (ops/adam): one launch a step over the flat moment buffers
        from ..ops.adam import scale_by_fused_adam

        core = scale_by_fused_adam(b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps)
    else:
        core = scale_by_adam(b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps)
    parts = [core]
    if mup_multipliers is not None:
        parts.append(scale_by_mup(mup_multipliers))
    if cfg.weight_decay and adamw:
        parts.append(add_decayed_weights(cfg.weight_decay))
    elif cfg.weight_decay:
        # plain Adam applies L2 to the gradient before the moment update
        parts.insert(0, add_decayed_weights(cfg.weight_decay))
    return chain(*parts)


def build_optimizer(name, params_cfg, mup_multipliers=None):
    """name + ``OptimizerParams`` -> transformation (lr excluded: the
    engine applies it from the schedule)."""
    name = name.lower()
    if name == ONEBIT_ADAM_OPTIMIZER:
        raise NotImplementedError(
            "optimizer 'onebitadam' is not ported yet (ROADMAP Queue A, "
            "'Multi-process training')")
    if name in (ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER, FUSED_ADAM_OPTIMIZER):
        return _adam_like(params_cfg, adamw=False, mup_multipliers=mup_multipliers,
                          use_fused=name == FUSED_ADAM_OPTIMIZER)
    if name == ADAMW_OPTIMIZER:
        return _adam_like(params_cfg, adamw=True, mup_multipliers=mup_multipliers)
    if name == MUADAM_OPTIMIZER:
        return _adam_like(params_cfg, adamw=False, mup_multipliers=mup_multipliers)
    if name == MUADAMW_OPTIMIZER:
        return _adam_like(params_cfg, adamw=True, mup_multipliers=mup_multipliers)
    if name in (SGD_OPTIMIZER, MUSGD_OPTIMIZER):
        parts = [trace(params_cfg.momentum)] if params_cfg.momentum else []
        if name == MUSGD_OPTIMIZER and mup_multipliers is not None:
            parts.append(scale_by_mup(mup_multipliers))
        if name == SGD_OPTIMIZER and params_cfg.weight_decay:
            parts.insert(0, add_decayed_weights(params_cfg.weight_decay))
        return chain(*parts) if parts else identity()
    if name == LAMB_OPTIMIZER:
        return chain(scale_by_adam(b1=params_cfg.betas[0], b2=params_cfg.betas[1],
                                   eps=params_cfg.eps),
                     add_decayed_weights(params_cfg.weight_decay),
                     scale_by_trust_ratio())
    if name in (LION_OPTIMIZER, FUSED_LION_OPTIMIZER):
        if name == FUSED_LION_OPTIMIZER:
            # B7 (ops/lion): one launch a step over the flat moment buffer
            from ..ops.lion import scale_by_fused_lion

            core = scale_by_fused_lion(b1=params_cfg.betas[0], b2=params_cfg.betas[1])
        else:
            core = scale_by_lion(b1=params_cfg.betas[0], b2=params_cfg.betas[1])
        parts = [core]
        if params_cfg.weight_decay:
            parts.append(add_decayed_weights(params_cfg.weight_decay))
        return chain(*parts)
    if name == ADAGRAD_OPTIMIZER:
        return scale_by_rss(initial_accumulator_value=0.1, eps=params_cfg.eps)
    raise ValueError(f"Unknown optimizer name {name!r}")
