"""Mixed-precision AdamW, the port of ``repro.optim.adam``.

Parameters may live in bf16 for compute; the optimizer keeps a float32
master copy and first / second moments whose dtypes are configurable (a
bf16 first moment saves memory at scale).  The state tree is the JAX
package's: ``step`` (int32 scalar), ``m``, ``v`` and ``master``, each
shaped as the params.

The arithmetic follows the reference step for step, in its order: clip
by the global norm first, ``t`` as float32, ``(m / bc1) / (sqrt(v / bc2)
+ eps)``, weight decay added to the update, then the float32 master cast
back to each parameter's dtype.  ``torch.optim.AdamW`` rounds in another
order, so it is not used.  Every function returns new tensors and
mutates none of its arguments.  :func:`opt_state_axes` gives the
state's logical axes, as the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import (leaves, leaves_with_paths, map_with_paths,
                              tree_map)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-5                 # paper section 5.3: Adam at 2e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    m_dtype: torch.dtype = torch.float32      # bf16 saves memory at scale
    v_dtype: torch.dtype = torch.float32
    master_dtype: torch.dtype = torch.float32  # float32 master of bf16 params
    keep_master: bool = True


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """Zero moments, ``step`` 0 on the params' device and (with
    ``keep_master``) a copy of the params in ``master_dtype``."""
    device = leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "m": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.m_dtype,
                                                 device=p.device), params),
             "v": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.v_dtype,
                                                 device=p.device), params)}
    if cfg.keep_master:
        state["master"] = tree_map(
            lambda p: p.detach().to(cfg.master_dtype, copy=True), params)
    return state


def opt_state_axes(param_axes, cfg: OptimizerConfig) -> dict:
    """Logical axes of :func:`init_opt_state`'s tree: the moments (and
    the master) mirror the parameters', ``step`` is a scalar."""
    state = {"step": (), "m": param_axes, "v": param_axes}
    if cfg.keep_master:
        state["master"] = param_axes
    return state


def value_and_grad(loss_fn, params):
    """``(loss, grads)`` of ``loss_fn(params)``, the twin of
    ``jax.value_and_grad``: the loss is computed over detached copies of
    the leaves that require grad, so ``params`` is left as it is; a leaf
    the loss does not reach gets a ``None`` gradient (a zero gradient to
    :func:`adam_update`).  The loss comes back detached."""
    req = tree_map(lambda p: p.detach().requires_grad_(True), params)
    keyed = leaves_with_paths(req)
    with torch.enable_grad():
        loss = loss_fn(req)
        grads = torch.autograd.grad(loss, [p for _, p in keyed],
                                    allow_unused=True)
    by_key = {k: g for (k, _), g in zip(keyed, grads)}
    return loss.detach(), map_with_paths(lambda k, _: by_key[k], req)


def _global_norm(grads):
    """The float32 L2 norm over every leaf, summed leaf by leaf in pytree
    order as the reference sums them."""
    total = 0
    for g in leaves(grads):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, gn=None):
    """Scale ``grads`` so their global norm (``gn`` when the caller has
    it) is at most ``max_norm``.  Returns ``(clipped grads, norm before
    clipping)``."""
    gn = _global_norm(grads) if gn is None else gn
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adam_update(grads, opt_state: dict, params, cfg: OptimizerConfig, lr,
                norm_fn=None):
    """One AdamW step.  ``grads`` has the params' structure (a ``None``
    leaf is a zero gradient); ``lr`` a float or a float32 scalar tensor.
    ``norm_fn(grads)`` gives the global norm where the leaves are blocks
    of sharded params (``dist.spmd.global_norm``).  Returns
    ``(new_params, new_opt_state, grad_norm)``."""
    grads = tree_map(lambda p, g: torch.zeros_like(p) if g is None else g,
                     params, grads)
    gn = (norm_fn or _global_norm)(grads)
    if cfg.grad_clip > 0:
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip, gn)
    step = opt_state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    ref = opt_state.get("master", params)

    def upd(g, m, v, p):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32.square()
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p32
        return p32 - lr * update, m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], ref)
    new_ref, new_m, new_v = (_pick(out, i) for i in range(3))
    new_state = {"step": step, "m": new_m, "v": new_v}
    if cfg.keep_master:
        new_state["master"] = new_ref
    new_params = tree_map(lambda r, p: r.to(p.dtype, copy=True), new_ref,
                          params)
    return new_params, new_state, gn


def _pick(tree, i):
    """Element ``i`` of each ``(ref, m, v)`` tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
