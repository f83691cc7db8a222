"""Mixture-of-Experts FFN with top-k routing and grouped capacity dispatch,
the port of ``repro.models.moe``.

Dispatch follows GShard's grouped formulation: tokens are split into
``G`` groups, and each group routes its own tokens into a ``[E, C, d]``
buffer (stable argsort by expert id -> within-expert rank -> scatter);
a token's slot past the capacity ``C`` is dropped.  The expert products
are plain batched products over the buffer, the combine sums each
token's ``k`` slots in float32.  The JAX package has no Pallas kernel
here, and neither has the port.

The JAX package sizes ``G`` from its device mesh and pins the buffer's
layout with sharding constraints; the port has no mesh yet (ROADMAP.md
Queue 1 item 7), so ``n_groups`` defaults to 1 and nothing is sharded.
Gradients are autograd's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def init_moe(d: int, d_ff: int, n_experts: int, dtype,
             generator: torch.Generator, device=None) -> dict:
    """The JAX ``init_moe`` tree: ``router [d, E]`` at scale 0.02, and
    ``w_gate`` / ``w_up [E, d, f]`` and ``w_down [E, f, d]`` at
    ``N(0, 1/d_in)``.  Normals are drawn on ``generator``'s device, then
    moved to ``device`` (``None`` means the card) in ``dtype``."""
    dev = resolve_device(device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dtype)

    return {"router": normal((d, n_experts), 0.02),
            "w_gate": normal((n_experts, d, d_ff), 1.0 / math.sqrt(d)),
            "w_up": normal((n_experts, d, d_ff), 1.0 / math.sqrt(d)),
            "w_down": normal((n_experts, d_ff, d), 1.0 / math.sqrt(d_ff))}


def _dispatch_group(x_g, experts_g, capacity: int, n_experts: int):
    """Dispatch of one group.  x_g: [Tg, d]; experts_g: [Tg, k] ->
    (buf [E, C, d], safe_rank [Tg, k], keep [Tg, k]).

    A slot's rank is its place among its expert's slots in flat (token-
    major, slot-minor) order, from a stable sort; slots at rank >= C are
    dropped (``safe_rank`` = C).  Their writes land in one spare expert
    row that is sliced off, so no index leaves the buffer.  The scatter
    loops over the k slots, so no [Tg * k, d] tensor is made."""
    tg, k = experts_g.shape
    n = tg * k
    flat_e = experts_g.reshape(n)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # bincount would read the largest id back to size its output: a sync
    # with the card every layer
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=flat_e.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[sort_idx] = rank_sorted
    rank = rank.reshape(tg, k)
    keep = rank < capacity
    safe_rank = torch.where(keep, rank, capacity)
    # dropped slots write to (spare expert E, row 0)
    row_e = torch.where(keep, experts_g, n_experts)
    row_r = torch.where(keep, rank, 0)
    buf = x_g.new_zeros((n_experts + 1, capacity, x_g.shape[-1]))
    for kk in range(k):
        buf[row_e[:, kk], row_r[:, kk]] = x_g
    return buf[:n_experts], safe_rank, keep


def moe_ffn(params: dict, x, *, top_k: int, capacity_factor: float = 1.25,
            activation=F.silu, n_groups: int | None = None):
    """x: [T, d] flat tokens -> (out [T, d] in x's dtype, aux_loss float32
    scalar).  ``params`` already in x's dtype (the block casts them).

    The router runs in float32 (``x.float() @ router.float()``); each
    token takes its ``top_k`` experts, weighted by their renormalised
    probabilities.  Capacity ``int(max(4, cf * Tg * k / E))``, rounded up
    to a multiple of 128 above 128, else of 4.  ``n_groups`` (default 1)
    splits the tokens into groups that dispatch alone; a T it does not
    divide falls back to one group, as the JAX package does.  The aux
    loss is Switch's load balance, ``E * sum(density * mean_probs)`` over
    the first choices."""
    t, d = x.shape
    n_experts = params["router"].shape[-1]
    g = n_groups or 1
    if t % g:
        g = 1
    tg = t // g

    router_logits = x.float() @ params["router"].float()
    probs = torch.softmax(router_logits, dim=-1)                  # [T, E]
    weights, experts = torch.topk(probs, top_k, dim=-1)           # [T, k]
    weights = weights / weights.sum(dim=-1, keepdim=True)

    density = F.one_hot(experts[:, 0], n_experts).float().mean(0)
    aux_loss = n_experts * torch.sum(density * probs.mean(0))

    capacity = int(max(4, capacity_factor * tg * top_k / n_experts))
    lane = 128 if capacity > 128 else 4
    capacity = -(-capacity // lane) * lane

    x_g = x.reshape(g, tg, d)
    e_g = experts.reshape(g, tg, top_k)
    parts = [_dispatch_group(x_g[i], e_g[i], capacity, n_experts)
             for i in range(g)]
    buf, safe_rank, keep = (torch.stack(z) if g > 1 else z[0][None]
                            for z in zip(*parts))
    del parts

    h = activation(torch.einsum("gecd,edf->gecf", buf, params["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    del buf
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"])
    del h

    # combine: the k slots in order, in float32; a dropped slot gathers 0
    w_g = (weights.reshape(g, tg, top_k) * keep).float()
    rows = torch.arange(g, device=x.device)[:, None]
    out = torch.zeros((g, tg, d), dtype=torch.float32, device=x.device)
    for kk in range(top_k):
        kept = keep[:, :, kk]
        gath = out_buf[rows, e_g[:, :, kk],
                       torch.where(kept, safe_rank[:, :, kk], 0)]
        gath = torch.where(kept[..., None], gath, 0)
        out = out + gath.float() * w_g[:, :, kk, None]
    return out.reshape(t, d).to(x.dtype), aux_loss
