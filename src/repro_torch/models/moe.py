"""Mixture-of-Experts FFN with top-k routing and grouped capacity dispatch,
the port of ``repro.models.moe``.

Dispatch follows GShard's grouped formulation: tokens are split into
``G`` groups, and each group routes its own tokens into a ``[E, C, d]``
buffer (stable argsort by expert id -> within-expert rank -> scatter);
a token's slot past the capacity ``C`` is dropped.  The expert products
are plain batched products over the buffer, the combine sums each
token's ``k`` slots in float32.  The JAX package has no Pallas kernel
here, and neither has the port.

``G`` comes from the installed sharding rules (``repro_torch.dist``),
as the JAX package sizes it from its mesh: with ``E`` divisible by the
``model`` axis (expert parallelism) one group a data group, else one a
device; one group without rules.  Under rules over an SPMD mesh
(``repro_torch.dist.compat.SpmdMesh``) each rank holds its data group's
tokens and runs its part, JAX's GSPMD layout written out:

* expert parallelism: every ``model`` rank of a data group routes the
  group's tokens, keeps its ``E/m`` slice of the dispatch buffer and of
  the (whole, replicated) expert weights, a free slice, runs those
  experts, and all-gathers the expert outputs over ``model`` before the
  float32 combine;
* otherwise each ``model`` rank routes its own share of the group's
  tokens through every expert, and the outputs are gathered over
  ``model``.

Under the sharded transformer (``transformer_spmd``) the expert weights
are a rank's blocks (``model_cut``): its ``E/m`` experts, or, where
``model`` cut ``d_ff`` instead (E does not divide it), ``d_ff/m`` of
every expert's columns, whose partial outputs are all-reduced over
``model``.

The aux loss is a mean over every token of the mesh: the routing sums
are all-reduced over the axes that split the tokens.  Under an SPMD mesh
every collective is one of :mod:`repro_torch.dist.spmd`'s autograd
functions, so the FFN takes a gradient as on one device: the gathered
expert outputs keep this rank's block of their gradient (every rank
combines alike), the ``d_ff`` blocks' float32 all-reduce passes it
through, and a tensor that the ranks of ``model`` use for different work
(the dispatch buffer, or whole weights over a rank's share of the
tokens) has its gradient summed over them.  A parameter's gradient is
summed over the data groups by the caller (the sharded transformer's
FSDP gather does).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist import spmd as S
from repro_torch.dist.compat import SpmdMesh, axis_index
from repro_torch.dist.context import current_rules


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


def moe_axes() -> dict:
    """The logical axes of :func:`init_moe`'s tree (the JAX ``init_moe``'s
    second return): ``experts`` and ``mlp`` both annotate toward
    ``model``, and ``divisible_spec`` keeps the first that divides (expert
    parallelism where E divides it, else ``d_ff`` over ``model``)."""
    return {"router": ("embed", None),
            "w_gate": ("experts", "embed", "mlp"),
            "w_up": ("experts", "embed", "mlp"),
            "w_down": ("experts", "mlp", "embed")}


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


def _data_axes(rules):
    """The data axes that split the tokens' rows (``pod``, ``data``, as
    the rules map the batch onto them: none where a batch too small to
    split is whole on every rank)."""
    batch = rules.mesh_axes("batch")
    return tuple(a for a in ("pod", "data")
                 if a in rules.mesh.shape and a in batch)


def _mesh_info():
    """``(mesh, data axes, data groups, model size)`` of the installed
    rules, or ``(None, (), 1, 1)``."""
    rules = current_rules()
    if rules is None:
        return None, (), 1, 1
    mesh, data = rules.mesh, _data_axes(rules)
    g = math.prod(mesh.shape[a] for a in data)
    return mesh, data, g, mesh.shape.get("model", 1)


def _group_axes(mesh, data, include_model: bool):
    """The mesh axes the dispatch groups run along."""
    fs = data
    if include_model and "model" in mesh.axis_names:
        fs = fs + ("model",)
    return fs if fs else None


def _one_group(params, x, mesh, data, model_cut, **kw):
    """JAX's fallback where the dispatch groups do not split a data
    group's tokens: one group over every token.  Each rank gathers the
    tokens of the data groups (their gradient summed back to the rank
    that holds them) and the expert weights whole over ``model`` (its
    ranks do the same work and keep their blocks of the gradient), runs
    the group as one process does and keeps its data group's rows.  Every
    data group computes the whole aux loss, so each passes back its share
    of the aux loss's gradient."""
    from repro_torch.dist.context import install_rules

    cut = {"experts": {"w_gate": 0, "w_up": 0, "w_down": 0},
           "ff": {"w_gate": 2, "w_up": 2, "w_down": 1}}.get(model_cut, {})
    whole = {k: S.all_gather(v, cut[k], mesh, "model", backward="split")
             if k in cut else v for k, v in params.items()}
    with install_rules(None):
        out, aux = moe_ffn(whole, S.all_gather(x, 0, mesh, data), n_groups=1,
                           **kw)
    groups = mesh.axis_size(data)
    return S.local_block(out, 0, mesh, data), \
        aux.detach() + (aux - aux.detach()) / groups


def moe_ffn(params: dict, x, *, top_k: int, capacity_factor: float = 1.25,
            activation=F.silu, n_groups: int | None = None,
            model_cut: str | None = None):
    """x: [T, d] tokens -> (out [T, d] in x's dtype, aux_loss float32
    scalar).  ``params`` already in x's dtype (the block casts them).

    The router runs in float32 (``x.float() @ router.float()``); each
    token takes its ``top_k`` experts, weighted by their renormalised
    probabilities.  Capacity ``int(max(4, cf * Tg * k / E))``, rounded up
    to a multiple of 128 above 128, else of 4.  ``G`` groups (module
    docstring; ``n_groups`` overrides it) dispatch alone; a T that ``G``
    does not divide falls back to one group, as the JAX package does.
    The aux loss is Switch's load balance, ``E * sum(density *
    mean_probs)`` over the first choices.

    Under an SPMD mesh ``x`` is this rank's data group's tokens, the
    groups are counted over the whole mesh, and each data group runs its
    whole groups; where the groups do not split its tokens the mesh runs
    JAX's one group (:func:`_one_group`).  ``model_cut`` says
    which dim of the expert weights the rules cut over ``model`` when
    they are this rank's blocks (their ``embed`` dim gathered, as the
    sharded transformer passes them): ``"experts"``, this rank's ``E /
    m`` experts; ``"ff"``, every expert's ``d_ff / m`` columns of
    ``w_gate`` / ``w_up`` and rows of ``w_down``: each model rank then
    runs all of its data group's tokens through its columns, and the
    partial expert outputs are all-reduced over ``model`` in float32
    before the combine.  ``None``: whole experts on every rank."""
    t, d = x.shape
    n_experts = params["router"].shape[-1]
    mesh, data, g_mesh, n_model = _mesh_info()
    use_ep = n_model > 1 and n_experts % n_model == 0
    g = n_groups or (g_mesh if use_ep else g_mesh * n_model)
    spmd = isinstance(mesh, SpmdMesh)
    if model_cut not in (None, "experts", "ff") or (
            model_cut and not (spmd and (model_cut == "experts") == use_ep)):
        raise ValueError(f"moe_ffn: model_cut {model_cut!r} with {n_experts} "
                         f"experts over {n_model} model ranks")
    col_split = model_cut == "ff"
    e_lo, n_local, model = 0, n_experts, ()
    if spmd:
        # the groups of this data group, then this rank's share of them
        local = g // g_mesh
        if g % g_mesh or t % local or (not use_ep and local % n_model):
            return _one_group(params, x, mesh, data, model_cut, top_k=top_k,
                              capacity_factor=capacity_factor,
                              activation=activation)
        j = axis_index(mesh, "model") if "model" in mesh.shape else 0
        if "model" in mesh.shape:
            model = ("model",)
        if use_ep:
            n_local = n_experts // n_model
            e_lo = j * n_local
        elif not col_split:
            # a share of the tokens through whole weights: what every
            # model rank uses for its own tokens sums its gradient
            params = {k: S.copy_to(v, mesh, model)
                      for k, v in params.items()}
            x = S.copy_to(x, mesh, model).reshape(n_model, t // n_model,
                                                  d)[j]
            local //= n_model
        g, t_all = local, t * g_mesh
        token_axes = _group_axes(mesh, data, not (use_ep or col_split))
    elif t % g:
        g = 1
    tg = x.shape[0] // g

    router_logits = x.float() @ params["router"].float()
    probs = torch.softmax(router_logits, dim=-1)                  # [T, E]
    weights, experts = torch.topk(probs, top_k, dim=-1)           # [T, k]
    weights = weights / weights.sum(dim=-1, keepdim=True)

    first = F.one_hot(experts[:, 0], n_experts).float()
    if spmd:
        # means over every token of the mesh
        density = S.all_reduce_sum(first.sum(0), mesh, token_axes) / t_all
        mean_probs = S.all_reduce_sum(probs.sum(0), mesh,
                                      token_axes) / t_all
    else:
        density, mean_probs = first.mean(0), probs.mean(0)
    aux_loss = n_experts * torch.sum(density * mean_probs)

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

    # expert parallelism: this rank's free slice of the experts (already
    # its own under ``model_cut``); the buffer, the same on every model
    # rank, feeds each rank's own experts or d_ff columns
    sliced = spmd and use_ep and not model_cut
    w = {k: S.copy_to(params[k], mesh, model)[e_lo:e_lo + n_local]
         if sliced else params[k] for k in ("w_gate", "w_up", "w_down")}
    if spmd and (use_ep or col_split):
        buf = S.copy_to(buf, mesh, model)
    buf = buf[:, e_lo:e_lo + n_local]
    h = activation(torch.einsum("gecd,edf->gecf", buf, w["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, w["w_up"])
    del buf
    out_buf = torch.einsum("gecf,efd->gecd", h, w["w_down"])
    del h
    if spmd and use_ep:
        out_buf = S.all_gather(out_buf, 1, mesh, model,
                               backward="split")        # [G, E, C, d]
    elif col_split:
        # the d_ff blocks' partial products, summed in float32
        out_buf = S.all_reduce_sum(out_buf.float(), mesh, model) \
            .to(out_buf.dtype)

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
    out = out.reshape(g * tg, d).to(x.dtype)
    if spmd and not (use_ep or col_split):
        out = S.all_gather(out, 0, mesh, model, backward="split")
    return out, aux_loss
