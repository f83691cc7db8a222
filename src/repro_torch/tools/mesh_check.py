"""The SPMD checks of the port's collective consumers, one rank a card:
the row-sharded lookup, the MoE FFN, ``compressed_psum``, the sharded
transformer's loss and gradient (``lm``) and DimeNet's edge-sharded
train cell (``gnn``), each held to its one-process version on the same
card and timed.

Run by ``chip_smoke.py`` (the mesh phase) and ``tests/test_torch_cuda.py``
through :func:`repro_torch.launch.mesh.run_spmd`::

    run_spmd(spmd_checks, shape, ("data", "model"), args=(spec,))

``spec`` sizes each check (see ``chip_smoke.py``: DLRM's width and
serve_bulk's ids, granite-moe's and qwen3-moe's layer widths at 4 x 2048
tokens, PreTTR-BERT's gradient tree, gemma3-4b and granite-moe at full
width over 2 x 2048 tokens, DimeNet at ``ogb_products`` cut by 48).
Every rank makes the same seeded inputs whole on its card and takes its
part, so each check compares with the whole computation in one process.
``count(fn) -> (fn(), launches)`` counts the kernel launches of each
check's one main call (the timing loops run after it).  On one card the
world is 1 and the collectives are the identity; the results carry the
world size.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def _uncounted(fn):
    return fn(), {}


def _time_ms(fn, n: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` calls after one."""
    fn()
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _group(mesh):
    """(data groups, this rank's data group)."""
    from repro_torch.dist.compat import axis_index

    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not data:
        return 1, 0
    return mesh.axis_size(data), axis_index(mesh, data)


def lookup_check(mesh, *, rows: int, dim: int, n_ids: int, seed: int = 0,
                 count=_uncounted) -> dict:
    """``sharded_lookup`` of a bf16 ``[rows, dim]`` table row-sharded over
    the mesh: uniform ids at capacity factor 4 and Zipf(1.2) ids at 1,
    each equal to ``take(table, ids) * keep`` exactly."""
    from repro_torch.dist.compat import axis_index
    from repro_torch.models.recsys.embedding import (_bucket_group,
                                                     lookup_capacity,
                                                     sharded_lookup)

    dev = mesh.device
    rows -= rows % mesh.size                 # whole row blocks a rank
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = torch.randn((rows, dim), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    per, s = rows // mesh.size, mesh.size
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    c = axis_index(mesh, axes)
    local = full[c * per:(c + 1) * per]
    g, gi = _group(mesh)
    ng = n_ids // g
    rng = np.random.default_rng(seed)
    cases = {"uniform_cf4": (rng.integers(0, rows, n_ids), 4.0),
             "zipf_cf1": (np.minimum(rng.zipf(1.2, n_ids) - 1, rows - 1),
                          1.0)}
    out = {"rows": rows, "dim": dim, "n_ids": n_ids, "ids_a_rank": ng,
           "table_bytes_a_rank": local.numel() * local.element_size()}
    for name, (ids, cf) in cases.items():
        ids = torch.from_numpy(ids[gi * ng:(gi + 1) * ng]).to(dev)
        with torch.inference_mode():
            got, launches = count(
                lambda: sharded_lookup(local, ids, mesh, capacity_factor=cf))
            cap = lookup_capacity(ng, s, cf)
            keep = _bucket_group(ids, s, per, cap)[3]
            want = full.index_select(0, ids) * keep[:, None].to(full.dtype)
            out[name] = {
                "capacity": cap, "dropped": int((~keep).sum()),
                "equal": bool(torch.equal(got, want)),
                "launches": launches,
                "ms": _time_ms(lambda: sharded_lookup(
                    local, ids, mesh, capacity_factor=cf)),
                "take_ms": _time_ms(lambda: full.index_select(0, ids))}
    return out


def moe_check(mesh, *, n_experts: int, d_model: int, d_ff: int,
              top_k: int, n_tokens: int, capacity_factor: float = 1.25,
              seed: int = 0, count=_uncounted) -> dict:
    """``moe_ffn`` in float32 under rules over the mesh against
    ``moe_ffn(..., n_groups=G)`` in one process: the output over this
    rank's data group's tokens (the same groups, dispatched alone), the
    aux loss over all of them."""
    from repro_torch.dist import default_rules, install_rules
    from repro_torch.models.moe import init_moe, moe_ffn

    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_moe(d_model, d_ff, n_experts, torch.float32, gen,
                      device=dev)
    x = torch.randn((n_tokens, d_model), generator=gen, device=dev)
    g, gi = _group(mesh)
    m = mesh.shape.get("model", 1)
    use_ep = m > 1 and n_experts % m == 0
    groups = g if use_ep else g * m
    tg = n_tokens // g
    xg = x[gi * tg:(gi + 1) * tg]
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    with torch.inference_mode():
        _, want_aux = moe_ffn(params, x, n_groups=groups, **kw)
        want, _ = moe_ffn(params, xg, n_groups=groups // g, **kw)
        with install_rules(default_rules(mesh)):
            (got, aux), launches = count(lambda: moe_ffn(params, xg, **kw))
            ms = _time_ms(lambda: moe_ffn(params, xg, **kw))
        one_ms = _time_ms(lambda: moe_ffn(params, xg, n_groups=groups // g,
                                          **kw))
    scale = float(want.abs().max())
    return {"n_experts": n_experts, "d_model": d_model, "d_ff": d_ff,
            "top_k": top_k, "tokens": n_tokens, "tokens_a_rank": tg,
            "groups": groups, "expert_parallel": use_ep,
            "max_abs_diff": float((got - want).abs().max()),
            "max_abs": scale, "aux": float(aux), "aux_one_process":
            float(want_aux), "launches": launches, "ms": ms,
            "one_process_ms": one_ms}


def psum_error(mean, x, mesh, axis) -> tuple[float, float]:
    """``compressed_psum``'s ``mean`` of ``x`` (the gradients plus the
    residual it was given) against the plain float32 all-reduce mean over
    ``axis`` -> (the largest error over its leaf's largest mean value, the
    largest error over its leaf's int8 bound).

    The bound: a rank's value, rounded to its own scale ``s_r``, is at
    most ``s_r / 2`` off, and is then scaled by the ranks' mean scale
    ``s_bar`` (``|q| <= 127``: at most ``127 |s_bar - s_r|`` more), so a
    leaf's mean is at most ``mean_r(s_r / 2 + 127 |s_bar - s_r|)`` off;
    ``2**-16`` of the largest ``|x|`` covers float32's own rounding.  A
    wrong scale or a wrong ``/ n`` lands far above it."""
    import torch.distributed as dist

    from repro_torch.tree import leaves

    group, n = mesh.group(axis), mesh.axis_size(axis)
    xs, means = leaves(x), leaves(mean)
    s = torch.stack([v.abs().max() for v in xs]).float() / 127
    s_bar = s.clone()
    dist.all_reduce(s_bar, group=group)
    s_bar /= n
    bound = s / 2 + 127 * (s_bar - s).abs()
    dist.all_reduce(bound, group=group)
    bound /= n
    top = s.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    bound += 127 * top * 2.0 ** -16
    rel = over = 0.0
    for i, (got, v) in enumerate(zip(means, xs)):
        ref = v.float().clone()
        dist.all_reduce(ref, group=group)
        ref /= n
        err = float((got.float() - ref).abs().max())
        rel = max(rel, err / max(float(ref.abs().max()), 1e-30))
        over = max(over, err / float(bound[i]))
    return rel, over


def psum_check(mesh, *, axis, seed: int = 0, count=_uncounted) -> dict:
    """``compressed_psum`` over PreTTR-BERT's full gradient tree (float32
    leaves of ``prettr_bert.full_config()``'s parameter shapes): ms a
    call, and the mean against the plain float32 all-reduce mean and
    against its int8 bound (:func:`psum_error`)."""
    from repro_torch.configs.prettr_bert import full_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.dist import default_rules, install_rules
    from repro_torch.optim import compressed_psum, init_error_feedback
    from repro_torch.tree import leaves, tree_map

    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed + mesh.rank)
    shapes = init_prettr(full_config(), gen, device=dev)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=dev), shapes)
    del shapes
    fb = init_error_feedback(grads)
    n = sum(g.numel() for g in leaves(grads))
    with install_rules(default_rules(mesh)):
        (mean, _), launches = count(
            lambda: compressed_psum(grads, fb, axis))
        ms = _time_ms(lambda: compressed_psum(grads, fb, axis))
    rel, over = psum_error(mean, grads, mesh, axis)
    return {"params": n, "leaves": len(leaves(grads)),
            "int32_bytes": 4 * n, "rel_err_vs_f32_mean": rel,
            "err_over_bound": over,
            "finite": all(bool(torch.isfinite(x).all())
                          for x in leaves(mean)),
            "launches": launches, "ms": ms}


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def split_launches(fn):
    """``(fn(), launches)``: the split-attention kernel's launches in
    ``fn``, by form (a ``count`` for the checks)."""
    from repro_torch.kernels.split_attention import split_flash_attention
    attrs = {"split_attention": "launches",
             "split_attention_causal": "causal_launches",
             "split_attention_window": "window_launches"}
    for a in attrs.values():
        setattr(split_flash_attention, a, 0)
    out = fn()
    return out, {k: getattr(split_flash_attention, a)
                 for k, a in attrs.items()}


def lm_check(mesh, *, config, batch: int, seq: int, grad: bool,
             bf16: bool, seed: int = 0, count=_uncounted) -> dict:
    """The sharded transformer (``transformer_spmd``) at ``config`` (its
    float32 form) under ``default_rules`` over the mesh, against one process on
    the same card: each rank makes the whole seeded float32 params and
    ``[batch, seq + 1]`` tokens, takes its shards and its data rows.

    * ``loss``: ``causal_lm_loss`` in float32 (TF32 off) through the
      kernels (``attn_impl="cuda"``, no grad), its launches counted,
      against the one-process loss over the whole batch; ``ms`` of each;
    * ``grad`` (with ``grad``): the loss and every gathered gradient leaf
      through the plain impl (the kernel wrappers refuse grad) against
      one process's, taken a batch row at a time (the whole batch's
      activations do not fit on the card beside the params and their
      gradient; every row but the last waits on the host) and averaged:
      every label counts, so the batch mean is the mean of the rows'
      means; each leaf's largest error over its largest value
      (``max_leaf_rel``), and each leaf element by element against
      ``|got - want| <= atol + rtol |want|`` (rtol = atol = 1e-5, the
      gloo tests' limit against JAX); the control
      (``control_tf32_max_leaf_rel``): the same sharded gradient with
      TF32 products, a lower precision that a sound float32 gradient
      must beat;
    * ``bf16`` (with ``bf16``): the loss at bf16 compute through the
      kernels, its launches counted, timed, against one process's; the
      control (``control_rel``): one process's bf16 loss against its
      float32 loss.

    MoE configs run at capacity factor E / k, so no token is dropped
    under the mesh's dispatch groups or one process's single group."""
    import dataclasses

    from repro_torch.dist import default_rules, install_rules
    from repro_torch.dist import spmd as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths, tree_map

    dev = mesh.device
    cfg = dataclasses.replace(config, attn_impl="cuda",
                              compute_dtype=torch.float32)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    plain = dataclasses.replace(cfg, attn_impl="plain")
    c16 = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    whole = T.init_params(cfg, gen, device=dev)
    whole_bytes = sum(t.numel() * t.element_size()
                      for _, t in leaves_with_paths(whole))
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=dev)

    def one(c, p=whole):
        return T.causal_lm_loss(p, c, toks[:, :-1], toks[:, 1:])

    # one process first, before this rank's shards exist beside the whole
    # params: its loss, and its gradient a row at a time, kept on the host
    with torch.no_grad():
        want = {"f32": float(one(cfg)), "ms": _time_ms(lambda: one(cfg), 3)}
        if bf16:
            want.update(bf16=float(one(c16)),
                        bf16_ms=_time_ms(lambda: one(c16), 3))
    if grad:
        want_l, host_g = 0.0, None
        for r in range(batch):
            row = toks[r:r + 1]
            lr, last_g = value_and_grad(lambda p: T.causal_lm_loss(
                p, plain, row[:, :-1], row[:, 1:]), whole)
            want_l += float(lr) / batch
            if r < batch - 1:
                on_host = tree_map(lambda t: t.to("cpu"), last_g)
                host_g = on_host if host_g is None else tree_map(
                    torch.add, host_g, on_host)
                del last_g, on_host
                torch.cuda.empty_cache()

    rules = default_rules(mesh)
    axes = T.param_axes(cfg)
    local = S.shard_tree(whole, axes, rules)
    mine = S.data_block(toks, mesh)

    def sharded(c, p=local):
        with install_rules(rules):
            return T.causal_lm_loss(p, c, mine[:, :-1], mine[:, 1:])

    # the whole leaves this rank holds only to compare (a shard that is
    # the whole leaf, or a view of it, shares its storage)
    compare_bytes = sum(
        w.numel() * w.element_size() for (_, w), (_, l) in
        zip(leaves_with_paths(whole), leaves_with_paths(local))
        if l.untyped_storage().data_ptr() != w.untyped_storage().data_ptr())

    def peak():
        """This rank's peak bytes, less what it holds only to compare: the
        whole params that are not its shards and the one-process
        gradient's last row (its shards counted)."""
        ref = sum(t.numel() * t.element_size()
                  for _, t in leaves_with_paths(last_g)) if grad else 0
        return torch.cuda.max_memory_allocated(dev) - compare_bytes - ref

    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.dh, "vocab": cfg.vocab_size,
           "n_experts": cfg.n_experts, "tokens": [batch, seq],
           "tokens_a_rank": list(mine[:, 1:].shape),
           "param_bytes": whole_bytes,
           "param_bytes_a_rank": sum(t.numel() * t.element_size()
                                     for _, t in leaves_with_paths(local)),
           "loss_rtol": 1e-5}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        got, launches = count(lambda: float(sharded(cfg)))
        out["loss"] = {"sharded": got, "one_process": want["f32"],
                       "rel": abs(got - want["f32"]) / abs(want["f32"]),
                       "launches": launches,
                       "ms": _time_ms(lambda: sharded(cfg), 3),
                       "one_process_ms": want["ms"],
                       "rank_peak_bytes": peak()}
    if grad:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        specs = S.tree_specs(whole, axes, rules)
        rest = leaves_with_paths(host_g) if host_g is not None else None

        def leaf_errors(g_local):
            """Each leaf's (largest error over its largest value, how far
            past rtol = atol = 1e-5 in units of atol: <= 0 inside)."""
            errs, excess = {}, {}
            got_g = S.gather_tree(g_local, specs, mesh)
            for i, ((k, g), (_, w)) in enumerate(zip(
                    leaves_with_paths(got_g), leaves_with_paths(last_g))):
                if rest is not None:
                    w = rest[i][1].to(dev) + w
                w = w / batch
                errs[k] = _rel(g, w)
                excess[k] = float(((g - w).abs() - 1e-5 * w.abs()).max()) \
                    / 1e-5
            return errs, excess

        got_l, got_g = value_and_grad(lambda p: sharded(plain, p), local)
        rank_peak = peak()
        errs, excess = leaf_errors(got_g)
        del got_g
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, ctl_g = value_and_grad(lambda p: sharded(plain, p), local)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ctl = leaf_errors(ctl_g)[0]
        del ctl_g
        worst, ctl_worst = max(errs, key=errs.get), max(ctl, key=ctl.get)
        out["grad"] = {"loss": float(got_l), "one_process": want_l,
                       "loss_rel": abs(float(got_l) - want_l) / abs(want_l),
                       "leaves": len(errs), "max_leaf_rel": errs[worst],
                       "worst_leaf": worst, "rtol": 1e-5, "atol": 1e-5,
                       "leaves_apart": sum(e > 1 for e in excess.values()),
                       "max_excess_over_atol": max(excess.values()),
                       "control_tf32_max_leaf_rel": ctl[ctl_worst],
                       "control_worst_leaf": ctl_worst,
                       "rank_peak_bytes": rank_peak}
        del host_g, last_g
        torch.cuda.empty_cache()
    if bf16:
        with torch.no_grad():
            got, launches = count(lambda: float(sharded(c16)))
            out["bf16"] = {"sharded": got, "one_process": want["bf16"],
                           "rel": abs(got - want["bf16"])
                           / abs(want["bf16"]),
                           "control_rel": abs(want["bf16"] - want["f32"])
                           / abs(want["f32"]),
                           "launches": launches,
                           "ms": _time_ms(lambda: sharded(c16), 3),
                           "one_process_ms": want["bf16_ms"]}
    out["max_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def gnn_check(mesh, *, shape: str, graph_cut: int, steps: int,
              seed: int = 0, count=_uncounted) -> dict:
    """DimeNet's GNN cell ``shape`` cut by ``graph_cut``
    (``launch.steps.build_cell`` under ``default_rules`` over the mesh; the
    full config, the published compute dtype) through the edge-sharded
    route, against one process on the same card.  Every rank makes the
    cell's whole args by ``cell.inputs`` (the seeded graph built on the
    host, the params and AdamW state on its card: ``host_build_s``) and
    takes its blocks by ``cell.local``.

    * ``f32``: the loss and every gradient leaf, gathered whole, at
      float32 compute, against one process's (no rules, the whole graph):
      ``loss_rel``, each leaf's largest error over its largest value
      (``max_leaf_rel``, ``worst_leaf``); the control: one process against
      itself run again (``index_add`` accumulates by atomics, in another
      order each run);
    * ``bf16``: ``steps`` of the cell's own train step (``cell.fn``, bf16
      messages) on the rank's blocks: the losses, ``ms`` a step (median
      after the first), the peak bytes; the first loss against one
      process's float32 loss (``apart``) beside one process's own bf16
      loss against it (``control``).

    ``launches`` counts the kernel launches of the route's float32
    gradient and the train steps (the path runs none); ``wall_s`` is the
    check's, host build included."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import default_rules, install_rules
    from repro_torch.dist import spmd as S
    from repro_torch.launch import steps as ST
    from repro_torch.models.gnn import dimenet as D
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths

    start = time.perf_counter()
    dev = mesh.device
    rules = default_rules(mesh)
    cell = ST.build_cell("dimenet", shape, rules, graph_cut=graph_cut)
    # the model's config; the sizes are read from the cell's inputs
    cfg = ST.gnn_cell_config(get_arch("dimenet"), shape, graph_cut).cfg
    t0 = time.perf_counter()
    state, batch = cell.inputs(torch.Generator(device=dev).manual_seed(seed),
                               dev)
    host_s = time.perf_counter() - t0
    params = state["params"]
    local_state, local_batch = cell.local((state, batch))
    loss_fn = D.energy_loss if cfg.task == "energy" else D.node_cls_loss
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    one = lambda k: value_and_grad(lambda p: loss_fn(p, k, batch), params)
    want_l, want_g = one(cfg32)
    again_l, again_g = one(cfg32)
    with torch.no_grad():
        one16 = float(loss_fn(params, cfg, batch))
    want = dict(leaves_with_paths(want_g))
    specs = ST._specs_of(cell.args[0]["params"])

    def leaf_errors(got_g):
        errs = {k: _rel(gk, want[k]) for k, gk in leaves_with_paths(got_g)}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    control = {"loss_rel": abs(float(again_l) - float(want_l))
               / abs(float(want_l)),
               "max_leaf_rel": leaf_errors(again_g)[0]}
    del again_g
    torch.cuda.empty_cache()

    def route():
        with install_rules(rules):
            got_l, got_g = value_and_grad(
                lambda p: loss_fn(p, cfg32, local_batch),
                local_state["params"])
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        st, losses, events = local_state, [], []
        for _ in range(steps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            st, out = cell.fn(st, local_batch)
            b.record()
            losses.append(out["loss"])
            events.append((a, b))
        torch.cuda.synchronize(dev)
        return got_l, got_g, [float(x) for x in losses], events

    (got_l, got_g, losses, events), launches = count(route)
    peak = torch.cuda.max_memory_allocated(dev)
    got_whole = S.gather_tree(got_g, specs, mesh)
    max_leaf, worst = leaf_errors(got_whole)
    del got_g, got_whole, want_g, want
    torch.cuda.empty_cache()
    info = get_arch("dimenet").shapes[shape]
    one32 = float(want_l)
    return {"shape": shape, "config": cfg.name,
            "n_blocks": cfg.n_blocks, "d_hidden": cfg.d_hidden,
            "n_bilinear": cfg.n_bilinear,
            "compute_dtype": str(cfg.compute_dtype),
            "reduced": {"graph_cut": {"run": graph_cut, "published": 1},
                        "n_nodes": {"run": int(batch["positions"].shape[0]),
                                    "published": info["n_nodes"]},
                        "n_edges": {"run": int(batch["edge_valid"].sum()),
                                    "published": info["n_edges"]}},
            "nodes": int(batch["positions"].shape[0]),
            "edges_padded": int(batch["edge_src"].shape[0]),
            "triplet_slots": int(batch["trip_kj"].shape[0]),
            "edges_a_rank": int(local_batch["edge_src"].shape[0]),
            "triplet_slots_a_rank": int(local_batch["trip_kj"].shape[0]),
            "node_feat_rows_a_rank": int(local_batch["node_feat"].shape[0]),
            "host_build_s": host_s,
            "f32": {"loss": float(got_l), "one_process": one32,
                    "loss_rel": abs(float(got_l) - one32) / abs(one32),
                    "max_leaf_rel": max_leaf, "worst_leaf": worst,
                    "control_one_process_again": control},
            "bf16": {"losses": losses, "steps": steps,
                     "one_process_f32": one32, "one_process_bf16": one16,
                     "apart": abs(losses[0] - one32),
                     "control": abs(one16 - one32),
                     "ms": statistics.median(a.elapsed_time(b)
                                             for a, b in events[1:]),
                     "rank_peak_bytes": peak},
            "launches": launches, "wall_s": time.perf_counter() - start}


def spmd_checks(mesh, spec: dict, count=_uncounted) -> dict:
    """The checks ``spec`` sizes -> {check: result}: the lookup, the MoE
    FFNs, ``compressed_psum``, the sharded transformers (``lm``) and
    DimeNet's train cell (``gnn``), each when ``spec`` has its key."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"world": mesh.size, "rank": mesh.rank,
           "mesh": dict(mesh.shape),
           "device": torch.cuda.get_device_name(mesh.device)}
    if "lookup" in spec:
        out["lookup"] = lookup_check(mesh, count=count, **spec["lookup"])
        torch.cuda.empty_cache()
    for name, kw in spec.get("moe", {}).items():
        out[f"moe_{name}"] = moe_check(mesh, count=count, **kw)
        torch.cuda.empty_cache()
    if "psum" in spec:
        out["psum"] = psum_check(mesh, count=count, **spec["psum"])
        torch.cuda.empty_cache()
    for name, kw in spec.get("lm", {}).items():
        out[f"lm_{name}"] = lm_check(mesh, count=count, **kw)
        torch.cuda.empty_cache()
    if "gnn" in spec:
        out["gnn"] = gnn_check(mesh, count=count, **spec["gnn"])
        torch.cuda.empty_cache()
    return out
