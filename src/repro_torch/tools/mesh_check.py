"""The SPMD checks of the port's collective consumers, one rank a card:
the row-sharded lookup, the MoE FFN and ``compressed_psum``, each held to
its one-process version on the same card and timed.

Run by ``chip_smoke.py`` (the mesh phase) and ``tests/test_torch_cuda.py``
through :func:`repro_torch.launch.mesh.run_spmd`::

    run_spmd(spmd_checks, shape, ("data", "model"), args=(spec,))

``spec`` sizes each check (see ``chip_smoke.py``: DLRM's width and
serve_bulk's ids, granite-moe's and qwen3-moe's layer widths at 4 x 2048
tokens, PreTTR-BERT's gradient tree).  Every rank makes the same seeded
inputs whole on its card and takes its part, so each check compares with
the whole computation in one process.  ``count(fn) -> (fn(), launches)``
counts the kernel launches of each check's one main call (the timing
loops run after it).  On one card the world is 1 and the collectives
are the identity; the results carry the world size.
"""
from __future__ import annotations

import statistics

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


def spmd_checks(mesh, spec: dict, count=_uncounted) -> dict:
    """The three checks at ``spec``'s sizes -> {check: result}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"world": mesh.size, "rank": mesh.rank,
           "mesh": dict(mesh.shape),
           "device": torch.cuda.get_device_name(mesh.device),
           "lookup": lookup_check(mesh, count=count, **spec["lookup"])}
    torch.cuda.empty_cache()
    for name, kw in spec["moe"].items():
        out[f"moe_{name}"] = moe_check(mesh, count=count, **kw)
        torch.cuda.empty_cache()
    out["psum"] = psum_check(mesh, count=count, **spec["psum"])
    return out
