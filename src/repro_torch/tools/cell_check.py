"""The cells of ``launch.steps`` on the card, one rank a card: each cell
built at full width with ``backend="cuda"`` (batch and depth cut as the
spec says) under ``default_rules`` of the rank's mesh, run on this
rank's part of seeded whole inputs, and held against the same cell
built with the plain impls and run in one process on the whole inputs
on the same card (a rank compares its block of the one-process output).

Run by ``chip_smoke.py`` (the cells phase) through
:func:`repro_torch.launch.mesh.run_spmd`::

    run_spmd(cell_checks, shape, ("data", "model"), args=(spec,))

``spec`` maps a key to ``(arch, shape, cuts)``; ``cuts`` are
``build_cell``'s (``batch``, ``seq``, ``n_layers``, ``rows_per_field``;
``smoke`` for a run on the CPU, where the wrappers run their plain
versions).  A recsys config has no backend knob: its plain control also
takes ``bag_impl="plain"``.  A decode cell
runs ``DECODE_STEPS`` teacher-forced steps from position ``seq -
DECODE_STEPS`` of its seeded cache.  ``count(fn) -> (fn(), launches)``
counts the kernel launches of the cell's run.

An output's difference is its largest error over its largest value (the
stored reps' over their valid tokens).  A bf16 cell reports three, each
on the rank's block: ``diff`` (the kernels against the plain impls),
``kernel_vs_f32`` (the kernels against the plain impls at float32
compute on the same inputs, the control) and ``plain_bf16_vs_f32``
(the plain impls against that control: the bf16 rounding of the
reference itself); the card check holds the second within a small
factor of the third.  BERT4Rec's top-k ids are not a difference:
``ids_mismatch`` counts those that differ from the plain run's where the
values are not tied (:func:`_ids_mismatch`).  A retrieval cell's
scores are the rank's block of the candidates.

A train cell runs at float32 compute (``overrides`` on its result; its
configured bf16 step is held by no check here): the kernels' forward and
the plain versions' backward (``models.backend``) against the plain
impls.  Its ``diff``: the loss's and ``grad_norm``'s; ``grad_apart``,
its clipped gradient (AdamW's first moment after the step over ``1 -
b1``) as the distance from ``|got - want| <= APART_TOL + APART_TOL
|want|`` element by element (at most 1 inside); ``grad_leaf_rel``, the
largest of each gradient leaf's largest error over its largest value;
``params_apart``, the updated parameters' distance from the same
element-wise limits.  The last two read only what lies above rounding
(``held``): a leaf whose largest gradient reaches ``ROUNDING_FLOOR`` of
the tree's largest, and in it the elements whose gradient reaches
``ROUNDING_FLOOR`` of the leaf's largest.  Below it a gradient is
rounding: PreTTR's key biases get one that is zero in exact arithmetic
(softmax is blind to a bias every key shares), and a first AdamW step
moves each parameter by about the learning rate in its gradient's sign,
so such an element moves either way.
Off a world of 1, MoE configs run at capacity factor E / k, so that the
mesh's dispatch groups drop no token, as one process's one group drops
none.
"""
from __future__ import annotations

import dataclasses
import time

import torch

DECODE_STEPS = 4
# element-wise limits: rtol = atol = APART_TOL (the gloo tests' against
# JAX)
APART_TOL = 1e-5
# a gradient below this share of its leaf's (a leaf's, of the tree's)
# largest is read as rounding: float32 rounding sits near 1e-6 of it
ROUNDING_FLOOR = 1e-3


def _uncounted(fn):
    return fn(), {}


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _apart(got, want, tol: float) -> float:
    """How far ``got`` lies from ``|got - want| <= tol + tol |want|``, in
    units of ``tol`` (at most 1 inside); 0 for no element."""
    got, want = got.float(), want.float()
    if not want.numel():
        return 0.0
    return float(((got - want).abs() - tol * want.abs()).max()) / tol


def _timed(fn):
    """``(fn(), seconds)`` of one call, the card synchronised around it."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _rows(x, mesh, axes):
    from repro_torch.dist import spmd as S

    return S.local_block(x, 0, mesh, axes) if axes else x


TRAIN_KINDS = ("train", "prettr_train", "rec_train")


def _config(arch, cuts):
    """The config a cell's check reads its fields from: the transformer
    config of an LM or PreTTR arch, else the arch's own (recsys)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.backend import transformer_config_of

    spec = get_arch(arch)
    cfg = spec.smoke if cuts.get("smoke") else spec.config
    return transformer_config_of(cfg) or cfg


def _overrides(arch, shape, cuts, world) -> dict:
    """The config fields a cell's check replaces: a train cell's compute
    dtype (float32, where the kernels' forward meets the plain one to
    rounding), and off a world of 1 an MoE config's capacity factor
    (E / k)."""
    from repro_torch.configs import get_arch

    spec = get_arch(arch)
    cfg = _config(arch, cuts)
    over = {}
    if world > 1 and getattr(cfg, "n_experts", 0):
        over["capacity_factor"] = cfg.n_experts / cfg.top_k
    if shape == "rank_train" or spec.shapes.get(shape, {}).get("kind") \
            in TRAIN_KINDS:
        over["compute_dtype"] = torch.float32
    return over


def _plain(arch) -> dict:
    """What the plain control replaces besides the backend: a DLRM or
    DeepFM config's ``bag_impl`` (the recsys configs have no backend
    knob)."""
    from repro_torch.configs import get_arch

    return {"bag_impl": "plain"} \
        if hasattr(get_arch(arch).config, "bag_impl") else {}


def _spec(arch, over):
    """``arch``'s ArchSpec with ``over``'s fields replaced in its
    transformer configs (a PreTTR config's backbone), or in a recsys
    config itself."""
    from repro_torch.configs import get_arch
    from repro_torch.models.backend import transformer_config_of

    def swap(cfg):
        if cfg is None or not over:
            return cfg
        tcfg = transformer_config_of(cfg)
        if tcfg is None:
            return dataclasses.replace(cfg, **over)
        new = dataclasses.replace(tcfg, **over)
        return new if tcfg is cfg else dataclasses.replace(cfg, backbone=new)

    spec = get_arch(arch)
    return dataclasses.replace(spec, config=swap(spec.config),
                               smoke=swap(spec.smoke))


def _held(grads):
    """Each gradient leaf's mask of the elements above rounding
    (``ROUNDING_FLOOR``), None for a leaf wholly below it."""
    top = max(float(w.abs().max()) for _, w in grads)
    out = []
    for _, w in grads:
        m = float(w.abs().max())
        out.append(None if m < ROUNDING_FLOOR * top
                   else w.abs() >= ROUNDING_FLOOR * m)
    return out


def _outputs(kind, fn, whole, steps_from=None, fed=None):
    """The cell's outputs on ``whole``, as a dict of tensors (a decode
    cell's ``DECODE_STEPS`` logits from ``steps_from``, fed ``fed``;
    BERT4Rec's top-k as ``values`` and ``ids``)."""
    if kind == "decode":
        params, _, cache, _ = whole
        return {f"step{i}": fn(params, fed[:, i:i + 1], cache,
                               steps_from + i)[0]
                for i in range(DECODE_STEPS)}
    out = fn(*whole)
    if kind == "prefill":
        return {"logits": out[0], "k": out[1][0], "v": out[1][1]}
    if kind == "prettr_index":
        return {"reps": out}
    if kind in ("prettr_serve", "rec_retrieval"):
        return {"scores": out}
    if kind == "rec_serve":
        return dict(zip(("values", "ids"), out)) if isinstance(out, tuple) \
            else {"logits": out}
    return {"state": out[0], "loss": out[1]["loss"],
            "grad_norm": out[1]["grad_norm"]}


def cell_check(mesh, arch: str, shape: str, cuts: dict, *, seed: int = 0,
               count=_uncounted) -> dict:
    """One cell against its one-process plain run (module docstring)."""
    from repro_torch.dist import default_rules
    from repro_torch.dist import spmd as S
    from repro_torch.dist.compat import AbstractMesh
    from repro_torch.launch.steps import build_spec_cell
    from repro_torch.models import transformer_spmd as SP
    from repro_torch.tree import leaves, leaves_with_paths

    dev = mesh.device
    over = _overrides(arch, shape, cuts, mesh.size)
    plain = {**over, **_plain(arch)}
    one = default_rules(AbstractMesh((1, 1), ("data", "model")))
    cell = build_spec_cell(_spec(arch, over), shape, default_rules(mesh),
                           "cuda", **cuts)
    ref = build_spec_cell(_spec(arch, plain), shape, one, "plain", **cuts)
    gen = torch.Generator(device=dev).manual_seed(seed)
    whole = cell.inputs(gen, dev)
    kind = cell.kind
    train = kind in TRAIN_KINDS
    pcfg = _config(arch, cuts)
    out = {"arch": arch, "shape": shape, "kind": kind, "notes": cell.notes,
           "model_flops": cell.model_flops,
           "overrides": {k: {"run": str(v), "published": str(getattr(pcfg, k))}
                         for k, v in over.items()}}
    every = tuple(a for a in ("pod", "data", "model")
                  if a in mesh.axis_names)
    data = S.data_axes(mesh)
    kw = {}
    if kind == "decode":
        params, tokens, cache, pos = whole
        if cuts.get("smoke"):
            # a smoke config computes in float32: its cache widened to it
            cache = tuple(c.float() for c in cache)
            whole = (params, tokens, cache, pos)
        b, seq = cache[0].shape[1:3]
        vocab = cell.args[0]["embed"]["tokens"].shape[0]
        kw = {"steps_from": seq - DECODE_STEPS, "fed": torch.randint(
            0, vocab, (b, DECODE_STEPS), generator=gen,
            device=gen.device).to(dev)}
    # the decode steps write the cache in place: the references get copies
    copy = lambda dt=None: whole if kind != "decode" else (
        whole[0], whole[1], tuple(c.to(dt or c.dtype, copy=True)
                                  for c in whole[2]), whole[3])
    want, out["plain_s"] = _timed(lambda: _outputs(kind, ref.fn, copy(),
                                                   **kw))
    ctl = None
    if not train and not cuts.get("smoke"):
        # the control: the plain impls at float32 compute
        f32 = build_spec_cell(_spec(arch, {**plain, "compute_dtype":
                                           torch.float32}),
                              shape, one, "plain", **cuts)
        ctl = _outputs(kind, f32.fn, copy(torch.float32), **kw)
    local = cell.local(whole)
    if kind == "decode":
        kw["fed"] = S.data_block(kw["fed"], mesh)
    (got, out["s"]), out["launches"] = count(
        lambda: _timed(lambda: _outputs(kind, cell.fn, local, **kw)))
    if train:
        from repro_torch.optim import OptimizerConfig

        new_l = cell.local((want["state"], *whole[1:]))[0]
        pairs = lambda f: list(zip(leaves(f(got["state"])), leaves(f(new_l))))
        b1 = OptimizerConfig().b1            # both train cells' optimizer
        grads = [(g.float() / (1 - b1), w.float() / (1 - b1))
                 for g, w in pairs(lambda st: st["opt"]["m"])]
        held = _held(grads)
        names = [k for k, _ in leaves_with_paths(got["state"]["opt"]["m"])]
        kept = [(g, w, k) for (g, w), h, k in zip(grads, held, names)
                if h is not None]
        worst = max(kept, key=lambda gwk: _rel(gwk[0], gwk[1]))
        params = [(g[h], w[h]) for (g, w), h in
                  zip(pairs(lambda st: st["params"]), held) if h is not None]
        out["diff"] = {"loss": _rel(got["loss"], want["loss"]),
                       "grad_norm": _rel(got["grad_norm"],
                                         want["grad_norm"]),
                       "grad_apart": max(_apart(g, w, APART_TOL)
                                         for g, w in grads),
                       "grad_leaf_rel": _rel(worst[0], worst[1]),
                       "params_apart": max(_apart(g, w, APART_TOL)
                                           for g, w in params)}
        out["worst_leaf"] = worst[2]
        out["held"] = {
            "leaves": [len(kept), len(grads)],
            "elements": sum(int(h.sum()) for h in held if h is not None)
            / sum(g.numel() for g, _ in grads)}
        out["loss"] = float(got["loss"])
        out["grad_norm"] = float(got["grad_norm"])
        return out
    cfg = _config(arch, cuts)
    block = {"logits": lambda x: _rows(x, mesh, data),
             "k": lambda x: SP.cache_block(x, cfg, mesh),
             "v": lambda x: SP.cache_block(x, cfg, mesh),
             # a retrieval cell's candidates are cut over every axis
             "scores": (lambda x: S.local_block(x, 1, mesh, every))
             if kind == "rec_retrieval" else
             (lambda x: _rows(x, mesh, every))}
    if kind == "prettr_index":
        valid = _rows(whole[2], mesh, every)
        block["reps"] = lambda x: _rows(x, mesh, every)[valid]
        got["reps"] = got["reps"][valid]
    mine = lambda d: {k: block.get(k, block["logits"])(x)
                      for k, x in d.items()}
    want = mine(want)
    if "ids" in got:
        out["ids_mismatch"] = _ids_mismatch(got.pop("ids"), want.pop("ids"),
                                            want["values"])
    out["diff"] = {k: _rel(g, want[k]) for k, g in got.items()}
    if ctl is not None:
        ctl = mine(ctl)
        ctl.pop("ids", None)
        out["kernel_vs_f32"] = {k: _rel(g, ctl[k]) for k, g in got.items()}
        out["plain_bf16_vs_f32"] = {k: _rel(w, ctl[k])
                                    for k, w in want.items()}
    return out


def _ids_mismatch(got, want, values) -> int:
    """Top-k ids that differ where the values are not tied within
    rounding (a gap to either neighbour above 2^-20 of the largest
    value)."""
    v = values.float()
    inf = torch.full_like(v[:, :1], float("inf"))
    gap = torch.minimum((torch.cat([inf, v], 1)[:, :-1] - v).abs(),
                        (v - torch.cat([v, -inf], 1)[:, 1:]).abs())
    apart = gap > 2 ** -20 * float(v.abs().max())
    return int((got != want)[apart].sum())


def cell_checks(mesh, spec: dict, count=_uncounted) -> dict:
    """Every cell of ``spec`` (``{key: (arch, shape, cuts)}``) ->
    ``{key: result}``, with the world's size and this rank's mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"world": mesh.size, "rank": mesh.rank, "mesh": dict(mesh.shape)}
    for key, (arch, shape, cuts) in spec.items():
        out[key] = cell_check(mesh, arch, shape, cuts, count=count)
        if mesh.device.type == "cuda":
            out[key]["max_allocated_bytes"] = \
                torch.cuda.max_memory_allocated(mesh.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(mesh.device)
    return out
