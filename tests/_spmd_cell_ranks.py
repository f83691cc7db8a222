"""Rank functions of the cell tests (``test_torch_sharded_decode.py``,
``test_torch_sharded_train.py`` on gloo ranks; ``test_torch_cuda.py`` on
the card): importable by name in the spawned ranks, torch and the port
only.  Each rank builds the cell under
``default_rules`` of its mesh, takes its part of the whole inputs with
the cell's own ``local``, runs the cell's function and returns what it
got beside the block of the single-device reference that it should
equal (as numpy)."""
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.dist import default_rules
from repro_torch.dist import spmd as S
from repro_torch.dist.compat import spmd_mesh
from repro_torch.launch import steps as ST
from repro_torch.models import transformer_spmd as SP
from repro_torch.tree import tree_map


def _meshes(mesh, extra_meshes):
    out = {"x".join(map(str, mesh.shape.values())): mesh}
    for sizes, names in extra_meshes:
        out["x".join(map(str, sizes))] = spmd_mesh(sizes, names, "cpu")
    return out


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _np(x):
    return x.detach().float().numpy()


def _decode_case(mesh, arch, cfg, params, prompt, fed, want):
    """Prefill (``forward(collect_cache=True)`` and the last logits) and
    ``len(fed[0])`` decode steps through the cells on this rank."""
    rules = default_rules(mesh)
    spec = dataclasses.replace(get_arch(arch), config=cfg)
    b, p = prompt.shape
    steps = fed.shape[1]
    whole = _t(params)
    pre = ST.make_lm_cell(spec, "prefill_32k", rules, batch=b, seq=p)
    lg, (k, v) = pre.fn(*pre.local((whole, torch.from_numpy(prompt))))
    dec = ST.make_lm_cell(spec, "decode_32k", rules, batch=b, seq=p + steps)
    # float32 caches: the comparison sees the arithmetic alone
    icfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    shape = (cfg.n_layers, b, p + steps, cfg.n_kv_heads, cfg.dh)
    cache = (torch.zeros(shape), torch.zeros(shape))
    params_l, _, cache, _ = dec.local((whole, torch.from_numpy(fed[:, :1]),
                                       cache, 0))
    cache[0][:, :, :p] = k
    cache[1][:, :, :p] = v
    rows = lambda a: _np(S.data_block(torch.from_numpy(a), mesh))
    out = {"prefill_logits": (_np(lg), rows(want["prefill_logits"])),
           "k": (_np(k), _np(SP.cache_block(torch.from_numpy(want["k"]),
                                            icfg, mesh))),
           "v": (_np(v), _np(SP.cache_block(torch.from_numpy(want["v"]),
                                            icfg, mesh)))}
    fed_l = S.data_block(torch.from_numpy(fed), mesh)
    for i in range(steps):
        lg, cache = dec.fn(params_l, fed_l[:, i:i + 1], cache, p + i)
        out[f"step{i}"] = (_np(lg), rows(want["steps"][i]))
    return out


def decode_world(mesh, cases, extra_meshes):
    """Every decode case on ``mesh`` and each of ``extra_meshes`` ->
    {mesh key: {case: {what: (got, want)}}}."""
    return {key: {name: _decode_case(m, *case)
                  for name, case in cases.items()}
            for key, m in _meshes(mesh, extra_meshes).items()}


def _train_case(mesh, kind, arch, cfg, accum, batch, seq, state, data):
    """One train step of a cell on this rank -> (loss, grad_norm, the
    updated params gathered whole or None off rank 0)."""
    rules = default_rules(mesh)
    spec = dataclasses.replace(get_arch(arch), config=cfg)
    if kind == "lm":
        cell = ST.make_lm_cell(spec, "train_4k", rules, batch=batch, seq=seq)
        st, specs = cell.args[0], tree_map(lambda t: t.spec,
                                           cell.args[0]["params"])
        fn = ST.make_lm_train_step(cfg, ST._lm_opt_cfg(cfg), accum, rules,
                                   specs)
    else:
        cell = ST.make_prettr_cell(spec, "rank_train", rules, batch=batch)
        st, fn = cell.args[0], cell.fn
    args = cell.local((_t(state), *(_t(d) for d in data)))
    new, out = fn(*args)
    specs = tree_map(lambda t: t.spec, st["params"])
    whole = S.gather_tree(new["params"], specs, mesh)
    return (float(out["loss"]), float(out["grad_norm"]),
            tree_map(_np, whole) if mesh.rank == 0 else None)


def _grad_on_another_thread(mesh, kind, arch, cfg, accum, batch, seq,
                            state, data):
    """An LM case's gradient with the backward pass run on a thread that
    has no rules installed, as autograd runs it on the card (the layers'
    recomputation must see the rules) -> its largest difference from
    the backward pass on this thread, or the error it raised."""
    import threading

    from repro_torch.dist import install_rules
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    rules = default_rules(mesh)
    local = S.shard_tree(_t(state["params"]), T.param_axes(cfg), rules)
    params = tree_map(lambda t: t.detach().requires_grad_(), local)
    p = leaves(params)
    toks = {k: S.data_block(torch.from_numpy(v), mesh)
            for k, v in data[0].items()}

    def loss():
        with install_rules(rules), torch.enable_grad():
            return T.causal_lm_loss(params, cfg, toks["tokens"],
                                    toks["labels"])

    box = {}

    def other(value):
        try:
            box["g"] = torch.autograd.grad(value, p)
        except Exception as e:          # reported to the test
            box["error"] = repr(e)

    thread = threading.Thread(target=other, args=(loss(),))
    thread.start()
    thread.join()
    if "error" in box:
        return box["error"]
    here = torch.autograd.grad(loss(), p)
    return max(float((a - b).abs().max()) for a, b in zip(box["g"], here))


def train_world(mesh, cases):
    """Every train case on ``mesh`` -> {case: (loss, grad_norm,
    params)}, and under ``"grad_thread"`` granite-moe's expert-parallel
    gradient with its backward pass on another thread."""
    out = {name: _train_case(mesh, *case) for name, case in cases.items()}
    out["grad_thread"] = _grad_on_another_thread(mesh,
                                                 *cases["granite_ep"])
    return out


def _max_rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def card_decode(mesh, steps=4):
    """gemma3's smoke prefill and decode cells on this rank's card through
    the kernels (``"cuda"``), float32 compute, against the same cells
    through the plain impls in one process on the card -> the largest
    relative differences and the flash-decode (row 6) launches of the
    decode steps."""
    from repro_torch.dist.compat import AbstractMesh
    from repro_torch.kernels.decode_attention import flash_decode_attention

    dev = mesh.device
    b, p = 2, 40
    one = default_rules(AbstractMesh((1, 1), ("data", "model")))
    out = {}
    for label, rules, backend in (("mesh", default_rules(mesh), "cuda"),
                                  ("one", one, "plain")):
        pre = ST.build_cell("gemma3-4b", "prefill_32k", rules, backend,
                            smoke=True, batch=b, seq=p)
        dec = ST.build_cell("gemma3-4b", "decode_32k", rules, backend,
                            smoke=True, batch=b, seq=p + steps)
        gen = torch.Generator(device=dev).manual_seed(0)
        params, prompt = pre.inputs(gen, dev)
        lg, (k, v) = pre.fn(*pre.local((params, prompt)))
        cfg = get_arch("gemma3-4b").smoke
        shape = (cfg.n_layers, b, p + steps, cfg.n_kv_heads, cfg.dh)
        cache = tuple(torch.zeros(shape, device=dev) for _ in range(2))
        params_l, _, cache, _ = dec.local((params, prompt[:, :1], cache, 0))
        cache[0][:, :, :p], cache[1][:, :, :p] = k, v
        flash_decode_attention.launches = 0
        logits = [lg]
        for i in range(steps):
            lg, cache = dec.fn(params_l, prompt[:, i:i + 1], cache, p + i)
            logits.append(lg)
        out[label] = (logits, flash_decode_attention.launches)
    return {"max_rel": max(_max_rel(a, b) for a, b in
                           zip(out["mesh"][0], out["one"][0])),
            "launches": out["mesh"][1], "plain_launches": out["one"][1]}


def card_moe_train(mesh):
    """granite-moe's smoke train cell (two micro-batches, the MoE FFN's
    gradient through its SPMD collectives) on this rank's card against
    the same cell in one process on the card -> the largest relative
    differences of the loss, ``grad_norm`` and the updated params.  The
    plain impls: the smoke config's head dim (12) is none the split
    kernel takes."""
    from repro_torch.dist.compat import AbstractMesh
    from repro_torch.tree import leaves

    dev = mesh.device
    one = default_rules(AbstractMesh((1, 1), ("data", "model")))
    res = {}
    for label, rules in (("mesh", default_rules(mesh)), ("one", one)):
        cell = ST.build_cell("granite-moe-3b-a800m", "train_4k", rules,
                             "plain", smoke=True, batch=4, seq=32)
        gen = torch.Generator(device=dev).manual_seed(0)
        new, out = cell.fn(*cell.local(cell.inputs(gen, dev)))
        res[label] = (out, leaves(new["params"]))
    (a, pa), (b, pb) = res["mesh"], res["one"]
    return {"loss": _max_rel(a["loss"], b["loss"]),
            "grad_norm": _max_rel(a["grad_norm"], b["grad_norm"]),
            "params": max(_max_rel(x, y) for x, y in zip(pa, pb))}
