"""Rank functions of the recsys gloo-rank tests
(``test_torch_recsys_mesh.py``): importable by name in the spawned ranks,
torch and the port only.  A world of 4 ranks builds three meshes over
the same ranks, (2, 2) ``data`` x ``model``, (4,) ``data`` and (4,)
``model``, and on each runs the sharded lookup's gradient, the DLRM and
DeepFM functions under its rules, and the recsys cells on its part of
seeded whole inputs.  Each result comes back beside the block of the
one-process reference that it should equal (as numpy), or gathered
whole."""
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.dist import default_rules, install_rules
from repro_torch.dist import spmd as S
from repro_torch.dist.compat import spmd_mesh
from repro_torch.launch import steps as ST
from repro_torch.models.recsys import deepfm as F
from repro_torch.models.recsys import dlrm as D
from repro_torch.models.recsys.embedding import sharded_lookup
from repro_torch.tree import tree_map

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4_data": ((4,), ("data",)),
          "4_model": ((4,), ("model",))}
# the recsys cells each mesh runs: key -> (arch, shape, smoke config
# fields replaced, batch)
CELLS = {"dlrm_train": ("dlrm-mlperf", "train_batch", {}, 8),
         "deepfm_train": ("deepfm", "train_batch", {}, 8),
         "xdeepfm_train": ("xdeepfm", "train_batch", {}, 8),
         "deepfm_serve": ("deepfm", "serve_p99", {}, 8),
         "dlrm_retrieval": ("dlrm-mlperf", "retrieval_cand", {}, None),
         "bert4rec_serve": ("bert4rec", "serve_p99", {}, 8),
         "bert4rec_train": ("bert4rec", "train_batch", {"seq_len": 40}, 8)}
EVERY = ("pod", "data", "model")


def _axes(mesh, names):
    return tuple(a for a in names if a in mesh.axis_names)


def _block(x, mesh, dim, names):
    """This rank's block of a whole tensor along ``dim`` over the mesh
    axes of ``names`` it has."""
    return S.local_block(x, dim, mesh, _axes(mesh, names))


def _np(x):
    return x.detach().float().numpy()


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def cell(arch, shape, over, batch, rules):
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, smoke=dataclasses.replace(spec.smoke,
                                                               **over))
    return ST.build_spec_cell(spec, shape, rules, smoke=True, batch=batch)


def cell_inputs(c, seed=0):
    return ST.cell_inputs(c, torch.Generator().manual_seed(seed), "cpu",
                          whole=True)


def _lookup_grads(mesh, table, cases):
    """``sharded_lookup``'s table gradient of ``sum(out * w)`` per case:
    this rank's ``[R/S, D]`` block."""
    out = {}
    whole = torch.from_numpy(table)
    for name, (ids, w, cf) in cases.items():
        local = _block(whole, mesh, 0, EVERY).clone().requires_grad_()
        rows = lambda a: _block(torch.from_numpy(a), mesh, 0, ("pod", "data"))
        got = sharded_lookup(local, rows(ids), mesh, capacity_factor=cf)
        (g,) = torch.autograd.grad((got * rows(w)).sum(), local)
        out[name] = g.numpy()
    return out


def _models(mesh, case, want):
    """DLRM's and DeepFM's forward, towers and retrieval under the mesh's
    rules, each table this rank's block (dense layers whole) -> {name:
    (got, want's block)}."""
    rules = default_rules(mesh)
    rows = lambda x: _block(x, mesh, 0, ("pod", "data"))
    cand = lambda x: _block(x, mesh, 0, EVERY)
    out = {}
    for fam in ("dlrm", "deepfm"):
        cfg, params, inp = case[fam]
        p = _t(params)
        p["table"] = cand(p["table"])
        if "w1" in p:
            p["w1"] = cand(p["w1"])
        x = {k: rows(torch.from_numpy(v)) for k, v in inp.items()}
        iv = {k: cand(torch.from_numpy(v)) for k, v in inp.items()
              if k.startswith("cand_")}
        with install_rules(rules), torch.no_grad():
            if fam == "dlrm":
                got = {"forward": D.dlrm_forward(p, cfg, x["dense"],
                                                 x["sparse"]),
                       "item_tower": D.item_tower(p, cfg, x["items"]),
                       "user_tower": D.user_tower(p, cfg, x["dense"],
                                                  x["users"]),
                       "retrieval": D.retrieval_scores(
                           p, cfg, x["dense"], x["users"], iv["cand_vecs"])}
            else:
                vecs, first = F.item_vectors(p, cfg, x["items"])
                got = {"forward": F.deepfm_forward(p, cfg, x["sparse"]),
                       "item_vectors": vecs, "item_first": first,
                       "retrieval": F.retrieval_scores(
                           p, cfg, x["users"], iv["cand_vecs"],
                           iv["cand_first"])}
        for name, g in got.items():
            w = rows(torch.from_numpy(want[fam][name]))
            if name == "retrieval":
                w = _block(w, mesh, 1, EVERY)
            out[f"{fam}/{name}"] = (_np(g), _np(w))
    return out


def _cells(mesh, want):
    """Every cell of CELLS on this rank's part of the seeded whole inputs
    -> {key: (got, want)}: a train cell's loss, grad_norm and new state
    gathered whole (rank 0), a serve cell's outputs beside their
    one-process block."""
    rules = default_rules(mesh)
    out = {}
    for key, (arch, shape, over, batch) in CELLS.items():
        c = cell(arch, shape, over, batch, rules)
        res = c.fn(*c.local(cell_inputs(c)))
        if c.kind == "rec_train":
            new, o = res
            specs = tree_map(lambda t: t.spec, c.args[0])
            whole = S.gather_tree(new, specs, mesh)
            out[key] = ((float(o["loss"]), float(o["grad_norm"]),
                         tree_map(_np, whole) if mesh.rank == 0 else None),
                        None)
            continue
        res = res if isinstance(res, tuple) else (res,)
        # a retrieval cell's one user is on every rank, its candidates
        # cut over every axis; the other cells' rows over the data axes
        w = [_block(torch.from_numpy(a), mesh, 1, EVERY)
             if c.kind == "rec_retrieval"
             else _block(torch.from_numpy(a), mesh, 0, ("pod", "data"))
             for a in want[key]]
        out[key] = ([r.numpy() if r.dtype == torch.int64 else _np(r)
                     for r in res],
                    [a.numpy() if a.dtype == torch.int64 else _np(a)
                     for a in w])
    return out


def world(mesh, table, lookup_cases, model_case, model_want, cell_want):
    """On a world of 4: each mesh of MESHES (the (2, 2) one is ``mesh``)
    -> {mesh key: {"lookup": ..., "models": ..., "cells": ...}}."""
    meshes = {"2x2": mesh, **{k: spmd_mesh(*v, "cpu")
                              for k, v in MESHES.items() if k != "2x2"}}
    return {key: {"coord": (S.block(m, _axes(m, EVERY))),
                  "lookup": _lookup_grads(m, table, lookup_cases),
                  "models": _models(m, model_case, model_want),
                  "cells": _cells(m, cell_want)}
            for key, m in meshes.items()}
