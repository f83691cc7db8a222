"""Rank functions of the DimeNet gloo-rank tests
(``test_torch_dimenet_mesh.py``): importable by name in the spawned ranks,
torch and the port only.  Each rank takes its blocks of seeded whole
inputs and params (numpy, from the parent) under ``default_rules`` on
its mesh, runs DimeNet's forward, loss and gradient through the sharded
route, and returns its share of the outputs beside the rows they cover,
the loss and the gradient gathered whole (as numpy)."""
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.configs import dimenet as DC
from repro_torch.dist import default_rules, install_rules
from repro_torch.dist import spmd as S
from repro_torch.dist.compat import spmd_mesh
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch import steps as ST
from repro_torch.models.gnn import dimenet as D
from repro_torch.models.gnn import dimenet_spmd as SP
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves, tree_map

# the meshes over a world of 4 and of 2
MESHES = {4: {"2x2": ((2, 2), ("data", "model")), "4": ((4,), ("data",))},
          2: {"2": ((2,), ("model",))}}
# a DimeNet small enough for the CPU: 2 blocks, d_hidden 16, n_bilinear 4
SMALL = dict(n_blocks=2, d_hidden=16, n_bilinear=4, n_spherical=3,
             n_radial=4, n_classes=8)
# the AdamW step: the smoke config at full_graph_sm, its graph cut
CELL = ("full_graph_sm", 20)


def config(task: str, d_feat: int, blocked: bool,
           dtype=torch.float32) -> D.DimeNetConfig:
    return dataclasses.replace(DC.smoke_config(), **SMALL, task=task,
                               d_feat=d_feat, blocked_triplets=blocked,
                               compute_dtype=dtype)


def cell(rules):
    return ST.build_cell("dimenet", CELL[0], rules, smoke=True,
                         graph_cut=CELL[1])


def _np(x):
    return x.detach().float().numpy()


def _tensors(tree):
    """A numpy tree as tensors, integers as int64."""
    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.long() if t.dtype in (torch.int32, torch.int64) else t
    return tree_map(conv, tree)


def _local(mesh, cfg, params, batch, rules):
    """This rank's shards of ``params`` and blocks of ``batch`` (the GNN
    cell's specs; ``label_mask`` whole)."""
    n_graphs = int(batch["labels"].shape[0]) if cfg.task == "energy" else 0
    c = ST.GnnCell("case", "graph_train", cfg, len(batch["positions"]),
                   len(batch["edge_src"]), len(batch["trip_kj"]), n_graphs,
                   0.0)
    specs = ST.gnn_batch_specs(c, rules)
    lb = {k: S.shard_leaf(v, specs[k].spec, mesh) if k in specs else v
          for k, v in batch.items()}
    return S.shard_tree(params, D.dimenet_axes(cfg), rules), lb


def _loss_fn(cfg):
    return D.energy_loss if cfg.task == "energy" else D.node_cls_loss


def _forward(params, cfg, batch):
    kw = {k: batch[k] for k in ("node_feat", "positions", "edge_src",
                                "edge_dst", "edge_valid", "trip_kj",
                                "trip_ji", "trip_valid")}
    if cfg.task == "energy":
        kw.update(graph_ids=batch["graph_ids"],
                  n_graphs=batch["labels"].shape[0])
    return D.dimenet_forward(params, cfg, **kw)


def _case(mesh, rules, cfg, params, batch):
    """-> {"rows": (start, length), "forward", "loss", "grads"}."""
    lp, lb = _local(mesh, cfg, params, batch, rules)
    with install_rules(rules):
        with torch.no_grad():
            out = _forward(lp, cfg, lb)
        rows = SP.Route(cfg).node_rows(len(batch["positions"]))
        loss, grads = value_and_grad(lambda p: _loss_fn(cfg)(p, cfg, lb),
                                     lp)
    specs = SP.param_specs(cfg, rules)
    whole = S.gather_tree(grads, specs, mesh)
    return {"rows": rows, "forward": _np(out),
            "loss": float(loss), "grads": tree_map(_np, whole)}


def _grad_on_another_thread(mesh, rules, cfg, params, batch):
    """The gradient with the backward pass on a thread that has no rules
    installed, as autograd runs it on the card -> its largest difference
    from the backward pass on this thread, or the error it raised."""
    lp, lb = _local(mesh, cfg, params, batch, rules)
    lp = tree_map(lambda t: t.detach().requires_grad_(), lp)
    p = leaves(lp)

    def loss():
        with install_rules(rules), torch.enable_grad():
            return _loss_fn(cfg)(lp, cfg, lb)

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


def _refusals(mesh, cfg, params, batch):
    """The errors the route raises where it cannot honour its inputs:
    rules that cut the edges over ``data`` alone, whole params where the
    rules cut them, whole node features where the rules cut them."""
    rules = default_rules(mesh)
    out = {}
    lp, lb = _local(mesh, cfg, params, batch, rules)
    data_only = ShardingRules(mesh, {**rules.rules, "edges": ("data",)})
    for key, r, p, b in (
            ("edges_over_data", data_only, lp, lb),
            ("whole_params", rules, params, lb),
            ("whole_node_feat", rules, lp,
             {**lb, "node_feat": batch["node_feat"]})):
        try:
            with install_rules(r), torch.no_grad():
                _loss_fn(cfg)(p, cfg, b)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def cell_inputs(c):
    """The cell's whole args from seed 0 (its init and its graph)."""
    return ST.cell_inputs(c, torch.Generator().manual_seed(0), "cpu",
                          whole=True)


def _train_step(mesh, rules):
    """The cell's AdamW step on this rank's blocks of its seeded args ->
    (loss, grad_norm, the updated params whole)."""
    c = cell(rules)
    new, out = c.fn(*c.local(cell_inputs(c)))
    specs = ST._specs_of(c.args[0]["params"])
    got = S.gather_tree(new["params"], specs, mesh)
    return float(out["loss"]), float(out["grad_norm"]), tree_map(_np, got)


def world(mesh, cases):
    """Every case on each mesh of this world -> {mesh key: {case:
    result}}; on the (2, 2) mesh also the cell's AdamW step, the backward
    on another thread and the refusals."""
    out = {}
    for key, (shape, names) in MESHES[mesh.size].items():
        m = mesh if (shape, names) == (tuple(mesh.shape.values()),
                                       tuple(mesh.axis_names)) \
            else spmd_mesh(shape, names, "cpu")
        rules = default_rules(m)
        res = {}
        for name, (task, d_feat, blocked, dtype, params, batch) in \
                cases.items():
            cfg = config(task, d_feat, blocked, dtype)
            res[name] = _case(m, rules, cfg, _tensors(params),
                              _tensors(batch))
        if key == "2x2":
            task, d_feat, blocked, dtype, params, batch = \
                cases["feat_blocked"]
            cfg = config(task, d_feat, blocked, dtype)
            res["grad_thread"] = _grad_on_another_thread(
                m, rules, cfg, _tensors(params), _tensors(batch))
            res["refusals"] = _refusals(m, cfg, _tensors(params),
                                        _tensors(batch))
            res["train_step"] = _train_step(m, rules)
        out[key] = res
    return out
