"""Rank functions of the gloo-rank tests (``test_torch_distributed.py``):
importable by name in the spawned ranks, torch and the port only."""
import torch

from repro_torch.dist import default_rules, install_rules
from repro_torch.dist.compat import axis_index, spmd_mesh
from repro_torch.dist.spmd import all_reduce_sum
from repro_torch.models.moe import moe_ffn
from repro_torch.models.recsys.embedding import sharded_lookup
from repro_torch.optim import compressed_psum, init_error_feedback
from repro_torch.tools.mesh_check import psum_error

LOOKUP_MESHES = {"2x2": ((2, 2), ("data", "model")),
                 "4_data": ((4,), ("data",)),
                 "4_model": ((4,), ("model",))}


def _group_rows(mesh, arr):
    """This rank's data group's rows of ``arr`` (split over the data
    axes, replicated over ``model``)."""
    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    g = mesh.axis_size(data) if data else 1
    i = axis_index(mesh, data) if data else 0
    n = len(arr) // g
    return arr[i * n:(i + 1) * n]


def _local_table(mesh, table):
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    per = len(table) // mesh.size
    c = axis_index(mesh, axes)
    return table[c * per:(c + 1) * per]


def world4(mesh, table, id_cases, moe_cases, dlrm_case):
    """On a world of 4: ``sharded_lookup`` over the meshes of
    LOOKUP_MESHES, ``moe_ffn`` and DLRM's forward under rules over the
    (2, 2) ``mesh``.  Returns numpy results keyed by case."""
    out = {}
    meshes = {"2x2": mesh, **{k: spmd_mesh(*v, "cpu")
                              for k, v in LOOKUP_MESHES.items()
                              if k != "2x2"}}
    tbl = torch.from_numpy(table)
    for key, m in meshes.items():
        local = _local_table(m, tbl)
        for name, (ids, cf) in id_cases.items():
            got = sharded_lookup(local, torch.from_numpy(_group_rows(m, ids)),
                                 m, capacity_factor=cf)
            out[f"lookup/{key}/{name}"] = got.numpy()
    rules = default_rules(mesh)
    for name, (params, x, top_k, cf) in moe_cases.items():
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        with install_rules(rules):
            y, aux = moe_ffn(p, torch.from_numpy(_group_rows(mesh, x)),
                             top_k=top_k, capacity_factor=cf)
        out[f"moe/{name}"] = (y.numpy(), float(aux))
    # the gradient of sum(y^2) over every token plus the aux loss (the
    # last case's capacity factor: no slot drops): d/dx of this rank's
    # rows, and each parameter's part from this data group's tokens; then
    # the same where the groups do not split the tokens (one group)
    grad_cases = {"moe_grad": moe_cases[name]}
    if "one_group_E5" in moe_cases:
        grad_cases["moe_one_group_grad"] = moe_cases["one_group_E5"]
    for key, (params, x, top_k, cf) in grad_cases.items():
        trainable = {k: torch.from_numpy(v).requires_grad_()
                     for k, v in params.items()}
        xg = torch.from_numpy(_group_rows(mesh, x)).requires_grad_()
        with install_rules(rules):
            y, aux = moe_ffn(trainable, xg, top_k=top_k, capacity_factor=cf)
            loss = all_reduce_sum(y.square().sum(), mesh, "data") + aux
            grads = torch.autograd.grad(loss, [xg, *trainable.values()])
        out[key] = (float(loss), grads[0].numpy(),
                    {k: g.numpy() for k, g in zip(trainable, grads[1:])})
    from repro_torch.models.recsys import dlrm as D
    cfg, params, dense, sparse = dlrm_case
    p = dict(params)
    p["table"] = _local_table(mesh, params["table"])
    with install_rules(rules):
        out["dlrm"] = D.dlrm_forward(
            p, cfg, torch.from_numpy(_group_rows(mesh, dense)),
            torch.from_numpy(_group_rows(mesh, sparse))).numpy()
    return out


def psum_steps(mesh, grads_by_step, axis):
    """``compressed_psum`` over ``axis`` for each step's gradient tree
    (this rank's row of each leaf), the residual carried: ->
    ([(mean, residual)] as numpy trees, this rank's coordinates on a
    (2, 2, 2) pod x data x model mesh of the same ranks, each step's
    error over its int8 bound: ``mesh_check.psum_error``)."""
    r = mesh.rank
    fb = None
    out, over = [], []
    for grads in grads_by_step:
        g = {k: torch.from_numpy(v[r:r + 1]) for k, v in grads.items()}
        if fb is None:
            fb = init_error_feedback(g)
        x = {k: g[k].float() + fb[k] for k in g}
        with install_rules(default_rules(mesh)):
            mean, fb = compressed_psum(g, fb, axis)
        over.append(psum_error(mean, x, mesh, axis)[1])
        out.append(({k: v.numpy() for k, v in mean.items()},
                    {k: v.numpy() for k, v in fb.items()}))
    return out, coordinates(spmd_mesh((2, 2, 2), ("pod", "data", "model"),
                                      "cpu")), over


def fails(mesh):
    """Rank 1 raises; rank 0 would sleep for ten minutes."""
    import time

    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    time.sleep(600)
    return mesh.rank


def sleeps(mesh, seconds):
    import time

    time.sleep(seconds)
    return mesh.rank


def coordinates(mesh):
    """This rank's coordinates and group ranks on each axis and pair."""
    import torch.distributed as dist

    out = {}
    pairs = [mesh.axis_names[i:i + 2] for i in range(len(mesh.axis_names))]
    for axes in (*mesh.axis_names, *pairs, mesh.axis_names):
        out[axes] = (axis_index(mesh, axes),
                     dist.get_process_group_ranks(mesh.group(axes)))
    return out
