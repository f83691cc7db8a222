"""Rank functions of the sharded-LM gloo tests (``test_torch_sharded_lm.py``):
importable by name in the spawned ranks, torch and the port only."""
import torch

from repro_torch.dist import default_rules, install_rules
from repro_torch.dist import spmd as S
from repro_torch.dist.compat import spmd_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import value_and_grad
from repro_torch.tree import tree_map


def _case(mesh, cfg, params_np, tokens, grad):
    """The sharded ``causal_lm_loss`` of ``tokens`` (this rank's data rows)
    over this rank's shards of the bridged params -> (loss, the whole
    gradient tree as numpy, or None)."""
    whole = tree_map(torch.from_numpy, params_np)
    rules = default_rules(mesh)
    axes = T.param_axes(cfg)
    local = S.shard_tree(whole, axes, rules)
    toks = S.data_block(torch.from_numpy(tokens), mesh)
    with install_rules(rules):
        loss_fn = lambda p: T.causal_lm_loss(p, cfg, toks[:, :-1],
                                             toks[:, 1:])
        if not grad:
            with torch.no_grad():
                return float(loss_fn(local)), None
        loss, g = value_and_grad(loss_fn, local)
        full = S.gather_tree(g, S.tree_specs(whole, axes, rules), mesh)
    return float(loss), tree_map(lambda x: x.numpy(), full)


def sharded_lm(mesh, cases, extra_meshes):
    """Every case on ``mesh`` and on each of ``extra_meshes`` (shapes of
    the same world) -> {mesh key: {case: (loss, grads)}}; the gradients
    from rank 0 only (every rank gathers the same)."""
    meshes = {"x".join(map(str, mesh.shape.values())): mesh}
    for sizes, names in extra_meshes:
        meshes["x".join(map(str, sizes)) + "_" + "_".join(names)] = \
            spmd_mesh(sizes, names, "cpu")
    out = {}
    for key, m in meshes.items():
        out[key] = {}
        for name, (cfg, params_np, tokens, grad) in cases.items():
            loss, g = _case(m, cfg, params_np, tokens, grad)
            out[key][name] = (loss, g if mesh.rank == 0 else None)
    return out
