"""Cell builders of the port, the twin of ``repro.launch.steps``: the
spec plumbing (each leaf's shape, dtype and partition spec under a
mesh's rules, without allocating a parameter) and the GNN part.  A cell
is one (architecture x input shape) pair; here the DimeNet cells of
``GNN_SHAPES``, with their per-shape configuration, analytic model FLOPs
and the training step the reference compiles for them.

The reference builds each cell from abstract, sharded shapes for its
compile dry-run.  The LM, PreTTR and recsys cells and the dry-run itself
wait for ROADMAP Queue 1 items 7.2 and 7.3; the port runs its GNN cells
on real data instead (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ArchSpec
from repro_torch.dist.compat import PartitionSpec
from repro_torch.dist.sharding import ShardingRules, divisible_spec
from repro_torch.models.gnn.dimenet import (DimeNetConfig, energy_loss,
                                            node_cls_loss)
from repro_torch.optim import (OptimizerConfig, adam_update, init_opt_state,
                               opt_state_axes, value_and_grad)
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# Spec plumbing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One leaf as the reference's sharded ``jax.ShapeDtypeStruct``: its
    shape, dtype and ``PartitionSpec`` on the rules' mesh."""
    shape: tuple
    dtype: torch.dtype
    spec: PartitionSpec


def sds(shape, dtype, rules: ShardingRules, axes) -> TensorSpec:
    """The spec of one ``shape`` / ``dtype`` leaf annotated ``axes``."""
    shape = tuple(int(n) for n in shape)
    return TensorSpec(shape, dtype, divisible_spec(rules, axes, shape))


def attach_shardings(shapes_tree, axes_tree, rules: ShardingRules):
    """``shapes_tree`` (leaves with ``shape`` and ``dtype``: tensors, meta
    tensors, TensorSpecs) and ``axes_tree`` (the same structure, logical
    axis tuples as leaves) -> a tree of :class:`TensorSpec`."""
    return tree_map(lambda s, a: sds(s.shape, s.dtype, rules, a),
                    shapes_tree, axes_tree)


def eval_params(init_fn):
    """``init_fn(generator, device) -> (params, axes)`` -> ``(meta params,
    axes)``: the init runs under ``FakeTensorMode``, so no parameter is
    allocated and each leaf comes back as a ``meta`` tensor of its shape
    and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params, axes = init_fn(torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    return meta, axes


def state_specs(init_fn, opt_cfg: OptimizerConfig, rules: ShardingRules):
    """Specs of ``{"params", "opt"}`` (the AdamW state of
    ``init_opt_state``), as the reference's ``state_specs``."""
    p_shapes, p_axes = eval_params(init_fn)
    o_shapes = init_opt_state(p_shapes, opt_cfg)
    return {"params": attach_shardings(p_shapes, p_axes, rules),
            "opt": attach_shardings(o_shapes,
                                    opt_state_axes(p_axes, opt_cfg), rules)}


def param_init(spec: ArchSpec):
    """``init_fn(generator, device) -> (params, axes)`` of a registry arch
    at its full config: the init and axes functions of its model."""
    cfg = spec.config
    if spec.name == "prettr-bert":
        from repro_torch.core.prettr import init_prettr, prettr_axes
        init, axes = init_prettr, prettr_axes
    elif spec.family == "lm":
        from repro_torch.models.transformer import init_params, param_axes
        init, axes = init_params, param_axes
    elif spec.family == "gnn":
        from repro_torch.models.gnn.dimenet import dimenet_axes, init_dimenet
        init, axes = init_dimenet, dimenet_axes
    elif spec.name == "dlrm-mlperf":
        from repro_torch.models.recsys.dlrm import dlrm_axes, init_dlrm
        init, axes = init_dlrm, dlrm_axes
    elif spec.name == "bert4rec":
        from repro_torch.models.recsys.bert4rec import (bert4rec_axes,
                                                        init_bert4rec)
        init, axes = init_bert4rec, bert4rec_axes
    else:
        from repro_torch.models.recsys.deepfm import deepfm_axes, init_deepfm
        init, axes = init_deepfm, deepfm_axes
    return lambda gen, device: (init(cfg, gen, device=device), axes(cfg))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

FANOUT_CAP = 8


def _pad_mult(n: int, m: int = 256) -> int:
    return -(-n // m) * m


def _dimenet_flops(cfg, n_edges: int, n_trip: int, n_nodes: int,
                   d_feat: int) -> float:
    d, nb, nsr = cfg.d_hidden, cfg.n_bilinear, cfg.n_spherical * cfg.n_radial
    per_block = (2 * n_edges * d * d * 2          # w_src + update in
                 + 2 * n_trip * d * nb            # w_down gather matmul
                 + 2 * n_trip * nsr * nb          # sbf gating
                 + 2 * n_edges * nb * d           # w_up
                 + 2 * n_edges * 2 * d * d)       # update MLP
    embed = 2 * n_nodes * max(d_feat, 1) * d + 2 * n_edges * 3 * d * d
    return float(cfg.n_blocks * per_block + embed)


@dataclasses.dataclass(frozen=True)
class GnnCell:
    """One DimeNet cell: its config and sizes as ``make_gnn_cell`` sets
    them (edges padded to a multiple of 256, FANOUT_CAP triplet slots an
    edge) and its model FLOPs a training step (3x the forward's)."""
    shape: str
    kind: str
    cfg: DimeNetConfig
    n_nodes: int
    n_edges: int                 # padded
    n_trip: int
    n_graphs: int
    model_flops: float


def gnn_cell_config(spec: ArchSpec, shape_name: str) -> GnnCell:
    """The per-shape choices of the reference's ``make_gnn_cell``:
    ``graph_sampled`` sizes its nodes and edges by the fanouts, with
    Reddit's 602 features and 41 classes; ``graph_energy`` packs
    ``batch`` molecules for the energy task; ``ogb_products`` has 47
    classes; float32 compute up to 1 M padded edges, bf16 above."""
    info = spec.shapes[shape_name]
    kind = info["kind"]
    n_graphs = 0
    if kind == "graph_sampled":
        bn = info["batch_nodes"]
        f1, f2 = info["fanout"]
        n_nodes = bn * (1 + f1 + f1 * f2)
        n_edges = bn * (f1 + f1 * f2)
        d_feat, n_classes, task = 602, 41, "node_cls"    # Reddit-like
    elif kind == "graph_energy":
        n_graphs = info["batch"]
        n_nodes = info["n_nodes"] * n_graphs
        n_edges = info["n_edges"] * n_graphs
        d_feat, n_classes, task = 0, 1, "energy"
    else:
        n_nodes, n_edges = info["n_nodes"], info["n_edges"]
        d_feat = info.get("d_feat", 0)
        n_classes = 47 if shape_name == "ogb_products" else 16
        task = "node_cls"
    n_edges_p = _pad_mult(n_edges)
    n_trip = n_edges_p * FANOUT_CAP
    # bf16 messages for the web-scale graphs (f32 for molecular energies)
    cd = torch.bfloat16 if n_edges_p > 1_000_000 else torch.float32
    cfg = dataclasses.replace(spec.config, d_feat=d_feat,
                              n_classes=n_classes, task=task,
                              compute_dtype=cd)
    return GnnCell(shape_name, kind, cfg, n_nodes, n_edges_p, n_trip,
                   n_graphs, 3 * _dimenet_flops(cfg, n_edges_p, n_trip,
                                                n_nodes, d_feat))


def gnn_train_step(params, opt, cfg: DimeNetConfig, opt_cfg, batch):
    """One AdamW step of the cell's loss (``energy_loss`` for the energy
    task, else ``node_cls_loss``) on a batch of tensors
    (``data.graphs.graph_batch_tensors``), the reference's ``train_step``.
    Returns ``(params, opt, {"loss", "grad_norm"})``; the inputs are not
    modified."""
    loss_fn = energy_loss if cfg.task == "energy" else node_cls_loss
    loss, grads = value_and_grad(lambda p: loss_fn(p, cfg, batch), params)
    params, opt, gn = adam_update(grads, opt, params, opt_cfg,
                                  lr=opt_cfg.lr)
    return params, opt, {"loss": loss, "grad_norm": gn}
