"""Cell builders of the port, the twin of ``repro.launch.steps``: the
spec plumbing (each leaf's shape, dtype and partition spec under a
mesh's rules, without allocating a parameter), the LM, PreTTR, GNN and
recsys cells and the dispatcher (:func:`build_cell`, :func:`cell_names`,
:func:`backend_support`).  A cell is one (architecture x input shape)
pair: its step function, its args as trees of :class:`TensorSpec`, its
analytic model FLOPs a call, notes and donated args.

The reference builds each cell from abstract, sharded shapes for its
compile dry-run; the port's is ``launch.dryrun``, which traces them on
fake tensors.  The port runs its cells:
:func:`cell_inputs` makes a cell's args from a seed, whole or as this
rank's part, and the step functions take real tensors, on one device or
on a rank of an SPMD mesh (``launch.mesh.run_spmd``), where the sharded
transformer (``models.transformer_spmd``), the sharded lookup
(``models.recsys.embedding``) and DimeNet's edge-sharded route
(``models.gnn.dimenet_spmd``) do what GSPMD does for the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch

from repro_torch.configs import ArchSpec, get_arch
from repro_torch.dist import spmd as S
from repro_torch.dist.compat import PartitionSpec, SpmdMesh
from repro_torch.dist.context import install_rules
from repro_torch.dist.sharding import (ShardingRules, divisible_spec,
                                       replicated_serving_rules)
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
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One (architecture x input shape) cell, the reference's ``Cell``:
    ``fn(*args)``, ``args`` as trees of :class:`TensorSpec` (the whole
    leaves' shapes, dtypes and partition specs), the analytic useful
    FLOPs of one call, notes and the donated arg indices (the reference
    donates state and caches; here a step returns new state and writes a
    cache in place).  The reference only compiles a cell; the port runs
    one, so two fields are its own: ``inputs(generator, device)`` makes
    the whole args from a seed, and ``local(args)`` takes this rank's part
    of them (:func:`cell_inputs`)."""
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    model_flops: float
    notes: str = ""
    donate: tuple = ()
    inputs: Callable | None = None
    local: Callable | None = None


def _installed(rules):
    return install_rules(rules) if rules is not None \
        else contextlib.nullcontext()


def _spec_local(args, specs, mesh):
    """Each leaf's block under its spec on an SPMD mesh (the whole leaf
    on any other mesh)."""
    if not isinstance(mesh, SpmdMesh):
        return args
    return tree_map(lambda x, t: S.shard_leaf(x, t.spec, mesh)
                    if torch.is_tensor(x) else x, args, specs)


def _specs_of(tree):
    """The PartitionSpec tree of a tree of :class:`TensorSpec`."""
    return tree_map(lambda t: t.spec, tree)


def _ids(gen, shape, high, device):
    return torch.randint(0, high, shape, generator=gen,
                         device=gen.device).to(device, torch.int32)


def _prefix_valid(gen, n, length, lo, device):
    """[n, length] bool: a random valid prefix of at least ``lo`` of each
    row."""
    lens = torch.randint(lo, length + 1, (n, 1), generator=gen,
                         device=gen.device)
    return (torch.arange(length, device=gen.device) < lens).to(device)


def _sharded_adam(grads, state, opt_cfg, specs):
    """AdamW on this rank's blocks: the global norm summed over the
    ranks that hold a leaf's other blocks (one process: the plain
    norm)."""
    from repro_torch.models import transformer_spmd as SP

    mesh = SP.active_mesh()
    norm = None if mesh is None else \
        (lambda g: S.global_norm(g, specs, mesh))
    return adam_update(grads, state["opt"], state["params"], opt_cfg,
                       lr=opt_cfg.lr, norm_fn=norm)


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
    edge) and its model FLOPs a training step (3x the forward's);
    ``graph_cut`` the port's cut of the graph (1: as published)."""
    shape: str
    kind: str
    cfg: DimeNetConfig
    n_nodes: int
    n_edges: int                 # padded
    n_trip: int
    n_graphs: int
    model_flops: float
    graph_cut: int = 1


def gnn_cell_config(spec: ArchSpec, shape_name: str,
                    graph_cut: int | None = None) -> GnnCell:
    """The per-shape choices of the reference's ``make_gnn_cell``:
    ``graph_sampled`` sizes its nodes and edges by the fanouts, with
    Reddit's 602 features and 41 classes; ``graph_energy`` packs
    ``batch`` molecules for the energy task; ``ogb_products`` has 47
    classes; float32 compute up to 1 M padded edges, bf16 above.

    ``graph_cut`` (the port's cut) divides a whole graph's nodes and
    edges (``graph_train``: the cell's own; ``graph_sampled``: the source
    graph the batch is sampled from, whose batch keeps its published
    sizes) and keeps the rest as published: the average degree, the
    features, classes and fanout cap, the config and the compute dtype
    that the published edge count picks.  The molecule cell takes none."""
    info = spec.shapes[shape_name]
    kind = info["kind"]
    n_graphs = 0
    cut = 1 if graph_cut is None else int(graph_cut)
    if cut < 1 or (cut > 1 and kind == "graph_energy"):
        raise ValueError(f"{shape_name}: graph_cut divides a graph's nodes "
                         f"and edges (a cut >= 1 of a graph_train or "
                         f"graph_sampled cell), got {graph_cut}")
    if kind == "graph_sampled":
        bn = info["batch_nodes"]
        f1, f2 = info["fanout"]
        n_nodes = bn * (1 + f1 + f1 * f2)
        n_edges = bn * (f1 + f1 * f2)
        d_feat, n_classes, task = 602, 41, "node_cls"    # Reddit-like
        if info["n_nodes"] // cut < bn:
            raise ValueError(f"{shape_name}: a graph cut to "
                             f"{info['n_nodes'] // cut} nodes cannot seed "
                             f"{bn} of them")
        published = n_edges
    elif kind == "graph_energy":
        n_graphs = info["batch"]
        n_nodes = info["n_nodes"] * n_graphs
        n_edges = info["n_edges"] * n_graphs
        d_feat, n_classes, task = 0, 1, "energy"
        published = n_edges
    else:
        n_nodes, n_edges = info["n_nodes"] // cut, info["n_edges"] // cut
        d_feat = info.get("d_feat", 0)
        n_classes = 47 if shape_name == "ogb_products" else 16
        task = "node_cls"
        published = info["n_edges"]
    n_edges_p = _pad_mult(n_edges)
    n_trip = n_edges_p * FANOUT_CAP
    # bf16 messages for the web-scale graphs (f32 for molecular energies)
    cd = torch.bfloat16 if _pad_mult(published) > 1_000_000 \
        else torch.float32
    cfg = dataclasses.replace(spec.config, d_feat=d_feat,
                              n_classes=n_classes, task=task,
                              compute_dtype=cd)
    return GnnCell(shape_name, kind, cfg, n_nodes, n_edges_p, n_trip,
                   n_graphs, 3 * _dimenet_flops(cfg, n_edges_p, n_trip,
                                                n_nodes, d_feat), cut)


def gnn_graph(spec: ArchSpec, shape_name: str, *, graph_cut: int = 1,
              seed: int = 0):
    """The graph of a DimeNet cell from ``data.graphs`` (a numpy
    ``GraphBatch``, unpadded) and notes on how it was made, its host
    seconds by step under ``host_s``: ``graph_train`` a random graph at
    the shape's sizes divided by ``graph_cut``, ``graph_energy`` the
    shape's molecules, ``graph_sampled`` one neighbour-sampled batch of
    ``batch_nodes`` seeds at the shape's fanouts from a random graph of
    the shape's (cut) sizes; triplets capped at FANOUT_CAP an edge."""
    import time

    import numpy as np

    from repro_torch.data import graphs as G

    info = spec.shapes[shape_name]
    c = gnn_cell_config(spec, shape_name, graph_cut)
    t0 = time.perf_counter()
    if c.kind == "graph_energy":
        g = G.make_molecule_batch(info["batch"], info["n_nodes"],
                                  info["n_edges"], fanout_cap=FANOUT_CAP,
                                  seed=seed)
        return g, {"host_s": {"make_molecule_batch":
                              time.perf_counter() - t0}}
    if c.kind != "graph_sampled":
        feat, pos, src, dst, labels = G.random_graph(
            c.n_nodes, info["n_edges"] // c.graph_cut, d_feat=c.cfg.d_feat,
            n_classes=c.cfg.n_classes, seed=seed)
        t1 = time.perf_counter()
        t_kj, t_ji, t_valid = G.build_triplets(src, dst, FANOUT_CAP, seed)
        g = G.GraphBatch(feat, pos, src, dst, np.ones(len(src), bool),
                         t_kj, t_ji, t_valid, labels)
        return g, {"host_s": {"random_graph": t1 - t0,
                              "build_triplets": time.perf_counter() - t1}}
    n = info["n_nodes"] // c.graph_cut
    n_src_edges = info["n_edges"] // c.graph_cut
    feat, pos, src, dst, labels = G.random_graph(
        n, n_src_edges, d_feat=c.cfg.d_feat, n_classes=c.cfg.n_classes,
        seed=seed)
    t1 = time.perf_counter()
    sampler = G.NeighborSampler(src, dst, n, seed=seed)
    del src, dst
    t2 = time.perf_counter()
    seeds = np.random.default_rng(seed).choice(n, info["batch_nodes"],
                                               replace=False)
    s_src, s_dst, node_map = sampler.sample(seeds, info["fanout"])
    del sampler
    t3 = time.perf_counter()
    t_kj, t_ji, t_valid = G.build_triplets(s_src, s_dst, FANOUT_CAP)
    g = G.GraphBatch(feat[node_map], pos[node_map], s_src, s_dst,
                     np.ones(len(s_src), bool), t_kj, t_ji, t_valid,
                     labels[node_map])
    t4 = time.perf_counter()
    return g, {"source_nodes": n, "source_edges": n_src_edges,
               "seed_nodes": info["batch_nodes"],
               "fanout": list(info["fanout"]),
               "host_s": {"random_graph": t1 - t0, "sampler_init": t2 - t1,
                          "sample": t3 - t2, "build_triplets": t4 - t3}}


def gnn_cell_batch(g, c: GnnCell, device) -> dict:
    """A graph (``gnn_graph``'s) as the cell's batch on ``device``: nodes
    padded to the cell's node count (zero rows, no edges), edges to its
    padded edge count and triplets to FANOUT_CAP slots an edge (invalid,
    so the blocked layout holds), in the dtypes of the cell's specs."""
    import numpy as np

    def pad(a, n):
        if len(a) > n:
            raise ValueError(f"{c.shape}: {len(a)} rows for a cell of {n}")
        out = np.zeros((n, *a.shape[1:]), a.dtype)
        out[:len(a)] = a
        return out

    if len(g.trip_kj) != len(g.edge_src) * FANOUT_CAP:
        raise ValueError(f"{c.shape}: {len(g.trip_kj)} triplet slots for "
                         f"{len(g.edge_src)} edges at a cap of {FANOUT_CAP}")
    n, e, t = c.n_nodes, c.n_edges, c.n_trip
    rows = {"node_feat": n, "positions": n, "edge_src": e, "edge_dst": e,
            "edge_valid": e, "trip_kj": t, "trip_ji": t, "trip_valid": t}
    if c.cfg.task == "energy":
        rows["graph_ids"] = n
    else:
        rows["labels"] = n
    out = {}
    for k, size in rows.items():
        a = pad(getattr(g, k), size)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        elif a.dtype != bool:
            a = a.astype(np.int32)
        out[k] = torch.from_numpy(a).to(device)
    if c.cfg.task == "energy":
        out["labels"] = torch.from_numpy(
            g.labels.astype(np.float32)).to(device)
    return out


def gnn_batch_specs(c: GnnCell, rules: ShardingRules) -> dict:
    """The reference's batch specs of a DimeNet cell: the edges and
    triplets over ``"edges"``, the node features over ``"table_rows"``,
    the rest whole."""
    cfg, n_nodes, ne, nt = c.cfg, c.n_nodes, c.n_edges, c.n_trip
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    batch = {
        "node_feat": (sds((n_nodes, cfg.d_feat), f32, rules,
                          ("table_rows", None)) if cfg.d_feat else
                      sds((n_nodes,), i32, rules, (None,))),
        "positions": sds((n_nodes, 3), f32, rules, (None, None)),
        "edge_src": sds((ne,), i32, rules, ("edges",)),
        "edge_dst": sds((ne,), i32, rules, ("edges",)),
        "edge_valid": sds((ne,), b8, rules, ("edges",)),
        "trip_kj": sds((nt,), i32, rules, ("edges",)),
        "trip_ji": sds((nt,), i32, rules, ("edges",)),
        "trip_valid": sds((nt,), b8, rules, ("edges",)),
    }
    if cfg.task == "energy":
        batch["graph_ids"] = sds((n_nodes,), i32, rules, (None,))
        batch["labels"] = sds((c.n_graphs,), f32, rules, (None,))
    else:
        batch["labels"] = sds((n_nodes,), i32, rules, (None,))
    return batch


def gnn_train_step(params, opt, cfg: DimeNetConfig, opt_cfg, batch):
    """One AdamW step of the cell's loss (``energy_loss`` for the energy
    task, else ``node_cls_loss``) on a batch of tensors
    (``data.graphs.graph_batch_tensors``), the reference's ``train_step``.
    Under rules over an SPMD mesh ``params``, ``opt`` and ``batch`` are a
    rank's blocks (``models.gnn.dimenet_spmd``) and the clipping norm is
    summed over the ranks that hold a leaf's other blocks.  Returns
    ``(params, opt, {"loss", "grad_norm"})``; the inputs are not
    modified."""
    from repro_torch.dist.context import current_rules
    from repro_torch.models.gnn import dimenet_spmd as SP

    loss_fn = energy_loss if cfg.task == "energy" else node_cls_loss
    loss, grads = value_and_grad(lambda p: loss_fn(p, cfg, batch), params)
    mesh = SP.active_mesh()
    norm = None
    if mesh is not None:
        specs = SP.param_specs(cfg, current_rules())
        norm = lambda g: S.global_norm(g, specs, mesh)
    params, opt, gn = adam_update(grads, opt, params, opt_cfg,
                                  lr=opt_cfg.lr, norm_fn=norm)
    return params, opt, {"loss": loss, "grad_norm": gn}


# the seed of a GNN cell's graph (chip_smoke.py's SEED)
GRAPH_SEED = 0


def make_gnn_cell(spec: ArchSpec, shape_name: str, rules: ShardingRules,
                  *, graph_cut: int | None = None) -> Cell:
    """The reference's DimeNet cell: the batch specs of
    :func:`gnn_cell_config`'s sizes and one :func:`gnn_train_step` under
    ``rules``.  ``inputs`` makes the graph of :func:`gnn_graph` (seed
    GRAPH_SEED) padded to the cell's sizes, with the model's seeded init;
    ``local`` takes each leaf's block under its spec.  On an SPMD mesh
    the edges must divide over every mesh axis (the route runs
    edge-parallel over all of them)."""
    from repro_torch.models.gnn.dimenet import dimenet_axes, init_dimenet
    from repro_torch.models.gnn.dimenet_spmd import edge_axes

    c = gnn_cell_config(spec, shape_name, graph_cut)
    cfg = c.cfg
    batch = gnn_batch_specs(c, rules)
    if isinstance(rules.mesh, SpmdMesh):
        cut = S.entry_axes(batch["edge_src"].spec[0])
        if tuple(a for a in cut if rules.mesh.shape[a] > 1) != tuple(
                a for a in edge_axes(rules) if rules.mesh.shape[a] > 1):
            raise ValueError(f"{spec.name} {shape_name}: {c.n_edges} padded "
                             f"edges do not divide over the mesh "
                             f"{dict(rules.mesh.shape)}")
    opt_cfg = OptimizerConfig()
    st = state_specs(lambda g, d: (init_dimenet(cfg, g, device=d),
                                   dimenet_axes(cfg)), opt_cfg, rules)

    def train_step(state, batch):
        with _installed(rules):
            params, opt, out = gnn_train_step(state["params"], state["opt"],
                                              cfg, opt_cfg, batch)
        return {"params": params, "opt": opt}, out

    def inputs(gen, device):
        g, _ = gnn_graph(spec, shape_name, graph_cut=c.graph_cut,
                         seed=GRAPH_SEED)
        params = init_dimenet(cfg, gen, device=device)
        return ({"params": params, "opt": init_opt_state(params, opt_cfg)},
                gnn_cell_batch(g, c, device))

    args = (st, batch)
    return Cell(spec.name, shape_name, c.kind, train_step, args,
                model_flops=c.model_flops,
                notes=f"nodes={c.n_nodes} edges={c.n_edges} trip={c.n_trip}",
                donate=(0,), inputs=inputs,
                local=lambda a: _spec_local(a, args, rules.mesh))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_opt_cfg(cfg) -> OptimizerConfig:
    big = cfg.num_params() > 20e9
    return OptimizerConfig(m_dtype=torch.bfloat16 if big else torch.float32,
                           keep_master=False)


def _lm_accum(arch: str) -> int:
    return {"mistral-large-123b": 4, "qwen3-moe-235b-a22b": 4,
            "granite-moe-3b-a800m": 2}.get(arch, 1)


def _micro_batch(x, j: int, accum: int, mesh):
    """Micro-batch ``j`` of the reference's reshape of the global batch
    (global rows ``[j gb / accum, (j + 1) gb / accum)``), this rank's
    data rows of it: the rows are gathered over the data axes (token ids,
    a few MB at 256 x 4096) and cut again."""
    if mesh is not None:
        x = S.gather_data(x, mesh)
    rows = x.shape[0] // accum
    x = x[j * rows:(j + 1) * rows]
    return x if mesh is None else S.data_block(x, mesh)


def make_lm_train_step(cfg, opt_cfg: OptimizerConfig, accum: int,
                       rules: ShardingRules | None = None,
                       param_specs=None):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``, the
    reference's: ``causal_lm_loss`` and its gradient over ``accum``
    micro-batches, the float32 gradients summed and divided by ``accum``,
    then ``adam_update``.  Under ``rules`` over an SPMD mesh ``state``
    holds this rank's shards (``param_specs``: their PartitionSpec tree)
    and ``batch`` (``tokens``, ``labels``) its data rows; each gradient
    comes back and is summed in the shards' own layout (what the
    reference's ``_shard_like_params`` enforces), and the clipping norm
    is summed over the ranks.  The loss runs ``cfg``'s impls; under
    ``"cuda"`` the forward launches the kernels and the backward takes
    the blocked attention's and the other ops' plain versions' gradient
    (``models.backend``)."""
    from repro_torch.models import transformer_spmd as SP
    from repro_torch.models.transformer import causal_lm_loss

    def train_step(state, batch):
        with _installed(rules):
            mesh = SP.active_mesh()
            specs = param_specs
            if mesh is not None and specs is None:
                specs = SP.param_specs(cfg, rules)
            params = state["params"]

            def loss_fn(mb):
                return lambda p: causal_lm_loss(p, cfg, mb["tokens"],
                                                mb["labels"])

            if accum <= 1:
                loss, grads = value_and_grad(loss_fn(batch), params)
            else:
                grads, loss = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device),
                    params), 0.0
                for j in range(accum):
                    mb = {k: _micro_batch(v, j, accum, mesh)
                          for k, v in batch.items()}
                    lj, g = value_and_grad(loss_fn(mb), params)
                    grads = tree_map(lambda a, b: a if b is None
                                     else a + b.float(), grads, g)
                    loss = loss + lj
                grads = tree_map(lambda g: g / accum, grads)
                loss = loss / accum
            params, opt, gn = _sharded_adam(grads, state, opt_cfg, specs)
        return {"params": params, "opt": opt}, \
            {"loss": loss, "grad_norm": gn}

    return train_step


def make_lm_cell(spec: ArchSpec, shape_name: str, rules: ShardingRules, *,
                 batch: int | None = None, seq: int | None = None) -> Cell:
    """The reference's LM cell of ``shape_name``: ``train`` (AdamW over
    ``_lm_accum`` micro-batches), ``prefill`` (``forward(collect_cache=
    True)`` and the last position's logits) or ``decode`` (one
    ``decode_step`` against a ``seq``-long cache at position ``pos``).
    Inference casts the config to bf16 params, as the reference's
    ``icfg``.  ``batch`` / ``seq`` cut the shape's global batch and
    sequence (the specs follow).

    Under rules over an SPMD mesh a rank's K/V cache is
    ``transformer_spmd.cache_block``'s layout (its data rows, the kv
    heads its query heads read), not the block of the cache's spec,
    which keeps the reference's ``DECODE_CACHE_AXES`` (its sequence cut
    over ``model``)."""
    from repro_torch.models import transformer as T
    from repro_torch.models import transformer_spmd as SP

    info = spec.shapes[shape_name]
    kind = info["kind"]
    gb, seq = batch or info["global_batch"], seq or info["seq_len"]
    cfg = spec.config
    n_act = cfg.num_active_params()
    ids = lambda gen, shape, device: _ids(gen, shape, cfg.vocab_size,
                                          device)

    if kind == "train":
        opt_cfg = _lm_opt_cfg(cfg)
        accum = _lm_accum(spec.name)
        st = state_specs(lambda g, d: (T.init_params(cfg, g, d),
                                       T.param_axes(cfg)), opt_cfg, rules)
        data = {"tokens": sds((gb, seq), torch.int32, rules,
                              ("batch", None)),
                "labels": sds((gb, seq), torch.int32, rules,
                              ("batch", None))}
        fn = make_lm_train_step(cfg, opt_cfg, accum, rules,
                                _specs_of(st["params"]))

        def inputs(gen, device):
            params = T.init_params(cfg, gen, device)
            return ({"params": params,
                     "opt": init_opt_state(params, opt_cfg)},
                    {"tokens": ids(gen, (gb, seq), device),
                     "labels": ids(gen, (gb, seq), device)})

        args = (st, data)
        return Cell(spec.name, shape_name, "train", fn, args,
                    model_flops=6.0 * n_act * gb * seq,
                    notes=f"grad_accum={accum}", donate=(0,), inputs=inputs,
                    local=lambda a: _spec_local(a, args, rules.mesh))

    icfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    data = [a for a in rules.mesh_axes("batch") if a in rules.mesh.shape]
    if gb % math.prod(rules.mesh.shape[a] for a in data):
        # a batch too small to split is whole on every rank, as its spec
        # says: the rules tell the MoE FFN so
        rules = ShardingRules(rules.mesh, {**rules.rules, "batch": ()})
    p_shapes, p_axes = eval_params(lambda g, d: (T.init_params(icfg, g, d),
                                                 T.param_axes(icfg)))
    params = attach_shardings(p_shapes, p_axes, rules)
    init = lambda gen, device: T.init_params(icfg, gen, device)

    if kind == "prefill":
        def prefill_step(params, tokens):
            with _installed(rules), torch.no_grad():
                hidden, kv, _ = T.forward(params, icfg, tokens,
                                          collect_cache=True)
                lg = T.logits(params, icfg, hidden[:, -1:])
            return lg, kv

        tokens = sds((gb, seq), torch.int32, rules, ("batch", None))
        args = (params, tokens)
        return Cell(spec.name, shape_name, "prefill", prefill_step, args,
                    model_flops=2.0 * n_act * gb * seq,
                    inputs=lambda gen, device: (
                        init(gen, device), ids(gen, (gb, seq), device)),
                    local=lambda a: _spec_local(a, args, rules.mesh))

    # decode: one new token against a seq_len KV cache
    def serve_step(params, tokens, cache, pos):
        with _installed(rules), torch.no_grad():
            return T.decode_step(params, icfg, tokens, cache, int(pos))

    cache_shape = (cfg.n_layers, gb, seq, cfg.n_kv_heads, cfg.dh)
    cache = tuple(sds(cache_shape, torch.bfloat16, rules,
                      T.DECODE_CACHE_AXES) for _ in range(2))
    tokens = sds((gb, 1), torch.int32, rules, ("batch", None))
    pos = TensorSpec((), torch.int32, PartitionSpec())
    args = (params, tokens, cache, pos)

    def inputs(gen, device):
        kv = tuple(torch.randn(cache_shape, generator=gen,
                               device=gen.device, dtype=torch.bfloat16)
                   .to(device) for _ in range(2))
        return (init(gen, device), ids(gen, (gb, 1), device), kv,
                torch.tensor(seq - 1, dtype=torch.int32, device=device))

    def local(a):
        p, t = _spec_local(a[:2], args[:2], rules.mesh)
        kv = a[2]
        if isinstance(rules.mesh, SpmdMesh):
            kv = tuple(SP.cache_block(c, icfg, rules.mesh) for c in kv)
        return p, t, kv, a[3]

    # useful decode FLOPs: params matmuls + attention against the cache
    attn_flops = 4.0 * gb * seq * cfg.n_heads * cfg.dh
    return Cell(spec.name, shape_name, "decode", serve_step, args,
                model_flops=2.0 * n_act * gb + attn_flops, donate=(2,),
                inputs=inputs, local=local)


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------


def _mlp_flops(dims, batch):
    return float(sum(2 * batch * a * b for a, b in zip(dims[:-1], dims[1:])))


#: the row-sharded leaves of a DLRM / DeepFM tree, never gathered
ROW_SHARDED = ("table", "w1")


def _recsys_view(params, specs, mesh):
    """The params a DLRM / DeepFM step computes with on this rank: the
    row-sharded tables as its block (their reads go through the sharded
    lookup), every dense leaf whole (``dist.spmd.whole_leaf``: the
    hybrid-parallel layout, each data group's rows on whole dense
    layers)."""
    if mesh is None:
        return params
    return {k: v if k in ROW_SHARDED else tree_map(
        lambda w, sp: S.whole_leaf(w, sp, mesh), v, specs[k])
        for k, v in params.items()}


def _data_mean(x, mesh):
    """The global mean from a data group's mean (the groups' rows are
    equal in number); its gradient passes through."""
    if mesh is None:
        return x
    axes = S.data_axes(mesh)
    return S.all_reduce_sum(x, mesh, axes) / mesh.axis_size(axes) \
        if axes else x


def _field_ids(gen, b, vocab_sizes, device):
    """[b, F] int32 ids, field f's uniform in its vocabulary."""
    return torch.stack([_ids(gen, (b,), v, device) for v in vocab_sizes], 1)


def _labels(gen, b, device):
    return (torch.rand((b,), generator=gen, device=gen.device) < 0.5) \
        .to(device, torch.float32)


def _normal(gen, shape, scale, device):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(device)


def _item_seqs(gen, cfg, b, device, *, cloze: bool):
    """BERT4Rec rows: a valid prefix of at least half the sequence of
    items in ``[2, n_items + 2)``, ``[MASK]`` at the last valid slot (and,
    for ``cloze``, at 15 % of the valid slots) -> ``(item_seq, valid,
    targets)``, targets the masked items (0 elsewhere)."""
    from repro_torch.models.recsys.bert4rec import MASK_ITEM

    s = cfg.seq_len
    valid = _prefix_valid(gen, b, s, max(1, s // 2), device)
    items = _ids(gen, (b, s), cfg.n_items, device) + 2
    last = torch.arange(s, device=device) == (valid.sum(1, keepdim=True) - 1)
    mask = last
    if cloze:
        drawn = torch.rand((b, s), generator=gen, device=gen.device) < 0.15
        mask = (mask | drawn.to(device)) & valid
    targets = torch.where(mask, items, 0).to(torch.int32)
    seq = torch.where(mask, MASK_ITEM, items) * valid
    return seq.to(torch.int32), valid, targets


def make_recsys_cell(spec: ArchSpec, shape_name: str, rules: ShardingRules,
                     *, batch: int | None = None) -> Cell:
    """The reference's recsys cells (``rec_train``, ``rec_serve``,
    ``rec_retrieval``) of DLRM, DeepFM / xDeepFM and BERT4Rec; ``batch``
    cuts the shape's batch.

    Under rules over an SPMD mesh a rank holds its block of every leaf:
    the fused ``table`` (and DeepFM's ``w1``) row-sharded over every axis
    and read through the sharded lookup, never gathered; the dense layers
    gathered whole for its data rows (:func:`_recsys_view`).  A train
    cell's loss is the global mean and its AdamW clips by the global norm
    (:func:`_sharded_adam`); retrieval scores come out as the rank's
    block of the candidate axis.  BERT4Rec runs ``attn_impl="blocked"``,
    as the reference's cells do: that attention reaches no Pallas kernel,
    and its ``forward_hidden`` (split flags that differ across its two
    layers, ``[MASK]`` anywhere) is one the split kernel refuses; over a
    mesh it takes the sharded transformer's route, the tied head
    vocab-sharded over ``model``."""
    info = spec.shapes[shape_name]
    kind = info["kind"]
    b = batch or info["batch"]
    name = spec.name
    cfg = spec.config
    opt_cfg = OptimizerConfig()
    mesh = rules.mesh if isinstance(rules.mesh, SpmdMesh) else None
    i32, f32 = torch.int32, torch.float32

    def cell(fn, args, flops, inputs, **kw):
        return Cell(name, shape_name, kind, fn, args, model_flops=flops,
                    inputs=inputs,
                    local=lambda a: _spec_local(a, args, rules.mesh), **kw)

    def new_state(params):
        return {"params": params, "opt": init_opt_state(params, opt_cfg)}

    if name == "bert4rec":
        from repro_torch.models.recsys import bert4rec as M

        cfg = dataclasses.replace(cfg, attn_impl="blocked")
        init = lambda g, d: (M.init_bert4rec(cfg, g, d), M.bert4rec_axes(cfg))
        bcfg = cfg.backbone()
        tok = b * cfg.seq_len
        # matmul params only: the (tied) item table is a lookup
        n_matmul = bcfg.num_params() - bcfg.vocab_size * bcfg.d_model \
            - bcfg.learned_pos * bcfg.d_model
        flops_fwd = 2.0 * n_matmul * tok
        rows = lambda dt: sds((b, cfg.seq_len), dt, rules, ("batch", None))
        if kind == "rec_train":
            st = state_specs(init, opt_cfg, rules)
            specs = _specs_of(st["params"])
            data = {"item_seq": rows(i32), "valid": rows(torch.bool),
                    "targets": rows(i32)}

            def train_step(state, batch):
                with _installed(rules):
                    loss, grads = value_and_grad(
                        lambda p: M.cloze_loss(p, cfg, batch),
                        state["params"])
                    params, opt, gn = _sharded_adam(grads, state, opt_cfg,
                                                    specs)
                return {"params": params, "opt": opt}, \
                    {"loss": loss, "grad_norm": gn}

            def inputs(gen, device):
                seq, valid, targets = _item_seqs(gen, cfg, b, device,
                                                 cloze=True)
                return (new_state(M.init_bert4rec(cfg, gen, device)),
                        {"item_seq": seq, "valid": valid,
                         "targets": targets})

            # Cloze head: 32 masked slots x the item softmax
            head_flops = 2.0 * b * 32 * bcfg.d_model * bcfg.vocab_size
            return cell(train_step, (st, data), 3 * (flops_fwd + head_flops),
                        inputs, donate=(0,))

        p_shapes, p_axes = eval_params(init)
        params = attach_shardings(p_shapes, p_axes, rules)

        def serve(params, seq, valid):
            with _installed(rules), torch.no_grad():
                return M.serve_topk(params, cfg, seq, valid,
                                    batch_chunk=min(1024, b))

        def inputs(gen, device):
            seq, valid, _ = _item_seqs(gen, cfg, b, device, cloze=False)
            return M.init_bert4rec(cfg, gen, device), seq, valid

        return cell(serve, (params, rows(i32), rows(torch.bool)),
                    flops_fwd + 2.0 * b * (cfg.n_items + 2) * cfg.embed_dim,
                    inputs)

    if name == "dlrm-mlperf":
        from repro_torch.models.recsys import dlrm as M

        init = lambda g, d: (M.init_dlrm(cfg, g, d), M.dlrm_axes(cfg))
        n_vec = cfg.n_sparse + 1
        flops_fwd = (_mlp_flops((cfg.n_dense, *cfg.bot_mlp), b)
                     + 2 * b * n_vec * n_vec * cfg.embed_dim
                     + _mlp_flops((n_vec * (n_vec - 1) // 2
                                   + cfg.bot_mlp[-1], *cfg.top_mlp), b))
        data = {"dense": sds((b, cfg.n_dense), f32, rules, ("batch", None)),
                "sparse": sds((b, cfg.n_sparse), i32, rules,
                              ("batch", None)),
                "labels": sds((b,), f32, rules, ("batch",))}
        fwd = lambda p, bt: M.dlrm_forward(p, cfg, bt["dense"], bt["sparse"])

        def batch_of(gen, device):
            return {"dense": _normal(gen, (b, cfg.n_dense), 1.0, device),
                    "sparse": _field_ids(gen, b, cfg.vocab_sizes, device),
                    "labels": _labels(gen, b, device)}

        if kind == "rec_retrieval":
            nc = _pad_mult(info["n_candidates"])   # row-shardable
            user = [cfg.vocab_sizes[f] for f in cfg.user_fields]
            p_shapes, p_axes = eval_params(init)
            params = attach_shardings(p_shapes, p_axes, rules)
            specs = _specs_of(params)
            bt = {"dense": sds((b, cfg.n_dense), f32, rules, ("batch", None)),
                  "user": sds((b, len(user)), i32, rules, ("batch", None))}
            vecs = sds((nc, cfg.embed_dim), f32, rules, ("table_rows", None))

            def retrieval(params, bt, iv):
                with _installed(rules), torch.no_grad():
                    return M.retrieval_scores(
                        _recsys_view(params, specs, mesh), cfg, bt["dense"],
                        bt["user"], iv)

            def inputs(gen, device):
                return (M.init_dlrm(cfg, gen, device),
                        {"dense": _normal(gen, (b, cfg.n_dense), 1.0, device),
                         "user": _field_ids(gen, b, user, device)},
                        # a table row's scale
                        _normal(gen, (nc, cfg.embed_dim), 0.01, device))

            return cell(retrieval, (params, bt, vecs),
                        2.0 * b * nc * cfg.embed_dim
                        + _mlp_flops((cfg.n_dense, *cfg.bot_mlp), b), inputs)
    else:
        from repro_torch.models.recsys import deepfm as M

        init = lambda g, d: (M.init_deepfm(cfg, g, d), M.deepfm_axes(cfg))
        flops_fwd = (_mlp_flops((cfg.n_fields * cfg.embed_dim, *cfg.mlp, 1),
                                b) + 2 * b * cfg.n_fields * cfg.embed_dim)
        if cfg.interaction == "cin":
            h_prev = cfg.n_fields
            for h in cfg.cin_layers:
                flops_fwd += 2 * b * h_prev * cfg.n_fields * cfg.embed_dim * h
                h_prev = h
        data = {"sparse": sds((b, cfg.n_fields), i32, rules,
                              ("batch", None)),
                "labels": sds((b,), f32, rules, ("batch",))}
        fwd = lambda p, bt: M.deepfm_forward(p, cfg, bt["sparse"])

        def batch_of(gen, device):
            return {"sparse": _field_ids(gen, b, cfg.vocab_sizes, device),
                    "labels": _labels(gen, b, device)}

        if kind == "rec_retrieval":
            nc = _pad_mult(info["n_candidates"])
            n_user = len(cfg.user_fields)
            p_shapes, p_axes = eval_params(init)
            params = attach_shardings(p_shapes, p_axes, rules)
            specs = _specs_of(params)
            args = (sds((b, n_user), i32, rules, ("batch", None)),
                    sds((nc, cfg.embed_dim), f32, rules,
                        ("table_rows", None)),
                    sds((nc,), f32, rules, ("table_rows",)))

            def retrieval(params, uids, ivecs, ifirst):
                with _installed(rules), torch.no_grad():
                    return M.retrieval_scores(
                        _recsys_view(params, specs, mesh), cfg, uids, ivecs,
                        ifirst)

            def inputs(gen, device):
                return (M.init_deepfm(cfg, gen, device),
                        _field_ids(gen, b, (cfg.vocab_per_field,) * n_user,
                                   device),
                        _normal(gen, (nc, cfg.embed_dim), 0.01, device),
                        _normal(gen, (nc,), 0.01, device))

            return cell(retrieval, (params, *args),
                        2.0 * b * nc * cfg.embed_dim, inputs)

    # the train and serve cells of DLRM and the DeepFM family
    if kind == "rec_train":
        st = state_specs(init, opt_cfg, rules)
        specs = _specs_of(st["params"])

        def train_step(state, batch):
            with _installed(rules):
                loss, grads = value_and_grad(
                    lambda p: _data_mean(M.bce_loss(
                        _recsys_view(p, specs, mesh), cfg, batch), mesh),
                    state["params"])
                params, opt, gn = _sharded_adam(grads, state, opt_cfg, specs)
            return {"params": params, "opt": opt}, \
                {"loss": loss, "grad_norm": gn}

        def inputs(gen, device):
            return (new_state(init(gen, device)[0]), batch_of(gen, device))

        return cell(train_step, (st, data), 3 * flops_fwd, inputs,
                    donate=(0,))

    p_shapes, p_axes = eval_params(init)
    params = attach_shardings(p_shapes, p_axes, rules)
    specs = _specs_of(params)
    del data["labels"]

    def serve(params, batch):
        with _installed(rules), torch.no_grad():
            return fwd(_recsys_view(params, specs, mesh), batch)

    def inputs(gen, device):
        params = init(gen, device)[0]
        bt = batch_of(gen, device)
        del bt["labels"]
        return params, bt

    return cell(serve, (params, data), flops_fwd, inputs)


# ---------------------------------------------------------------------------
# PreTTR cells (the paper's own model)
# ---------------------------------------------------------------------------

PRETTR_SHAPES = {
    "rank_train":  {"kind": "prettr_train", "global_batch": 256},
    "index_docs":  {"kind": "prettr_index", "batch": 4096},
    "serve_join":  {"kind": "prettr_serve", "batch": 2048},
}


def make_prettr_cell(spec: ArchSpec, shape_name: str, rules: ShardingRules,
                     *, batch: int | None = None) -> Cell:
    """The reference's PreTTR cells: ``rank_train`` (``rank_pairs_loss``
    over positive and negative pairs, then AdamW, under ``rules``),
    ``index_docs`` (``precompute_docs``) and ``serve_join``
    (``join_and_score``); the last two under ``replicated_serving_rules``,
    the batch cut over every axis and the weights whole.  ``batch`` cuts
    the shape's batch.  ``rank_train`` differentiates through the
    config's impls (under ``"cuda"`` the kernels forward; backward the
    blocked attention's and the plain versions' gradient:
    ``models.backend``)."""
    from repro_torch.core import prettr as P

    cfg = spec.config
    bcfg = cfg.backbone
    info = PRETTR_SHAPES[shape_name]
    if shape_name in ("index_docs", "serve_join"):
        rules = replicated_serving_rules(rules.mesh)
    lq, ld = cfg.max_query_len, cfg.max_doc_len
    s = lq + ld
    n = bcfg.num_params()
    init = lambda g, d: (P.init_prettr(cfg, g, d), P.prettr_axes(cfg))

    def cell(kind, fn, args, flops, inputs, **kw):
        return Cell(spec.name, shape_name, kind, fn, args, model_flops=flops,
                    inputs=inputs,
                    local=lambda a: _spec_local(a, args, rules.mesh), **kw)

    if info["kind"] == "prettr_train":
        gb = batch or info["global_batch"]
        opt_cfg = OptimizerConfig()
        st = state_specs(init, opt_cfg, rules)
        specs = _specs_of(st["params"])
        pair = {"tokens": sds((gb, s), torch.int32, rules, ("batch", None)),
                "segs": sds((gb, s), torch.int32, rules, ("batch", None)),
                "valid": sds((gb, s), torch.bool, rules, ("batch", None))}

        def train_step(state, pos, neg):
            with _installed(rules):
                loss, grads = value_and_grad(
                    lambda p: P.rank_pairs_loss(p, cfg, pos, neg),
                    state["params"])
                params, opt, gn = _sharded_adam(grads, state, opt_cfg,
                                                specs)
            return {"params": params, "opt": opt}, \
                {"loss": loss, "grad_norm": gn}

        def pairs(gen, device):
            valid = torch.cat([_prefix_valid(gen, gb, lq, 2, device),
                               _prefix_valid(gen, gb, ld, 2, device)], 1)
            segs = torch.cat([torch.zeros((gb, lq), dtype=torch.int32),
                              torch.ones((gb, ld), dtype=torch.int32)],
                             1).to(device)
            toks = _ids(gen, (gb, s), bcfg.vocab_size, device) * valid
            return {"tokens": toks, "segs": segs, "valid": valid}

        def inputs(gen, device):
            params = P.init_prettr(cfg, gen, device)
            return ({"params": params, "opt": init_opt_state(params,
                                                             opt_cfg)},
                    pairs(gen, device), pairs(gen, device))

        return cell(info["kind"], train_step, (st, pair, pair),
                    2 * 3 * 2.0 * n * gb * s, inputs, donate=(0,))

    p_shapes, p_axes = eval_params(init)
    params = attach_shardings(p_shapes, p_axes, rules)
    b = batch or info["batch"]

    if info["kind"] == "prettr_index":
        def index_step(params, docs, valid):
            with _installed(rules), torch.no_grad():
                return P.precompute_docs(params, cfg, docs, valid)

        def inputs(gen, device):
            valid = _prefix_valid(gen, b, ld, 2, device)
            return (P.init_prettr(cfg, gen, device),
                    _ids(gen, (b, ld), bcfg.vocab_size, device) * valid,
                    valid)

        args = (params,
                sds((b, ld), torch.int32, rules, ("batch", None)),
                sds((b, ld), torch.bool, rules, ("batch", None)))
        return cell(info["kind"], index_step, args,
                    2.0 * n * (cfg.l / bcfg.n_layers) * b * ld, inputs)

    def join_step(params, q_reps, q_valid, store, d_valid):
        with _installed(rules), torch.no_grad():
            return P.join_and_score(params, cfg, q_reps, q_valid, store,
                                    d_valid)

    e = cfg.compress_dim or bcfg.d_model

    def inputs(gen, device):
        normal = lambda *shape: torch.randn(shape, generator=gen,
                                            device=gen.device)
        # stored reps as the compressor writes them: GELU outputs
        store = torch.nn.functional.gelu(normal(b, ld, e),
                                         approximate="tanh")
        return (P.init_prettr(cfg, gen, device),
                normal(b, lq, bcfg.d_model).to(device),
                _prefix_valid(gen, b, lq, 2, device),
                store.to(device, cfg.store_dtype),
                _prefix_valid(gen, b, ld, 2, device))

    args = (params,
            sds((b, lq, bcfg.d_model), torch.float32, rules,
                ("batch", None, None)),
            sds((b, lq), torch.bool, rules, ("batch", None)),
            sds((b, ld, e), torch.float16, rules, ("batch", None, None)),
            sds((b, ld), torch.bool, rules, ("batch", None)))
    frac = (bcfg.n_layers - cfg.l) / bcfg.n_layers
    return cell(info["kind"], join_step, args, 2.0 * n * frac * b * s,
                inputs)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def backend_support(cfg, backend: str | None) -> str:
    """``"applied"`` if ``backend`` (``"cuda"``, ``"plain"`` or
    ``"blocked"``) lands on ``cfg``, ``"passthrough"`` if the config has
    no backend knob (recsys, GNN), ``"unsupported"`` if the arch cannot
    run it: the reference's logic, its ``"pallas"`` being the port's
    ``"cuda"``; ``"plain"`` and ``"blocked"`` apply to every config with
    the knobs.  One stated
    difference: the split kernel takes the window at runtime, so a layer
    range that mixes windows (gemma3-4b) is ``"applied"`` under
    ``"cuda"`` where the reference's ``"pallas"`` is ``"unsupported"``.
    A bare TransformerConfig whose split flags differ across its layers
    stays ``"unsupported"``: the kernel impl refuses it (a PreTTRConfig's
    cells run the uniform subranges [0, l) and [l, n))."""
    from repro_torch.models.backend import impls_for, transformer_config_of

    if backend is None:
        return "passthrough"
    impls_for(backend)
    tcfg = transformer_config_of(cfg)
    if tcfg is None:
        return "passthrough"
    if backend == "cuda" and tcfg is cfg \
            and 0 < tcfg.split_layers < tcfg.n_layers:
        return "unsupported"
    return "applied"


def _with_backend(spec: ArchSpec, backend: str | None) -> ArchSpec:
    """A spec whose configs route through ``backend``; configs where it
    does not apply (:func:`backend_support`) pass through unchanged."""
    if backend is None:
        return spec
    from repro_torch.models.backend import apply_backend

    def swap(cfg):
        if cfg is None or backend_support(cfg, backend) != "applied":
            return cfg
        return apply_backend(cfg, backend)

    return dataclasses.replace(spec, config=swap(spec.config),
                               smoke=swap(spec.smoke))


def build_cell(arch: str, shape_name: str, rules: ShardingRules,
               backend: str | None = None, *, smoke: bool = False,
               batch: int | None = None, seq: int | None = None,
               n_layers: int | None = None,
               rows_per_field: int | None = None,
               graph_cut: int | None = None) -> Cell:
    """The cell ``(arch, shape_name)`` under ``rules``, its configs routed
    through ``backend``.  The port's cuts for running a cell where its
    published size does not fit: ``smoke`` takes the arch's smoke config,
    ``n_layers`` keeps that many layers, ``batch`` / ``seq`` cut the
    shape's batch and sequence, ``rows_per_field`` caps every field's
    vocabulary of a DLRM / DeepFM table (widths stay as published),
    ``graph_cut`` divides a DimeNet graph's nodes and edges
    (:func:`gnn_cell_config`)."""
    return build_spec_cell(get_arch(arch), shape_name, rules, backend,
                           smoke=smoke, batch=batch, seq=seq,
                           n_layers=n_layers, rows_per_field=rows_per_field,
                           graph_cut=graph_cut)


def _cap_rows(cfg, cap: int):
    """A DLRM / DeepFM config with every field's vocabulary at most
    ``cap``."""
    if hasattr(cfg, "vocab_per_field"):
        return dataclasses.replace(cfg, vocab_per_field=min(
            cfg.vocab_per_field, cap))
    if hasattr(cfg, "vocab_sizes"):
        return dataclasses.replace(cfg, vocab_sizes=tuple(
            min(v, cap) for v in cfg.vocab_sizes))
    raise ValueError(f"{cfg.name}: rows_per_field cuts a DLRM or DeepFM "
                     f"table")


def build_spec_cell(spec: ArchSpec, shape_name: str, rules: ShardingRules,
                    backend: str | None = None, *, smoke: bool = False,
                    batch: int | None = None, seq: int | None = None,
                    n_layers: int | None = None,
                    rows_per_field: int | None = None,
                    graph_cut: int | None = None) -> Cell:
    """:func:`build_cell` of the architecture ``spec`` describes (as
    registered, or with its configs replaced)."""
    arch = spec.name
    if graph_cut is not None and spec.family != "gnn":
        raise ValueError(f"{arch}: graph_cut cuts a DimeNet graph")
    spec = _with_backend(spec, backend)
    if smoke:
        spec = dataclasses.replace(spec, config=spec.smoke)
    if rows_per_field is not None:
        spec = dataclasses.replace(spec, config=_cap_rows(spec.config,
                                                          rows_per_field))
    if spec.family == "recsys":
        if seq is not None or n_layers is not None:
            raise ValueError(f"{arch}: a recsys cell takes the cuts batch "
                             f"and rows_per_field")
        return make_recsys_cell(spec, shape_name, rules, batch=batch)
    if spec.family == "gnn":
        if batch is not None or seq is not None or n_layers is not None:
            raise ValueError(f"{arch}: a DimeNet cell takes the cuts smoke "
                             f"and graph_cut")
        return make_gnn_cell(spec, shape_name, rules, graph_cut=graph_cut)
    if n_layers is not None:
        cfg = spec.config
        if hasattr(cfg, "backbone"):
            raise ValueError(f"{arch}: n_layers cuts a transformer LM")
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            cfg, n_layers=n_layers))
    if arch == "prettr-bert":
        return make_prettr_cell(spec, shape_name, rules, batch=batch)
    return make_lm_cell(spec, shape_name, rules, batch=batch, seq=seq)


def cell_names(include_prettr: bool = True) -> list[tuple[str, str]]:
    """Every (arch, shape) cell of the reference's dry-run, recsys cells
    included."""
    from repro_torch.configs import ASSIGNED_ARCHS, arch_cells

    out = [(arch, shape) for arch in ASSIGNED_ARCHS
           for shape in arch_cells(arch)]
    if include_prettr:
        out += [("prettr-bert", shape) for shape in PRETTR_SHAPES]
    return out


def cell_inputs(cell: Cell, generator: torch.Generator, device, *,
                whole: bool = False):
    """Real tensors for ``cell.args``, made from ``generator`` (seeded
    weights from the model's own init, token ids, valid prefixes, random
    reps and caches) on ``device``: the whole leaves (``whole``), or this
    rank's part of them under the cell's rules (``cell.local``: each
    leaf's block under its spec, a decode cache in the sharded
    transformer's layout).  It adds no feature to the model: the reference
    only compiles its cells."""
    if cell.inputs is None:
        raise ValueError(f"{cell.arch} {cell.shape}: the DimeNet cells take "
                         f"a graph from data.graphs")
    args = cell.inputs(generator, device)
    return args if whole else cell.local(args)
