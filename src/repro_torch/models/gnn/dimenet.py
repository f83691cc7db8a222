"""DimeNet (Klicpera et al., arXiv:2003.03123), the port of
``repro.models.gnn.dimenet``.

Directional message passing: messages live on *directed edges* m_{ji};
interaction blocks aggregate over *triplets* (k->j->i) with a joint
radial x angular basis of the (d_kj, angle_kji) geometry.  The triplets
come from host-enumerated index lists with a fanout cap
(``repro_torch.data.graphs``), gathered, then summed onto edges and from
edges onto nodes.

The interaction block is the reference's DimeNet++ form (Hadamard basis
gating with a down / up projection, arXiv:2011.14115); ``n_bilinear``
sizes the down-projection.  Citation-graph cells carry node *features*:
a linear input projection replaces the atom embedding, and synthetic 3D
positions supply the geometry.

No Pallas kernel computes any of it in the reference, and the port runs
no hand-written kernel here: gathers, ``index_add``, a reshape-sum and
small dense products (``@``).  Gathers that carry gradients are
``index_select``, whose backward is an ``index_add``: indexing's backward
sorts the indices instead, which took 45.7 of a Cora training step's
52.1 busy ms on an H100 (``chip_smoke.py``'s profile).  On the card
``index_add`` accumulates in a nondeterministic order, so two runs there
differ at float32 rounding.

Where parity hangs on detail, as the reference does it:

- distances, unit vectors, angles and both bases are float32, cast to
  ``compute_dtype`` only then; ``sbf`` is masked by ``trip_valid`` after
  the cast;
- the envelope divides by ``max(d, 1e-9)`` and *selects* (``where``)
  below the cutoff: ``u`` is huge where ``d`` is tiny, so a multiply by
  a mask would not do; the cosine is clipped at +-(1 - 1e-7) in float32
  before ``arccos``;
- triplet -> edge aggregation is a local reshape-sum when
  ``cfg.blocked_triplets`` and ``T % E == 0`` (``build_triplets``' blocked
  layout), else an ``index_add`` over ``trip_ji``;
- each block projects ``[E, d] -> [E, n_bilinear]`` *before* the gather
  by ``trip_kj`` (the same math as gathering first, 16x less traffic);
- each interaction block is recomputed in the backward
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)
  whenever grad is enabled, so only the ``[E, d]`` carry stays live
  between blocks.

The reference's ``maybe_shard`` hints place the messages and the gated
triplets over ``("edges", None)`` and leave GSPMD to insert the
collectives.  Here the model reaches its weights, its graph and its
collectives through a route (:class:`Local`: one process, every hook
the identity); under rules over an SPMD mesh
:mod:`~repro_torch.models.gnn.dimenet_spmd` gives the same hooks over a
rank's edge block, with the collectives written out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 6
    d_feat: int = 0            # >0: feature input projection (citation graphs)
    n_atom_types: int = 16
    n_classes: int = 16        # node-classification head
    task: str = "node_cls"     # "node_cls" | "energy"
    # build_triplets' lists are blocked (trip_ji[t] == t // fanout_cap), so
    # triplet -> edge aggregation is a local reshape-sum; False sums by
    # index for arbitrary layouts
    blocked_triplets: bool = True
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# Geometry bases (float32)
# ---------------------------------------------------------------------------


def envelope(d_scaled, p: int):
    """Smooth polynomial cutoff envelope u(d) (DimeNet Eq. 8)."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    u = 1.0 / torch.clamp(d_scaled, min=1e-9) + a * d_scaled ** (p - 1) \
        + b * d_scaled ** p + c * d_scaled ** (p + 1)
    return torch.where(d_scaled < 1.0, u, 0.0)


def radial_basis(d, n_radial: int, cutoff: float, p: int):
    """e_RBF: [E, n_radial] — spherical Bessel j_0 roots (Eq. 7)."""
    ds = d / cutoff
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    env = envelope(ds, p)
    return (env[:, None] * math.sqrt(2.0 / cutoff)
            * torch.sin(n[None, :] * math.pi * ds[:, None]))


def spherical_basis(d_kj, angle, n_spherical: int, n_radial: int,
                    cutoff: float, p: int):
    """a_SBF: [T, n_spherical * n_radial] — radial Bessel x Chebyshev
    angular polynomials (the reference's cos(l theta) expansion in place
    of the Legendre / Bessel product)."""
    ds = d_kj / cutoff
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d_kj.device)
    env = envelope(ds, p)
    rad = env[:, None] * torch.sin(n[None, :] * math.pi * ds[:, None])
    l = torch.arange(n_spherical, dtype=torch.float32, device=d_kj.device)
    ang = torch.cos(l[None, :] * angle[:, None])                     # [T, S]
    return (rad[:, None, :] * ang[:, :, None]).reshape(d_kj.shape[0], -1)


def edge_geometry(positions, src, dst):
    """distances d_ji and unit vectors for directed edges j->i."""
    vec = positions[dst] - positions[src]
    d = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
    return d, vec / d[:, None]


def triplet_angles(unit_vec, trip_kj, trip_ji):
    """angle at j between edges (k->j) and (j->i)."""
    # k->j points toward j; j->i points away from j: angle between -v_kj, v_ji
    cos = torch.sum((-unit_vec[trip_kj]) * unit_vec[trip_ji], dim=-1)
    return torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _mlp_shapes(dims):
    return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
            for i in range(len(dims) - 1)]


def param_shapes(cfg: DimeNetConfig) -> dict:
    """The shape of every leaf of the params tree, as nested dicts and
    lists of tuples."""
    d, nb, r = cfg.d_hidden, cfg.n_bilinear, cfg.n_radial
    block = {"w_src": (d, d),                        # m_kj transform
             "w_rbf": (r, d),
             "w_sbf": (cfg.n_spherical * r, nb),     # basis -> bilinear dim
             "w_down": (d, nb),                      # DimeNet++ projection
             "w_up": (nb, d),
             "update": _mlp_shapes([2 * d, d, d])}
    return {"embed": (cfg.d_feat or cfg.n_atom_types, d),
            "rbf_proj": (r, d),
            "msg_init": _mlp_shapes([3 * d, d]),
            "blocks": [dict(block) for _ in range(cfg.n_blocks)],
            "out_rbf": (r, d),
            "head": _mlp_shapes([d, d, cfg.n_classes
                                 if cfg.task == "node_cls" else 1])}


def _mlp_axes(dims):
    return [{"w": ("embed", "mlp"), "b": ("mlp",)}
            for _ in range(len(dims) - 1)]


def dimenet_axes(cfg: DimeNetConfig) -> dict:
    """The logical-axes tree of :func:`init_dimenet`'s params (the JAX
    ``init_dimenet``'s second return; its head is annotated as a
    ``[d, d, 1]`` MLP, two layers whatever the class count)."""
    d = cfg.d_hidden
    block = {"w_src": ("embed", "mlp"), "w_rbf": (None, "embed"),
             "w_sbf": (None, None), "w_down": ("embed", None),
             "w_up": (None, "embed"), "update": _mlp_axes([2 * d, d, d])}
    return {"embed": (None, "embed"), "rbf_proj": (None, "embed"),
            "msg_init": _mlp_axes([3 * d, d]),
            "blocks": [dict(block) for _ in range(cfg.n_blocks)],
            "out_rbf": (None, "embed"), "head": _mlp_axes([d, d, 1])}


def init_dimenet(cfg: DimeNetConfig, generator: torch.Generator,
                 device=None) -> dict:
    """Random params with the JAX ``init_dimenet`` tree (``embed``,
    ``rbf_proj``, ``msg_init``, ``blocks``, ``out_rbf``, ``head``; the
    layer stacks as lists of ``{w, b}``) in ``cfg.param_dtype``: dense
    weights ``N(0, 1/d_in)``, biases 0, the atom-type embedding ``N(0, 1)
    x 0.5``, all drawn in float32 on ``generator``'s device and placed on
    ``device`` (``None`` means the card)."""
    dev = resolve_device(device)

    def draw(key, shape):
        if key.endswith("/b"):
            return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        x = torch.randn(shape, generator=generator, device=generator.device)
        scale = 0.5 if key == "embed" and not cfg.d_feat \
            else 1.0 / math.sqrt(shape[0])
        return (x * scale).to(device=dev, dtype=cfg.param_dtype)

    return map_shapes(draw, param_shapes(cfg))


def map_shapes(fn, shapes, prefix: str = ""):
    """``fn(key, shape)`` over the tuple leaves of a :func:`param_shapes`
    tree, keyed as ``tree.leaves_with_paths`` keys the params; the result
    has the tree's structure."""
    if isinstance(shapes, dict):
        return {k: map_shapes(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [map_shapes(fn, v, f"{prefix}/{i}")
                for i, v in enumerate(shapes)]
    return fn(prefix, shapes)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mlp(layers, x, last_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or last_act:
            x = F.silu(x)
    return x


def _segment_sum(x, ids, n: int):
    """``jax.ops.segment_sum(x, ids, num_segments=n)``: ``index_add`` onto
    float32 zeros (in a nondeterministic order on the card), rounded to
    ``x``'s dtype once; a bf16 sum would round at every add."""
    return torch.zeros((n, *x.shape[1:]), dtype=torch.float32,
                       device=x.device).index_add(0, ids, x.float()) \
        .to(x.dtype)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


class Local:
    """How DimeNet reaches its weights, its graph and its collectives in
    one process: every leaf whole, every hook the identity.
    ``dimenet_spmd.Route`` gives the same hooks where the batch leaves are
    a rank's blocks on an SPMD mesh (the edges and triplets cut over
    every axis) and the params its shards."""

    def weights(self, params):
        """The params as the model computes with them."""
        return params

    def n_nodes(self, node_feat, positions) -> int:
        return node_feat.shape[0] if node_feat.ndim else positions.shape[0]

    def geometry(self, d, unit):
        """The distances and unit vectors of every edge, from this
        route's edges' ones."""
        return d, unit

    def nodes(self, h):
        """The node embedding of every node, from this route's node
        rows."""
        return h

    def edges(self, x):
        """A per-edge tensor of every edge, from this route's edges'
        rows."""
        return x

    def triplets_to_edges(self, gated, trip_ji, n_edges: int):
        """Triplet rows summed onto this route's ``n_edges`` edges by
        ``trip_ji`` (the unblocked layout)."""
        return _segment_sum(gated, trip_ji, n_edges)

    def run(self, fn, *args):
        """One interaction block ``fn(*args)``, recomputed in the backward
        whenever grad is enabled (only the ``[E, d]`` carry stays live
        between blocks)."""
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def edges_to_nodes(self, x, edge_dst, n_nodes: int):
        """The per-node sum of ``x`` over its in-edges, for the nodes
        this route's head runs on."""
        return _segment_sum(x, edge_dst, n_nodes)

    def rows(self, x):
        """This route's rows of a per-node tensor that is whole."""
        return x

    def to_graphs(self, x, graph_ids, n_graphs: int):
        """Per-graph sums of the head's rows."""
        return _segment_sum(x, graph_ids, n_graphs)

    def total(self, x):
        """A sum over this route's rows, summed over every route."""
        return x


LOCAL = Local()


def _route(cfg):
    """The installed rules' SPMD route, or :data:`LOCAL`."""
    from repro_torch.models.gnn import dimenet_spmd as SP

    return SP.Route(cfg) if SP.active_mesh() is not None else LOCAL


def dimenet_forward(params, cfg: DimeNetConfig, *, node_feat, positions,
                    edge_src, edge_dst, edge_valid, trip_kj, trip_ji,
                    trip_valid, graph_ids=None, n_graphs: int = 0):
    """Returns per-node logits [N, n_classes] or per-graph energy [G], in
    ``cfg.compute_dtype``.  Index tensors are int32 or int64.  Under rules
    over an SPMD mesh the inputs and params are a rank's blocks
    (``dimenet_spmd``) and the logits its contiguous share of the node
    rows (``Route.node_rows``); the energies are whole."""
    route = _route(cfg)
    cd = cfg.compute_dtype
    cast = lambda t: tree_map(lambda a: a.to(cd), t)
    params = route.weights(params)
    n_nodes = route.n_nodes(node_feat, positions)
    d_ji, unit = edge_geometry(positions.float(), edge_src, edge_dst)
    rbf = radial_basis(d_ji, cfg.n_radial, cfg.cutoff,
                       cfg.envelope_p).to(cd)
    # the k->j edges of a triplet may be any edge
    d_all, unit_all = route.geometry(d_ji, unit)
    angle = triplet_angles(unit_all, trip_kj, trip_ji)
    sbf = spherical_basis(d_all[trip_kj], angle, cfg.n_spherical,
                          cfg.n_radial, cfg.cutoff, cfg.envelope_p).to(cd)
    sbf = sbf * trip_valid[:, None].to(cd)
    e_valid = edge_valid[:, None].to(cd)

    # node embedding
    if cfg.d_feat:
        h = node_feat.to(cd) @ params["embed"].to(cd)
    else:
        h = params["embed"].to(cd).index_select(0, node_feat)
    h = route.nodes(h)
    rbf_e = rbf @ params["rbf_proj"].to(cd)
    m = _mlp(cast(params["msg_init"]),
             torch.cat([h.index_select(0, edge_src),
                        h.index_select(0, edge_dst), rbf_e], dim=-1),
             last_act=True)
    m = m * e_valid

    n_edges = edge_src.shape[0]
    n_trip = trip_kj.shape[0]

    def interaction_block(m, bp):
        # down-project per edge before the triplet gather: the gathered
        # operand is [T, n_bilinear], not [T, d_hidden]
        down = (F.silu(m @ bp["w_src"]) * (rbf @ bp["w_rbf"])) \
            @ bp["w_down"]                                     # [E, nb]
        gated = route.edges(down).index_select(0, trip_kj) \
            * (sbf @ bp["w_sbf"])
        if cfg.blocked_triplets and n_trip % n_edges == 0:
            agg = gated.reshape(n_edges, n_trip // n_edges, -1).sum(dim=1)
        else:
            agg = route.triplets_to_edges(gated, trip_ji, n_edges)
        inc = agg @ bp["w_up"]                                 # [E, d]
        m = m + _mlp(bp["update"], torch.cat([m, inc], dim=-1),
                     last_act=True)
        return m * e_valid

    for blk in params["blocks"]:
        m = route.run(interaction_block, m, cast(blk))

    # edges -> nodes
    node_out = route.edges_to_nodes(m * (rbf @ params["out_rbf"].to(cd)),
                                    edge_dst, n_nodes)
    out = _mlp(cast(params["head"]), node_out)
    if cfg.task == "energy":
        if graph_ids is None or n_graphs <= 0:
            raise ValueError("the energy task needs graph_ids and "
                             "n_graphs > 0")
        return route.to_graphs(out[:, 0], route.rows(graph_ids), n_graphs)
    return out


def _forward_batch(params, cfg, batch, **kw):
    return dimenet_forward(
        params, cfg, node_feat=batch["node_feat"],
        positions=batch["positions"], edge_src=batch["edge_src"],
        edge_dst=batch["edge_dst"], edge_valid=batch["edge_valid"],
        trip_kj=batch["trip_kj"], trip_ji=batch["trip_ji"],
        trip_valid=batch["trip_valid"], **kw)


def node_cls_loss(params, cfg, batch):
    """Mean cross-entropy of the node logits (log-softmax in float32)
    over the nodes of ``batch.get("label_mask")`` (all nodes without
    one), divided by ``max(sum(mask), 1)``.  On a mesh each rank sums its
    share of the nodes and the sums are all-reduced: every rank returns
    the same loss."""
    route = _route(cfg)
    logits = _forward_batch(params, cfg, batch)
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = route.rows(batch["labels"]).long()
    gold = torch.gather(logp, -1, labels[:, None])[:, 0]
    mask = batch.get("label_mask")
    mask = torch.ones_like(gold) if mask is None \
        else route.rows(mask).to(gold.dtype)
    return -route.total(torch.sum(gold * mask)) \
        / torch.clamp(route.total(torch.sum(mask)), min=1.0)


def energy_loss(params, cfg, batch):
    """Mean squared error of the per-graph energies."""
    pred = _forward_batch(params, cfg, batch, graph_ids=batch["graph_ids"],
                          n_graphs=batch["labels"].shape[0])
    return torch.mean(torch.square(pred - batch["labels"]))
