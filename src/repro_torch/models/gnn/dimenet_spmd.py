"""DimeNet over an SPMD mesh: the :class:`Route` that
:func:`repro_torch.models.gnn.dimenet.dimenet_forward`, ``node_cls_loss``
and ``energy_loss`` take when the installed rules' mesh is an
:class:`~repro_torch.dist.compat.SpmdMesh`.  It computes what the JAX
package computes when GSPMD lays the model out by ``default_rules``
(``repro.models.gnn.dimenet`` places the messages and the gated triplets
over ``("edges", None)``), with the collectives written out
(:mod:`repro_torch.dist.spmd`).  The forward is DimeNet's own; this
module gives it a rank's weights and the collectives around the reads
that cross edge blocks (``dimenet.Local`` lists the hooks).

What a rank holds, each batch leaf under the spec of ``launch.steps``'
GNN cell (``_spec_local``):

* ``edge_*`` and ``trip_*``: a contiguous block of ``E / W`` edges and
  the matching ``T / W`` triplet slots, ``W`` the mesh's size.  The rules
  must cut ``"edges"`` over every mesh axis of more than one rank, in the
  mesh's order, or the route raises: a rank never runs one process's
  arithmetic on its block.  In ``build_triplets``' blocked layout a
  rank's triplets are those of its own edges, so the reshape-sum onto
  edges stays local;
* ``node_feat``: the rows of ``("table_rows", None)`` -- a block where
  the mesh divides the node count, whole where not (``divisible_spec``);
  atom types whole;
* ``positions``, ``labels``, ``label_mask`` and ``graph_ids`` whole;
* each parameter: its block under
  :func:`~repro_torch.models.gnn.dimenet.dimenet_axes`.

The reads that cross blocks, in the forward's order:

1. every weight gathered whole (:func:`~repro_torch.dist.spmd.summed_leaf`):
   each rank uses it for its own edges and nodes, the ranks of ``model``
   too, so its gradient is the sum over all ``W`` ranks, reduce-scattered
   to the rank's block;
2. the node embedding of the rank's node rows, all-gathered to ``[N, d]``
   where ``node_feat`` is cut (the gradient summed back);
3. the distance and unit vector ``[E, 4]`` of every edge, gathered in
   float32 once a forward (the triplets' ``k -> j`` edges lie anywhere;
   no gradient);
4. in each interaction block, the down-projected messages ``[E / W,
   n_bilinear]`` all-gathered to ``[E, n_bilinear]`` before the triplet
   gather (the backward reduce-scatters the ``index_add`` of the triplet
   gradients).  Each block runs under ``torch.utils.checkpoint``, so the
   gather is made again in the backward, under the rules (autograd's
   backward thread on the card has none installed).  The unblocked layout
   (``blocked_triplets=False`` or ``T % E != 0``) sums the rank's triplets
   into a float32 ``[E, n_bilinear]`` and reduce-scatters it to the
   rank's edges;
5. edges to nodes: the rank's edges summed into a float32 ``[N, d]``
   partial, all-reduced, rounded to ``compute_dtype`` once (as one
   process's ``_segment_sum`` rounds once);
6. the head on the rank's contiguous share of the nodes
   (:meth:`Route.node_rows`); ``node_cls_loss`` all-reduces the masked
   log-likelihood sum and the mask count, ``energy_loss`` the float32
   per-graph partial energies, so every rank holds the same loss.
"""
from __future__ import annotations

import torch

from repro_torch.dist import spmd as S
from repro_torch.dist.compat import SpmdMesh, axis_index
from repro_torch.dist.context import current_rules, install_rules
from repro_torch.dist.sharding import divisible_spec
from repro_torch.models.gnn import dimenet as D
from repro_torch.tree import tree_map


def active_mesh():
    """The installed rules' mesh when it is an SPMD mesh, else None."""
    rules = current_rules()
    if rules is not None and isinstance(rules.mesh, SpmdMesh):
        return rules.mesh
    return None


def edge_axes(rules) -> tuple:
    """The mesh axes that cut the edges under ``rules``: every axis of
    more than one rank, in the mesh's order; raises where the rules cut
    them otherwise."""
    mesh = rules.mesh
    mapped = tuple(a for a in rules.mesh_axes("edges") if a in mesh.shape)
    need = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    if any(a not in mapped for a in need) \
            or list(mapped) != [a for a in mesh.axis_names if a in mapped]:
        raise ValueError(f"DimeNet runs edge-parallel over every mesh axis: "
                         f"the rules cut 'edges' over {mapped} of a mesh "
                         f"{dict(mesh.shape)}")
    return mapped


def param_specs(cfg: D.DimeNetConfig, rules):
    """The ``PartitionSpec`` of every leaf of :func:`dimenet.init_dimenet`'s
    params under ``rules``."""
    meta = D.map_shapes(lambda _, s: torch.empty(s, device="meta"),
                        D.param_shapes(cfg))
    return S.tree_specs(meta, D.dimenet_axes(cfg), rules)


class Route(D.Local):
    """DimeNet's hooks on this rank of the installed rules' SPMD mesh:
    ``params`` are its shards, the batch leaves its blocks (module
    docstring).  Made once a forward or loss call."""

    def __init__(self, cfg: D.DimeNetConfig):
        self.rules = rules = current_rules()
        self.mesh = mesh = rules.mesh
        self.cfg = cfg
        self.axes = edge_axes(rules)
        self.world = mesh.axis_size(self.axes)
        self.rank = axis_index(mesh, self.axes) if self.axes else 0
        self.specs = param_specs(cfg, rules)
        self.shapes = D.param_shapes(cfg)
        self.node_axes = ()

    def weights(self, params):
        def whole(w, spec, shape):
            w = S.summed_leaf(w, spec, self.mesh)
            if tuple(w.shape) != tuple(shape):
                raise ValueError(f"a DimeNet leaf of {tuple(shape)} gathered "
                                 f"to {tuple(w.shape)}: the route takes a "
                                 f"rank's shards under {spec}")
            return w
        return tree_map(whole, params, self.specs, self.shapes)

    def n_nodes(self, node_feat, positions) -> int:
        n = positions.shape[0]
        if self.cfg.d_feat:
            spec = divisible_spec(self.rules, ("table_rows", None),
                                  (n, self.cfg.d_feat))
            self.node_axes = S.entry_axes(spec[0])
        rows = n // self.mesh.axis_size(self.node_axes)
        if node_feat.shape[0] != rows:
            raise ValueError(f"node_feat of {node_feat.shape[0]} rows on a "
                             f"rank of {dict(self.mesh.shape)} over {n} "
                             f"nodes: its block has {rows}")
        return n

    def node_rows(self, n_nodes: int) -> tuple[int, int]:
        """``(start, length)`` of this rank's contiguous share of
        ``n_nodes`` nodes, ``ceil(N / W)`` a rank (the last shares may be
        short or empty)."""
        share = -(-n_nodes // self.world)
        start = min(self.rank * share, n_nodes)
        return start, min(share, n_nodes - start)

    def geometry(self, d, unit):
        with torch.no_grad():
            g = S._gather(torch.cat([d[:, None], unit], dim=1), 0, self.mesh,
                          self.axes)
        return g[:, 0], g[:, 1:]

    def nodes(self, h):
        return S.all_gather(h, 0, self.mesh, self.node_axes,
                            backward="sum")

    def edges(self, x):
        return S.all_gather(x, 0, self.mesh, self.axes, backward="sum")

    def triplets_to_edges(self, gated, trip_ji, n_edges: int):
        whole = torch.zeros((n_edges * self.world, *gated.shape[1:]),
                            dtype=torch.float32, device=gated.device) \
            .index_add(0, trip_ji, gated.float())
        return S.reduce_scatter(whole, 0, self.mesh, self.axes) \
            .to(gated.dtype)

    def run(self, fn, *args):
        from torch.utils.checkpoint import checkpoint

        if torch.is_grad_enabled():
            return checkpoint(self._under_rules, fn, *args,
                              use_reentrant=False)
        return fn(*args)

    def _under_rules(self, fn, *args):
        # the recomputation runs on autograd's own thread on the card,
        # where the thread-local rules are not installed
        with install_rules(self.rules):
            return fn(*args)

    def edges_to_nodes(self, x, edge_dst, n_nodes: int):
        part = torch.zeros((n_nodes, *x.shape[1:]), dtype=torch.float32,
                           device=x.device).index_add(0, edge_dst, x.float())
        # every rank reads its own rows of the sum, so the gradient of
        # each partial is the sum of the ranks' row gradients
        whole = S.copy_to(S.all_reduce_sum(part, self.mesh, self.axes),
                          self.mesh, self.axes)
        return self.rows(whole).to(x.dtype)

    def rows(self, x):
        return x.narrow(0, *self.node_rows(x.shape[0]))

    def to_graphs(self, x, graph_ids, n_graphs: int):
        part = torch.zeros((n_graphs, *x.shape[1:]), dtype=torch.float32,
                           device=x.device).index_add(0, graph_ids, x.float())
        return S.all_reduce_sum(part, self.mesh, self.axes).to(x.dtype)

    def total(self, x):
        return S.all_reduce_sum(x, self.mesh, self.axes)
