"""Graph generators, triplet enumeration and a neighbour sampler, a copy
of ``repro.data.graphs``: the same arguments and seed give the same
arrays bit for bit (the same ``default_rng`` calls in the same order).

Message passing in the port is ``index_add`` over explicit edge-index
arrays; everything here produces those arrays on the host with numpy.
DimeNet also needs *triplets* (k->j->i): for each directed edge j->i, the
incoming edges k->j (k != i), at most ``fanout_cap`` of them, so their
count is a static ``n_edges * fanout_cap``.  ``build_triplets`` keeps the
reference's per-edge loop and ``NeighborSampler.sample`` its dict and
frontier loops: their ``rng.choice`` calls, edge by edge and node by node,
decide which triplets and neighbours are drawn.

:func:`graph_batch_tensors` turns a :class:`GraphBatch` into the tensors
``repro_torch.models.gnn.dimenet`` takes, on the card unless the caller
asks for the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class GraphBatch:
    """Padded, statically-shaped graph sample."""
    node_feat: np.ndarray        # [N, F] float or [N] int (atom types)
    positions: np.ndarray        # [N, 3]
    edge_src: np.ndarray         # [E] int32  (j of j->i)
    edge_dst: np.ndarray         # [E] int32  (i of j->i)
    edge_valid: np.ndarray       # [E] bool
    trip_kj: np.ndarray          # [T] index into edges (the k->j edge)
    trip_ji: np.ndarray          # [T] index into edges (the j->i edge)
    trip_valid: np.ndarray       # [T] bool
    labels: np.ndarray           # [N] int (node cls) or [G] float (energy)
    graph_ids: np.ndarray | None = None   # [N] for batched small graphs


def triplet_count(n_edges: int, fanout_cap: int) -> int:
    return n_edges * fanout_cap


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")``: a stable order is unique, and
    torch's CPU sort finds it ~9x faster on Reddit's 114.6 M edge ids."""
    return torch.sort(torch.from_numpy(np.ascontiguousarray(keys)),
                      stable=True).indices.numpy()


def random_positions(rng, n_nodes: int, density: float = 1.0):
    """3D positions in a box sized for roughly unit nearest-neighbor
    distance."""
    side = (n_nodes / density) ** (1.0 / 3.0)
    return rng.uniform(0, side, size=(n_nodes, 3)).astype(np.float32)


def random_graph(n_nodes: int, n_edges: int, *, d_feat: int = 0,
                 n_classes: int = 16, seed: int = 0):
    """Random directed graph with synthetic 3D positions (so DimeNet's
    distances and angles are defined for citation-graph shapes too)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    # bias destinations near the source id to give locality (power-ish degree)
    dst = (src + rng.integers(1, max(2, n_nodes // 8), size=n_edges)) % n_nodes
    dst = dst.astype(np.int32)
    feat = (rng.normal(0, 1, size=(n_nodes, d_feat)).astype(np.float32)
            if d_feat else rng.integers(0, 16, size=n_nodes).astype(np.int32))
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    return feat, random_positions(rng, n_nodes), src, dst, labels


def build_triplets(src: np.ndarray, dst: np.ndarray, fanout_cap: int,
                   seed: int = 0):
    """For each edge e=(j->i), up to ``fanout_cap`` incoming edges (k->j),
    k != i.  Returns (trip_kj, trip_ji, trip_valid) with static length
    n_edges * fanout_cap; edge e's triplets fill slots [e * cap, (e + 1)
    * cap), so trip_ji[t] == t // cap (the *blocked* layout)."""
    rng = np.random.default_rng(seed)
    n_edges = len(src)
    n_nodes = int(max(src.max(), dst.max())) + 1
    # incoming edge lists per node
    order = _stable_argsort(dst)
    sorted_dst = dst[order]
    starts = np.searchsorted(sorted_dst, np.arange(n_nodes + 1))
    t_kj = np.zeros(n_edges * fanout_cap, np.int32)
    t_ji = np.zeros(n_edges * fanout_cap, np.int32)
    t_valid = np.zeros(n_edges * fanout_cap, bool)
    for e in range(n_edges):
        j, i = src[e], dst[e]
        lo, hi = starts[j], starts[j + 1]
        incoming = order[lo:hi]
        incoming = incoming[src[incoming] != i]
        if len(incoming) > fanout_cap:
            incoming = rng.choice(incoming, size=fanout_cap, replace=False)
        sl = slice(e * fanout_cap, e * fanout_cap + len(incoming))
        t_kj[sl] = incoming
        t_ji[sl] = e
        t_valid[sl] = True
    return t_kj, t_ji, t_valid


def make_graph_batch(n_nodes: int, n_edges: int, *, d_feat: int = 0,
                     fanout_cap: int = 8, n_classes: int = 16,
                     seed: int = 0) -> GraphBatch:
    feat, pos, src, dst, labels = random_graph(
        n_nodes, n_edges, d_feat=d_feat, n_classes=n_classes, seed=seed)
    t_kj, t_ji, t_valid = build_triplets(src, dst, fanout_cap, seed)
    return GraphBatch(feat, pos, src, dst, np.ones(n_edges, bool),
                      t_kj, t_ji, t_valid, labels)


def make_molecule_batch(batch: int, n_nodes: int, n_edges: int, *,
                        fanout_cap: int = 8, seed: int = 0) -> GraphBatch:
    """``batch`` disjoint small molecules packed into one graph (node/edge
    offsets shifted), energy label per molecule."""
    rng = np.random.default_rng(seed)
    feats, poss, srcs, dsts = [], [], [], []
    for b in range(batch):
        z = rng.integers(1, 10, size=n_nodes).astype(np.int32)
        pos = random_positions(rng, n_nodes, density=0.8)
        src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
        dst = (src + rng.integers(1, n_nodes, size=n_edges)) % n_nodes
        feats.append(z)
        poss.append(pos + b * 100.0)   # separate boxes
        srcs.append(src + b * n_nodes)
        dsts.append(dst.astype(np.int32) + b * n_nodes)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    t_kj, t_ji, t_valid = build_triplets(src, dst, fanout_cap, seed)
    energies = rng.normal(0, 1, size=batch).astype(np.float32)
    graph_ids = np.repeat(np.arange(batch, dtype=np.int32), n_nodes)
    return GraphBatch(np.concatenate(feats), np.concatenate(poss), src, dst,
                      np.ones(len(src), bool), t_kj, t_ji, t_valid,
                      energies, graph_ids)


class NeighborSampler:
    """GraphSAGE-style uniform fanout sampler over a CSR adjacency —
    the real sampler behind the ``minibatch_lg`` cell."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int,
                 seed: int = 0):
        order = _stable_argsort(dst)
        self.nbr = src[order]
        self.starts = np.zeros(n_nodes + 1, np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.starts[1:] = np.cumsum(counts)
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_nodes: np.ndarray, fanouts: tuple[int, ...]):
        """-> (sub_src, sub_dst, node_map) where node ids are re-indexed into
        the sampled node set; batch (seed) nodes come first."""
        nodes = list(batch_nodes)
        node_pos = {int(n): i for i, n in enumerate(nodes)}
        edges = []
        frontier = list(batch_nodes)
        for fanout in fanouts:
            nxt = []
            for v in frontier:
                lo, hi = self.starts[v], self.starts[v + 1]
                if hi == lo:
                    continue
                nbrs = self.nbr[lo:hi]
                if len(nbrs) > fanout:
                    nbrs = self.rng.choice(nbrs, size=fanout, replace=False)
                for u in nbrs:
                    u = int(u)
                    if u not in node_pos:
                        node_pos[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    edges.append((node_pos[u], node_pos[int(v)]))
            frontier = nxt
        if not edges:
            edges = [(0, 0)]
        e = np.asarray(edges, np.int32)
        return e[:, 0], e[:, 1], np.asarray(nodes, np.int64)


def graph_batch_tensors(g: GraphBatch, device=None) -> dict:
    """``g`` as the batch dict the DimeNet losses take, on ``device``
    (``None`` means the card): indices (edges, triplets, graph ids, atom
    types, class labels) as int64, which every indexing, ``index_add``
    and ``gather`` call takes; masks as bool; features, positions and
    energy labels as float32.  ``graph_ids`` only where ``g`` has them."""
    dev = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype.is_floating_point:
            t = t.float()
        elif t.dtype != torch.bool:
            t = t.long()
        return t.to(dev)

    out = {k: conv(getattr(g, k)) for k in (
        "node_feat", "positions", "edge_src", "edge_dst", "edge_valid",
        "trip_kj", "trip_ji", "trip_valid", "labels")}
    if g.graph_ids is not None:
        out["graph_ids"] = conv(g.graph_ids)
    return out
