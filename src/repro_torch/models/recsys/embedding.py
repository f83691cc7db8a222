"""Fused embedding table and its lookups (``repro.models.recsys.embedding``),
single device.

All categorical fields share one fused table ``[total_rows, dim]`` with
per-field row offsets, the DLRM/FBGEMM layout.  Every lookup of the
models goes through :func:`padded_bag`, the one call site of the
embedding-bag kernel: a single-hot lookup is a bag of one row with weight
1, a model's ``take_rows(...).mean(1)`` / ``.sum(1)`` is a mean / sum bag
over the fields, and :func:`lookup_multihot` is the kernel's padded
``[n_bags, max_nnz]`` layout with ``weights = valid``.  The segment form
:func:`embedding_bag` (any ``bag_field``) is not that layout and stays a
plain ``index_add_``.

``impl`` picks the gather-reduce: ``"cuda"`` calls the kernel wrapper
(the kernel on CUDA tensors, its plain version on CPU ones), ``"plain"``
the plain version everywhere.

**Row sharding.**  Under rules installed over an SPMD mesh of more than
one rank (``repro_torch.dist``), the table is row-sharded over every
mesh axis: rank ``r`` at mesh coordinate ``c`` (over ``pod``, ``data``,
``model``) holds rows ``[c R/S, (c+1) R/S)`` as its local ``[R/S, D]``
table, and :func:`lookup_single` / :func:`take_rows` route through
:func:`sharded_lookup`, the DLRM all-to-all exchange: ids to their
owners, an owner-local gather (bags of one through the kernel), the
vectors back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import (embedding_bag_op,
                                               embedding_bag_ref)
from repro_torch.models.backend import _trainable

IMPLS = ("cuda", "plain")
# float32 elements drawn at a time by init_fused_table (256 MB)
_INIT_CHUNK = 1 << 26


def fused_table_offsets(vocab_sizes) -> np.ndarray:
    """Per-field starting row in the fused table."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes))[:-1]]) \
        .astype(np.int64)


def init_fused_table(generator: torch.Generator, vocab_sizes, dim: int,
                     dtype=torch.float32, scale: float = 0.01,
                     pad_multiple: int = 512, device=None):
    """``N(0, scale^2)`` rows, cast to ``dtype``, with the row count padded
    to ``pad_multiple`` as in the JAX package.  Normals are drawn on
    ``generator``'s device in chunks of rows and written into the table on
    ``device`` (``None`` means the card), so a bf16 table is never built
    whole in float32 first."""
    dev = resolve_device(device)
    total = int(np.sum(vocab_sizes))
    total = -(-total // pad_multiple) * pad_multiple
    table = torch.empty((total, dim), dtype=dtype, device=dev)
    step = max(1, _INIT_CHUNK // dim)
    for r in range(0, total, step):
        n = min(step, total - r)
        x = torch.randn((n, dim), generator=generator,
                        device=generator.device)
        table[r:r + n] = (x * scale).to(device=dev, dtype=dtype)
    return table


#: logical axes of a fused table (rows sharded over the whole mesh)
FUSED_TABLE_AXES = ("table_rows", None)


def padded_bag(table, ids, weights=None, *, mode: str = "sum",
               out_dtype=None, impl: str = "cuda"):
    """The gather-reduce of every lookup: ids ``[n_bags, max_nnz]``
    (weights 0 for pads, None for 1) -> ``[n_bags, dim]`` in ``out_dtype``
    (default the table's; each row converted to it first, as
    ``table.astype(out_dtype)`` before a gather).  Under autograd
    through the table, ``"cuda"`` launches the kernel forward and takes
    the plain version's gradient backward (``backend._ReferenceGradient``: a
    scatter-add into a table-sized zero, the gradient of JAX's
    ``take``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown embedding impl {impl!r}; impls: {IMPLS}")
    bag = lambda fn: lambda t: fn(t, ids, weights, mode=mode,
                                  out_dtype=out_dtype)
    if impl == "plain":
        return bag(embedding_bag_ref)(table)
    return _trainable(bag(embedding_bag_op), bag(embedding_bag_ref), table)


def bag_rows(table, flat_ids, *, mode: str = "sum", out_dtype=None,
             impl: str = "cuda"):
    """The sum or mean over the last axis of fused-table rows ``flat_ids
    [N, F]`` -> ``[N, dim]`` in ``out_dtype`` (default the table's), the
    reference's ``take_rows(...).sum(1)`` / ``.mean(1)``: one padded bag
    a row in one process; under row sharding (module docstring)
    :func:`take_rows`, then the float32 reduction of the rows converted
    to ``out_dtype``."""
    if _row_sharding_mesh() is None:
        return padded_bag(table, flat_ids, mode=mode, out_dtype=out_dtype,
                          impl=impl)
    rows = take_rows(table, flat_ids, out_dtype=out_dtype, impl=impl)
    red = rows.float().sum(1) if mode == "sum" else rows.float().mean(1)
    return red.to(rows.dtype)


def field_ids(ids, offsets):
    """Per-field ids -> fused-table rows: ``ids`` plus the fields' row
    offsets, broadcast against it (``[F]`` for ids ``[..., F]``)."""
    return ids + torch.as_tensor(offsets, dtype=ids.dtype).to(ids.device)


def _row_sharding_mesh():
    """The SPMD mesh tables are row-sharded over, or None: rules installed
    over an SPMD mesh of more than one rank.  (JAX also asks that the
    rank count divide the global rows; a rank's ``[R/S, D]`` makes the
    global count ``S`` times the local one, so it always does.)"""
    from repro_torch.dist.compat import SpmdMesh
    from repro_torch.dist.context import current_rules

    rules = current_rules()
    if rules is None or not isinstance(rules.mesh, SpmdMesh) \
            or rules.mesh.size <= 1:
        return None
    return rules.mesh


def lookup_single(table, offsets, ids, *, out_dtype=None,
                  impl: str = "cuda"):
    """Single-hot lookup. ids: [B, F] per-field indices -> [B, F, dim];
    row-sharded under an SPMD mesh (module docstring)."""
    return take_rows(table, field_ids(ids, offsets), out_dtype=out_dtype,
                     impl=impl)


def take_rows(table, flat_ids, *, out_dtype=None, impl: str = "cuda"):
    """Row gather of fused-table rows ``flat_ids [...]`` -> ``[..., dim]``;
    row-sharded under an SPMD mesh (module docstring)."""
    shape = flat_ids.shape
    mesh = _row_sharding_mesh()
    if mesh is not None:
        out = sharded_lookup(table, flat_ids.reshape(-1), mesh, impl=impl)
        if out_dtype is not None:
            out = out.to(out_dtype)
    else:
        out = padded_bag(table, flat_ids.reshape(-1, 1), out_dtype=out_dtype,
                         impl=impl)
    return out.reshape(*shape, table.shape[1])


def _bucket_group(flat_ids, n_shards: int, rows_per: int, capacity: int):
    """Bucket one group's ids by owner shard -> (bucket_ids [S, C],
    owner [N], slot [N], keep [N]).  An id's slot is its rank among its
    owner's ids in id order (a stable sort); ids past ``capacity`` are
    not kept (slot ``C``, bucket untouched)."""
    n = flat_ids.shape[0]
    owner = flat_ids // rows_per
    sort_idx = torch.argsort(owner, stable=True)
    sorted_o = owner[sort_idx]
    counts = torch.zeros(n_shards, dtype=owner.dtype,
                         device=owner.device).scatter_add_(
        0, owner, torch.ones_like(owner))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=owner.device) - starts[sorted_o]
    rank = torch.empty_like(rank_sorted)
    rank[sort_idx] = rank_sorted
    keep = rank < capacity
    slot = torch.where(keep, rank, capacity)
    # dropped ids write to a spare column that is sliced off
    bucket = flat_ids.new_zeros((n_shards, capacity + 1))
    bucket[owner, slot] = flat_ids
    return bucket[:, :capacity], owner, slot, keep


def lookup_capacity(n_ids: int, n_shards: int,
                    capacity_factor: float = 4.0) -> int:
    """A group's bucket width: ``max(4, cf * N / S)`` rounded up to 8."""
    capacity = int(max(4, capacity_factor * n_ids / n_shards))
    return -(-capacity // 8) * 8


def sharded_lookup(table, flat_ids, mesh, *, capacity_factor: float = 4.0,
                   impl: str = "cuda"):
    """The row-sharded lookup of every rank of ``mesh`` (an
    ``SpmdMesh``), the DLRM all-to-all pattern (``repro.models.recsys.
    embedding.sharded_lookup``).

    ``table``: this rank's rows ``[R/S, D]`` (module docstring);
    ``flat_ids``: ``[Ng]`` global row ids of this rank's data group (the
    ranks of a group along ``model`` pass the same ids, as an id array
    sharded over the data axes is replicated over ``model``).  Returns
    ``[Ng, D]`` in the table's dtype:

    1. *bucket*: the group's ids sorted by owner into ``[S, C]`` buckets,
       ``C`` from :func:`lookup_capacity`;
    2. *exchange + gather*: an all-to-all sends bucket ``o`` to owner
       ``o``, which gathers its rows (bags of one through
       :func:`padded_bag`, the kernel on the card);
    3. *return + combine*: a second all-to-all sends the vectors back,
       and each id takes ``vecs[owner, slot] * keep``.

    Ids past an owner's capacity (Zipf skew) come back as zero rows.

    The table's gradient goes the same way back (:class:`_ShardedLookup`):
    each id's output gradient to its ``(owner, slot)``, the reverse
    all-to-all to the owners, a float32 ``index_add_`` into the local
    block at the gathered rows.  Dropped ids get none, as their zeros
    took none.  The ranks along ``model`` of a data group looked up the
    same ids for the same work, so an owner receives each group's
    gradient once from every one of them: it keeps the copy of the
    group's rank at ``model`` coordinate 0 (``all_gather``'s ``"split"``
    rule in ``dist.spmd``), and sums over the data groups, which looked
    up different rows.  A table row's gradient is then one process's."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    if len(axes) != len(mesh.axis_names):
        raise ValueError(f"sharded_lookup: mesh axes {mesh.axis_names} are "
                         f"not of ('pod', 'data', 'model')")
    capacity = lookup_capacity(flat_ids.shape[0], mesh.size, capacity_factor)
    bucket, owner, slot, keep = _bucket_group(flat_ids, mesh.size,
                                              table.shape[0], capacity)
    return _ShardedLookup.apply(table, bucket, owner, slot, keep, mesh, axes,
                                impl)


def _all_to_all(x):
    import torch.distributed as dist

    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous())
    return out


class _ShardedLookup(torch.autograd.Function):
    """:func:`sharded_lookup`'s exchange, gather and combine, with the
    table's gradient (its docstring)."""

    @staticmethod
    def forward(ctx, table, bucket, owner, slot, keep, mesh, axes, impl):
        from repro_torch.dist.compat import axis_index

        n_shards, capacity = bucket.shape
        rows_per, d = table.shape
        # owner coordinate of each rank (the all-to-all's chunks go by
        # rank)
        order = torch.as_tensor(mesh.ranks.transpose(
            [mesh.axis_names.index(a) for a in axes]).reshape(-1).argsort(),
            device=bucket.device)
        recv = _all_to_all(bucket[order])
        local = torch.clamp(recv - axis_index(mesh, axes) * rows_per, 0,
                            rows_per - 1)
        rows = padded_bag(table, local.reshape(-1, 1), impl=impl)
        vecs = _all_to_all(rows).reshape(n_shards, capacity, d)
        by_owner = torch.empty_like(vecs)
        by_owner[order] = vecs
        out = by_owner[owner, torch.where(keep, slot, 0)]
        ctx.save_for_backward(local, owner, slot, order)
        ctx.mesh, ctx.table = mesh, (table.shape, table.dtype)
        return out * keep[:, None].to(out.dtype)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        local, owner, slot, order = ctx.saved_tensors
        mesh = ctx.mesh
        (rows_per, d), dtype = ctx.table
        n_shards, capacity = local.shape
        # dropped ids (slot C) land in a spare column that is sliced off
        buf = grad.new_zeros((n_shards, capacity + 1, d))
        buf[owner, slot] = grad
        recv = _all_to_all(buf[:, :capacity][order])
        if "model" in mesh.axis_names:
            coord = np.indices(mesh.ranks.shape)[
                mesh.axis_names.index("model")]
            from_first = np.empty(mesh.size, bool)
            from_first[mesh.ranks.reshape(-1)] = coord.reshape(-1) == 0
            recv = recv * torch.as_tensor(from_first, device=recv.device)[
                :, None, None].to(recv.dtype)
        g = torch.zeros((rows_per, d), dtype=torch.float32,
                        device=grad.device)
        g.index_add_(0, local.reshape(-1), recv.reshape(-1, d).float())
        return (g.to(dtype),) + (None,) * 7


def embedding_bag(table, offsets, ids, bag_field, *, n_bags, mode="sum",
                  weights=None, valid=None):
    """Multi-hot EmbeddingBag in the segment form.

    ids: [NNZ] flat indices (already field-offset, as in the JAX package);
    bag_field: [NNZ] bag id in [0, n_bags); optional per-sample weights /
    validity.  -> [n_bags, dim], summed in the rows' (promoted) dtype with
    ``index_add_``, as JAX's ``segment_sum``."""
    vecs = table[ids]
    if weights is not None:
        vecs = vecs * weights[:, None]
    if valid is not None:
        vecs = vecs * valid[:, None].to(vecs.dtype)
    out = vecs.new_zeros((n_bags, vecs.shape[1])).index_add_(0, bag_field,
                                                             vecs)
    if mode == "mean":
        ones = torch.ones_like(bag_field, dtype=vecs.dtype) if valid is None \
            else valid.to(vecs.dtype)
        cnt = vecs.new_zeros((n_bags,)).index_add_(0, bag_field, ones)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def lookup_multihot(table, offsets, ids, valid, *, mode="sum",
                    impl: str = "cuda"):
    """Batched multi-hot: ids [B, F, NNZ] (+valid mask) -> [B, F, dim],
    the kernel's padded layout with ``weights = valid``."""
    b, f, nnz = ids.shape
    flat = field_ids(ids, np.asarray(offsets)[:, None]).reshape(b * f, nnz)
    out = padded_bag(table, flat, valid.reshape(b * f, nnz).float(),
                     mode=mode, impl=impl)
    return out.reshape(b, f, -1)
