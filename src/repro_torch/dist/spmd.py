"""Explicit SPMD over an :class:`~repro_torch.dist.compat.SpmdMesh`: a
rank's shards of a parameter tree under the sharding rules, their
inverse, and the collectives of the sharded transformer as autograd
functions, so a loss computed through them has a gradient.

JAX places every leaf by its ``PartitionSpec`` and lets GSPMD insert the
collectives.  Here each rank holds the block of every leaf that its mesh
coordinates select (:func:`shard_tree`: a dim sharded over mesh axes
``(a, b)`` is cut into ``size(a) * size(b)`` blocks, and the rank takes
the block of its row-major coordinate over them) and the model code
calls the collectives by hand:

* :func:`all_gather` -- the blocks of a dim concatenated.  Its backward
  either sums the ranks' gradients and keeps this rank's block (a
  reduce-scatter: the ranks used the gathered tensor for different work,
  as FSDP's data ranks do for different tokens) or only keeps this
  rank's block (``backward="split"``: the ranks did the same work).
* :func:`all_reduce_sum` -- the sum of the ranks' partial results (a
  row-parallel product); the backward passes the gradient through, as
  every rank holds the same sum.
* :func:`copy_to` -- the identity, whose backward sums the ranks'
  gradients: a replicated tensor that each rank uses for a different
  part of the work (the input of a column-parallel product).
* :func:`reduce_scatter` -- this rank's block of the sum of the ranks'
  tensors (each rank summed its own work into the whole); the backward
  gathers the blocks' gradients.
* :func:`gather_data_dims` / :func:`whole_leaf` -- a leaf's data dims
  (FSDP), or every dim, gathered for a rank's data rows;
  :func:`summed_leaf` -- every dim gathered for a rank's own share of the
  work, the gradient summed over every rank (DimeNet's edge blocks).

:func:`global_norm` is the gradient norm of a tree of blocks, which
AdamW's clipping needs whole.

Every collective is the identity over a group of one rank, so a world
of one runs the same code with no communication.  Gloo has no
reduce-scatter: there the sum is an all-reduce and the slice is taken
after (NCCL, and the dry run's fake process group, run
``reduce_scatter_tensor``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist.compat import axis_index
from repro_torch.dist.sharding import ShardingRules, divisible_spec
from repro_torch.tree import tree_map


def entry_axes(entry) -> tuple:
    """A ``PartitionSpec`` entry as a tuple of mesh axes."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _mesh_order(mesh, axes) -> tuple:
    """``axes`` checked to run in the mesh's order, as its groups do."""
    if list(axes) != [a for a in mesh.axis_names if a in axes]:
        raise ValueError(f"a dim sharded over {axes} of a mesh with axes "
                         f"{mesh.axis_names}: the port takes spec entries in "
                         f"the mesh's axis order")
    return tuple(axes)


def block(mesh, axes) -> tuple[int, int]:
    """``(index, count)`` of this rank's block along a dim sharded over
    ``axes``."""
    axes = _mesh_order(mesh, axes)
    return axis_index(mesh, axes), mesh.axis_size(axes)


def local_block(x, dim: int, mesh, axes):
    """This rank's block of ``x`` along ``dim`` (a view)."""
    if not axes:
        return x
    i, n = block(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def shard_leaf(x, spec, mesh):
    """This rank's block of a whole leaf under ``spec`` (a copy, so the
    whole leaf may be freed; the leaf itself when no dim is sharded)."""
    out = x
    for d, entry in enumerate(spec):
        out = local_block(out, d, mesh, entry_axes(entry))
    return out if out is x else out.contiguous()


def tree_specs(like, axes, rules: ShardingRules):
    """The ``PartitionSpec`` of every leaf of ``like`` (leaves with a
    whole ``shape``) annotated by ``axes``."""
    return tree_map(lambda p, a: divisible_spec(rules, a, tuple(p.shape)),
                    like, axes)


def shard_tree(params, axes, rules: ShardingRules):
    """This rank's shards of every leaf of ``params`` (whole leaves) per
    ``divisible_spec`` on the rules' SPMD mesh."""
    return tree_map(lambda p, a: shard_leaf(
        p, divisible_spec(rules, a, tuple(p.shape)), rules.mesh),
        params, axes)


def gather_tree(shards, specs, mesh):
    """The inverse of :func:`shard_tree`: whole leaves from every rank's
    shards (``specs`` from :func:`tree_specs`), with no autograd."""
    def whole(x, spec):
        with torch.no_grad():
            for d, entry in enumerate(spec):
                axes = entry_axes(entry)
                if axes:
                    x = _gather(x, d, mesh, axes)
        return x
    return tree_map(whole, shards, specs)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _gather(x, dim: int, mesh, axes):
    import torch.distributed as dist

    n = mesh.axis_size(axes)
    if n == 1:
        return x
    group = mesh.group(_mesh_order(mesh, axes))
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce(x, mesh, axes, op=None):
    import torch.distributed as dist

    if mesh.axis_size(axes) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM,
                    group=mesh.group(_mesh_order(mesh, axes)))
    return x


def _reduce_scatter(x, dim: int, mesh, axes):
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    of ``axes``."""
    import torch.distributed as dist

    group = mesh.group(_mesh_order(mesh, axes))
    # NCCL and the dry run's fake group (which stands in for it) have one
    if dist.get_backend(group) not in ("nccl", "fake"):
        # a copy of the block, so the whole sum may be freed
        return local_block(_reduce(x.clone(), mesh, axes), dim, mesh,
                           axes).clone()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // mesh.axis_size(axes),
                         *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, split):
        ctx.dim, ctx.mesh, ctx.axes, ctx.split = dim, mesh, axes, split
        return _gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        g = local_block(g, ctx.dim, ctx.mesh, ctx.axes) if ctx.split \
            else _reduce_scatter(g, ctx.dim, ctx.mesh, ctx.axes)
        return g.contiguous(), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _reduce_scatter(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.dim, ctx.mesh, ctx.axes), None, \
            None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.clone(), ctx.mesh, ctx.axes), None, None


def all_gather(x, dim: int, mesh, axes, *, backward: str = "sum"):
    """The blocks of ``x`` along ``dim`` from the ranks of ``axes``, in
    their order.  ``backward="sum"`` sums the ranks' gradients (they used
    the whole for different work) and keeps this rank's block;
    ``"split"`` keeps the block of this rank's own gradient (they did
    the same work)."""
    axes = entry_axes(axes)
    if backward not in ("sum", "split"):
        raise ValueError(f"backward must be 'sum' or 'split', got "
                         f"{backward!r}")
    if not axes or mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, dim, mesh, axes, backward == "split")


def reduce_scatter(x, dim: int, mesh, axes):
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    of ``axes`` (each rank holds its partial sum of the whole); the
    gradient of the block is gathered back whole, as every rank's partial
    reaches every block."""
    axes = entry_axes(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    if x.shape[dim] % mesh.axis_size(axes):
        raise ValueError(f"a dim of {x.shape[dim]} reduce-scattered over "
                         f"{mesh.axis_size(axes)} ranks")
    return _ReduceScatter.apply(x, dim, mesh, axes)


def all_reduce_sum(x, mesh, axes):
    """The sum of ``x`` over the ranks of ``axes``; the gradient passes
    through (every rank holds the same sum)."""
    axes = entry_axes(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axes)


def copy_to(x, mesh, axes):
    """``x``, whose gradient is summed over the ranks of ``axes``."""
    axes = entry_axes(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    return _CopyTo.apply(x, mesh, axes)


def gather_data_dims(w, spec, mesh):
    """``w`` (a rank's block under ``spec``) with every dim sharded over
    the data axes gathered (FSDP); the gradient is reduce-scattered back,
    and summed over the data axes that no dim takes (each data group adds
    its own rows' part).  A dim cut over ``model`` stays cut."""
    used = set()
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes and "model" in axes and axes != ("model",):
            raise ValueError(f"a dim sharded over {axes}: a leaf takes the "
                             f"data axes or 'model' on a dim, not both")
        if axes and axes != ("model",):
            w = all_gather(w, d, mesh, axes, backward="sum")
            used.update(axes)
    rest = tuple(a for a in data_axes(mesh) if a not in used)
    return copy_to(w, mesh, rest) if rest else w


def whole_leaf(w, spec, mesh):
    """A leaf that every rank uses alike on its data group's rows, whole
    (the hybrid-parallel DLRM layout of the dense layers):
    :func:`gather_data_dims`, then the dims cut over ``model`` gathered
    with this rank's block of its own gradient kept (the ranks of
    ``model`` in a data group do the same work)."""
    w = gather_data_dims(w, spec, mesh)
    for d, entry in enumerate(spec):
        if entry_axes(entry) == ("model",):
            w = all_gather(w, d, mesh, "model", backward="split")
    return w


def summed_leaf(w, spec, mesh):
    """A leaf that each rank uses for its own share of the work (its
    edges, its nodes), whole: every dim cut under ``spec`` gathered, and
    the gradient summed over every rank of the mesh, then this rank's
    block kept.  Unlike :func:`whole_leaf`, the ranks of ``model`` did
    different work too, so their gradients add."""
    used = set()
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            w = all_gather(w, d, mesh, axes, backward="sum")
            used.update(axes)
    rest = tuple(a for a in mesh.axis_names if a not in used)
    return copy_to(w, mesh, rest) if rest else w


def all_reduce_max(x, mesh, axes):
    """The elementwise max over the ranks of ``axes`` (no gradient)."""
    import torch.distributed as dist

    axes = entry_axes(axes)
    if not axes:
        return x.detach()
    return _reduce(x.detach().clone(), mesh, axes, dist.ReduceOp.MAX)


def global_norm(tree, specs, mesh):
    """The float32 L2 norm over every leaf of a tree of this rank's blocks
    (``specs`` from :func:`tree_specs`): each leaf's sum of squares is
    summed over the ranks that hold its other blocks (the axes its spec
    names), never over ranks that hold a copy of the same block.  A
    ``None`` leaf counts as zero."""
    sums = {}

    def add(g, spec):
        named = {a for e in spec for a in entry_axes(e)}
        axes = tuple(a for a in mesh.axis_names if a in named)
        sums[axes] = sums.get(axes, 0) + g.float().square().sum()
        return g

    tree_map(add, tree, specs)
    total = 0
    # the same keys in the same order on every rank
    for axes, part in sums.items():
        total = total + (_reduce(part.detach().clone(), mesh, axes)
                         if axes else part)
    return torch.sqrt(total)


def data_axes(mesh) -> tuple:
    """The batch axes of a mesh (``pod``, ``data``), in its order."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def gather_data(x, mesh, dim: int = 0):
    """The whole batch from every data rank's rows (:func:`data_block`'s
    inverse), with no gradient."""
    with torch.no_grad():
        return _gather(x, dim, mesh, data_axes(mesh))


def data_block(x, mesh, dim: int = 0):
    """This rank's rows of a batch split over the data axes."""
    axes = data_axes(mesh)
    if x.shape[dim] % max(1, math.prod(mesh.shape[a] for a in axes)):
        raise ValueError(f"a batch of {x.shape[dim]} rows over data axes "
                         f"{axes} of {mesh.shape}")
    return local_block(x, dim, mesh, axes)
