"""Logical-axis sharding rules, the port of ``repro.dist.sharding``.

Every parameter and activation is annotated with *logical* axis names
("embed", "mlp", "batch", ...).  A :class:`ShardingRules` maps each
logical axis onto zero or more *mesh* axes; :func:`divisible_spec` turns
an annotation tuple into a :class:`~repro_torch.dist.compat.PartitionSpec`
for a given shape, dropping mesh axes that do not divide the dimension
and mesh axes an earlier dimension already took (so MoE weights
annotated ``("experts", "embed", "mlp")`` put ``model`` on the expert
dim when E divides it, expert parallelism, and on ``d_ff`` otherwise).

The rules read a mesh's ``axis_names`` and ``shape`` only, so they work
on each of the port's meshes (:mod:`repro_torch.dist.compat`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Union

from repro_torch.dist.compat import PartitionSpec

# one logical axis maps to a mesh axis, an ordered tuple of mesh axes
# (tried left to right), or None / absent (replicated)
MeshAxes = Union[str, tuple, None]


def _as_tuple(v: MeshAxes) -> tuple:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A mesh plus the logical-axis -> mesh-axis mapping used on it."""

    mesh: object
    rules: Mapping[str, MeshAxes]

    def mesh_axes(self, logical) -> tuple:
        """Mesh axes a logical axis maps to (empty tuple = replicated)."""
        if logical is None:
            return ()
        return _as_tuple(self.rules.get(logical))


def default_rules(mesh) -> ShardingRules:
    """Rules covering every logical axis of the models, for any mesh built
    from ("pod",) x ("data",) x ("model",) axes.

    * batch-like axes shard over the data axes; fully data-parallel
      tensors ("edges", "table_rows") spill onto "model" as well,
    * parameter "embed" dims shard over the data axes (ZeRO / FSDP),
    * tensor-parallel dims ("heads", "mlp", "experts", "vocab", ...) and
      the activation TP axes ("embed_tp", "act_seq", "kv_seq") take
      "model"."""
    names = set(mesh.axis_names)
    data = tuple(a for a in ("pod", "data") if a in names)
    model = tuple(a for a in ("model",) if a in names)
    every = data + model
    return ShardingRules(mesh, {
        # activations
        "batch": data,
        "act_seq": model,
        "embed_tp": model,
        "kv_seq": model,
        "edges": every,
        # parameters
        "embed": data,
        "mlp": model,
        "heads": model,
        "kv_heads": model,
        "experts": model,
        "vocab": model,
        "table_rows": every,
        "layers": None,
    })


def replicated_serving_rules(mesh) -> ShardingRules:
    """Serving cells: batch sharded over every mesh axis, weights (and all
    other logical axes) replicated."""
    every = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    return ShardingRules(mesh, {"batch": every})


def _need_shard_axis(mesh) -> None:
    if "shard" not in mesh.axis_names:
        raise ValueError(
            f"sharded serving needs a mesh with a 'shard' axis; got axes "
            f"{tuple(mesh.axis_names)}")


def sharded_serving_rules(mesh) -> ShardingRules:
    """Scale-out serving cells: a mesh with a ``"shard"`` axis, one index
    shard (and one ``ShardWorker``) a position along it.  ``batch`` shards
    over the other axes; nothing maps onto ``"shard"``, an axis of data
    ownership, not of tensor parallelism: only candidate ids go to a
    shard and only float32 scores come back."""
    _need_shard_axis(mesh)
    rest = tuple(a for a in mesh.axis_names if a != "shard")
    return ShardingRules(mesh, {"batch": rest})


def serving_shard_devices(mesh) -> list:
    """One device a serving shard (a placement mesh's), in shard order:
    each shard's first replica along the other axes."""
    _need_shard_axis(mesh)
    ax = mesh.axis_names.index("shard")
    devs = mesh.devices
    sel = tuple(slice(None) if i == ax else 0 for i in range(devs.ndim))
    return list(devs[sel].reshape(-1))


def divisible_spec(rules: ShardingRules, axes, shape) -> PartitionSpec:
    """Annotation tuple + concrete shape -> PartitionSpec.

    A mesh axis is kept on a dimension only if (a) no earlier dimension of
    this spec took it and (b) the dimension divides by the product of the
    mesh-axis sizes kept on it so far."""
    mesh_shape = dict(rules.mesh.shape)
    axes = _as_tuple(axes)
    used: set = set()
    parts = []
    for i, dim in enumerate(tuple(shape)):
        logical = axes[i] if i < len(axes) else None
        kept = []
        size = 1
        for a in rules.mesh_axes(logical):
            n = mesh_shape.get(a)
            if n is None or a in used:
                continue
            if dim % (size * n) == 0:
                kept.append(a)
                size *= n
                used.add(a)
        parts.append(tuple(kept) if len(kept) > 1 else
                     (kept[0] if kept else None))
    return PartitionSpec(*parts)
