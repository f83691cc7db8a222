"""The port's sharding surface: partition specs and its three kinds of
device mesh (the counterpart of ``repro.dist.compat`` and
``jax.sharding``).

The JAX package is single-controller: one process sees every device,
``jit`` over a mesh runs the collectives inside one program, and the
router and the index builder place work on a mesh's devices by
``device_put``.  PyTorch runs one process per card for collectives, so
the port has:

* :class:`Mesh` -- a placement mesh: a grid of ``torch.device``\\ s with
  axis names, held by one process (``jax.sharding.Mesh``).  The router and
  the index builder place work on its devices.  Entries may repeat
  (``cpu`` four times models four devices in the CPU tests).
* :class:`SpmdMesh` -- an SPMD mesh: a named
  ``torch.distributed.device_mesh.DeviceMesh`` over every rank of the
  default process group, one rank a device.  The collective consumers
  (the row-sharded lookup, the MoE FFN, ``compressed_psum``) ask it for
  an axis's process group (:meth:`SpmdMesh.group`) and this rank's
  coordinate along it (:func:`axis_index`, ``jax.lax.axis_index``).
* :class:`AbstractMesh` -- axis names and sizes only, for the rule
  arithmetic (``jax.sharding.AbstractMesh``).

:class:`~repro_torch.dist.sharding.ShardingRules` and
:func:`~repro_torch.dist.sharding.divisible_spec` read only
``axis_names`` and ``shape`` (an ordered ``{axis: size}``), which all
three provide.  Nothing here touches a device or a process group at
import.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch


class PartitionSpec(tuple):
    """A tuple of per-dimension entries, each ``None`` (replicated), a mesh
    axis name, or a tuple of axis names: ``jax.sharding.PartitionSpec``'s
    layout, compared as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_tuple(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class AbstractMesh:
    """Axis names and sizes, no devices: ``AbstractMesh((4, 2), ("data",
    "model"))``."""

    def __init__(self, axis_sizes, axis_names):
        axis_sizes, axis_names = tuple(axis_sizes), tuple(axis_names)
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(n) for n in axis_sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """A placement mesh: ``devices`` (anything ``np.asarray`` makes an
    array of ``torch.device``\\ s or device strings, one axis a name) held
    by one process."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim == 0:
            grid = grid.reshape(1)
        axis_names = _axis_tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"devices of shape {grid.shape} for axes "
                             f"{axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        super().__init__(grid.shape, axis_names)


class SpmdMesh(AbstractMesh):
    """An SPMD mesh over every rank of the default process group: a
    ``DeviceMesh`` with ``mesh_dim_names``, rank ``r`` at the row-major
    coordinate ``r`` of ``shape``.  Build it in every rank, in the same
    order (its groups are made collectively): :func:`spmd_mesh`."""

    def __init__(self, device_type: str, axis_sizes, axis_names):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        super().__init__(axis_sizes, axis_names)
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"an SPMD mesh of {self.size} devices in a "
                             f"world of {world} ranks")
        self.ranks = np.arange(world).reshape(tuple(self.shape.values()))
        self.rank = dist.get_rank()
        self.device_type = device_type
        self.device_mesh = DeviceMesh(device_type, torch.from_numpy(
            self.ranks.copy()), mesh_dim_names=self.axis_names)
        # the groups of two or more axes, not the whole mesh: made by
        # every rank in one order, as new_group asks
        self._groups = {}
        for n in range(2, len(self.axis_names)):
            for axes in itertools.combinations(self.axis_names, n):
                self._make_groups(axes)

    def _make_groups(self, axes):
        import torch.distributed as dist

        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        grid = self.ranks.transpose(rest + dims).reshape(
            -1, math.prod(self.shape[a] for a in axes))
        for ranks in grid:
            group = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                self._groups[axes] = group

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def _axes(self, axes) -> tuple:
        axes = _axis_tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of "
                             f"{self.axis_names}")
        # mesh order, as the groups were made
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank's fellows along ``axes`` (one
        axis name or a tuple of them), whose group ranks run in the
        row-major order of those axes."""
        import torch.distributed as dist

        axes = self._axes(axes)
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axis_tuple(axes))


def spmd_mesh(axis_sizes, axis_names, device_type: str | None = None
              ) -> SpmdMesh:
    """An :class:`SpmdMesh` over the initialised default process group
    (``device_type`` defaults to ``cuda`` under NCCL, else ``cpu``)."""
    import torch.distributed as dist

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return SpmdMesh(device_type, axis_sizes, _axis_tuple(axis_names))


def axis_index(mesh: SpmdMesh, axes) -> int:
    """This rank's coordinate along ``axes`` (one name, or a tuple taken
    row-major in the order given): ``jax.lax.axis_index``."""
    coord = dict(zip(mesh.axis_names,
                     (int(c) for c in np.argwhere(mesh.ranks == mesh.rank)[0])))
    idx = 0
    for a in _axis_tuple(axes):
        idx = idx * mesh.shape[a] + coord[a]
    return idx

