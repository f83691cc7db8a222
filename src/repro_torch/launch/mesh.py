"""Mesh construction, the port of ``repro.launch.mesh``: placement meshes
over this process's devices, the production shapes as abstract meshes,
and :func:`run_spmd`, which starts one rank a device and builds the named
SPMD mesh in each.

Functions only, never module-level meshes: importing this module touches
no device and starts no process.

On the H100 the counterpart of the TPU production meshes keeps their
axes and moves them onto the card family's links: ``model``, the
tensor- and expert-parallel axis that carries the most traffic, within
one node's NVLink domain; ``data`` across nodes; ``pod`` across
clusters, the slowest hop, where ``compressed_psum`` sends int8.
"""
from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.compat import AbstractMesh, Mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production shapes, names and sizes only: ``data`` x ``model``
    16 x 16, or ``pod`` x ``data`` x ``model`` 2 x 16 x 16."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh(device=None) -> Mesh:
    """A one-device ``("data",)`` mesh (``None`` means the card)."""
    return Mesh([resolve_device(device)], ("data",))


def make_device_mesh(axis_name: str = "data") -> Mesh:
    """A one-axis placement mesh over every visible card, in index
    order."""
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("make_device_mesh: no CUDA device is visible")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device("cuda", i) for i in range(n)]
    return Mesh(grid, (axis_name,))


def card_mesh_shape(n: int) -> tuple[int, int]:
    """The ``("data", "model")`` shape of ``n`` cards, one rank a card:
    (n / 2, 2) on an even count above 1, else (n, 1)."""
    return (n // 2, 2) if n > 1 and n % 2 == 0 else (n, 1)


def _rank_main(rank, fn, axis_sizes, axis_names, device_type, store_path,
               results, threads, args):
    import torch.distributed as dist

    from repro_torch.dist.compat import spmd_mesh

    if threads:
        torch.set_num_threads(threads)
    world = math.prod(axis_sizes)
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, **kw)
    try:
        mesh = spmd_mesh(axis_sizes, axis_names, device_type)
        results.put((rank, fn(mesh, *args)))
    finally:
        dist.destroy_process_group()


def run_spmd(fn, axis_sizes, axis_names, *, device_type: str = "cuda",
             args=(), timeout_s: float = 600.0, store_dir: str | None = None,
             threads: int | None = None) -> list:
    """Run ``fn(mesh, *args)`` in one process a device of an
    ``axis_sizes`` mesh and return its results in rank order.

    Each rank is started by ``torch.multiprocessing`` (spawn), joins a
    ``FileStore`` rendezvous in ``store_dir`` (a fresh temporary
    directory by default), initialises NCCL on card ``rank``
    (``device_type="cuda"``) or gloo on the CPU, and builds the named
    :class:`~repro_torch.dist.compat.SpmdMesh`.  ``fn`` must be importable
    by name and return picklable host data.  A rank that raises stops
    every rank and its traceback is raised here; past ``timeout_s`` every
    rank is killed and ``TimeoutError`` raised.  There is no fallback:
    an NCCL that fails to start is an error.  ``threads`` sets each
    rank's ``torch.set_num_threads``."""
    import torch.multiprocessing as mp

    axis_sizes = tuple(int(n) for n in axis_sizes)
    axis_names = (axis_names,) if isinstance(axis_names, str) \
        else tuple(axis_names)
    world = math.prod(axis_sizes)
    if device_type == "cuda":
        resolve_device("cuda")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"an SPMD mesh of {world} cards, but "
                               f"{torch.cuda.device_count()} are visible")
    tmp = tempfile.mkdtemp(prefix="spmd_", dir=store_dir)
    results = mp.get_context("spawn").Queue()
    procs = mp.start_processes(
        _rank_main, nprocs=world, join=False, start_method="spawn",
        args=(fn, axis_sizes, axis_names, device_type,
              os.path.join(tmp, "store"), results, threads, args))
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        # drain the queue before joining: a rank blocks on its put
        while len(got) < world:
            try:
                rank, value = results.get(timeout=0.5)
                got[rank] = value
            except queue.Empty:
                procs.join(timeout=0)          # raises a rank's failure
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_spmd: {world - len(got)} of "
                                   f"{world} ranks gave no result in "
                                   f"{timeout_s} s")
        while not procs.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_spmd: ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
