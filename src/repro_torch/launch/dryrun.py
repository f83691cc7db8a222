"""Dry run of every (arch x shape x mesh) cell on the CPU, the twin of
``repro.launch.dryrun``, for the H100.

The JAX package lowers and compiles each cell for 256 or 512 placeholder
TPU devices.  Here each cell runs in a process of its own, as rank 0 of a
``"fake"`` process group of 256 or 512 ranks (``FakeStore``: no process
but this one, collectives that move nothing), on an ``SpmdMesh`` of the
production shape (``launch.mesh.make_production_mesh``: 16 x 16, or 2 x
16 x 16 for ``multi``):

1. the cell built under ``default_rules`` (``launch.steps.build_cell``);
2. its args made whole as fake tensors (``FakeTensorMode``: shapes and
   dtypes, no storage), then rank 0's part of them by the cell's own
   ``local``;
3. one call of ``cell.fn`` under ``FakeTensorMode``,
   ``torch.utils.flop_counter.FlopCounterMode`` and
   :class:`~repro_torch.launch.op_analysis.OpCounter`.

Nothing is allocated and no card is used.  The cells run the backend
``--backend`` names, by default ``"blocked"``, the JAX configs' default
attention (KV blocks of ``block_kv``, no ``[S, S]`` scores forward or
backward; BERT4Rec's cells run it whatever the flag); ``"plain"`` counts
the plain attention's ``[S, S]`` scores, ``"cuda"`` the kernel wrappers'
plain versions forward (on CPU tensors) and the blocked gradient
backward.  Each record's ``backend`` names the family applied
(``"default"`` where a config has no backend knob).  The FLOPs and bytes
are those of the unfused PyTorch ops (the kernels' fused work moves
fewer bytes).  Per cell it records
the JAX record's keys where the meaning is the same (``peak_bytes_per_
device`` here: the rank's argument bytes plus the peak of the live bytes
its ops made; ``collective_bytes_per_device`` from the c10d ops), with
``op_flops_per_device`` / ``op_bytes_per_device`` for JAX's ``hlo_*``
(unfused: an upper bound on the HBM bytes), ``argument_bytes_per_device``
(exact, from the specs' blocks), ``trace_s`` for JAX's ``lower_s`` /
``compile_s`` and ``fits_80gb``.  The roofline's denominators are one H100
SXM's published peaks at 700 W.

The DimeNet cells trace like every other: each rank's block of edges and
triplets through the edge-sharded route (``models.gnn.dimenet_spmd``),
its message all-gathers, reduce-scatters and node all-reduce among the
c10d bytes.

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun             # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepfm \\
        --mesh single --force
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_FLOPS = 989e12       # bf16 FLOP/s a card
HBM_BW = 3.35e12          # bytes/s a card
HBM_BYTES = 80e9          # the card's memory, 80 GB
# one 400 Gb/s NIC a card: every axis of the production meshes spans
# hosts of 8 cards
LINK_BW = 50e9            # bytes/s a card

MESHES = ("single", "multi")


def mesh_shape(mesh_kind: str):
    """``(axis_sizes, axis_names)`` of a production mesh kind."""
    from repro_torch.launch.mesh import make_production_mesh

    m = make_production_mesh(multi_pod=mesh_kind == "multi")
    return tuple(m.shape.values()), m.axis_names


def _block_bytes(spec, mesh_shape_: dict) -> int:
    """Bytes of one rank's block of a TensorSpec."""
    import torch

    n = 1
    for d, size in enumerate(spec.shape):
        entry = spec.spec[d] if d < len(spec.spec) else None
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        n *= size // math.prod(mesh_shape_[a] for a in axes)
    return n * torch.empty((), dtype=spec.dtype).element_size()


def _fake_whole(spec):
    """A whole leaf of ``spec`` under the active FakeTensorMode; a 0-dim
    integer (an optimizer's step) a real 0."""
    import torch
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    if not spec.shape and not spec.dtype.is_floating_point:
        with unset_fake_temporarily():
            return torch.zeros((), dtype=spec.dtype)
    return torch.empty(spec.shape, dtype=spec.dtype)


def _fake_args(args):
    """A cell's whole args (:func:`_fake_whole`); a 0-dim integer arg of
    its own (a decode cell's position, which the step reads on the host)
    a Python 0."""
    from repro_torch.launch.steps import TensorSpec
    from repro_torch.tree import tree_map

    return tuple(0 if isinstance(a, TensorSpec) and not a.shape
                 and not a.dtype.is_floating_point
                 else tree_map(_fake_whole, a) for a in args)


def run_cell(arch: str, shape: str, axis_sizes, axis_names,
             backend: str | None = None, mesh_kind: str = "custom") -> dict:
    """One cell's record on a fake process group of ``prod(axis_sizes)``
    ranks (module docstring).  Initialises the default process group:
    call it once a process."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.dist import default_rules
    from repro_torch.dist.compat import spmd_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.steps import TensorSpec, backend_support, \
        build_cell
    from repro_torch.tree import leaves

    n_dev = math.prod(axis_sizes)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "devices": n_dev}
    spec = get_arch(arch)
    applied = backend if backend_support(spec.config, backend) \
        == "applied" else "default"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_dev)
    try:
        mesh = spmd_mesh(axis_sizes, axis_names, "cpu")
        cell = build_cell(arch, shape, default_rules(mesh), backend)
        is_spec = lambda x: isinstance(x, TensorSpec)
        arg_bytes = sum(_block_bytes(s, mesh.shape)
                        for s in leaves(cell.args) if is_spec(s))
        t0 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True) as fake:
            local = cell.local(_fake_args(cell.args))
            # each block's own bytes (a block may be a view of the whole)
            local_bytes = sum({id(t): t.numel() * t.element_size()
                               for t in leaves(local)
                               if isinstance(t, torch.Tensor)}.values())
            flops, counter = FlopCounterMode(display=False), OpCounter(fake)
            with flops, counter:
                cell.fn(*local)
        trace_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    ops = counter.summary()
    flops_dev = float(flops.get_total_flops())
    bytes_dev = float(ops["op_bytes"])
    coll = ops["collective_bytes"]
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll["total"] / LINK_BW}
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    model_s = cell.model_flops / (n_dev * PEAK_FLOPS)
    peak = local_bytes + ops["peak_live_bytes"]
    return {**rec, "backend": applied, "kind": cell.kind, "ok": True,
            "notes": cell.notes, "trace_s": round(trace_s, 1),
            "argument_bytes_per_device": arg_bytes,
            "peak_bytes_per_device": peak,
            "fits_80gb": peak <= HBM_BYTES,
            "op_flops_per_device": flops_dev,
            "op_bytes_per_device": bytes_dev,
            "op_count": ops["op_count"],
            "model_flops": cell.model_flops,
            "useful_compute_ratio": (cell.model_flops / (flops_dev * n_dev)
                                     if flops_dev else None),
            "collective_bytes_per_device": coll,
            "roofline": terms, "dominant_term": dominant,
            "roofline_step_s": bound_s, "model_compute_s": model_s,
            "roofline_fraction": model_s / bound_s if bound_s else None}


def _child(arch, shape, mesh_kind, backend):
    import traceback

    sizes, names = mesh_shape(mesh_kind)
    try:
        rec = run_cell(arch, shape, sizes, names, backend, mesh_kind)
    except Exception as e:      # a failure here is a bug in the sharding
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    print(json.dumps(rec))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--backend", default="blocked",
                    choices=["blocked", "plain", "cuda"],
                    help="compute-backend family of every arch config "
                         "(module docstring)")
    ap.add_argument("--child", nargs=3, metavar=("ARCH", "SHAPE", "MESH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(*args.child, args.backend)
        return

    from repro_torch.launch.steps import cell_names

    os.makedirs(args.out, exist_ok=True)
    meshes = MESHES if args.mesh == "both" else (args.mesh,)
    cells = [(a, s) for a, s in cell_names()
             if (args.arch is None or a == args.arch)
             and (args.shape is None or s == args.shape)]
    n_ok = n_fail = 0
    for arch, shape in cells:
        for mesh_kind in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}.json")
            if os.path.exists(path) and not args.force:
                print(f"[skip] {arch} {shape} {mesh_kind} (exists)")
                continue
            print(f"[dryrun] {arch} {shape} {mesh_kind} ...", flush=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--child", arch, shape, mesh_kind]
            cmd += ["--backend", args.backend]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            try:
                rec = json.loads(proc.stdout.strip().splitlines()[-1])
            except (IndexError, json.JSONDecodeError):
                rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "ok": False, "error": f"exit {proc.returncode}",
                       "traceback": proc.stderr[-4000:]}
            if rec["ok"]:
                n_ok += 1
                print(f"  ok: peak/dev={rec['peak_bytes_per_device'] / 1e9:.2f}"
                      f"GB fits_80gb={rec['fits_80gb']} "
                      f"dominant={rec['dominant_term']} "
                      f"trace={rec['trace_s']}s", flush=True)
            else:
                n_fail += 1
                print(f"  FAIL: {rec['error'][:300]}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")


if __name__ == "__main__":
    main()
