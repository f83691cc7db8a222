"""Build and load the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers).  The library lands in a directory under ``build/`` at
the repository root named by a hash of the sources and flags, so the
first call after a source edit rebuilds and later calls reuse it.
Nothing here runs at import time: the library is built on the first
kernel launch.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` (or ``cudaErrorInvalidValue`` for an
argument it does not take); :func:`check` raises when it is not 0.  The
attention, compressor and embedding-bag entries report through a last
``int*`` argument (:func:`launch_reporting`): those that route between
kernels the one they ran (a tensor-core or a CUDA-core kernel; the
embedding bag's wide, narrow or generic kernel), the Sq = 1 entries how
many kernels they launched (the split-KV kernel, and its merge when the
keys were split).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
IP = ctypes.POINTER(ctypes.c_int)
#: what a routed entry's last argument reports
TENSOR_CORE, CUDA_CORE = 1, 0
#: what an Sq = 1 entry's last argument reports when it merged splits
WITH_MERGE = 2
_STRIDES = [LL] * 3
#: C signatures of the library's entry points (all return int).
SIGNATURES = {
    # q, k, v, out, lengths, k_valid, k_scales, v_scales, dtype, kv_dtype,
    # B, Hq, Hkv, Sq, Skv, D, q/k/v/out (batch, head, seq) strides,
    # causal, window, seg_boundary, scale, stream, kernel ran (out)
    "rt_split_attention": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                           *_STRIDES * 4, I, I, I, F, P, IP],
    # q, kq, vq, kd, vd, out, dlen, kq_valid, kd_valid, kd_scale, vd_scale,
    # dtype, kd_dtype, B, Hq, Hkv, Sq, Lq, Ld, D, q/kq/vq/kd/vd/out
    # strides, scale, stream, kernel ran (out)
    "rt_join_attention": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                          I, I, I, *_STRIDES * 6, F, P, IP],
    # q, kq, vq, k_pool, v_pool, out, dlen, kq_valid, page_table,
    # dval_pool, k_scale_pool, v_scale_pool, dtype, kd_dtype, B, Hq, Hkv,
    # Sq, Lq, n_pages, page, D, q/kq/vq/out strides, scale, stream,
    # kernel ran (out)
    "rt_join_attention_paged": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                                I, I, I, I, I, I, I, *_STRIDES * 4, F, P,
                                IP],
    # q, kq, vq, kd, vd, out, kq_valid, kd_valid, partial, dtype, B, Hq,
    # Hkv, Lq, Ld, D, q (batch, head) strides, kq/vq/kd/vd strides, out
    # (batch, head) strides, n_splits, the planner's align / max splits /
    # block rows, scale, stream, launches (out)
    "rt_join_attention_row": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                              LL, LL, *_STRIDES * 4, LL, LL, I, I, I, I, F,
                              P, IP],
    # q, k, v, out, lengths, k_valid, partial, dtype, B, Hq, Hkv, S, D, q
    # (batch, head) strides, k/v strides, out (batch, head) strides,
    # window, n_splits, the planner's align / max splits / block rows,
    # scale, stream, launches (out)
    "rt_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, LL, LL,
                            *_STRIDES * 2, LL, LL, I, I, I, I, I, F, P,
                            IP],
    # x, w, b, out, in_dtype, out_dtype, T, d, e, stream, kernel ran (out)
    "rt_compress": [P, P, P, P, I, I, I, I, I, P, IP],
    # r, w, b, gamma, beta, out, in_dtype, out_dtype, T, e, d, eps, stream,
    # kernel ran (out)
    "rt_decompress": [P, P, P, P, P, P, I, I, I, I, I, F, P, IP],
    # table, ids, weights (or None), out, table_dtype, out_dtype, ids_64,
    # rows, dim, n_bags, nnz, mean, stream, kernel ran (out)
    "rt_embedding_bag": [P, P, P, P, I, I, I, LL, I, LL, I, I, P, IP],
}

_lock = threading.Lock()
_lib = None
#: seconds from the start of the last build in this process to the end
#: of each source's ``nvcc -c`` (all start together), by file name, and
#: to the end of the link (``"link"``); empty when the library was
#: already built
NVCC_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "are built from source at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if its hashed build directory lacks it; returns
    its path.  One ``nvcc -c`` per source runs in parallel; every process
    is waited for before a failure is raised."""
    out_dir = BUILD_ROOT / f"kernels-{_digest()}"
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    t0 = time.perf_counter()
    for src in _sources():
        obj = out_dir / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    # one waiter a process, so each source's seconds are its own
    results = [None] * len(jobs)

    def wait(i, proc):
        out, err = proc.communicate()
        results[i] = (out, err, time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=(i, proc))
               for i, (_, _, proc) in enumerate(jobs)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    NVCC_SECONDS.clear()
    failed = []
    for (cmd, obj, proc), (out, err, secs) in zip(jobs, results):
        NVCC_SECONDS[Path(cmd[-1]).name] = secs
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f".build-{tag}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    NVCC_SECONDS["link"] = time.perf_counter() - t0
    os.replace(tmp, lib)
    for _, obj, _ in jobs:
        obj.unlink()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:       # set once, after the entries are typed
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record through a kernel wrapper: the
    kernels write into buffers autograd knows nothing of, so their
    outputs carry no gradient and every parameter below them would get
    none.  Every public wrapper calls this first, before its CPU branch,
    so the plain version that stands in for the kernel on the CPU
    refuses too."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel's output "
            f"carries no gradient; train through the backend ops "
            f"(repro_torch.models.backend) or the recsys lookups "
            f"(embedding.padded_bag), whose 'cuda' forms launch the kernel "
            f"and take the gradient of the plain backend, or call it under "
            f"torch.no_grad() / torch.inference_mode()")


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {code}")


def launch_reporting(entry: str, *args) -> int:
    """Call a reporting entry and raise if it failed; returns what it
    reported: the kernel it ran for a routed entry (TENSOR_CORE or
    CUDA_CORE; the embedding bag's codes are in
    ``kernels/embedding_bag/ops.py``), the kernels it launched (1, or
    WITH_MERGE) for an Sq = 1 one."""
    report = ctypes.c_int(-1)
    check(entry, getattr(library(), entry)(*args, ctypes.byref(report)))
    return report.value


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The card's streaming multiprocessors (a property, read once)."""
    import torch
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


def stream_ptr(device) -> int:
    """The raw handle of ``device``'s current CUDA stream: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object at every launch."""
    import torch
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def dtype_code(dtype, int8: bool = False) -> int:
    """Element type code of the C entries; int8 (raw doc K/V) only where
    ``int8`` says the operand may hold it."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if int8:
        codes[torch.int8] = 3
    if dtype not in codes:
        raise TypeError(f"kernel operand must be one of {list(codes)}, "
                        f"got {dtype}")
    return codes[dtype]


def output_like(q, out):
    """The attention output buffer: ``out`` checked against q, or a new
    contiguous one."""
    if out is None:
        return q.new_empty(q.shape)
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(
            f"out {tuple(out.shape)} {out.dtype} {out.device} does not match "
            f"q {tuple(q.shape)} {q.dtype} {q.device}")
    return out


def ptr(t):
    """``t.data_ptr()``, or None (a null pointer) for an absent operand."""
    return None if t is None else t.data_ptr()


def bhs_strides(t) -> list[int]:
    """(batch, head, seq) element strides of a [B, H, S, D] tensor whose
    last dim is contiguous."""
    s = t.stride()
    if s[3] != 1:
        raise ValueError(
            f"kernel operand must be contiguous in its last dim, got "
            f"strides {s}")
    return [s[0], s[1], s[2]]
