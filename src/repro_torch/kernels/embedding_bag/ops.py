"""Public wrapper of the embedding-bag kernel (``csrc/embedding_bag.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  An input that requires grad while grad is
enabled raises first, on either device (``_build.refuse_grad``): the
kernels' outputs carry no gradient.
Launch counters, one per form, each launch counted
once: ``embedding_bag_op.launches`` (sum, output in the table's type),
``.mean_launches`` (mean, output in the table's type) and
``.cast_launches`` (bf16 output from a float32 table, either mode: the
models' ``table.astype(bf16)`` fused into the gather).  Each launch also
counts in one of three route counters, by the kernel the C entry reports
it ran: ``.wide_launches`` (``embedding_bag_wide_kernel``: rows of a
multiple of 16 bytes from a 16-byte aligned table), ``.narrow_launches``
(``embedding_bag_narrow_kernel``: rows of at most 64 bytes, a warp's
bags as one span of 8- or 4-byte words) and ``.generic_launches``
(``embedding_bag_kernel``: everything else)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import MODES, embedding_bag_ref

TABLE_DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 256
#: what ``rt_embedding_bag`` reports it ran (``kRan*`` in the source)
GENERIC, WIDE, NARROW = 0, 1, 2


def embedding_bag_op(table, ids, weights=None, *, mode: str = "sum",
                     out_dtype=None):
    """table: [rows, dim] float32 or bf16; ids: [n_bags, max_nnz] int32 or
    int64; weights: optional [n_bags, max_nnz] float32 (0 marks a pad,
    None means 1) -> [n_bags, dim] in ``out_dtype`` (the table's, the
    default, or bf16 from a float32 table): per bag the float32 sum of
    ``row * w`` over every slot, pads included; ``mean`` divides by
    ``max(sum_j w, 1)``.  Each row is converted to ``out_dtype`` before
    it is weighted (see ``ref.py``)."""
    _build.refuse_grad("embedding_bag_op", table, ids, weights)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights, mode=mode,
                                 out_dtype=out_dtype)
    out_dtype = table.dtype if out_dtype is None else out_dtype
    _check(table, ids, weights, mode, out_dtype)
    n_bags, nnz = ids.shape
    rows, dim = table.shape
    out = torch.empty((n_bags, dim), dtype=out_dtype, device=table.device)
    if n_bags == 0:
        return out
    ids = ids.contiguous()
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    kernel = _build.launch_reporting(
        "rt_embedding_bag", table.data_ptr(), ids.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        _build.dtype_code(table.dtype), _build.dtype_code(out_dtype),
        int(ids.dtype == torch.int64), rows, dim, n_bags, nnz,
        int(mode == "mean"), _build.stream_ptr(table.device))
    fn = embedding_bag_op
    setattr(fn, _ROUTE_COUNTERS[kernel],
            getattr(fn, _ROUTE_COUNTERS[kernel]) + 1)
    if out_dtype != table.dtype:
        fn.cast_launches += 1
    elif mode == "mean":
        fn.mean_launches += 1
    else:
        fn.launches += 1
    return out


_ROUTE_COUNTERS = {WIDE: "wide_launches", NARROW: "narrow_launches",
                   GENERIC: "generic_launches"}
embedding_bag_op.launches = 0
embedding_bag_op.mean_launches = 0
embedding_bag_op.cast_launches = 0
embedding_bag_op.wide_launches = 0
embedding_bag_op.narrow_launches = 0
embedding_bag_op.generic_launches = 0


def _check(table, ids, weights, mode, out_dtype):
    if table.device.type != "cuda" or ids.device != table.device or (
            weights is not None and weights.device != table.device):
        raise ValueError(f"table, ids and weights must lie on one CUDA "
                         f"device, got {table.device}, {ids.device}"
                         + ("" if weights is None else f", {weights.device}"))
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if table.dtype not in TABLE_DTYPES or out_dtype not in (
            table.dtype, torch.bfloat16):
        raise TypeError(f"the embedding-bag kernel reads and writes "
                        f"{TABLE_DTYPES}, the output in the table's type or "
                        f"bf16 from float32, got table {table.dtype}, "
                        f"output {out_dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [rows, dim] tensor, "
                         f"got shape {tuple(table.shape)} strides "
                         f"{table.stride()}")
    if not 0 < table.shape[1] <= MAX_DIM:
        raise ValueError(f"dim {table.shape[1]} outside the kernel's "
                         f"1..{MAX_DIM}")
    if ids.dim() != 2 or (weights is not None
                          and weights.shape != ids.shape):
        raise ValueError(f"ids {tuple(ids.shape)} must be [n_bags, max_nnz]"
                         + ("" if weights is None else
                            f" and match weights {tuple(weights.shape)}"))
