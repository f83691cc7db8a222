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
the plain version everywhere.  The row sharding of the JAX package
(``sharded_lookup``) waits for the port's device meshes (ROADMAP.md
Queue 1 item 7).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import (embedding_bag_op,
                                               embedding_bag_ref)

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


def padded_bag(table, ids, weights=None, *, mode: str = "sum",
               out_dtype=None, impl: str = "cuda"):
    """The gather-reduce of every lookup: ids ``[n_bags, max_nnz]``
    (weights 0 for pads, None for 1) -> ``[n_bags, dim]`` in ``out_dtype``
    (default the table's; each row converted to it first, as
    ``table.astype(out_dtype)`` before a gather)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown embedding impl {impl!r}; impls: {IMPLS}")
    fn = embedding_bag_op if impl == "cuda" else embedding_bag_ref
    return fn(table, ids, weights, mode=mode, out_dtype=out_dtype)


def field_ids(ids, offsets):
    """Per-field ids -> fused-table rows: ``ids`` plus the fields' row
    offsets, broadcast against it (``[F]`` for ids ``[..., F]``)."""
    return ids + torch.as_tensor(offsets, dtype=ids.dtype).to(ids.device)


def lookup_single(table, offsets, ids, *, out_dtype=None,
                  impl: str = "cuda"):
    """Single-hot lookup. ids: [B, F] per-field indices -> [B, F, dim]."""
    b, f = ids.shape
    flat = field_ids(ids, offsets).reshape(b * f, 1)
    return padded_bag(table, flat, out_dtype=out_dtype, impl=impl) \
        .reshape(b, f, -1)


def take_rows(table, flat_ids, *, out_dtype=None, impl: str = "cuda"):
    """Row gather of fused-table rows ``flat_ids [...]`` -> ``[..., dim]``."""
    shape = flat_ids.shape
    out = padded_bag(table, flat_ids.reshape(-1, 1), out_dtype=out_dtype,
                     impl=impl)
    return out.reshape(*shape, table.shape[1])


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
