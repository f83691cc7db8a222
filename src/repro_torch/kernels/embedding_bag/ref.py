"""Plain PyTorch version of the embedding-bag kernel: the JAX package's
``embedding_bag_ref`` semantics (gather, float32 weighted sum, mean over
the summed weights, one cast), with the kernel's output type."""
from __future__ import annotations

MODES = ("sum", "mean")


def embedding_bag_ref(table, ids, weights=None, *, mode: str = "sum",
                      out_dtype=None):
    """table: [rows, dim]; ids: [n_bags, max_nnz] integers; weights:
    optional [n_bags, max_nnz] (0 marks a pad, None means 1) -> [n_bags,
    dim] in ``out_dtype`` (default the table's).  Each row is converted to
    ``out_dtype`` (the models' ``table.astype(compute_dtype)``), weighted
    and summed in float32; ``mean`` divides by ``max(sum_j w, 1)``.  An id
    outside [0, rows) gives its slot NaN, as ``jnp.take`` does."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    out_dtype = table.dtype if out_dtype is None else out_dtype
    rows = table.shape[0]
    ids = ids.long()
    inside = (ids >= 0) & (ids < rows)
    vecs = table[ids.clamp(0, rows - 1)].to(out_dtype).float()
    vecs.masked_fill_(~inside[..., None], float("nan"))   # a fresh gather
    if weights is None:
        out = vecs.sum(1)
        if mode == "mean":
            out = out / max(ids.shape[1], 1)
    else:
        w = weights.float()
        out = (vecs * w[..., None]).sum(1)
        if mode == "mean":
            out = out / w.sum(1, keepdim=True).clamp_min(1.0)
    return out.to(out_dtype)
