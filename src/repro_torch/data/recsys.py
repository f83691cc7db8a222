"""Synthetic click-log / interaction generators for the recsys models, a
copy of ``repro.data.recsys`` (numpy only): the same ``np.random.Generator``
state gives the same arrays bit for bit."""
from __future__ import annotations

import numpy as np


def click_batch(rng: np.random.Generator, batch: int, *, n_dense: int,
                vocab_sizes, zipf_a: float = 1.3):
    """Criteo-style batch: dense [B, n_dense], sparse [B, F] ids, labels from
    a logistic ground truth over random per-field affinities."""
    dense = rng.normal(0, 1, size=(batch, n_dense)).astype(np.float32) \
        if n_dense else np.zeros((batch, 0), np.float32)
    sparse = np.stack([
        np.minimum(rng.zipf(zipf_a, size=batch) - 1, v - 1).astype(np.int64)
        for v in vocab_sizes], axis=1)
    # ground truth: hash-derived affinity per (field, id bucket)
    aff = np.zeros(batch, np.float32)
    for f in range(sparse.shape[1]):
        aff += np.sin(0.1 * (sparse[:, f] % 97) + f)
    if n_dense:
        aff += 0.3 * dense[:, 0]
    p = 1.0 / (1.0 + np.exp(-0.5 * aff))
    labels = (rng.random(batch) < p).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


def item_seq_batch(rng: np.random.Generator, batch: int, *, n_items: int,
                   seq_len: int, mask_prob: float = 0.15, zipf_a: float = 1.2):
    """BERT4Rec Cloze batch: item_seq [B, S] with [MASK]=1 holes, targets."""
    seq = np.minimum(rng.zipf(zipf_a, size=(batch, seq_len)) + 1,
                     n_items + 1).astype(np.int32)
    lengths = rng.integers(seq_len // 2, seq_len + 1, size=batch)
    valid = np.arange(seq_len)[None] < lengths[:, None]
    seq = np.where(valid, seq, 0)
    mask = (rng.random((batch, seq_len)) < mask_prob) & valid
    # ensure at least one mask per row
    mask[np.arange(batch),
         rng.integers(0, seq_len, batch) % np.maximum(lengths, 1)] = True
    mask &= valid
    targets = np.where(mask, seq, 0)
    item_seq = np.where(mask, 1, seq)   # MASK_ITEM = 1
    return {"item_seq": item_seq, "valid": valid, "targets": targets}
