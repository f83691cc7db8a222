"""Plain PyTorch version of the flash-decode kernel: float32 throughout,
the JAX package's ``decode_attention_ref`` semantics."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, lengths, k_valid=None, *, window: int = -1):
    """q: [B, Hq, 1, D]; k, v: [B, Hkv, S, D]; lengths: [B]; k_valid:
    optional [B, S] boolean (non-prefix validity) -> [B, Hq, 1, D] in q's
    dtype.  The query sits at position ``lengths - 1``; ``window`` > 0
    masks keys with ``q_pos - k_pos >= window``."""
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    kk = k.float().repeat_interleave(n_rep, dim=1)
    vv = v.float().repeat_interleave(n_rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    lengths = lengths.to(q.device)
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos[None, None, None, :] < lengths[:, None, None, None]
    if k_valid is not None:
        mask = mask & k_valid.bool()[:, None, None, :]
    if window > 0:
        q_pos = (lengths - 1)[:, None, None, None]
        mask = mask & ((q_pos - k_pos[None, None, None, :]) < window)
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
