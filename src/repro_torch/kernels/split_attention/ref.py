"""Plain PyTorch version of the split-attention kernel: float32 throughout,
the JAX package's ``split_attention_ref`` semantics."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def split_attention_ref(q, k, v, lengths, k_valid=None, *,
                        seg_boundary: int = -1):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; lengths: [B]; k_valid:
    optional [B, Skv] boolean (non-prefix validity).  Returns
    [B, Hq, Sq, D] in q's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    k = k.float().repeat_interleave(n_rep, dim=1)
    v = v.float().repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = (k_pos < lengths.to(q.device)[:, None, None, None]).expand(s.shape)
    if k_valid is not None:
        mask = mask & k_valid.bool()[:, None, None, :]
    if seg_boundary >= 0:
        mask = mask & ((q_pos >= seg_boundary) == (k_pos >= seg_boundary))
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)
