"""Plain PyTorch version of the split-KV join-attention kernels: float32
throughout, the JAX package's ``join_attention_ref`` semantics."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def join_attention_ref(q, kq, vq, kd, vd, kq_valid=None, kd_valid=None):
    """q: [B, Hq, Sq, D]; kq, vq: [B, Hkv, Lq, D]; kd, vd: [B, Hkv, Ld, D];
    kq_valid / kd_valid: optional [B, Lq] / [B, Ld] booleans.  Returns
    [B, Hq, Sq, D]: softmax over the union of both segments."""
    b, hq, sq, d = q.shape
    hkv, lq, ld = kq.shape[1], kq.shape[2], kd.shape[2]
    n_rep = hq // hkv
    k = torch.cat([kq, kd], dim=2).float().repeat_interleave(n_rep, dim=1)
    v = torch.cat([vq, vd], dim=2).float().repeat_interleave(n_rep, dim=1)
    if kq_valid is None:
        kq_valid = torch.ones((b, lq), dtype=torch.bool, device=q.device)
    if kd_valid is None:
        kd_valid = torch.ones((b, ld), dtype=torch.bool, device=q.device)
    valid = torch.cat([kq_valid.bool(), kd_valid.bool()], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(d)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)
