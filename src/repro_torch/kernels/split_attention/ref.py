"""Plain PyTorch version of the split-attention kernel: float32 throughout,
the JAX package's ``split_attention_ref`` semantics."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def split_attention_ref(q, k, v, lengths, k_valid=None, k_scales=None,
                        v_scales=None, *, causal: bool = False,
                        window: int = -1, seg_boundary: int = -1):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; lengths: [B]; k_valid:
    optional [B, Skv] boolean (non-prefix validity); k_scales/v_scales:
    optional [B, Skv] float32 per-token scales of raw int8 k/v (dequantise,
    then attend).  Query row i and key j sit at positions i and j:
    ``causal`` keeps j <= i, ``window`` > 0 keeps i - j < window.
    Returns [B, Hq, Sq, D] in q's dtype."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    k, v = k.float(), v.float()
    if k_scales is not None:
        k = k * k_scales.float()[:, None, :, None]
        v = v * v_scales.float()[:, None, :, None]
    n_rep = hq // hkv
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = (k_pos < lengths.to(q.device)[:, None, None, None]).expand(s.shape)
    if k_valid is not None:
        mask = mask & k_valid.bool()[:, None, None, :]
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    if seg_boundary >= 0:
        mask = mask & ((q_pos >= seg_boundary) == (k_pos >= seg_boundary))
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)
