"""Plain PyTorch versions of the split-KV join-attention kernels: float32
throughout, the JAX package's ``join_attention_ref`` semantics, with the
decode-then-attend version of the raw-int8 doc segment and the
densify-then-attend version of the paged one."""
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
    k = torch.cat([kq.float(), kd.float()], dim=2).repeat_interleave(n_rep,
                                                                     dim=1)
    v = torch.cat([vq.float(), vd.float()], dim=2).repeat_interleave(n_rep,
                                                                     dim=1)
    if kq_valid is None:
        kq_valid = torch.ones((b, lq), dtype=torch.bool, device=q.device)
    if kd_valid is None:
        kd_valid = torch.ones((b, ld), dtype=torch.bool, device=q.device)
    valid = torch.cat([kq_valid.bool(), kd_valid.bool()], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(d)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def dequantize_kv(x_q, scales):
    """Widen raw-int8 K or V rows with per-token float32 scales.
    x_q: [B, Hkv, Ld, D] int8; scales: [B, Ld] -> float32."""
    return x_q.float() * scales.float()[:, None, :, None]


def join_attention_ref_quant(q, kq, vq, kd_q, vd_q, kd_scales, vd_scales,
                             kq_valid=None, kd_valid=None):
    """Decode-then-attend version of the int8 doc segment."""
    return join_attention_ref(q, kq, vq, dequantize_kv(kd_q, kd_scales),
                              dequantize_kv(vd_q, vd_scales),
                              kq_valid=kq_valid, kd_valid=kd_valid)


def pages_to_dense(pages, page_table):
    """[P, page, ...] pools through a [B, nP] page table -> [B, nP * page,
    ...] rows in assembled order."""
    g = pages[page_table.long()]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def join_attention_ref_paged(q, kq, vq, kd_pages, vd_pages, page_table,
                             dval_pages, kq_valid=None, kd_scale_pages=None,
                             vd_scale_pages=None):
    """Densify-then-attend version of the paged doc segment: pools
    [P, page, Hkv, D], validity [P, page], optional scale pools
    [P, page, 1] for int8 pools."""
    kd = pages_to_dense(kd_pages, page_table).movedim(2, 1)
    vd = pages_to_dense(vd_pages, page_table).movedim(2, 1)
    kd_valid = pages_to_dense(dval_pages, page_table).bool()
    if kd_scale_pages is not None:
        return join_attention_ref_quant(
            q, kq, vq, kd, vd, pages_to_dense(kd_scale_pages,
                                              page_table)[..., 0],
            pages_to_dense(vd_scale_pages, page_table)[..., 0],
            kq_valid=kq_valid, kd_valid=kd_valid)
    return join_attention_ref(q, kq, vq, kd, vd, kq_valid=kq_valid,
                              kd_valid=kd_valid)
