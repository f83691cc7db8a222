"""Public wrapper of the split-KV join-attention kernels
(``csrc/join_attention.cu``): the tiled kernel for Sq > 1 and the
key-parallel row kernel for the CLS-only final layer (Sq = 1).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch a
kernel or raise.  ``join_flash_attention.launches`` counts the tiled
kernel's launches and ``join_flash_attention.row_launches`` the row
kernel's."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.join_attention.ref import join_attention_ref
from repro_torch.kernels.masking import last_valid_lengths
from repro_torch.kernels.split_attention.ops import HEAD_DIMS


def join_flash_attention(q, kq, vq, kd, vd, kq_valid=None, kd_valid=None, *,
                         out=None):
    """Attention of ``q`` over the union of two K/V segments, never
    concatenated: the query segment (``kq``/``vq``, masked by
    ``kq_valid``) and the doc segment (``kd``/``vd``, masked by
    ``kd_valid``; tiles past its last valid key are skipped).

    q: [B, Hq, Sq, D]; kq, vq: [B, Hkv, Lq, D]; kd, vd: [B, Hkv, Ld, D]
    (any strides with a contiguous D axis); masks optional booleans.
    ``out``: optional [B, Hq, Sq, D] destination.  Sq = 1 (the CLS row)
    goes to the row kernel, parallel over keys within each (batch row,
    head) block.  Returns [B, Hq, Sq, D] in q's dtype."""
    if q.device.type == "cpu":
        res = join_attention_ref(q, kq, vq, kd, vd, kq_valid, kd_valid)
        return res if out is None else out.copy_(res)
    row = q.shape[2] == 1
    out = _launch("rt_join_attention_row" if row else "rt_join_attention",
                  q, kq, vq, kd, vd, kq_valid, kd_valid, out)
    if row:
        join_flash_attention.row_launches += 1
    else:
        join_flash_attention.launches += 1
    return out


join_flash_attention.launches = 0
join_flash_attention.row_launches = 0


def _launch(entry, q, kq, vq, kd, vd, kq_valid, kd_valid, out):
    b, hq, sq, d = q.shape
    hkv, lq, ld = kq.shape[1], kq.shape[2], kd.shape[2]
    tensors = (q, kq, vq, kd, vd)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("q, kq, vq, kd, vd must lie on one CUDA device")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"operand dtypes differ: {[t.dtype for t in tensors]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if (kq.shape != vq.shape or kd.shape != vd.shape
            or kq.shape[0] != b or kd.shape[0] != b or kd.shape[1] != hkv
            or kq.shape[3] != d or kd.shape[3] != d or hq % hkv):
        raise ValueError(
            f"join shapes do not match: q {tuple(q.shape)}, kq "
            f"{tuple(kq.shape)}, vq {tuple(vq.shape)}, kd {tuple(kd.shape)}, "
            f"vd {tuple(vd.shape)}")
    dev = q.device
    kq_valid = (torch.ones((b, lq), dtype=torch.bool, device=dev)
                if kq_valid is None else kq_valid.to(dev, torch.bool))
    kd_valid = (torch.ones((b, ld), dtype=torch.bool, device=dev)
                if kd_valid is None else kd_valid.to(dev, torch.bool))
    kq_valid, kd_valid = kq_valid.contiguous(), kd_valid.contiguous()
    if kq_valid.shape != (b, lq) or kd_valid.shape != (b, ld):
        raise ValueError(f"masks {tuple(kq_valid.shape)} / "
                         f"{tuple(kd_valid.shape)} do not match B={b}, "
                         f"Lq={lq}, Ld={ld}")
    dlen = last_valid_lengths(kd_valid).contiguous()
    out = _build.output_like(q, out)
    code = getattr(_build.library(), entry)(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(), kd.data_ptr(),
        vd.data_ptr(), out.data_ptr(), dlen.data_ptr(), kq_valid.data_ptr(),
        kd_valid.data_ptr(), _build.dtype_code(q.dtype), b, hq, hkv, sq, lq,
        ld, d, *_build.bhs_strides(q), *_build.bhs_strides(kq),
        *_build.bhs_strides(vq), *_build.bhs_strides(kd),
        *_build.bhs_strides(vd), *_build.bhs_strides(out),
        1.0 / math.sqrt(d), _build.stream_ptr(dev))
    _build.check(entry, code)
    return out
