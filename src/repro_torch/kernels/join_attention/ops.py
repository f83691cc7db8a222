"""Public wrappers of the split-KV join-attention kernels
(``csrc/join_attention.cu``, ``csrc/join_attention_row.cu``,
``csrc/join_attention_paged.cu``): the tiled kernel over dense float or
raw-int8 doc K/V, the split-KV kernel of ``csrc/decode_attention.cuh``
for the CLS-only final layer (Sq = 1, float K/V), and the tiled kernel
over the doc cache's page pools.

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch a
kernel or raise.  An input that requires grad while grad is
enabled raises first, on either device (``_build.refuse_grad``): the
kernels' outputs carry no gradient.
Launch counters: ``join_flash_attention.launches`` (the
tiled kernel, float K/V), ``.row_launches`` (the CLS row),
``.row_merge_launches`` (CLS-row calls whose keys were split across
blocks, which also launch the merge kernel; ``.last_row_n_splits`` is
the split count of the last), ``.int8_launches`` (the
tiled kernel, int8 K/V) and
``join_flash_attention_paged.launches``; and on both wrappers one per
kernel the C entry routed a tiled call to: ``.tensor_core_launches``
(``join_tc_kernel``: bf16 / fp16 q, head dim 64 or 128, Sq > 1, doc K/V
of q's type, raw int8 or, paged, the other 16-bit type, 16-byte aligned
operands) and ``.cuda_core_launches`` (``join_tiled_kernel``: everything
else, float32 q among it)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import plan
from repro_torch.kernels.join_attention.ref import (join_attention_ref,
                                                    join_attention_ref_paged,
                                                    join_attention_ref_quant,
                                                    pages_to_dense)
from repro_torch.kernels.masking import last_valid_lengths
from repro_torch.kernels.split_attention.ops import HEAD_DIMS


def join_flash_attention(q, kq, vq, kd, vd, kq_valid=None, kd_valid=None,
                         kd_scales=None, vd_scales=None, *, out=None):
    """Attention of ``q`` over the union of two K/V segments, never
    concatenated: the query segment (``kq``/``vq``, masked by
    ``kq_valid``) and the doc segment (``kd``/``vd``, masked by
    ``kd_valid``; tiles past its last valid key are skipped).

    q: [B, Hq, Sq, D]; kq, vq: [B, Hkv, Lq, D]; kd, vd: [B, Hkv, Ld, D]
    (any strides with a contiguous D axis); masks optional booleans.
    ``kd_scales`` / ``vd_scales`` (both or neither): [B, Ld] float32
    per-token scales of raw int8 ``kd`` / ``vd``, widened inside the
    kernel.  ``out``: optional [B, Hq, Sq, D] destination.  Sq = 1 with
    float K/V goes to the split-KV kernel, which reads the masks itself
    and never reads a masked key.  Returns [B, Hq, Sq, D] in q's dtype."""
    _build.refuse_grad("join_flash_attention", q, kq, vq, kd, vd, kq_valid,
                       kd_valid, kd_scales, vd_scales, out)
    quant = _check_scales(kd, kd_scales, vd_scales)
    if q.device.type == "cpu":
        if quant:
            res = join_attention_ref_quant(q, kq, vq, kd, vd, kd_scales,
                                           vd_scales, kq_valid, kd_valid)
        else:
            res = join_attention_ref(q, kq, vq, kd, vd, kq_valid, kd_valid)
        return res if out is None else out.copy_(res)
    if q.shape[2] == 1 and not quant:
        out = _launch_row(q, kq, vq, kd, vd, kq_valid, kd_valid, out)
        join_flash_attention.row_launches += 1
        return out
    out, kernel = _launch(q, kq, vq, kd, vd, kq_valid, kd_valid, kd_scales,
                          vd_scales, out)
    _count_route(join_flash_attention, kernel)
    if quant:
        join_flash_attention.int8_launches += 1
    else:
        join_flash_attention.launches += 1
    return out


join_flash_attention.launches = 0
join_flash_attention.row_launches = 0
join_flash_attention.row_merge_launches = 0
join_flash_attention.last_row_n_splits = None
join_flash_attention.int8_launches = 0
join_flash_attention.tensor_core_launches = 0
join_flash_attention.cuda_core_launches = 0


def _count_route(fn, kernel):
    if kernel == _build.TENSOR_CORE:
        fn.tensor_core_launches += 1
    else:
        fn.cuda_core_launches += 1


def join_flash_attention_paged(q, kq, vq, kd_pages, vd_pages, page_table,
                               dval_pages, kq_valid=None,
                               kd_scale_pages=None, vd_scale_pages=None, *,
                               out=None):
    """The join with the doc segment read from the device doc cache's
    token-page pools through a page table; no dense K/V copy is made.

    q: [B, Hq, Sq, D]; kq, vq: [B, Hkv, Lq, D]; kd_pages, vd_pages:
    [P, page, Hkv, D] pools (int8, float16, bfloat16 or float32, whatever
    q's dtype); page_table: [B, nP] pool page per (row, page slot), tails
    pointing at an all-zero page; dval_pages: [P, page] token validity
    (0/1 bytes or booleans); kd_scale_pages / vd_scale_pages: [P, page, 1]
    float32 scale pools, required for int8 pools.  The doc segment spans
    nP * page assembled positions; its valid length is computed on the
    device from ``dval_pages[page_table]``.  Returns [B, Hq, Sq, D]."""
    _build.refuse_grad("join_flash_attention_paged", q, kq, vq, kd_pages,
                       vd_pages, page_table, dval_pages, kq_valid,
                       kd_scale_pages, vd_scale_pages, out)
    quant = _check_scales(kd_pages, kd_scale_pages, vd_scale_pages)
    if q.device.type == "cpu":
        res = join_attention_ref_paged(q, kq, vq, kd_pages, vd_pages,
                                       page_table, dval_pages, kq_valid,
                                       kd_scale_pages, vd_scale_pages)
        return res if out is None else out.copy_(res)
    b, hq, sq, d = q.shape
    hkv, lq = kq.shape[1], kq.shape[2]
    n_pool, page = kd_pages.shape[0], kd_pages.shape[1]
    _check_common(q, kq, vq, (kd_pages, vd_pages, page_table, dval_pages))
    if (kd_pages.shape != (n_pool, page, hkv, d)
            or vd_pages.shape != kd_pages.shape
            or dval_pages.shape != (n_pool, page) or page_table.dim() != 2
            or page_table.shape[0] != b or page_table.shape[1] == 0):
        raise ValueError(
            f"paged join shapes do not match: q {tuple(q.shape)}, kq "
            f"{tuple(kq.shape)}, pools {tuple(kd_pages.shape)} / "
            f"{tuple(vd_pages.shape)}, validity {tuple(dval_pages.shape)}, "
            f"page table {tuple(page_table.shape)}")
    if vd_pages.dtype != kd_pages.dtype:
        raise TypeError(f"pool dtypes differ: {kd_pages.dtype}, "
                        f"{vd_pages.dtype}")
    if not (kd_pages.is_contiguous() and vd_pages.is_contiguous()):
        raise ValueError("K/V pools must be contiguous [P, page, Hkv, D]")
    if dval_pages.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise TypeError(f"validity pool must hold bytes, got "
                        f"{dval_pages.dtype}")
    dval = dval_pages.contiguous().view(torch.uint8)
    table = page_table.to(torch.int32).contiguous()
    scales = ([_scale_pool(s, n_pool, page, q.device)
               for s in (kd_scale_pages, vd_scale_pages)] if quant else [])
    scale_ptrs = [t.data_ptr() for t in scales] or [0, 0]
    # one past each row's last valid key, on the device (no host sync)
    dlen = last_valid_lengths(pages_to_dense(dval, table).bool()) \
        .contiguous()
    kq_valid = _mask(kq_valid, b, lq, q.device)
    out = _build.output_like(q, out)
    kernel = _build.launch_reporting(
        "rt_join_attention_paged", q.data_ptr(), kq.data_ptr(),
        vq.data_ptr(), kd_pages.data_ptr(), vd_pages.data_ptr(),
        out.data_ptr(), dlen.data_ptr(),
        kq_valid.data_ptr(), table.data_ptr(), dval.data_ptr(),
        *scale_ptrs, _build.dtype_code(q.dtype),
        _build.dtype_code(kd_pages.dtype, int8=True), b, hq, hkv, sq, lq,
        table.shape[1], page, d, *_build.bhs_strides(q),
        *_build.bhs_strides(kq), *_build.bhs_strides(vq),
        *_build.bhs_strides(out), 1.0 / math.sqrt(d),
        _build.stream_ptr(q.device))
    _count_route(join_flash_attention_paged, kernel)
    join_flash_attention_paged.launches += 1
    return out


join_flash_attention_paged.launches = 0
join_flash_attention_paged.tensor_core_launches = 0
join_flash_attention_paged.cuda_core_launches = 0


def _check_scales(kd, k_scales, v_scales) -> bool:
    """True for raw int8 doc K/V, which must come with both scales; float
    K/V take none."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both doc K/V scale operands or neither")
    quant = kd.dtype == torch.int8
    if quant != (k_scales is not None):
        raise ValueError(
            f"per-token scales go with raw int8 doc K/V and only with "
            f"them: K/V {kd.dtype}, scales "
            f"{'given' if k_scales is not None else 'missing'}")
    return quant


def _check_common(q, kq, vq, others):
    b, hq, _, d = q.shape
    hkv = kq.shape[1]
    tensors = (q, kq, vq, *others)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("join operands must lie on one CUDA device")
    if kq.dtype != q.dtype or vq.dtype != q.dtype:
        raise TypeError(f"q, kq, vq dtypes differ: {q.dtype}, {kq.dtype}, "
                        f"{vq.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if kq.shape != vq.shape or kq.shape[0] != b or kq.shape[3] != d \
            or hq % hkv:
        raise ValueError(f"join shapes do not match: q {tuple(q.shape)}, "
                         f"kq {tuple(kq.shape)}, vq {tuple(vq.shape)}")


def _mask(valid, b, n, dev):
    if valid is None:
        return torch.ones((b, n), dtype=torch.bool, device=dev)
    valid = valid.to(dev, torch.bool).contiguous()
    if valid.shape != (b, n):
        raise ValueError(f"mask {tuple(valid.shape)} and B={b}, length "
                         f"{n} do not match")
    return valid


def _scale_pool(s, n_pool, page, dev):
    if s.dtype != torch.float32 or s.device != dev or s.shape not in (
            (n_pool, page, 1), (n_pool, page)):
        raise ValueError(f"scale pool must be float32 [{n_pool}, {page}, 1]"
                         f" on {dev}, got {s.dtype} {tuple(s.shape)} on "
                         f"{s.device}")
    return s.contiguous()


def _check_doc(q, kq, kd, vd, quant):
    b, _, _, d = q.shape
    hkv = kq.shape[1]
    if kd.dtype != (torch.int8 if quant else q.dtype) \
            or vd.dtype != kd.dtype:
        raise TypeError(f"doc K/V dtypes {kd.dtype}, {vd.dtype} do not go "
                        f"with q {q.dtype}: float doc K/V share q's dtype, "
                        f"raw int8 comes with scales")
    if kd.shape != vd.shape or kd.shape[:2] != (b, hkv) or kd.shape[3] != d:
        raise ValueError(
            f"join shapes do not match: q {tuple(q.shape)}, kq "
            f"{tuple(kq.shape)}, kd {tuple(kd.shape)}, vd {tuple(vd.shape)}")


def _launch_row(q, kq, vq, kd, vd, kq_valid, kd_valid, out):
    """The CLS row through the split-KV kernel: no valid-length pass on the
    host side, absent masks passed as null pointers."""
    b, hq, _, d = q.shape
    hkv, lq, ld = kq.shape[1], kq.shape[2], kd.shape[2]
    _check_common(q, kq, vq, (kd, vd))
    _check_doc(q, kq, kd, vd, quant=False)
    dev = q.device
    masks = [None if m is None else _mask(m, b, n, dev)
             for m, n in ((kq_valid, lq), (kd_valid, ld))]
    n_splits, part = plan.split_plan(b, hq, hkv, d, lq + ld, dev)
    out = _build.output_like(q, out)
    qs, os_ = _build.bhs_strides(q), _build.bhs_strides(out)
    launched = _build.launch_reporting(
        "rt_join_attention_row", q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        kd.data_ptr(), vd.data_ptr(), out.data_ptr(),
        *(_build.ptr(m) for m in masks), _build.ptr(part),
        _build.dtype_code(q.dtype), b, hq, hkv, lq, ld, d, qs[0], qs[1],
        *_build.bhs_strides(kq), *_build.bhs_strides(vq),
        *_build.bhs_strides(kd), *_build.bhs_strides(vd), os_[0], os_[1],
        n_splits, *plan.LAYOUT, 1.0 / math.sqrt(d), _build.stream_ptr(dev))
    join_flash_attention.row_merge_launches += int(
        launched == _build.WITH_MERGE)
    join_flash_attention.last_row_n_splits = n_splits
    return out


def _launch(q, kq, vq, kd, vd, kq_valid, kd_valid, kd_scales, vd_scales,
            out):
    b, hq, sq, d = q.shape
    hkv, lq, ld = kq.shape[1], kq.shape[2], kd.shape[2]
    _check_common(q, kq, vq, (kd, vd))
    quant = kd_scales is not None
    _check_doc(q, kq, kd, vd, quant)
    dev = q.device
    kq_valid = _mask(kq_valid, b, lq, dev)
    kd_valid = _mask(kd_valid, b, ld, dev)
    scale_ptrs = []
    if quant:
        scales = []
        for s in (kd_scales, vd_scales):
            if s.shape != (b, ld) or s.device != dev:
                raise ValueError(f"scales {tuple(s.shape)} on {s.device} "
                                 f"do not match B={b}, Ld={ld} on {dev}")
            scales.append(s.to(torch.float32).contiguous())
        scale_ptrs = [t.data_ptr() for t in scales]
    dlen = last_valid_lengths(kd_valid).contiguous()
    out = _build.output_like(q, out)
    return out, _build.launch_reporting(
        "rt_join_attention", q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        kd.data_ptr(), vd.data_ptr(), out.data_ptr(), dlen.data_ptr(),
        kq_valid.data_ptr(), kd_valid.data_ptr(), *(scale_ptrs or [0, 0]),
        _build.dtype_code(q.dtype), _build.dtype_code(kd.dtype, int8=True),
        b, hq, hkv, sq, lq, ld, d, *_build.bhs_strides(q),
        *_build.bhs_strides(kq), *_build.bhs_strides(vq),
        *_build.bhs_strides(kd), *_build.bhs_strides(vd),
        *_build.bhs_strides(out), 1.0 / math.sqrt(d), _build.stream_ptr(dev))
