"""Public wrapper of the split-attention kernel (``csrc/split_attention.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  ``split_flash_attention.launches`` counts kernel
launches."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masking import last_valid_lengths
from repro_torch.kernels.split_attention.ref import split_attention_ref

HEAD_DIMS = (16, 32, 64, 128)


def split_flash_attention(q, k, v, lengths=None, k_valid=None, *,
                          seg_boundary: int = -1, out=None):
    """Flash attention with the PreTTR split mask.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (any strides with a
    contiguous D axis); lengths: [B] valid KV length, the tile-skip bound
    (defaults to one past the last valid key of ``k_valid``, else Skv);
    k_valid: optional [B, Skv] boolean, the exact key mask;
    ``seg_boundary`` >= 0: tokens attend only within their side of that
    index.  ``out``: optional [B, Hq, Sq, D] destination (any strides with
    a contiguous D axis), so callers can receive the model layout without
    a copy.  Returns [B, Hq, Sq, D] in q's dtype."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if lengths is None:
        lengths = (torch.full((b,), skv, dtype=torch.int32, device=q.device)
                   if k_valid is None else last_valid_lengths(k_valid))
    if q.device.type == "cpu":
        res = split_attention_ref(q, k, v, lengths, k_valid,
                                  seg_boundary=seg_boundary)
        return res if out is None else out.copy_(res)
    _check(q, k, v)
    if k_valid is None:
        k_valid = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    k_valid = k_valid.to(device=q.device, dtype=torch.bool).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if k_valid.shape != (b, skv) or lengths.shape != (b,):
        raise ValueError(f"k_valid {tuple(k_valid.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={b}, "
                         f"Skv={skv}")
    out = _build.output_like(q, out)
    lib = _build.library()
    code = lib.rt_split_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), k_valid.data_ptr(), _build.dtype_code(q.dtype),
        b, hq, k.shape[1], sq, skv, d,
        *_build.bhs_strides(q), *_build.bhs_strides(k),
        *_build.bhs_strides(v), *_build.bhs_strides(out),
        int(seg_boundary), 1.0 / math.sqrt(d), _build.stream_ptr(q.device))
    _build.check("split_attention", code)
    split_flash_attention.launches += 1
    return out


split_flash_attention.launches = 0


def _check(q, k, v):
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("q, k, v must lie on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, hq, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
