"""Public wrapper of the flash-decode kernel (``csrc/decode_attention.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  Launch counters, one per form:
``flash_decode_attention.launches`` (no window: the CLS-only layer and
the LM's global layers) and ``.window_launches`` (window > 0: the LM's
local layers)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.masking import last_valid_lengths

# 16 is smoke_config's head dim (its legacy join and rank_forward end here
# on the card); 64 PreTTR-BERT's; 256 gemma3's
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8                    # query heads per KV head the kernel takes


def flash_decode_attention(q, k, v, lengths=None, k_valid=None, *,
                           window: int = -1, out=None):
    """One query row per head against a K/V sequence.

    q: [B, Hq, 1, D]; k, v: [B, Hkv, S, D] (any strides with a contiguous
    D axis); head h reads KV head ``h // (Hq / Hkv)``.  lengths: [B], the
    query sits at ``lengths - 1`` and keys at or past ``lengths`` are
    never read; it defaults to one past the last valid key of ``k_valid``,
    else S.  k_valid: optional [B, S] boolean or int mask (non-prefix
    validity, as the CLS-only layer's two padded segments give).
    ``window`` > 0 masks keys with ``q_pos - k_pos >= window``.  The scale
    is ``1/sqrt(D)``.  ``out``: optional [B, Hq, 1, D] destination (any
    strides with a contiguous D axis).  Returns [B, Hq, 1, D] in q's
    dtype."""
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if sq != 1:
        raise ValueError(f"flash decode takes one query row, got q "
                         f"{tuple(q.shape)}")
    if lengths is None:
        lengths = (torch.full((b,), s, dtype=torch.int32, device=q.device)
                   if k_valid is None
                   else last_valid_lengths(k_valid.to(q.device).bool()))
    if q.device.type == "cpu":
        res = decode_attention_ref(q, k, v, lengths, k_valid,
                                   window=int(window))
        return res if out is None else out.copy_(res)
    _check(q, k, v)
    dev = q.device
    k_valid = (torch.ones((b, s), dtype=torch.bool, device=dev)
               if k_valid is None
               else k_valid.to(dev).bool().contiguous())
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if k_valid.shape != (b, s) or lengths.shape != (b,):
        raise ValueError(f"k_valid {tuple(k_valid.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={b}, S={s}")
    out = _build.output_like(q, out)
    qs, os_ = _build.bhs_strides(q), _build.bhs_strides(out)
    code = _build.library().rt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), k_valid.data_ptr(), _build.dtype_code(q.dtype),
        b, hq, hkv, s, d, qs[0], qs[1], *_build.bhs_strides(k),
        *_build.bhs_strides(v), os_[0], os_[1], int(window),
        1.0 / math.sqrt(d), _build.stream_ptr(dev))
    _build.check("decode_attention", code)
    if window > 0:
        flash_decode_attention.window_launches += 1
    else:
        flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.window_launches = 0


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
    if hq % k.shape[1] or hq // k.shape[1] > MAX_GROUP:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={k.shape[1]} "
                         f"with at most {MAX_GROUP} query heads per KV head")
