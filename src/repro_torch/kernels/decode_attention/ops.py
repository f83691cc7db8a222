"""Public wrapper of the flash-decode kernel (``csrc/decode_attention.cu``,
the split-KV kernel of ``csrc/decode_attention.cuh``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  An input that requires grad while grad is
enabled raises first, on either device (``_build.refuse_grad``): the
kernels' outputs carry no gradient.
Launch counters, one per form:
``flash_decode_attention.launches`` (no window: the CLS-only layer and
the LM's global layers) and ``.window_launches`` (window > 0: the LM's
local layers); and for the calls whose keys were split across blocks,
which also launch the merge kernel, ``.merge_launches`` and
``.window_merge_launches``.  ``.last_n_splits`` is the split count the
last launch ran with."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import plan
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.masking import last_valid_lengths

# 16 is smoke_config's head dim (its legacy join and rank_forward end here
# on the card); 64 PreTTR-BERT's; 256 gemma3's
HEAD_DIMS = (16, 32, 64, 128, 256)


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
    _build.refuse_grad("flash_decode_attention", q, k, v, lengths, k_valid,
                       out)
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if sq != 1:
        raise ValueError(f"flash decode takes one query row, got q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        if lengths is None:
            lengths = (torch.full((b,), s, dtype=torch.int32)
                       if k_valid is None
                       else last_valid_lengths(k_valid.bool()))
        res = decode_attention_ref(q, k, v, lengths, k_valid,
                                   window=int(window))
        return res if out is None else out.copy_(res)
    _check(q, k, v)
    dev = q.device
    # without lengths every key up to S is in range and k_valid masks the
    # rest, which is the default's result; only a window needs the query
    # position, one past the last valid key
    if lengths is None and k_valid is not None and window > 0:
        lengths = last_valid_lengths(k_valid.to(dev).bool())
    if lengths is not None:
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
        if lengths.shape != (b,):
            raise ValueError(f"lengths {tuple(lengths.shape)} does not "
                             f"match B={b}")
    if k_valid is not None:
        k_valid = k_valid.to(dev, torch.bool).contiguous()
        if k_valid.shape != (b, s):
            raise ValueError(f"k_valid {tuple(k_valid.shape)} does not "
                             f"match B={b}, S={s}")
    n_splits, part = plan.split_plan(b, hq, hkv, d,
                                     plan.decode_span(s, int(window)), dev)
    out = _build.output_like(q, out)
    qs, os_ = _build.bhs_strides(q), _build.bhs_strides(out)
    launched = _build.launch_reporting(
        "rt_decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _build.ptr(lengths), _build.ptr(k_valid),
        _build.ptr(part),
        _build.dtype_code(q.dtype), b, hq, hkv, s, d, qs[0], qs[1],
        *_build.bhs_strides(k), *_build.bhs_strides(v), os_[0], os_[1],
        int(window), n_splits, *plan.LAYOUT, 1.0 / math.sqrt(d),
        _build.stream_ptr(dev))
    merged = launched == _build.WITH_MERGE
    if window > 0:
        flash_decode_attention.window_launches += 1
        flash_decode_attention.window_merge_launches += int(merged)
    else:
        flash_decode_attention.launches += 1
        flash_decode_attention.merge_launches += int(merged)
    flash_decode_attention.last_n_splits = n_splits
    return out


flash_decode_attention.launches = 0
flash_decode_attention.window_launches = 0
flash_decode_attention.merge_launches = 0
flash_decode_attention.window_merge_launches = 0
flash_decode_attention.last_n_splits = None


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
