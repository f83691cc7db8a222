"""Public wrapper of the split-attention kernel (``csrc/split_attention.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  An input that requires grad while grad is
enabled raises first, on either device (``_build.refuse_grad``): the
kernels' outputs carry no gradient.
Launch counters, one per form, each launch counted
once: ``split_flash_attention.launches`` (bidirectional, float K/V: the
PreTTR form), ``.causal_launches`` (causal, no window),
``.window_launches`` (a sliding window, causal or not) and
``.int8_launches`` (raw int8 K/V with per-token scales, any mask); and
one per kernel the C entry routed the call to:
``.tensor_core_launches`` (``split_attention_tc_kernel``: bf16 / fp16 q,
head dim 64, 128 or 256, Sq > 1, 16-byte aligned operands) and
``.cuda_core_launches`` (``split_attention_kernel``: everything else,
float32 q among it); and ``.d32_launches``, the launches at head dim 32
(BERT4Rec's heads), on top of their form's and their kernel's count."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masking import last_valid_lengths
from repro_torch.kernels.split_attention.ref import split_attention_ref

# 16 smoke_config's head dim, 32 BERT4Rec's, 64 PreTTR-BERT's, 256 gemma3's
HEAD_DIMS = (16, 32, 64, 128, 256)


def split_flash_attention(q, k, v, lengths=None, k_valid=None, k_scales=None,
                          v_scales=None, *, causal: bool = False,
                          window: int = -1, seg_boundary: int = -1,
                          out=None):
    """Flash attention with PreTTR split / causal / sliding-window masks.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (any strides with a
    contiguous D axis), in q's dtype or raw int8 with ``k_scales`` /
    ``v_scales`` ([B, Skv] float32 per-token scales, both or neither),
    applied while the kernel stages each K/V tile.  lengths: [B] valid KV
    length, the tile-skip bound (defaults to one past the last valid key
    of ``k_valid``, else Skv); k_valid: optional [B, Skv] boolean, the
    exact key mask.  Query row i and key j sit at positions i and j:
    ``causal`` keeps j <= i; ``window`` > 0 keeps i - j < window;
    ``seg_boundary`` >= 0 keeps both on one side of that index.  ``out``:
    optional [B, Hq, Sq, D] destination (any strides with a contiguous D
    axis), so callers can receive the model layout without a copy.
    Returns [B, Hq, Sq, D] in q's dtype."""
    _build.refuse_grad("split_flash_attention", q, k, v, lengths, k_valid,
                       k_scales, v_scales, out)
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if lengths is None:
        lengths = (torch.full((b,), skv, dtype=torch.int32, device=q.device)
                   if k_valid is None else last_valid_lengths(k_valid))
    if q.device.type == "cpu":
        res = split_attention_ref(q, k, v, lengths, k_valid, k_scales,
                                  v_scales, causal=causal, window=window,
                                  seg_boundary=seg_boundary)
        return res if out is None else out.copy_(res)
    quant = k_scales is not None
    _check(q, k, v, quant)
    dev = q.device
    if k_valid is None:
        k_valid = torch.ones((b, skv), dtype=torch.bool, device=dev)
    k_valid = k_valid.to(device=dev, dtype=torch.bool).contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if k_valid.shape != (b, skv) or lengths.shape != (b,):
        raise ValueError(f"k_valid {tuple(k_valid.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={b}, "
                         f"Skv={skv}")
    scale_ptrs = [None, None]
    if quant:
        k_scales, v_scales = (s.to(device=dev, dtype=torch.float32)
                              .contiguous() for s in (k_scales, v_scales))
        if k_scales.shape != (b, skv) or v_scales.shape != (b, skv):
            raise ValueError(f"k_scales {tuple(k_scales.shape)} / v_scales "
                             f"{tuple(v_scales.shape)} are not [B={b}, "
                             f"Skv={skv}]")
        scale_ptrs = [k_scales.data_ptr(), v_scales.data_ptr()]
    out = _build.output_like(q, out)
    kernel = _build.launch_reporting(
        "rt_split_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lengths.data_ptr(), k_valid.data_ptr(), *scale_ptrs,
        _build.dtype_code(q.dtype), _build.dtype_code(k.dtype, int8=quant),
        b, hq, k.shape[1], sq, skv, d,
        *_build.bhs_strides(q), *_build.bhs_strides(k),
        *_build.bhs_strides(v), *_build.bhs_strides(out),
        int(bool(causal)), int(window), int(seg_boundary),
        1.0 / math.sqrt(d), _build.stream_ptr(dev))
    fn = split_flash_attention
    if kernel == _build.TENSOR_CORE:
        fn.tensor_core_launches += 1
    else:
        fn.cuda_core_launches += 1
    if d == 32:
        fn.d32_launches += 1
    if quant:
        fn.int8_launches += 1
    elif window > 0:
        fn.window_launches += 1
    elif causal:
        fn.causal_launches += 1
    else:
        fn.launches += 1
    return out


split_flash_attention.launches = 0
split_flash_attention.causal_launches = 0
split_flash_attention.window_launches = 0
split_flash_attention.int8_launches = 0
split_flash_attention.tensor_core_launches = 0
split_flash_attention.cuda_core_launches = 0
split_flash_attention.d32_launches = 0


def _check(q, k, v, quant: bool):
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("q, k, v must lie on one CUDA device")
    if quant and not (k.dtype == v.dtype == torch.int8):
        raise TypeError(f"k/v with scales must be raw int8, got {k.dtype}, "
                        f"{v.dtype}")
    if not quant and not (q.dtype == k.dtype == v.dtype):
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
