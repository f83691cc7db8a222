"""How the split-KV kernel (``csrc/decode_attention.cuh``) cuts a row's
keys into splits: the planner the wrappers run on the host, and the chunk
bounds the kernel computes on the device, repeated here so the CPU can
check them.

The planner reads shapes only, never a tensor's values, so a launch never
waits for the device.  It aims at ``BLOCKS_PER_SM`` blocks an SM and at
least ``MIN_KEYS`` keys a split; each row's ``[lo, hi)`` (known only on
the device) is then cut into ``n_splits`` chunks of a multiple of
``ALIGN`` keys, starting at ``lo``.  ``split_plan`` is what both Sq = 1
wrappers call; the C entries are passed ``LAYOUT`` and refuse to launch
when it differs from their own constants."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

BLOCKS_PER_SM = 2
MIN_KEYS = 64
ALIGN = 16          # kSplitAlign of decode_attention.cuh
MAX_SPLITS = 4096   # kMaxSplits of decode_attention.cuh
BLOCK_ROWS = 8      # kBlockRows: larger GQA groups take row groups
#: the constants above that the kernel shares, in the C entries' order
LAYOUT = (ALIGN, MAX_SPLITS, BLOCK_ROWS)


def row_groups(group: int) -> int:
    """Blocks a GQA group of ``group`` query heads takes (8 rows each)."""
    return -(-group // BLOCK_ROWS)


def plan_splits(blocks: int, span: int, n_sm: int) -> int:
    """Splits of each row's keys for ``blocks`` (batch, head, row group)
    blocks a split over at most ``span`` keys a row: enough for
    BLOCKS_PER_SM blocks an SM, no fewer than MIN_KEYS keys a split, at
    least one and at most MAX_SPLITS."""
    for name, x in (("blocks", blocks), ("span", span), ("n_sm", n_sm)):
        if type(x) is not int:
            raise TypeError(f"plan_splits takes Python ints (shapes), got "
                            f"{name}={x!r}")
    want = -(-BLOCKS_PER_SM * n_sm // max(blocks, 1))
    return max(1, min(want, span // MIN_KEYS, MAX_SPLITS))


def split_plan(b: int, hq: int, hkv: int, d: int, span: int, dev):
    """The split-KV kernel's ``n_splits`` for a call over at most ``span``
    keys a row, from shapes alone, and the float32 partials it writes when
    it splits ([B, Hq, n_splits, D + 2]; None for one split)."""
    n_splits = plan_splits(b * hkv * row_groups(hq // hkv), span,
                           _build.sm_count(dev))
    part = (torch.empty(b * hq * n_splits * (d + 2), dtype=torch.float32,
                        device=dev) if n_splits > 1 else None)
    return n_splits, part


def decode_span(s: int, window: int) -> int:
    """The most keys a flash-decode row can see: S, or the window."""
    return min(s, window) if window > 0 else s


def split_bounds(lo, hi, n_splits: int, split: int):
    """Keys ``[s_lo, s_hi)`` of split ``split`` of a row that sees
    ``[lo, hi)``; empty (``s_lo >= s_hi``) past the row's keys.  Works on
    ints and on integer tensors alike."""
    span = hi - lo
    per = (span + n_splits - 1) // n_splits
    if isinstance(per, int):
        per = max(per, 0)
    else:
        per = per.clamp_min(0)
    chunk = (per + ALIGN - 1) // ALIGN * ALIGN
    s_lo = lo + split * chunk
    s_hi = s_lo + chunk
    return s_lo, (min(hi, s_hi) if isinstance(s_hi, int)
                  else s_hi.minimum(hi))
