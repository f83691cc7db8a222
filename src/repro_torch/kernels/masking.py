"""Shared mask plumbing for the kernel wrappers and the backend layer."""
from __future__ import annotations

import torch


def last_valid_lengths(valid):
    """Boolean ``valid [B, S]`` -> ``[B]`` int32: one past the last True
    per row (0 for all-False rows).  This is the kernels' tile-skip bound:
    it covers every valid index without requiring the mask to be a
    prefix."""
    size = valid.shape[-1]
    rev = torch.argmax(valid.flip(-1).to(torch.int32), dim=-1)
    return torch.where(valid.any(dim=-1), size - rev,
                       torch.zeros_like(rev)).to(torch.int32)
