"""Plain PyTorch versions of the compressor kernels: float32 throughout,
the JAX package's ``compress_ref`` / ``decompress_ref`` semantics."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def compress_ref(x, w, b, *, out_dtype=torch.float16):
    """x: [..., d] -> [..., e]: GELU_tanh(x @ w + b), cast."""
    h = x.float() @ w.float() + b.float()
    return F.gelu(h, approximate="tanh").to(out_dtype)


def decompress_ref(r, w, b, gamma, beta, *, out_dtype=torch.float32,
                   eps: float = 1e-6):
    """r: [..., e] -> [..., d]: LayerNorm(r @ w + b) * gamma + beta, cast."""
    h = r.float() @ w.float() + b.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = (h - mu).square().mean(dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * gamma.float() + beta.float()).to(out_dtype)
