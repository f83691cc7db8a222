"""PreTTR term-representation compression (paper section 4.2), the port
of ``repro.core.compression``.

Compress:   r    = GELU(s_l @ W_comp + b_comp)            # d -> e
Decompress: s_hat = LayerNorm(r @ W_decomp + b_decomp)   # e -> d
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import backend as B
from repro_torch.models import layers as L


def init_compressor(d: int, e: int, generator: torch.Generator, device,
                    dtype=torch.float32) -> dict:
    """Same tree and scales as the JAX ``init_compressor``."""
    def dense(d_in, d_out):
        w = torch.randn((d_in, d_out), generator=generator,
                        device=generator.device) / math.sqrt(d_in)
        return w.to(device=device, dtype=dtype)

    zeros = lambda n: torch.zeros((n,), device=device, dtype=dtype)
    return {"w_comp": dense(d, e), "b_comp": zeros(e),
            "w_decomp": dense(e, d), "b_decomp": zeros(d),
            "ln": {"scale": torch.ones((d,), device=device, dtype=dtype),
                   "bias": zeros(d)}}


def compress_plain(params: dict, s_l, *, store_dtype=torch.float16):
    """[..., d] -> [..., e] in ``s_l``'s dtype, stored as ``store_dtype``:
    the "plain" backend (``repro.core.compression.compress_jnp``)."""
    dt = s_l.dtype
    r = L.gelu(s_l @ params["w_comp"].to(dt) + params["b_comp"].to(dt))
    return r.to(store_dtype)


def decompress_plain(params: dict, r, *, compute_dtype=torch.bfloat16):
    """[..., e] -> [..., d] in ``compute_dtype``: the "plain" backend
    (``repro.core.compression.decompress_jnp``)."""
    r = r.to(compute_dtype)
    s_hat = r @ params["w_decomp"].to(compute_dtype) \
        + params["b_decomp"].to(compute_dtype)
    return L.layer_norm(s_hat, params["ln"]["scale"], params["ln"]["bias"])


def compress(params: dict, s_l, *, store_dtype=torch.float16, impl="cuda"):
    return B.get_impl("compress", impl)(params, s_l, store_dtype=store_dtype)


def decompress(params: dict, r, *, compute_dtype=torch.bfloat16,
               impl="cuda"):
    return B.get_impl("decompress", impl)(params, r,
                                          compute_dtype=compute_dtype)


def roundtrip(params: dict, s_l, *, store_dtype=torch.float16,
              compute_dtype=torch.bfloat16, impl="cuda"):
    return decompress(params, compress(params, s_l, store_dtype=store_dtype,
                                       impl=impl),
                      compute_dtype=compute_dtype, impl=impl)
