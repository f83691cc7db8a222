"""PreTTR term-representation compression (paper section 4.2), the port
of ``repro.core.compression``.

Compress:   r    = GELU(s_l @ W_comp + b_comp)            # d -> e
Decompress: s_hat = LayerNorm(r @ W_decomp + b_decomp)   # e -> d

The compressor's training loss is the paper's Eq. 2,
:func:`attention_mse_loss`: the mean squared error between the attention
probabilities of layers ``l..n-1`` with and without the round trip,
captured by a plain-attention forward (:func:`forward_capture_attention`).
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


def compressor_axes() -> dict:
    """The logical axes of :func:`init_compressor`'s tree."""
    return {"w_comp": ("embed", None), "b_comp": (None,),
            "w_decomp": (None, "embed"), "b_decomp": ("embed",),
            "ln": {"scale": ("embed",), "bias": ("embed",)}}


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


# ---------------------------------------------------------------------------
# Attention-capture forward + Eq. (2) loss
# ---------------------------------------------------------------------------


def _attn_probs_one_layer(lp, x, cfg, *, positions, segs, valid, window):
    """A plain-attention layer step that also returns the attention
    probabilities [B, H, S, S] float32, as the reference's: Q/K/V without
    their biases or qk-norm, no post-norms, keys and queries masked by
    ``valid`` (``segs`` is unused there too).  Used only to train the
    compressor, on short sequences, so materialising the probabilities
    is fine."""
    del segs
    b, s, _ = x.shape
    dh = cfg.dh
    cd = cfg.compute_dtype
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    p = lp["attn"]
    q = (h @ p["wq"].to(cd)).reshape(b, s, cfg.n_heads, dh)
    k = (h @ p["wk"].to(cd)).reshape(b, s, cfg.n_kv_heads, dh)
    v = (h @ p["wv"].to(cd)).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.rope:
        q = L.rope(q, positions, base=cfg.rope_base,
                   fraction=cfg.rope_fraction)
        k = L.rope(k, positions, base=cfg.rope_base,
                   fraction=cfg.rope_fraction)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kk, vv = L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) \
        / math.sqrt(dh)
    mask = L.attention_mask(positions, positions, causal=cfg.causal,
                            window=window, q_valid=valid, k_valid=valid)
    logits = logits.masked_fill(~mask[:, None], L.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vv.dtype), vv)
    out = out.reshape(b, s, cfg.n_heads * dh) @ p["wo"].to(cd)
    x = x + out
    h2 = L.apply_norm(lp["ln2"], x, cfg.norm)
    mlp_p = {k_: w.to(cd) for k_, w in lp["mlp"].items()}
    x = x + L.mlp(mlp_p, h2, gated=cfg.gated_mlp, activation=cfg.activation)
    return x, probs


def forward_capture_attention(params, cfg, x, lo: int, hi: int, *,
                              positions, segs=None, valid=None):
    """Layers [lo, hi) with plain attention over ``x`` [B, S, d]; returns
    ``(x, probs [hi - lo, B, H, S, S])``."""
    windows = cfg.layer_windows()
    probs = []
    for i in range(lo, hi):
        x, pr = _attn_probs_one_layer(params["layers"][i], x, cfg,
                                      positions=positions, segs=segs,
                                      valid=valid, window=windows[i])
        probs.append(pr)
    return x, torch.stack(probs)


def attention_mse_loss(params, comp_params, cfg, tokens, *, l: int,
                       valid=None, store_dtype=torch.float16):
    """Paper Eq. (2): the mean over layers ``l..n-1`` of the MSE between
    the attention probabilities of the compressed and the uncompressed
    network.  ``params`` is the backbone, a frozen teacher (its
    probabilities are detached); only ``comp_params`` is meant to get
    gradients.  Layers ``0..l`` run through ``cfg.attn_impl`` (no
    gradient needs to pass them); the round trip runs the plain
    compressor, as the reference's default impl does, so autograd
    reaches its weights."""
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x0 = T.embed(params, cfg, tokens, positions, None)
    x_l = T.run_layer_range(params, cfg, x0, 0, l, positions=positions,
                            valid=valid)
    _, probs_t = forward_capture_attention(params, cfg, x_l, l, cfg.n_layers,
                                           positions=positions, valid=valid)
    x_hat = roundtrip(comp_params, x_l, store_dtype=store_dtype,
                      compute_dtype=cfg.compute_dtype, impl="plain")
    _, probs_s = forward_capture_attention(params, cfg, x_hat, l,
                                           cfg.n_layers, positions=positions,
                                           valid=valid)
    per_layer = (probs_s - probs_t.detach()).square().mean(dim=(1, 2, 3, 4))
    return per_layer.mean()
