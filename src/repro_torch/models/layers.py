"""Shared NN layers (the PreTTR subset of ``repro.models.layers``), as
plain functions over dicts of tensors.

Matmuls run in the compute dtype; normalisation statistics and softmax in
float32.  Parameters stay in their own dtype and are cast at the use site,
as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30          # finite mask value: all-pad rows stay finite


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dtype)


def apply_norm(params: dict, x):
    return layer_norm(x, params["scale"], params["bias"])


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(params: dict, x):
    """Ungated BERT MLP with biases; ``params`` already in ``x``'s dtype."""
    h = gelu(x @ params["w_in"] + params["b_in"])
    return h @ params["w_out"] + params["b_out"]


def repeat_kv(k, n_rep: int):
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D]: head h reads KV head
    h // n_rep."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def plain_attention(q, k, v, mask, *, scale: float):
    """Reference O(S^2)-memory attention.  q: [B, Sq, Hq, D]; k, v:
    [B, Skv, Hkv, D]; mask broadcastable to [B, 1, Sq, Skv] (True =
    attend).  Logits in float32, probabilities cast to ``v``'s dtype
    before the second product, as ``repro.models.layers.plain_attention``."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def decode_attention(q, k_cache, v_cache, *, scale: float, k_pos, q_pos,
                     window=-1, k_valid=None):
    """One query row against a K/V sequence, as
    ``repro.models.layers.decode_attention``.  q: [B, 1, Hq, D]; k_cache,
    v_cache: [B, S, Hkv, D]; k_pos: [B, S] and q_pos: [B, 1] positions;
    keys attend when ``k_pos <= q_pos``, inside ``window`` (> 0) and
    ``k_valid``.  Logits in float32, probabilities cast to V's dtype
    before the second product."""
    n_rep = q.shape[2] // k_cache.shape[2]
    kk, vv = repeat_kv(k_cache, n_rep), repeat_kv(v_cache, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    msk = dk <= dq
    if window >= 0:
        msk = msk & (dq - dk < window)
    if k_valid is not None:
        msk = msk & k_valid.bool()[..., None, :]
    s = s.masked_fill(~msk[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype), vv)
