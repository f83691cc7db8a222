"""Shared NN layers (``repro.models.layers``), as plain functions over dicts
of tensors.

Matmuls run in the compute dtype; normalisation statistics and softmax in
float32.  Parameters stay in their own dtype and are cast at the use site,
as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30          # finite mask value: all-pad rows stay finite


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm scaling by ``1 + scale`` (zero-initialised scales), float32
    inside."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dtype)


def mm_f32(a, b):
    """``a @ b`` (2-D) summed and returned in float32, not rounded to the
    operands' 16-bit type (JAX's ``preferred_element_type``).  On the card
    a 16-bit product asks cuBLAS for a float32 output; elsewhere the
    operands are widened first, which is exact (a 16-bit product fits a
    float32)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                         torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def norm_axes(kind: str) -> dict:
    """The logical axes of a norm's params (``repro.models.layers.
    init_norm``'s second return)."""
    if kind == "rmsnorm":
        return {"scale": ("embed",)}
    return {"scale": ("embed",), "bias": ("embed",)}


def mlp_axes(*, gated: bool, bias: bool = False) -> dict:
    """The logical axes of an MLP's params (``init_mlp``'s second
    return)."""
    if gated:
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
    ax = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}
    if bias:
        ax.update(b_in=("mlp",), b_out=("embed",))
    return ax


def apply_norm(params: dict, x, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope(x, positions, *, base: float = 10000.0, fraction: float = 1.0):
    """RoPE on ``x [..., S, H, D]`` at ``positions [..., S]``; only the
    first ``fraction * D`` dims (rounded down to even) rotate.  Angles are
    float32: ``positions / base ** (arange(half) / half)``."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    exponents = torch.arange(half, dtype=torch.float32,
                             device=x.device) / half
    # a Python base, not a device tensor: a host-to-device copy would
    # wait for the stream on every call
    timescale = torch.pow(float(base), exponents)
    angles = positions.float()[..., None, None] / timescale
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_mask(q_pos, k_pos, *, causal: bool, window: int,
                   q_seg=None, k_seg=None, split_segments: bool = False,
                   q_valid=None, k_valid=None):
    """Boolean ``[**, Sq, Skv]`` mask, True = may attend.  ``window < 0``
    disables windowing; ``split_segments`` keeps tokens inside their own
    segment (the PreTTR split mask)."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                   dtype=torch.bool, device=dq.device)
    if causal:
        m = m & (dk <= dq)
    if window >= 0:
        m = m & (dq - dk < window)
    if q_seg is not None and k_seg is not None and split_segments:
        m = m & (q_seg[..., :, None] == k_seg[..., None, :])
    if q_valid is not None:
        m = m & q_valid.bool()[..., :, None]
    if k_valid is not None:
        m = m & k_valid.bool()[..., None, :]
    return m


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
    msk = attention_mask(q_pos, k_pos, causal=True, window=window,
                         k_valid=k_valid)
    s = s.masked_fill(~msk[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype), vv)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}


def mlp(params: dict, x, *, gated: bool, activation: str):
    """Gated (``act(x Wg) * x Wu -> Wd``) or plain MLP with optional
    biases; ``params`` already in ``x``'s dtype."""
    act = ACTIVATIONS[activation]
    if gated:
        return (act(x @ params["w_gate"]) * (x @ params["w_up"])) \
            @ params["w_down"]
    h = x @ params["w_in"]
    if "b_in" in params:
        h = h + params["b_in"]
    out = act(h) @ params["w_out"]
    if "b_out" in params:
        out = out + params["b_out"]
    return out
