"""Shared NN layers (``repro.models.layers``), as plain functions over dicts
of tensors.

Matmuls run in the compute dtype; normalisation statistics and softmax in
float32.  Parameters stay in their own dtype and are cast at the use site,
as in the JAX package.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def _blocked_step(o, m, l, qh, q_pos, q_seg, kblk, vblk, kp, ks, kvd, *,
                  n_rep, scale, causal, window, split_segments):
    """One KV block of :func:`blocked_attention`: its float32 scores, mask
    and online-softmax update of the carries ``(o, m, l)``."""
    kblk = repeat_kv(kblk, n_rep).transpose(1, 2)       # [B, H, bk, D]
    vblk = repeat_kv(vblk, n_rep).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kblk.float()) * scale
    msk = attention_mask(q_pos, kp, causal=causal, window=window,
                         q_seg=q_seg, k_seg=ks, split_segments=split_segments,
                         k_valid=kvd)
    s = s.masked_fill(~msk[:, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(vblk.dtype).float(), vblk.float())
    return o_new, m_new, l_new


def blocked_attention(q, k, v, *, scale: float, block_kv: int, q_pos, k_pos,
                      causal: bool, window=-1, q_seg=None, k_seg=None,
                      split_segments=False, k_valid=None):
    """Flash-style attention in plain PyTorch, as
    ``repro.models.layers.blocked_attention``: a loop over KV blocks of
    ``block_kv`` keys with an online softmax, so the ``[Sq, Skv]`` scores
    are never formed.  Under autograd each block step runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``), so the
    backward holds one block's ``[Sq, block_kv]`` scores at a time and
    the carries ``(o, m, l)`` of every block, O(Sq * block_kv) memory.

    q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] (GQA repeated a block at a
    time); q_pos [B, Sq], k_pos [B, Skv].  Skv is padded up to a multiple
    of ``block_kv`` with invalid keys.  Scores and the carries are
    float32, probabilities cast to V's dtype before the second product;
    no block is skipped, masked or not."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    nblocks = -(-skv // block_kv)
    pad = nblocks * block_kv - skv
    dev = q.device
    if k_valid is None:
        k_valid = torch.ones((b, skv), dtype=torch.bool, device=dev)
    if k_seg is None:
        k_seg = torch.zeros((b, skv), dtype=torch.int32, device=dev)
    if q_seg is None:
        q_seg = torch.zeros((b, sq), dtype=torch.int32, device=dev)
    k_pos = k_pos.expand(b, skv)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad))
        k_valid = F.pad(k_valid.bool(), (0, pad), value=False)
        k_seg = F.pad(k_seg, (0, pad), value=-1)
    qh = q.transpose(1, 2).float()                      # [B, H, Sq, D]
    # the step's tensors are its arguments, never its closure's: a
    # checkpoint keeps its function alive until the backward, and with it
    # whatever the function closes over
    step = functools.partial(
        _blocked_step, n_rep=n_rep, scale=scale, causal=causal,
        window=window, split_segments=split_segments)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    o = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    for i in range(nblocks):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        xs = (o, m, l, qh, q_pos, q_seg, k[:, blk], v[:, blk], k_pos[:, blk],
              k_seg[:, blk], k_valid[:, blk])
        if remat:
            o, m, l = checkpoint(step, *xs, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            o, m, l = step(*xs)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)                # [B, Sq, H, D]


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
