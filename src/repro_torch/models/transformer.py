"""The encoder subset of ``repro.models.transformer`` that PreTTR-BERT
runs: config, embeddings, Q/K/V projections, the block tail and a plain
Python loop over a range of layers.

Parameters are plain dicts of tensors; ``params["layers"]`` is a list with
one dict per layer (the JAX package stacks them on a leading axis;
``repro_torch.bridge`` slices them).  Learned positions only: no RoPE,
windows, qk-norm or MoE.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import backend as B
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int | None = None          # defaults to d_model // n_heads
    causal: bool = False                 # not ported: raises in attention
    learned_pos: int = 0                 # learned position table size
    segment_vocab: int = 0               # segment embedding table size
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "cuda"              # "plain" | "cuda"
    compress_impl: str = "cuda"          # "plain" | "cuda"
    # PreTTR hook: layers below split_layers mask query<->doc attention
    split_layers: int = 0

    def __post_init__(self):
        # unknown impl names fail here, not at the first forward
        B.validate_config(self.attn_impl, self.compress_impl)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def embed(params, cfg: TransformerConfig, tokens, positions, segs):
    """Token + learned-position + segment embeddings in compute dtype."""
    cd = cfg.compute_dtype
    emb = params["embed"]
    x = emb["tokens"][tokens].to(cd)
    if cfg.learned_pos:
        x = x + emb["pos"][positions].to(cd)
    if cfg.segment_vocab and segs is not None:
        x = x + emb["segment"][segs].to(cd)
    return x


def project_q(p, x, cfg: TransformerConfig):
    """Q projection in model layout ``[B, S, Hq, Dh]``."""
    b, s, _ = x.shape
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, cfg.n_heads, cfg.dh)
    return q + p["bq"].to(cd).reshape(cfg.n_heads, cfg.dh)


def project_kv(p, x, cfg: TransformerConfig):
    """K/V projections in model layout ``[B, S, Hkv, Dh]``."""
    b, s, _ = x.shape
    cd = cfg.compute_dtype
    k = (x @ p["wk"].to(cd)).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    v = (x @ p["wv"].to(cd)).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    k = k + p["bk"].to(cd).reshape(cfg.n_kv_heads, cfg.dh)
    v = v + p["bv"].to(cd).reshape(cfg.n_kv_heads, cfg.dh)
    return k, v


def block_tail(lp, cfg: TransformerConfig, x, attn_out):
    """Everything after attention in a block: residual, LayerNorm, MLP,
    residual.  Shared by the layer step and the split-residual join."""
    cd = cfg.compute_dtype
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x)
    mlp_p = {k: v.to(cd) for k, v in lp["mlp"].items()}
    return x + L.mlp(mlp_p, h)


def layer_step(lp, x, cfg: TransformerConfig, *, split_flag: bool, segs,
               valid, seg_boundary: int = -1):
    """One full block over ``x [B, S, d]``."""
    b, s, _ = x.shape
    h = L.apply_norm(lp["ln1"], x)
    p = lp["attn"]
    q = project_q(p, h, cfg)
    k, v = project_kv(p, h, cfg)
    out = B.get_impl("attention", cfg.attn_impl)(
        q, k, v, cfg=cfg, scale=1.0 / math.sqrt(cfg.dh),
        split_flag=split_flag, segs=segs, valid=valid,
        seg_boundary=seg_boundary)
    attn_out = out.reshape(b, s, cfg.n_heads * cfg.dh) \
        @ p["wo"].to(cfg.compute_dtype)
    return block_tail(lp, cfg, x, attn_out)


def run_layer_range(params, cfg: TransformerConfig, x, lo: int, hi: int, *,
                    segs=None, valid=None, seg_boundary: int = -1):
    """Run layers [lo, hi) over already-embedded ``x``: the hook PreTTR
    uses for precompute (0..l) and join (l..n).  Layers below
    ``cfg.split_layers`` carry the split mask: by segment ids in the plain
    impl, at the static token index ``seg_boundary`` in the kernel impl
    (-1 = single segment)."""
    for i in range(lo, hi):
        x = layer_step(params["layers"][i], x, cfg,
                       split_flag=i < cfg.split_layers, segs=segs,
                       valid=valid, seg_boundary=seg_boundary)
    return x
