"""PreTTR: Precomputing Transformer Term Representations (paper section 4),
the port of ``repro.core.prettr``.

* **Index** -- :func:`precompute_docs` runs documents alone through layers
  ``0..l`` and returns the (compressed, fp16) term reps the index stores.
* **Query** -- :func:`encode_query` runs the query through layers ``0..l``
  once; :func:`join_and_score` decodes the stored reps and runs layers
  ``l..n-1`` over the split residual (query and doc segments stay separate
  tensors; attention runs over the split K/V pair through the
  ``join_attention`` backend op), finishing with a CLS-only final layer.
  ``fused=False`` is the legacy concat join: it materialises
  ``[B, Lq + Ld, d]``, runs the join layers over it through the
  ``attention`` op and ends in :func:`_cls_only_layer`, a decode-shaped
  attention through the ``decode_attention`` op.
* **Train-time forward** -- :func:`rank_forward` runs the joint input with
  the split mask below ``l`` and the same :func:`_cls_only_layer`.  It is
  kept for the soundness invariant ``rank_forward ==
  join_and_score(encode_query, precompute_docs)`` up to storage rounding.

* **Stored layer-``l`` K/V** -- :func:`precompute_doc_kv` moves the
  join's query-invariant doc-side K/V projections of layer ``l`` to index
  time; ``join_and_score(..., doc_kv=...)`` takes them dense (float, or
  raw int8 with per-token scales) or as a :class:`PagedDocKV` view of the
  device doc cache's page pools.

* **Index-time pruning** -- :func:`doc_salience` scores each stored doc
  token by the attention mass it receives at layer ``l``; the builder
  keeps each doc's most salient tokens.

Not ported yet: ``rank_pairs_loss`` (training).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import compression as C
from repro_torch.device import resolve_device
from repro_torch.models import backend as B
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class PreTTRConfig:
    backbone: T.TransformerConfig
    l: int = 6                       # layers precomputed
    max_query_len: int = 32          # [CLS] + query + [SEP], padded
    max_doc_len: int = 224           # doc + trailing [SEP], padded
    compress_dim: int = 0            # e; 0 disables compression
    store_dtype: torch.dtype = torch.float16
    cls_only_last_layer: bool = True

    def __post_init__(self):
        if self.backbone.causal:
            raise ValueError("the PreTTR backbone is a bidirectional encoder")
        if self.backbone.split_layers != self.l:
            raise ValueError("backbone.split_layers must equal "
                             "PreTTRConfig.l")
        if not 0 <= self.l < self.backbone.n_layers:
            raise ValueError(f"l={self.l} outside [0, "
                             f"{self.backbone.n_layers})")


def make_backbone(n_layers=12, d_model=768, n_heads=12, d_ff=3072,
                  vocab_size=30522, l=6, max_len=256, n_kv_heads=None,
                  **kw) -> T.TransformerConfig:
    """A Vanilla-BERT-style encoder (the paper's base model family)."""
    return T.TransformerConfig(
        name="prettr_bert", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv_heads or n_heads, d_ff=d_ff,
        vocab_size=vocab_size, causal=False, rope=False,
        learned_pos=max_len, segment_vocab=2, norm="layernorm",
        gated_mlp=False, activation="gelu", mlp_bias=True, qkv_bias=True,
        split_layers=l, **kw)


def init_prettr(cfg: PreTTRConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the JAX ``init_prettr`` tree (per-layer list
    instead of stacked leaves; no ``lm_head``) and scales: the backbone
    from :func:`repro_torch.models.transformer.init_params`.  Normals are
    drawn on ``generator``'s device, then moved to ``device`` (``None``
    means the card)."""
    dev = resolve_device(device)
    bb = cfg.backbone
    backbone = T.init_params(bb, generator, dev)
    backbone.pop("lm_head", None)
    score = torch.randn((bb.d_model, 1), generator=generator,
                        device=generator.device) / math.sqrt(bb.d_model)
    params = {"backbone": backbone,
              "score_head": score.to(device=dev, dtype=bb.param_dtype)}
    if cfg.compress_dim:
        params["compressor"] = C.init_compressor(bb.d_model, cfg.compress_dim,
                                                 generator, dev,
                                                 bb.param_dtype)
    return params


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _score_from_cls(params, cfg: PreTTRConfig, cls_rep):
    """cls_rep: [B, d] -> [B] float32 ranking score."""
    h = L.apply_norm(params["backbone"]["final_norm"], cls_rep,
                     cfg.backbone.norm)
    return (h @ params["score_head"].to(h.dtype))[..., 0].float()


def _decode_doc_store(params, cfg: PreTTRConfig, doc_store):
    """Index bytes -> join-input doc reps [B, Ld, d] in compute dtype."""
    bcfg = cfg.backbone
    if cfg.compress_dim:
        return C.decompress(params["compressor"], doc_store,
                            compute_dtype=bcfg.compute_dtype,
                            impl=bcfg.compress_impl)
    return doc_store.to(bcfg.compute_dtype)


def _positions(start: int, n: int, b: int, device):
    return (start + torch.arange(n, device=device)).expand(b, n)


def _cls_only_layer(lp, x, cfg: T.TransformerConfig, *, positions, valid):
    """Final layer computing only the [CLS] (index 0) row of attention
    (paper section 6.3): a decode-shaped attention through the
    ``decode_attention`` backend op (the flash-decode kernel under
    ``"cuda"``).  x: [B, S, d]; positions, valid: [B, S] -> cls rep
    [B, d]."""
    b = x.shape[0]
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    p = lp["attn"]
    q = T.project_q(p, h[:, :1], cfg)
    k, v = T.project_kv(p, h, cfg)
    # bidirectional: the query row sits past every key
    q_pos = torch.full((b, 1), (2**31 - 1) // 2, dtype=positions.dtype,
                       device=x.device)
    out = B.get_impl("decode_attention", cfg.attn_impl)(
        q, k, v, cfg=cfg, scale=1.0 / math.sqrt(cfg.dh), k_pos=positions,
        q_pos=q_pos, window=-1, k_valid=valid, static_window=-1)
    out = out.reshape(b, 1, cfg.n_heads * cfg.dh) \
        @ p["wo"].to(cfg.compute_dtype)
    return T.block_tail(lp, cfg, x[:, :1], out)[:, 0]


# ---------------------------------------------------------------------------
# Train-time joint forward
# ---------------------------------------------------------------------------


def rank_forward(params, cfg: PreTTRConfig, tokens, segs, valid):
    """Joint [CLS];q;[SEP];d;[SEP] forward with the split mask in layers
    0..l and the compressor round trip on doc tokens.  tokens/segs/valid:
    [B, S] with S = max_query_len + max_doc_len.  Returns scores [B]."""
    bcfg = cfg.backbone
    b, s = tokens.shape
    positions = _positions(0, s, b, tokens.device)
    x = T.embed(params["backbone"], bcfg, tokens, positions, segs)
    x = T.run_layer_range(params["backbone"], bcfg, x, 0, cfg.l, segs=segs,
                          valid=valid, seg_boundary=cfg.max_query_len)
    if cfg.compress_dim:
        x_hat = C.roundtrip(params["compressor"], x,
                            store_dtype=cfg.store_dtype,
                            compute_dtype=bcfg.compute_dtype,
                            impl=bcfg.compress_impl)
        x = torch.where((segs == 1)[..., None], x_hat, x)
    last = bcfg.n_layers - (1 if cfg.cls_only_last_layer else 0)
    x = T.run_layer_range(params["backbone"], bcfg, x, cfg.l, last,
                          segs=segs, valid=valid)
    if cfg.cls_only_last_layer:
        cls = _cls_only_layer(params["backbone"]["layers"][-1], x, bcfg,
                              positions=positions, valid=valid)
    else:
        cls = x[:, 0]
    return _score_from_cls(params, cfg, cls)


# ---------------------------------------------------------------------------
# Index-time / query-time split execution
# ---------------------------------------------------------------------------


def precompute_docs(params, cfg: PreTTRConfig, doc_tokens, doc_valid):
    """Index time: [N, Ld] doc tokens -> stored reps [N, Ld, e or d] in
    ``store_dtype``.  Documents sit at positions ``max_query_len + i``,
    their joint-forward positions."""
    bcfg = cfg.backbone
    n, ld = doc_tokens.shape
    segs = torch.ones((n, ld), dtype=torch.long, device=doc_tokens.device)
    x = T.embed(params["backbone"], bcfg, doc_tokens,
                _positions(cfg.max_query_len, ld, n, doc_tokens.device), segs)
    x = T.run_layer_range(params["backbone"], bcfg, x, 0, cfg.l, segs=segs,
                          valid=doc_valid)
    if cfg.compress_dim:
        return C.compress(params["compressor"], x,
                          store_dtype=cfg.store_dtype,
                          impl=bcfg.compress_impl)
    return x.to(cfg.store_dtype)


def precompute_doc_kv(params, cfg: PreTTRConfig, doc_store):
    """Index time: layer-``l`` doc-side K/V from the *stored* reps
    ``doc_store`` [N, Ld, e|d] (as :func:`precompute_docs` returned them,
    or decoded from the index's codec), so they match what the join would
    recompute from the index bytes.  Returns ``(k, v)`` each
    [N, Ld, n_kv_heads * dh] in ``cfg.store_dtype``."""
    bcfg = cfg.backbone
    x_d = _decode_doc_store(params, cfg, doc_store)
    n, ld, _ = x_d.shape
    lp = params["backbone"]["layers"][cfg.l]
    h_d = L.apply_norm(lp["ln1"], x_d, bcfg.norm)
    k, v = T.project_kv(lp["attn"], h_d, bcfg)
    flat = bcfg.n_kv_heads * bcfg.dh
    return (k.reshape(n, ld, flat).to(cfg.store_dtype),
            v.reshape(n, ld, flat).to(cfg.store_dtype))


def encode_query(params, cfg: PreTTRConfig, q_tokens, q_valid):
    """Query time: [B, Lq] -> query reps [B, Lq, d] through layers 0..l."""
    bcfg = cfg.backbone
    b, lq = q_tokens.shape
    segs = torch.zeros((b, lq), dtype=torch.long, device=q_tokens.device)
    x = T.embed(params["backbone"], bcfg, q_tokens,
                _positions(0, lq, b, q_tokens.device), segs)
    return T.run_layer_range(params["backbone"], bcfg, x, 0, cfg.l,
                             segs=segs, valid=q_valid)


def doc_salience(params, cfg: PreTTRConfig, doc_store, doc_valid):
    """Index-time token salience for pruning: the attention mass each
    stored doc token receives at join layer ``l`` from the valid tokens of
    its own document.

    ``doc_store`` [N, Ld, e|d] as :func:`precompute_docs` returned it;
    decoded as the join decodes it, then layer ``l``'s ``ln1`` and Q/K
    projections at positions ``max_query_len + arange(Ld)``.  Each valid
    query row is softmaxed over the valid keys in float32 (a finite mask,
    so an all-pad row cannot give NaN); the weight landing on each key is
    summed over rows and averaged over heads.  Returns [N, Ld] float32, 0
    at invalid positions.  Plain PyTorch: it needs the attention weights,
    which no kernel returns."""
    bcfg = cfg.backbone
    x_d = _decode_doc_store(params, cfg, doc_store)
    n, ld, _ = x_d.shape
    pos_d = _positions(cfg.max_query_len, ld, n, x_d.device)
    lp = params["backbone"]["layers"][cfg.l]
    h_d = L.apply_norm(lp["ln1"], x_d, bcfg.norm)
    rope_base = bcfg.layer_rope_bases()[cfg.l]
    q = T.project_q(lp["attn"], h_d, bcfg, positions=pos_d,
                    rope_base=rope_base)                   # [N, Ld, H, Dh]
    k, _ = T.project_kv(lp["attn"], h_d, bcfg, positions=pos_d,
                        rope_base=rope_base)               # [N, Ld, Hkv, Dh]
    k = L.repeat_kv(k, bcfg.n_heads // bcfg.n_kv_heads)
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) \
        / math.sqrt(bcfg.dh)
    v = doc_valid.bool()
    logits = torch.where(v[:, None, None, :], logits,
                         torch.full((), -1e30, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(v[:, None, :, None], w, torch.zeros((), device=w.device))
    return (w.sum(dim=2).mean(dim=1) * v).float()


@dataclasses.dataclass
class PagedDocKV:
    """Stored layer-``l`` doc K/V in the device doc cache's token-page
    pools, consumed by the join without a dense per-batch copy.

    ``k``/``v``: [P, page, Hkv, Dh] pools; ``valid``: [P, page] byte pool
    (the cache's page 0 is all zero, so page-table tails mask
    themselves); ``page_table``: [B, nP] int32; ``k_scale``/``v_scale``:
    optional [P, page, 1] float32 scale pools of raw int8 K/V pools."""
    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    page_table: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


@dataclasses.dataclass
class JoinState:
    """Query-time join operands, segment-resident: the two segments stay
    separate tensors end to end.  ``doc_k``/``doc_v`` are the index's
    stored layer-``l`` K/V in model layout (layer ``l`` then skips the
    doc-side K/V projections); with ``doc_k_scale``/``doc_v_scale`` they
    are raw int8 payload, dequantised inside the join.  ``doc_kv_paged``
    replaces the dense pair with a :class:`PagedDocKV`.  ``fused`` picks
    the path :func:`score_join` runs: the split residual, or the legacy
    concat join."""
    x_q: torch.Tensor                # [B, Lq, d] query reps (compute dtype)
    q_valid: torch.Tensor            # [B, Lq] bool
    x_d: torch.Tensor                # [B, Ld, d] decoded doc reps
    d_valid: torch.Tensor            # [B, Ld] bool
    doc_k: torch.Tensor | None = None        # [B, Ld, Hkv, Dh]
    doc_v: torch.Tensor | None = None        # [B, Ld, Hkv, Dh]
    doc_k_scale: torch.Tensor | None = None  # [B, Ld] f32 (raw int8 doc_k)
    doc_v_scale: torch.Tensor | None = None  # [B, Ld] f32 (raw int8 doc_v)
    doc_kv_paged: PagedDocKV | None = None
    fused: bool = True


def _stored_kv_operand(st: JoinState):
    """The stored-K/V operand of a JoinState in the form the split layers
    dispatch on: None, (k, v), (k, v, ks, vs) or a PagedDocKV."""
    if st.doc_kv_paged is not None:
        return st.doc_kv_paged
    if st.doc_k is None:
        return None
    if st.doc_k_scale is not None:
        return (st.doc_k, st.doc_v, st.doc_k_scale, st.doc_v_scale)
    return (st.doc_k, st.doc_v)


def prepare_join(params, cfg: PreTTRConfig, q_reps, q_valid, doc_store,
                 doc_valid, *, doc_kv=None, fused: bool = True) -> JoinState:
    """Decode the index payload and build the :class:`JoinState`.
    ``doc_kv`` supplies the stored layer-``l`` streams in one of three
    forms: ``(k, v)`` floats each [B, Ld, n_kv_heads * dh];
    ``(k, v, k_scale, v_scale)`` int8 payload with [B, Ld] float32 scales
    (dequantised inside the join); or a :class:`PagedDocKV` whose pools
    may arrive flat ([P, page, d_kv], [P, page] scales) from the device
    doc cache and are reshaped to the kernel's page layout here.
    ``fused=False`` (the legacy concat path) takes no stored K/V."""
    if doc_kv is not None and not fused:
        raise ValueError(
            "stored layer-l doc K/V streams require the fused join path "
            "(the legacy concat path re-projects at layer l)")
    bcfg = cfg.backbone
    x_d = _decode_doc_store(params, cfg, doc_store)
    doc_k = doc_v = doc_k_scale = doc_v_scale = paged = None
    if doc_kv is not None:
        b, ld = x_d.shape[0], x_d.shape[1]
        hkv, dh = bcfg.n_kv_heads, bcfg.dh
        if isinstance(doc_kv, PagedDocKV):
            page = doc_kv.k.shape[1]
            paged = PagedDocKV(
                k=doc_kv.k.reshape(-1, page, hkv, dh),
                v=doc_kv.v.reshape(-1, page, hkv, dh),
                valid=doc_kv.valid, page_table=doc_kv.page_table,
                k_scale=(None if doc_kv.k_scale is None
                         else doc_kv.k_scale.reshape(-1, page, 1)),
                v_scale=(None if doc_kv.v_scale is None
                         else doc_kv.v_scale.reshape(-1, page, 1)))
        elif len(doc_kv) == 4:
            # raw int8 payload keeps its narrow dtype: the join dequantises
            k, v, doc_k_scale, doc_v_scale = doc_kv
            doc_k = k.reshape(b, ld, hkv, dh)
            doc_v = v.reshape(b, ld, hkv, dh)
        else:
            doc_k, doc_v = (a.reshape(b, ld, hkv, dh).to(bcfg.compute_dtype)
                            for a in doc_kv)
    return JoinState(x_q=q_reps.to(bcfg.compute_dtype),
                     q_valid=q_valid.bool(), x_d=x_d,
                     d_valid=doc_valid.bool(), doc_k=doc_k, doc_v=doc_v,
                     doc_k_scale=doc_k_scale, doc_v_scale=doc_v_scale,
                     doc_kv_paged=paged, fused=fused)


def _unpack_stored_kv(doc_kv):
    """A stored-K/V operand -> ``(kd, vd, kd_scale, vd_scale, paged)``, the
    operand set of the ``join_attention`` impls."""
    if isinstance(doc_kv, PagedDocKV):
        return None, None, None, None, doc_kv
    if len(doc_kv) == 4:
        kd, vd, ks, vs = doc_kv
        return kd, vd, ks, vs, None
    kd, vd = doc_kv
    return kd, vd, None, None, None


def _join_layer_split(lp, bcfg: T.TransformerConfig, x_q, x_d, q_valid,
                      d_valid, doc_kv=None):
    """One join layer over the split residual (x_q, x_d).  Every
    non-attention op is row-wise, so running it per segment equals running
    it on the concatenation; the Q blocks are stacked so each layer issues
    one attention call over the split K/V pair.  ``doc_kv`` (layer ``l``
    only): the stored doc K/V, which replace the doc-side projections."""
    dh = bcfg.dh
    lq = x_q.shape[1]
    p = lp["attn"]
    h_q = L.apply_norm(lp["ln1"], x_q, bcfg.norm)
    h_d = L.apply_norm(lp["ln1"], x_d, bcfg.norm)
    kq, vq = T.project_kv(p, h_q, bcfg)
    if doc_kv is None:
        kd, vd = T.project_kv(p, h_d, bcfg)
        kd_scale = vd_scale = paged = None
    else:
        kd, vd, kd_scale, vd_scale, paged = _unpack_stored_kv(doc_kv)
    q = torch.cat([T.project_q(p, h_q, bcfg), T.project_q(p, h_d, bcfg)],
                  dim=1)
    out = B.get_impl("join_attention", bcfg.attn_impl)(
        q, kq, vq, kd, vd, cfg=bcfg, scale=1.0 / math.sqrt(dh),
        q_valid=torch.cat([q_valid, d_valid], dim=1), kq_valid=q_valid,
        kd_valid=d_valid, kd_scale=kd_scale, vd_scale=vd_scale, paged=paged)
    wo = p["wo"].to(bcfg.compute_dtype)

    def finish(x, o):
        attn_out = o.reshape(x.shape[0], x.shape[1], bcfg.n_heads * dh) @ wo
        return T.block_tail(lp, bcfg, x, attn_out)

    return finish(x_q, out[:, :lq]), finish(x_d, out[:, lq:])


def _cls_only_layer_split(lp, bcfg: T.TransformerConfig, x_q, x_d, q_valid,
                          d_valid, doc_kv=None):
    """Final CLS-only layer (paper section 6.3) over the split residual:
    one attention row ([CLS] is row 0 of the query segment) against the
    split K/V pair.  x_q: [B, Lq, d]; x_d: [B, Ld, d] -> cls rep [B, d]."""
    cd = bcfg.compute_dtype
    b = x_q.shape[0]
    p = lp["attn"]
    h_q = L.apply_norm(lp["ln1"], x_q, bcfg.norm)
    h_d = L.apply_norm(lp["ln1"], x_d, bcfg.norm)
    q = T.project_q(p, h_q[:, :1], bcfg)
    kq, vq = T.project_kv(p, h_q, bcfg)
    if doc_kv is None:
        kd, vd = T.project_kv(p, h_d, bcfg)
        kd_scale = vd_scale = paged = None
    else:                            # l == n_layers - 1: stored K/V
        kd, vd, kd_scale, vd_scale, paged = _unpack_stored_kv(doc_kv)
    out = B.get_impl("join_attention", bcfg.attn_impl)(
        q, kq, vq, kd, vd, cfg=bcfg, scale=1.0 / math.sqrt(bcfg.dh),
        q_valid=torch.ones((b, 1), dtype=torch.bool, device=q.device),
        kq_valid=q_valid, kd_valid=d_valid, kd_scale=kd_scale,
        vd_scale=vd_scale, paged=paged)
    out = out.reshape(b, 1, bcfg.n_heads * bcfg.dh) @ p["wo"].to(cd)
    x_cls = T.block_tail(lp, bcfg, x_q[:, :1], out)
    return x_cls[:, 0]


def _score_join_fused(params, cfg: PreTTRConfig, st: JoinState):
    """Layers ``l..n-1`` over the split residual, then the score."""
    bcfg = cfg.backbone
    layers = params["backbone"]["layers"]
    last = bcfg.n_layers - (1 if cfg.cls_only_last_layer else 0)
    x_q, x_d = st.x_q, st.x_d
    stored = _stored_kv_operand(st)
    for li in range(cfg.l, last):
        x_q, x_d = _join_layer_split(layers[li], bcfg, x_q, x_d, st.q_valid,
                                     st.d_valid,
                                     doc_kv=stored if li == cfg.l else None)
    if cfg.cls_only_last_layer:
        cls = _cls_only_layer_split(layers[-1], bcfg, x_q, x_d, st.q_valid,
                                    st.d_valid,
                                    doc_kv=stored if cfg.l == last else None)
    else:
        cls = x_q[:, 0]
    return _score_from_cls(params, cfg, cls)


def _score_join_concat(params, cfg: PreTTRConfig, st: JoinState):
    """Legacy concat join: materialise [B, Lq + Ld, d] at the joint
    forward's positions (``[0, Lq) ++ max_query_len + [0, Ld)``) and run
    layers ``l..n-2`` over it, then the CLS-only layer and the score."""
    bcfg = cfg.backbone
    layers = params["backbone"]["layers"]
    b, lq, _ = st.x_q.shape
    ld = st.x_d.shape[1]
    dev = st.x_q.device
    x = torch.cat([st.x_q, st.x_d], dim=1)
    positions = torch.cat([torch.arange(lq, device=dev),
                           cfg.max_query_len
                           + torch.arange(ld, device=dev)]).expand(b, lq + ld)
    segs = torch.cat([torch.zeros((b, lq), dtype=torch.long, device=dev),
                      torch.ones((b, ld), dtype=torch.long, device=dev)],
                     dim=1)
    valid = torch.cat([st.q_valid, st.d_valid], dim=1)
    last = bcfg.n_layers - (1 if cfg.cls_only_last_layer else 0)
    for li in range(cfg.l, last):
        x = T.layer_step(layers[li], x, bcfg, split_flag=False, segs=segs,
                         valid=valid, seg_boundary=-1)
    if cfg.cls_only_last_layer:
        cls = _cls_only_layer(layers[-1], x, bcfg, positions=positions,
                              valid=valid)
    else:
        cls = x[:, 0]
    return _score_from_cls(params, cfg, cls)


def score_join(params, cfg: PreTTRConfig, st: JoinState):
    """Scores [B] of a prepared :class:`JoinState`, on the path its
    ``fused`` flag names."""
    return (_score_join_fused if st.fused else _score_join_concat)(
        params, cfg, st)


def join_and_score(params, cfg: PreTTRConfig, q_reps, q_valid, doc_store,
                   doc_valid, *, doc_kv=None, fused: bool = True):
    """Query-time join: q_reps [B, Lq, d] (+ valid), doc_store
    [B, Ld, e|d] as loaded from the index (decoded from its codec) and
    optional stored layer-``l`` ``doc_kv`` (see :func:`prepare_join`) ->
    scores [B] float32.  ``fused=True`` (the serving path) keeps the two
    segments apart through the ``join_attention`` op; ``fused=False`` is
    the legacy concat join."""
    st = prepare_join(params, cfg, q_reps, q_valid, doc_store, doc_valid,
                      doc_kv=doc_kv, fused=fused)
    return score_join(params, cfg, st)
