"""BERT4Rec (Sun et al., arXiv:1904.06690), the port of
``repro.models.recsys.bert4rec``: a bidirectional transformer over item
sequences, trained by masked-item (Cloze) prediction.

Built on :mod:`repro_torch.models.transformer` (``causal=False``, learned
positions, two segments).  PreTTR applies natively: the user's history
is the "document" side.  With ``prettr_l > 0`` the first ``l`` layers
mask attention between the history segment and the target / [MASK]
segment, so :func:`precompute_history` runs a stable history through
layers ``0..l`` offline (one segment, no split mask needed) and
:func:`serve_scores_from_reps` joins a fresh [MASK] slot to those reps
through layers ``l..n`` (no split flag): both run the split-attention
kernel exactly on ``attn_impl="cuda"``.  :func:`forward_hidden` runs
layers ``0..n`` in one range whose split flags differ and whose [MASK]
slots sit anywhere, which the kernel's static ``seg_boundary`` cannot
express: on ``"cuda"`` it raises (``transformer._run_layers``), as the
JAX ``pallas`` impl does; it runs on ``"plain"``.

The vocab-sharded top-k of the JAX package is a plain two-stage
``torch.topk`` here (:func:`two_stage_topk`); a device mesh is ROADMAP.md
Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T

MASK_ITEM = 1  # item id reserved for [MASK]; 0 = padding


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000
    seq_len: int = 200
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    prettr_l: int = 0                # >0: PreTTR split boundary
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "cuda"          # "cuda" | "plain"

    def backbone(self) -> T.TransformerConfig:
        return T.TransformerConfig(
            name="bert4rec", n_layers=self.n_blocks, d_model=self.embed_dim,
            n_heads=self.n_heads, n_kv_heads=self.n_heads,
            d_ff=4 * self.embed_dim, vocab_size=self.n_items + 2,
            causal=False, rope=False, learned_pos=self.seq_len + 1,
            segment_vocab=2, norm="layernorm", gated_mlp=False,
            activation="gelu", mlp_bias=True, qkv_bias=True,
            tie_embeddings=True, split_layers=self.prettr_l,
            compute_dtype=self.compute_dtype, param_dtype=self.param_dtype,
            attn_impl=self.attn_impl, block_kv=256)


def init_bert4rec(cfg: Bert4RecConfig, generator: torch.Generator,
                  device=None) -> dict:
    """Random params (``transformer.init_params`` of the backbone) on
    ``device`` (``None`` means the card)."""
    return T.init_params(cfg.backbone(), generator, device=device)


def bert4rec_axes(cfg: Bert4RecConfig) -> dict:
    """The logical-axes tree of :func:`init_bert4rec`'s params: the
    backbone's (``transformer.param_axes``)."""
    return T.param_axes(cfg.backbone())


def _mask_hidden(hidden, pos):
    """``hidden [B, S, d]`` at one position a row -> ``[B, 1, d]``."""
    idx = pos.long()[:, None, None].expand(-1, 1, hidden.shape[-1])
    return torch.take_along_dim(hidden, idx, dim=1)


def forward_hidden(params, cfg: Bert4RecConfig, item_seq, valid):
    """item_seq: [B, S] (0 = pad, 1 = [MASK]) -> hidden [B, S, d]; [MASK]
    slots are segment 0, the rest segment 1."""
    segs = (item_seq != MASK_ITEM).long()
    hidden, _, _ = T.forward(params, cfg.backbone(), item_seq, segs=segs,
                             valid=valid)
    return hidden


def cloze_loss(params, cfg: Bert4RecConfig, batch, *, max_masked: int = 32,
               logits_chunk: int = 2):
    """Masked-item cross-entropy over up to ``max_masked`` masked slots a
    row (the lowest-indexed first), in chunks of ``logits_chunk`` slots
    recomputed in the backward pass, so the ``[B, S, V]`` logits never
    exist.  ``batch``: ``item_seq``, ``valid``, ``targets`` (0 where not
    masked)."""
    from torch.utils.checkpoint import checkpoint

    bcfg = cfg.backbone()
    hidden = forward_hidden(params, cfg, batch["item_seq"], batch["valid"])
    targets = batch["targets"]
    s = targets.shape[1]
    is_masked = (targets > 0).float()
    # masked slots first, ties to the lowest index
    order = is_masked - torch.arange(s, dtype=torch.float32,
                                     device=targets.device) * 1e-6
    idx = torch.topk(order, max_masked, dim=-1).indices
    h_sel = torch.take_along_dim(hidden, idx[..., None], dim=1)
    t_sel = torch.take_along_dim(targets, idx, dim=1)
    w_sel = torch.take_along_dim(is_masked, idx, dim=1)
    head = T._head(params, bcfg)                   # tied: [d, V]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, max_masked, logits_chunk):
        sl = slice(c, c + logits_chunk)
        total = total + checkpoint(T._chunk_nll, h_sel[:, sl], t_sel[:, sl],
                                   w_sel[:, sl], head, use_reentrant=False)
    return total / torch.clamp(w_sel.sum(), min=1.0)


def two_stage_topk(scores, k: int, n_shards: int):
    """Top-k over the last axis in two stages: each of ``n_shards``
    contiguous slices' top-k, then the top-k of those ``n_shards * k``
    candidates (one stage when ``n_shards`` does not divide the axis).
    The same values and ids as one ``torch.topk`` up to ties."""
    b, v = scores.shape
    if n_shards <= 1 or v % n_shards:
        return torch.topk(scores, k, dim=-1)
    v1, i1 = torch.topk(scores.reshape(b, n_shards, v // n_shards), k,
                        dim=-1)
    i1 = i1 + (torch.arange(n_shards, device=scores.device)
               * (v // n_shards))[None, :, None]
    v2, i2 = torch.topk(v1.reshape(b, -1), k, dim=-1)
    return v2, torch.take_along_dim(i1.reshape(b, -1), i2, dim=1)


def serve_topk(params, cfg: Bert4RecConfig, item_seq, valid, *, k: int = 100,
               batch_chunk: int = 4096, vocab_shards: int = 16):
    """Next-item serving: each row's last valid slot holds [MASK] ->
    (scores [B, k] float32, item ids [B, k]).  The encoder, the scores
    and the top-k run ``batch_chunk`` rows at a time, so at serve_bulk the
    ``[B, V]`` scores never exist at once."""
    head = params["embed"]["tokens"].to(cfg.compute_dtype)
    b = item_seq.shape[0]
    shards = vocab_shards if head.shape[0] % vocab_shards == 0 else 1
    vals, ids = [], []
    for lo in range(0, b, batch_chunk):
        seq, val = item_seq[lo:lo + batch_chunk], valid[lo:lo + batch_chunk]
        hidden = forward_hidden(params, cfg, seq, val)
        mask_pos = torch.clamp(val.long().sum(-1) - 1, min=0)
        h = _mask_hidden(hidden, mask_pos)[:, 0]
        v, i = two_stage_topk(L.mm_f32(h, head.T), k, shards)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def serve_scores(params, cfg: Bert4RecConfig, item_seq, valid):
    """Every item's score at the last valid slot: [B, n_items + 2]."""
    hidden = forward_hidden(params, cfg, item_seq, valid)
    h = _mask_hidden(hidden, valid.long().sum(-1) - 1)
    return T.logits(params, cfg.backbone(), h)[:, 0]


# ---------------------------------------------------------------------------
# PreTTR split serving (prettr_l > 0)
# ---------------------------------------------------------------------------


def precompute_history(params, cfg: Bert4RecConfig, hist_seq, valid):
    """Offline: the history (segment 1, positions 1..S) through layers
    0..l -> [B, S, d]."""
    bcfg = cfg.backbone()
    b, s = hist_seq.shape
    dev = hist_seq.device
    positions = (1 + torch.arange(s, device=dev)).expand(b, s)
    segs = torch.ones((b, s), dtype=torch.long, device=dev)
    x = T.embed(params, bcfg, hist_seq, positions, segs)
    return T.run_layer_range(params, bcfg, x, 0, cfg.prettr_l,
                             positions=positions, segs=segs, valid=valid)


def serve_scores_from_reps(params, cfg: Bert4RecConfig, hist_reps,
                           hist_valid):
    """Online: a fresh [MASK] slot (position 0, segment 0) joined to
    precomputed history reps through layers l..n; the slot's scores over
    every item, [B, n_items + 2] float32."""
    bcfg = cfg.backbone()
    b, s = hist_reps.shape[:2]
    dev = hist_reps.device
    tpos = torch.zeros((b, 1), dtype=torch.long, device=dev)
    tgt = T.embed(params, bcfg,
                  torch.full((b, 1), MASK_ITEM, dtype=torch.long,
                             device=dev), tpos, tpos)
    # the slot passes layers 0..l alone: below l the split mask keeps it
    # from the history, and one token attends only itself
    tgt = T.run_layer_range(params, bcfg, tgt, 0, cfg.prettr_l,
                            positions=tpos, segs=tpos,
                            valid=torch.ones((b, 1), dtype=torch.bool,
                                             device=dev))
    x = torch.cat([tgt, hist_reps.to(tgt.dtype)], dim=1)
    positions = torch.cat([tpos, (1 + torch.arange(s, device=dev))
                           .expand(b, s)], dim=1)
    segs = torch.cat([tpos, torch.ones((b, s), dtype=torch.long,
                                       device=dev)], dim=1)
    valid = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                       hist_valid.bool()], dim=1)
    x = T.run_layer_range(params, bcfg, x, cfg.prettr_l, bcfg.n_layers,
                          positions=positions, segs=segs, valid=valid)
    h = L.apply_norm(params["final_norm"], x[:, :1], bcfg.norm)
    return T.logits(params, bcfg, h)[:, 0]
