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
JAX ``pallas`` impl does; it runs on ``"plain"`` and ``"blocked"``.

Under rules over an SPMD mesh the backbone takes the sharded
transformer's route (``models.transformer_spmd``): the tied head is
vocab-sharded over ``model``, :func:`cloze_loss` takes a vocab-parallel
cross-entropy, and :func:`serve_topk` scores only the rank's vocab block
and gathers just the ``[B, m k]`` candidates over ``model``, JAX's
two-stage top-k with the network between its stages.  In one process
the two stages are :func:`two_stage_topk`.
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
    attn_impl: str = "cuda"          # "cuda" | "plain" | "blocked"

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
    return _hidden(params, cfg, item_seq, valid, T._route(cfg.backbone()))


def _hidden(params, cfg, item_seq, valid, route):
    segs = (item_seq != MASK_ITEM).long()
    hidden, _, _ = T._forward(params, cfg.backbone(), item_seq, route,
                              segs=segs, valid=valid)
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
    route = T._route(bcfg)
    hidden = _hidden(params, cfg, batch["item_seq"], batch["valid"], route)
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
    head = route.head(params, bcfg)        # tied: [d, V] (a rank's block)
    h_sel = route.enter(h_sel, "vocab")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, max_masked, logits_chunk):
        sl = slice(c, c + logits_chunk)
        total = total + checkpoint(T._chunk_nll, h_sel[:, sl], t_sel[:, sl],
                                   w_sel[:, sl], head, route,
                                   use_reentrant=False)
    return route.data_sum(total) / torch.clamp(route.data_sum(w_sel.sum()),
                                               min=1.0)


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
    ``[B, V]`` scores never exist at once.  Under rules over an SPMD mesh
    (module docstring) the rows are the rank's data rows, and each rank
    of ``model`` scores its vocab block: :func:`_sharded_topk`."""
    bcfg = cfg.backbone()
    route = T._route(bcfg)
    head = route.head(params, bcfg)                # [d, V or V_local]
    b = item_seq.shape[0]
    shards = vocab_shards if head.shape[1] % vocab_shards == 0 else 1
    vals, ids = [], []
    for lo in range(0, b, batch_chunk):
        seq, val = item_seq[lo:lo + batch_chunk], valid[lo:lo + batch_chunk]
        hidden = _hidden(params, cfg, seq, val, route)
        mask_pos = torch.clamp(val.long().sum(-1) - 1, min=0)
        h = _mask_hidden(hidden, mask_pos)[:, 0]
        lg = L.mm_f32(h, head)
        v, i = _sharded_topk(lg, k, route) if route is not T.LOCAL \
            and route.p.vocab_split else two_stage_topk(lg, k, shards)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def _sharded_topk(lg, k: int, route):
    """The global top-k from each ``model`` rank's ``[B, V_local]``
    scores of its vocab block (rows from ``route.v0``): the local top-k,
    its ``[B, k]`` values and global ids gathered over ``model`` (a block
    shorter than ``k`` padded with -inf), then the top-k of the ``[B, m
    k]`` candidates."""
    from repro_torch.dist import spmd as S

    kk = min(k, lg.shape[1])
    v1, i1 = torch.topk(lg, kk, dim=-1)
    if kk < k:
        v1 = torch.cat([v1, v1.new_full((lg.shape[0], k - kk),
                                        float("-inf"))], 1)
        i1 = torch.cat([i1, i1.new_zeros((lg.shape[0], k - kk))], 1)
    with torch.no_grad():
        v_all = S._gather(v1, 1, route.mesh, ("model",))
        i_all = S._gather(i1 + route.v0, 1, route.mesh, ("model",))
    v2, i2 = torch.topk(v_all, k, dim=-1)
    return v2, torch.take_along_dim(i_all, i2, dim=1)


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
