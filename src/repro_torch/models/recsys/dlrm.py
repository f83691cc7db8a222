"""DLRM (Naumov et al., arXiv:1906.00091), MLPerf configuration
(``repro.models.recsys.dlrm``).

dense [B,13] -> bottom MLP 13-512-256-128; 26 categorical lookups (dim 128,
fused table); dot-product feature interaction over the 27 vectors (lower
triangle, 351 pairs) concat bottom output -> top MLP 1024-1024-512-256-1.

Retrieval mode, the PreTTR analogue: ``item_fields`` marks the item-side
fields; :func:`item_tower` precomputes item vectors offline (a mean bag
over the item fields) and :func:`retrieval_scores` scores a user against
10^6 of them with one product.

Every lookup is a bag of :func:`embedding.padded_bag`, so on the card it
runs the embedding-bag kernel (``cfg.bag_impl == "cuda"``).  Parameters
are cast to ``compute_dtype`` at the use site, as in the JAX package; the
table's cast is fused into the kernel's gather, so bf16 storage
(``param_dtype=torch.bfloat16``) gives the same bits as float32 storage.
The towers' mean bags are :func:`embedding.bag_rows`: under row sharding
``take_rows`` through the sharded lookup, then the mean over the fields,
as the JAX package reads them.  ``bce_loss`` is the training loss; under
``bag_impl="cuda"`` its lookup launches the kernel forward and takes the
plain version's gradient backward (``embedding.padded_bag``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E

# MLPerf / Criteo-1TB per-field vocabulary sizes (public benchmark config)
CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_dense: int = 13
    vocab_sizes: tuple = CRITEO_1TB_VOCABS
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    # retrieval split: which sparse fields are item-side (rest = user-side)
    item_fields: tuple = tuple(range(13, 26))
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    bag_impl: str = "cuda"            # embedding.IMPLS

    @property
    def n_sparse(self):
        return len(self.vocab_sizes)

    @property
    def user_fields(self):
        return [f for f in range(self.n_sparse) if f not in self.item_fields]


def _dense(generator, d_in, d_out, dtype, device):
    """A ``[d_in, d_out]`` weight ``N(0, 1/d_in)`` (``dense_init``)."""
    x = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device)
    return (x / math.sqrt(d_in)).to(device=device, dtype=dtype)


def _mlp_init(generator, dims, dtype, device):
    """Dense layers ``N(0, 1/d_in)`` weights, zero biases."""
    return [{"w": _dense(generator, dims[i], dims[i + 1], dtype, device),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
            for i in range(len(dims) - 1)]


def _cast(layers, dtype):
    return [{k: v.to(dtype) for k, v in lyr.items()} for lyr in layers]


def _mlp_axes(dims):
    return [{"w": ("embed", "mlp"), "b": ("mlp",)}
            for _ in range(len(dims) - 1)]


def _mlp(layers, x, final_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator,
              device=None) -> dict:
    """Random params with the JAX ``init_dlrm`` tree (``table``, ``bot``,
    ``top``) in ``cfg.param_dtype``: the table ``N(0, 0.01^2)`` drawn in
    row chunks, dense weights ``N(0, 1/d_in)``, biases 0.  Drawn on
    ``generator``'s device, placed on ``device`` (``None`` means the
    card)."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    table = E.init_fused_table(generator, cfg.vocab_sizes, cfg.embed_dim, pd,
                               device=dev)
    n_vec = cfg.n_sparse + 1
    n_pairs = n_vec * (n_vec - 1) // 2
    bot = _mlp_init(generator, (cfg.n_dense, *cfg.bot_mlp), pd, dev)
    top = _mlp_init(generator, (n_pairs + cfg.bot_mlp[-1], *cfg.top_mlp), pd,
                    dev)
    return {"table": table, "bot": bot, "top": top}


def dlrm_axes(cfg: DLRMConfig) -> dict:
    """The logical-axes tree of :func:`init_dlrm`'s params (the JAX
    ``init_dlrm``'s second return)."""
    n_vec = cfg.n_sparse + 1
    n_pairs = n_vec * (n_vec - 1) // 2
    return {"table": E.FUSED_TABLE_AXES,
            "bot": _mlp_axes((cfg.n_dense, *cfg.bot_mlp)),
            "top": _mlp_axes((n_pairs + cfg.bot_mlp[-1], *cfg.top_mlp))}


def dot_interaction(vectors):
    """vectors: [B, F, D] -> [B, F*(F-1)/2] float32 pairwise dots (lower
    triangle, row-major).  The operands are widened to float32 and the
    product runs in float32 (``preferred_element_type``; no TF32)."""
    v = vectors.float()
    z = torch.bmm(v, v.transpose(1, 2))
    f = vectors.shape[1]
    iu, ju = torch.tril_indices(f, f, -1, device=vectors.device)
    return z[:, iu, ju]


def dlrm_forward(params, cfg: DLRMConfig, dense, sparse_ids):
    """dense: [B, 13] f32; sparse_ids: [B, 26] int -> logits [B] f32."""
    cd = cfg.compute_dtype
    offsets = E.fused_table_offsets(cfg.vocab_sizes)
    bot = _mlp(_cast(params["bot"], cd), dense.to(cd), final_act=True)
    emb = E.lookup_single(params["table"], offsets, sparse_ids, out_dtype=cd,
                          impl=cfg.bag_impl)                       # [B, 26, D]
    vectors = torch.cat([bot[:, None, :], emb], dim=1)            # [B, 27, D]
    inter = dot_interaction(vectors).to(cd)
    x = torch.cat([inter, bot], dim=-1)
    return _mlp(_cast(params["top"], cd), x)[:, 0].float()


def _bce(logits, labels):
    """Mean binary cross-entropy of float32 ``logits`` against 0/1
    ``labels``, in the stable form ``max(x, 0) - x y + log1p(exp(-|x|))``
    the JAX models use."""
    y = labels.float()
    return (torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def bce_loss(params, cfg: DLRMConfig, batch):
    """Mean binary cross-entropy of ``dlrm_forward`` logits against
    ``batch["labels"]``."""
    return _bce(dlrm_forward(params, cfg, batch["dense"], batch["sparse"]),
                batch["labels"])


# ---------------------------------------------------------------------------
# Retrieval mode (PreTTR analogue)
# ---------------------------------------------------------------------------


def item_tower(params, cfg: DLRMConfig, item_ids):
    """Precompute item-side vectors offline: [N, n_item_fields] -> [N, D]
    in the table's dtype, the mean of the item-field embeddings."""
    offsets = E.fused_table_offsets(cfg.vocab_sizes)
    flat = E.field_ids(item_ids, offsets[list(cfg.item_fields)])
    return E.bag_rows(params["table"], flat, mode="mean", impl=cfg.bag_impl)


def user_tower(params, cfg: DLRMConfig, dense, user_sparse_ids):
    """Online user-side vector [B, D] in the compute dtype."""
    cd = cfg.compute_dtype
    offsets = E.fused_table_offsets(cfg.vocab_sizes)
    bot = _mlp(_cast(params["bot"], cd), dense.to(cd), final_act=True)
    flat = E.field_ids(user_sparse_ids, offsets[cfg.user_fields])
    return bot + E.bag_rows(params["table"], flat, mode="mean", out_dtype=cd,
                            impl=cfg.bag_impl)


def retrieval_scores(params, cfg: DLRMConfig, dense, user_sparse_ids,
                     item_vectors):
    """One user against N precomputed candidates: [B, N] float32 scores,
    a single [B,D]x[D,N] product in the compute dtype summed in float32."""
    u = user_tower(params, cfg, dense, user_sparse_ids)
    return L.mm_f32(u, item_vectors.to(u.dtype).t())
