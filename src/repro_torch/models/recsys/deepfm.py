"""DeepFM (Guo et al., arXiv:1703.04247) and xDeepFM (Lian et al.,
arXiv:1803.05170), as ``repro.models.recsys.deepfm``.

DeepFM: y = w0 + sum first-order + FM second-order + DNN(flat embeddings).
FM second-order uses the O(F*D) identity 0.5*((sum v)^2 - sum v^2).
xDeepFM replaces FM with the Compressed Interaction Network (CIN):
x^{k+1}_{h,d} = sum_{i,j} W^k_{h,i,j} * x^k_{i,d} * x^0_{j,d}, with
per-layer sum-pooled logits.

Retrieval mode mirrors dlrm.py: item-side field embeddings summed offline
(the PreTTR analogue); for xDeepFM only the gather is precomputable.

Lookups run through :func:`embedding.padded_bag`: the field embeddings as
bags of one whose rows the kernel rounds to the compute dtype (the JAX
``table.astype(compute_dtype)`` without casting the table), the
first-order term as one sum bag over the fields of the width-1 ``w1``
table, the retrieval partial sums as sum bags (:func:`embedding.bag_rows`:
under row sharding every table and ``w1`` read goes through
``take_rows`` and the sharded lookup, then the sum over the fields, as
the JAX package reads them).  ``bce_loss`` is the training loss; under
``bag_impl="cuda"`` its lookups launch the kernel forward and take the
plain version's gradient backward (``embedding.padded_bag``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E
from repro_torch.models.recsys.dlrm import (_bce, _cast, _dense, _mlp,
                                            _mlp_axes, _mlp_init)


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_fields: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    mlp: tuple = (400, 400, 400)
    interaction: str = "fm"          # "fm" | "cin"
    cin_layers: tuple = ()           # xDeepFM: (200, 200, 200)
    item_fields: tuple = tuple(range(20, 39))
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    bag_impl: str = "cuda"           # embedding.IMPLS

    @property
    def vocab_sizes(self):
        return (self.vocab_per_field,) * self.n_fields

    @property
    def user_fields(self):
        return [f for f in range(self.n_fields) if f not in self.item_fields]


def init_deepfm(cfg: DeepFMConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the JAX ``init_deepfm`` tree (``table``, ``w1``,
    ``b0``, ``dnn``; ``cin`` and ``cin_out`` for the CIN interaction) in
    ``cfg.param_dtype``: the table and ``w1`` (one scalar a row, rows as
    the padded table) ``N(0, 0.01^2)``, dense weights ``N(0, 1/d_in)``,
    biases and ``b0`` 0.  Drawn on ``generator``'s device, placed on
    ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    table = E.init_fused_table(generator, cfg.vocab_sizes, cfg.embed_dim, pd,
                               device=dev)
    w1 = E.init_fused_table(generator, cfg.vocab_sizes, 1, pd, device=dev)
    dnn = _mlp_init(generator, (cfg.n_fields * cfg.embed_dim, *cfg.mlp, 1),
                    pd, dev)
    params = {"table": table, "w1": w1,
              "b0": torch.zeros((), dtype=pd, device=dev), "dnn": dnn}
    if cfg.interaction == "cin":
        h_prev, cin = cfg.n_fields, []
        for h in cfg.cin_layers:
            cin.append({"w": _dense(generator, h_prev * cfg.n_fields, h, pd,
                                    dev)})
            h_prev = h
        params["cin"] = cin
        params["cin_out"] = _dense(generator, sum(cfg.cin_layers), 1, pd, dev)
    return params


def deepfm_axes(cfg: DeepFMConfig) -> dict:
    """The logical-axes tree of :func:`init_deepfm`'s params (the JAX
    ``init_deepfm``'s second return)."""
    axes = {"table": E.FUSED_TABLE_AXES, "w1": ("table_rows", None),
            "b0": (), "dnn": _mlp_axes((cfg.n_fields * cfg.embed_dim,
                                        *cfg.mlp, 1))}
    if cfg.interaction == "cin":
        axes["cin"] = [{"w": (None, "mlp")} for _ in cfg.cin_layers]
        axes["cin_out"] = ("mlp", None)
    return axes


def fm_second_order(emb):
    """emb: [B, F, D] -> [B] via 0.5*((sum_f v)^2 - sum_f v^2)."""
    s = emb.sum(dim=1)
    s2 = (emb * emb).sum(dim=1)
    return 0.5 * (s * s - s2).sum(dim=-1)


def cin(params_cin, cin_out, x0):
    """Compressed Interaction Network. x0: [B, F, D] -> [B] logit."""
    xs, pooled = x0, []
    for lyr in params_cin:
        # outer product over field axes, per embedding dim
        z = xs[:, :, None, :] * x0[:, None, :, :]          # [B, H, F, D]
        b, h, f, d = z.shape
        xs = torch.relu(torch.einsum("bkd,kh->bhd", z.reshape(b, h * f, d),
                                     lyr["w"]))
        pooled.append(xs.sum(dim=-1))                      # [B, H]
    return (torch.cat(pooled, dim=-1) @ cin_out)[:, 0]


def deepfm_forward(params, cfg: DeepFMConfig, sparse_ids):
    """sparse_ids: [B, F] -> logits [B] f32."""
    cd = cfg.compute_dtype
    flat = E.field_ids(sparse_ids, E.fused_table_offsets(cfg.vocab_sizes))
    emb = E.take_rows(params["table"], flat, out_dtype=cd,
                      impl=cfg.bag_impl)                    # [B, F, D]
    first = E.bag_rows(params["w1"], flat, impl=cfg.bag_impl)[:, 0]
    b = sparse_ids.shape[0]
    deep = _mlp(_cast(params["dnn"], cd), emb.reshape(b, -1))[:, 0]
    logit = params["b0"] + first + deep.float()
    if cfg.interaction == "cin":
        return logit + cin(_cast(params["cin"], cd),
                           params["cin_out"].to(cd), emb).float()
    return logit + fm_second_order(emb).float()


def bce_loss(params, cfg: DeepFMConfig, batch):
    """Mean binary cross-entropy of ``deepfm_forward`` logits against
    ``batch["labels"]`` (``dlrm._bce``)."""
    return _bce(deepfm_forward(params, cfg, batch["sparse"]),
                batch["labels"])


def item_vectors(params, cfg: DeepFMConfig, item_ids):
    """Precompute item-side embedding sums offline (PreTTR analogue).
    item_ids: [N, n_item_fields] -> ([N, D] second-order partial,
    [N] first-order partial), in the table's dtype."""
    offsets = E.fused_table_offsets(cfg.vocab_sizes)
    flat = E.field_ids(item_ids, offsets[list(cfg.item_fields)])
    return (E.bag_rows(params["table"], flat, impl=cfg.bag_impl),
            E.bag_rows(params["w1"], flat, impl=cfg.bag_impl)[:, 0])


def retrieval_scores(params, cfg: DeepFMConfig, user_ids, item_vecs,
                     item_first):
    """FM cross-term between user-side and item-side embedding sums:
    score(u, i) = b0 + first(u) + first(i) + <sum_emb(u), sum_emb(i)>
    (the user-internal / item-internal FM terms are rank-constant).
    user_ids: [B, n_user_fields]; item_vecs: [N, D] -> [B, N]."""
    offsets = E.fused_table_offsets(cfg.vocab_sizes)
    flat = E.field_ids(user_ids, offsets[cfg.user_fields])
    emb_u = E.bag_rows(params["table"], flat, impl=cfg.bag_impl)    # [B, D]
    first_u = E.bag_rows(params["w1"], flat, impl=cfg.bag_impl)[:, 0]
    cross = L.mm_f32(emb_u, item_vecs.t())
    return params["b0"] + first_u[:, None] + item_first[None, :] + cross
