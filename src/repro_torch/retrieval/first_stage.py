"""First-stage retrieval over the term-rep index's own stored vectors, the
port of ``repro.retrieval.first_stage``.

* **Doc side (once, at construction)** -- the stored streams go to the
  card in fixed chunks of ``chunk`` docs (a partial last chunk is padded
  with empty rows), are decoded there (the codec's decode, then the
  compressor's decompress through ``_decode_doc_store``), masked-mean
  pooled and optionally L2-normalised into a device-resident ``[N, d]``
  float32 matrix.
* **Query side** -- :func:`~repro_torch.core.prettr.encode_query` through
  layers ``0..l``, pooled the same way (``pool="mean"``) or read at [CLS]
  (``pool="cls"``).
* **Scoring** -- one float32 product ``q @ doc_matrix.T`` (TF32 off) and
  a top-k that breaks ties as ``jax.lax.top_k`` does, lower doc id first
  (:func:`topk_stable`).  Brute force, exact.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import prettr as P
from repro_torch.device import resolve_device, to_device
from repro_torch.serving.service import validate_index_compat


def pool_reps(reps, valid, *, normalize: bool = True):
    """Masked mean-pool token reps: reps [B, L, d], valid [B, L] -> [B, d]
    float32, L2-normalised when ``normalize``; a row with no valid token
    pools to the zero vector."""
    v = valid.bool()
    x = reps.float() * v[..., None]
    pooled = x.sum(1) / v.sum(1, keepdim=True).clamp_min(1)
    if normalize:
        pooled = pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp_min(1e-9)
    return pooled


def topk_stable(scores, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest scores in
    descending order, equal scores by ascending index (``torch.topk``
    promises no order among ties) -> (values, indices).  Like XLA, it
    orders floats totally, so +0.0 ranks above -0.0: a stable pass that
    moves negative zeros last goes before the stable sort by value."""
    neg_zero = (scores == 0) & torch.signbit(scores)
    first = torch.argsort(neg_zero.to(torch.uint8), dim=-1, stable=True)
    values, idx = torch.sort(scores.gather(-1, first), dim=-1,
                             descending=True, stable=True)
    return values[..., :k], first.gather(-1, idx)[..., :k]


@contextlib.contextmanager
def _full_f32():
    """float32 products at full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class FirstStageRetriever:
    """Brute-force inner-product retrieval over pooled index reps::

        fs = FirstStageRetriever(params, cfg, index)
        doc_ids, scores = fs.retrieve(q_tokens, q_valid, k=100)   # [B, k]

    ``pool``: ``"mean"`` pools queries by masked mean like the doc side;
    ``"cls"`` reads the query's [CLS] rep.  ``normalize`` L2-normalises
    both sides (cosine scores).  ``chunk`` is the fixed doc-batch shape of
    the pooling pass.  ``device`` (``None`` means the card) holds the
    params and the doc matrix."""

    def __init__(self, params, cfg: P.PreTTRConfig, index, *,
                 pool: str = "mean", normalize: bool = True,
                 chunk: int = 256, validate_index: bool = True, device=None):
        if pool not in ("mean", "cls"):
            raise ValueError(f"pool must be 'mean' or 'cls', got {pool!r}")
        if validate_index:
            validate_index_compat(cfg, index)
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.index = index
        self.pool = pool
        self.normalize = bool(normalize)
        self.doc_matrix = self._build_doc_matrix(max(1, int(chunk)))

    def _build_doc_matrix(self, chunk: int):
        """[N, d] pooled doc vectors from the index's stored streams,
        decoded on the device."""
        n = len(self.index)
        pad_to = self.cfg.max_doc_len
        codec = self.index.codec
        streams = list(codec.streams(self.index.rep_dim))
        out = []
        for lo in range(0, n, chunk):
            ids = list(range(lo, min(lo + chunk, n)))
            parts, valid = self.index.stage(ids, pad_to=pad_to,
                                            streams=streams,
                                            device=self.device)
            if len(ids) < chunk:           # keep the chunk shape fixed
                grow = lambda t: torch.cat([t, t.new_zeros(
                    (chunk - len(ids), *t.shape[1:]))])
                parts = {k: grow(t) for k, t in parts.items()}
                valid = grow(valid)
            with torch.inference_mode():
                st = (parts["reps"] if codec.decode_is_identity
                      else codec.decode(parts))
                x = P._decode_doc_store(self.params, self.cfg, st)
                out.append(pool_reps(x, valid,
                                     normalize=self.normalize)[: len(ids)])
        if not out:
            return torch.zeros((0, self.cfg.backbone.d_model),
                               device=self.device)
        return torch.cat(out)

    # -- query side ----------------------------------------------------------
    def encode_queries(self, q_tokens, q_valid):
        """[B, Lq] packed query tokens and validity (numpy or tensors) ->
        pooled [B, d] float32 on the device."""
        qt = torch.as_tensor(np.asarray(q_tokens, np.int64),
                             device=self.device)
        qv = torch.as_tensor(np.asarray(q_valid, bool), device=self.device)
        with torch.inference_mode():
            reps = P.encode_query(self.params, self.cfg, qt, qv)
            if self.pool == "cls":
                cls = reps[:, 0].float()
                if self.normalize:
                    cls = cls / torch.linalg.vector_norm(
                        cls, dim=-1, keepdim=True).clamp_min(1e-9)
                return cls
            return pool_reps(reps, qv, normalize=self.normalize)

    # -- scoring -------------------------------------------------------------
    def score_all(self, q_tokens, q_valid):
        """Scores against every doc -> [B, N] float32."""
        q = self.encode_queries(q_tokens, q_valid)
        with _full_f32(), torch.inference_mode():
            return q @ self.doc_matrix.T

    def retrieve(self, q_tokens, q_valid, k: int):
        """Top-k candidates: q_tokens / q_valid [B, Lq] -> (doc ids [B, k]
        int32 by descending score, scores [B, k] float32), tensors on the
        device.  ``k`` is clamped to the corpus size."""
        n = self.doc_matrix.shape[0]
        if n == 0:
            raise ValueError("cannot retrieve from an empty index")
        scores, ids = topk_stable(self.score_all(q_tokens, q_valid),
                                  min(int(k), n))
        return ids.int(), scores
