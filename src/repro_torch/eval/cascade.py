"""End-to-end cascade evaluation, the port of ``repro.eval.cascade``:
corpus -> index build -> first-stage top-k -> re-rank -> IR metrics.

One :func:`run_cascade` call measures an operating point (a codec, a
pruning policy, a join layer ``l``, a candidate depth ``k``) through the
real path: :class:`~repro_torch.index.IndexBuilder`'s output, pooled
first-stage retrieval over the index's own stored reps
(:class:`~repro_torch.retrieval.FirstStageRetriever`) and the packed
:class:`~repro_torch.serving.RankingService`, scored with
:mod:`repro_torch.eval.metrics` against the synthetic world's graded
qrels.  ``first_stage`` reports the retriever alone (its recall at the
pool depth bounds what any re-ranker can recover), ``rerank`` the whole
cascade.  Every draw is seeded and the service drains one FIFO workload,
so a (seed, config) pair gives the same result on one device.
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Any

import numpy as np

from repro_torch.core import prettr as P
from repro_torch.data.synthetic_ir import SyntheticIRWorld, pack_query_batch
from repro_torch.eval import metrics as M
from repro_torch.index import IndexBuilder, TermRepIndex
from repro_torch.retrieval import FirstStageRetriever
from repro_torch.serving import RankingService, RankRequest


@dataclasses.dataclass(frozen=True)
class CascadeResult:
    """One operating point's quality readout.  ``stages`` holds each
    stage's per-query candidates: ``{"first_stage": (ids, scores),
    "rerank": (ids, scores)}``, [Q, k] numpy arrays by descending score."""
    first_stage: dict[str, float]         # the retriever alone
    rerank: dict[str, float]              # the whole cascade
    meta: dict[str, Any]                  # codec / l / k / sizes / seed
    stages: dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                 compare=False)

    def flat(self) -> dict[str, float]:
        """``{"first_stage/<m>": v, "rerank/<m>": v}``."""
        out = {f"first_stage/{k}": v for k, v in self.first_stage.items()}
        out.update({f"rerank/{k}": v for k, v in self.rerank.items()})
        return out


def _stage_metrics(world: SyntheticIRWorld, cand_ids: np.ndarray,
                   cand_scores: np.ndarray, k_metric: int) -> dict:
    """One stage's per-query (doc ids, scores) against the qrels."""
    rels = np.stack([world.qrels[qi][cand_ids[qi]]
                     for qi in range(len(cand_ids))])
    return M.cascade_metrics(cand_scores, rels, k=k_metric,
                             n_relevant=world.n_relevant(),
                             ideal_rels=world.qrels)


def run_cascade(params, cfg: P.PreTTRConfig, world: SyntheticIRWorld, *,
                codec: str = "fp16", k: int = 32, k_metric: int = 10,
                n_shards: int = 1, micro_batch: int = 32,
                index_dir: str | None = None, index=None,
                pool: str = "mean", backend: str | None = None,
                store_layer_kv: bool = False, kv_codec: str | None = None,
                keep_frac: float = 1.0, max_kept_tokens: int = 0,
                device=None) -> CascadeResult:
    """Run the cascade over ``world`` and score both stages at depth
    ``k_metric``.

    Builds a ``codec`` index of ``world.docs`` (into ``index_dir`` or a
    temporary directory; an open ``index`` skips the build), retrieves
    ``k`` candidates a query, re-ranks them through a ``RankingService``
    and returns the per-stage metrics.  ``store_layer_kv`` / ``kv_codec``
    and ``keep_frac`` / ``max_kept_tokens`` build those operating points;
    both stages serve at the index's (pruned) ``max_doc_len``.
    ``backend`` (``"cuda"`` / ``"plain"``) routes every stage; ``device``
    (``None`` means the card) runs them."""
    if backend is not None:
        from repro_torch.models.backend import apply_backend
        cfg = apply_backend(cfg, backend)

    def _run(idx) -> CascadeResult:
        scfg = cfg
        if 0 < idx.max_doc_len < cfg.max_doc_len:
            scfg = dataclasses.replace(cfg, max_doc_len=idx.max_doc_len)
        fs = FirstStageRetriever(params, scfg, idx, pool=pool, device=device)
        q_tokens, q_valid = pack_query_batch(world.queries,
                                             cfg.max_query_len)
        cand_ids, cand_scores = (t.cpu().numpy() for t in
                                 fs.retrieve(q_tokens, q_valid, k))
        del fs
        first_stage = _stage_metrics(world, cand_ids, cand_scores, k_metric)
        # recall at the whole pool depth: relevant docs outside the pool
        # are out of any re-ranker's reach
        rels = np.stack([world.qrels[qi][cand_ids[qi]]
                         for qi in range(world.n_queries)])
        ranked, n_valid = M.ranked_rels_from_scores(cand_scores, rels)
        first_stage["pool_recall"] = float(M.recall_at_k(
            ranked, n_valid, k, world.n_relevant()).mean())

        svc = RankingService(params, scfg, idx, micro_batch=micro_batch,
                             device=device)
        for qi in range(world.n_queries):
            svc.submit(RankRequest(q_tokens[qi], q_valid[qi],
                                   [int(d) for d in cand_ids[qi]],
                                   request_id=str(qi)))
        by_qi = {int(r.request_id): r for r in svc.drain()}
        rr_ids = np.stack([np.asarray(by_qi[qi].doc_ids, np.int64)
                           for qi in range(world.n_queries)])
        # responses come sorted by descending score; the metrics' stable
        # sort then keeps the service's order among ties
        rr_scores = np.stack([by_qi[qi].scores
                              for qi in range(world.n_queries)])
        rerank = _stage_metrics(world, rr_ids, rr_scores, k_metric)
        meta = {"codec": idx.codec.name, "l": cfg.l, "k": k,
                "k_metric": k_metric, "n_docs": world.n_docs,
                "n_queries": world.n_queries, "seed": world.seed,
                "pool": pool, "n_shards": idx.n_shards,
                "kv_codec": (idx.kv_codec.name if idx.kv_codec else None),
                "prune": idx.prune_policy}
        return CascadeResult(
            first_stage=first_stage, rerank=rerank, meta=meta,
            stages={"first_stage": (cand_ids, cand_scores),
                    "rerank": (rr_ids, rr_scores)})

    if index is not None:
        return _run(index)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = index_dir or tmp
        IndexBuilder(out_dir, cfg, params, codec=codec, n_shards=n_shards,
                     store_layer_kv=store_layer_kv, kv_codec=kv_codec,
                     keep_frac=keep_frac, max_kept_tokens=max_kept_tokens,
                     device=device).build(list(world.docs))
        return _run(TermRepIndex.open(out_dir))
