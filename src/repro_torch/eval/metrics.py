"""Rank-quality metrics of the retrieval cascade, the port of
``repro.eval.metrics`` (batched torch).

Every metric takes per-query *ranked relevance grades* ``[Q, K]`` (the
grade of the candidate at each rank, 0 = not relevant) and ``n_valid
[Q]`` (true candidate-list lengths; rows are padded to K).
:func:`ranked_rels_from_scores` makes that form from ``(scores, rels)``
with a stable descending sort, so tied scores keep candidate order.

Degenerate cases, as in the reference:

* an empty candidate list (``n_valid == 0``): MRR, hit and nDCG are 0;
  the percentile rank is 1 (worst) when relevant docs exist;
* no relevant doc anywhere (``n_relevant == 0``): nDCG 0, percentile
  rank 0, recall 1;
* relevant docs missing from the list count against recall and the
  percentile rank (each at the worst percentile, 1.0).

Higher is better for all but :func:`mean_percentile_rank`.
"""
from __future__ import annotations

import torch


def _t(x, dtype):
    return torch.as_tensor(x).to(dtype)


def ranked_rels_from_scores(scores, rels, valid=None):
    """Relevance grades by descending score (stable: ties keep candidate
    order; invalid rows sink to the end with grade 0).  scores [Q, K],
    rels [Q, K], valid [Q, K] bool (default all) -> (ranked [Q, K] int32,
    n_valid [Q] int32)."""
    scores = _t(scores, torch.float32)
    rels = _t(rels, torch.int32).to(scores.device)
    valid = (torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
             if valid is None else _t(valid, torch.bool).to(scores.device))
    keyed = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-keyed, dim=-1, stable=True)
    ranked = torch.take_along_dim(
        torch.where(valid, rels, torch.zeros_like(rels)), order, dim=-1)
    return ranked, valid.sum(-1).int()


def _rank_mask(ranked, n_valid, k: int):
    """[Q, K] bool: ranks inside the top-k that hold a real candidate."""
    pos = torch.arange(ranked.shape[-1], device=ranked.device)
    return (pos[None, :] < k) & (pos[None, :] < n_valid[:, None])


def reciprocal_rank_at_k(ranked, n_valid, k: int, min_grade: int = 1):
    """1 / rank of the first top-k candidate with grade >= ``min_grade``,
    else 0 -> [Q] float32."""
    hit = (ranked >= min_grade) & _rank_mask(ranked, n_valid, k)
    first = torch.argmax(hit.int(), dim=-1)       # 0 when no hit at all
    return torch.where(hit.any(-1), 1.0 / (first + 1.0),
                       torch.zeros((), device=ranked.device))


def hit_at_k(ranked, n_valid, k: int, min_grade: int = 1):
    """1.0 where a top-k candidate has grade >= ``min_grade`` -> [Q]."""
    hit = (ranked >= min_grade) & _rank_mask(ranked, n_valid, k)
    return hit.any(-1).float()


def _discounts(n: int, device):
    return 1.0 / torch.log2(torch.arange(2, n + 2, dtype=torch.float32,
                                         device=device))


def ndcg_at_k(ranked, n_valid, k: int, ideal_rels=None):
    """nDCG@k with gain ``2^grade - 1``.  ``ideal_rels`` [Q, R]: the
    query's corpus-wide grades, for the ideal DCG; default: the best order
    of the candidate list itself.  0 where the ideal DCG is 0 -> [Q]."""
    mask = _rank_mask(ranked, n_valid, k)
    zero = torch.zeros((), device=ranked.device)
    gains = (2.0 ** torch.where(mask, ranked, 0) - 1.0) \
        * _discounts(ranked.shape[-1], ranked.device)[None, :]
    dcg = torch.where(mask, gains, zero).sum(-1)
    src = ranked if ideal_rels is None else \
        _t(ideal_rels, torch.int32).to(ranked.device)
    ideal = torch.sort(src, dim=-1, descending=True).values[:, :k].float()
    if ideal_rels is None:
        # the candidate-list ideal respects the list's length
        ideal = torch.where(
            torch.arange(ideal.shape[-1], device=ranked.device)[None, :]
            < torch.clamp(n_valid, max=k)[:, None], ideal, zero)
    idcg = ((2.0 ** ideal - 1.0)
            * _discounts(ideal.shape[-1], ranked.device)[None, :]).sum(-1)
    return torch.where(idcg > 0, dcg / idcg.clamp_min(1e-30), zero)


def recall_at_k(ranked, n_valid, k: int, n_relevant, min_grade: int = 1):
    """Share of the query's ``n_relevant`` corpus-wide relevant docs found
    in the top-k; 1.0 for a query with none -> [Q] float32."""
    n_relevant = _t(n_relevant, torch.int32).to(ranked.device)
    found = ((ranked >= min_grade)
             & _rank_mask(ranked, n_valid, k)).sum(-1).float()
    return torch.where(n_relevant > 0, found / n_relevant.clamp_min(1),
                       torch.ones((), device=ranked.device))


def mean_percentile_rank(ranked, n_valid, n_relevant, min_grade: int = 1):
    """Mean percentile rank of the relevant docs (lower is better): rank r
    of n_valid contributes ``r / n_valid``, each relevant doc missing from
    the list 1.0; 0 for a query with none -> [Q] float32."""
    n_relevant = _t(n_relevant, torch.int32).to(ranked.device)
    pos = torch.arange(ranked.shape[-1], device=ranked.device)
    rel = (ranked >= min_grade) & (pos[None, :] < n_valid[:, None])
    pct = (pos[None, :] + 1.0) / n_valid.clamp_min(1)[:, None]
    found_sum = torch.where(rel, pct, torch.zeros((), device=pct.device)) \
        .sum(-1)
    n_missing = torch.clamp(n_relevant - rel.sum(-1), min=0)
    total = found_sum + n_missing.float()
    return torch.where(n_relevant > 0, total / n_relevant.clamp_min(1),
                       torch.zeros((), device=ranked.device))


def cascade_metrics(scores, rels, valid=None, *, k: int = 10,
                    n_relevant=None, ideal_rels=None,
                    min_grade: int = 1) -> dict:
    """Every metric in one pass -> ``{name: float}`` means over queries.
    ``n_relevant`` [Q] (corpus-wide relevant counts) adds recall@k and the
    mean percentile rank; ``ideal_rels`` [Q, R] sets nDCG's ideal."""
    ranked, n_valid = ranked_rels_from_scores(scores, rels, valid)
    out = {
        f"mrr@{k}": reciprocal_rank_at_k(ranked, n_valid, k, min_grade),
        f"hit@{k}": hit_at_k(ranked, n_valid, k, min_grade),
        f"ndcg@{k}": ndcg_at_k(ranked, n_valid, k, ideal_rels),
    }
    if n_relevant is not None:
        out[f"recall@{k}"] = recall_at_k(ranked, n_valid, k, n_relevant,
                                         min_grade)
        out["mpr"] = mean_percentile_rank(ranked, n_valid, n_relevant,
                                          min_grade)
    return {name: float(v.mean()) for name, v in out.items()}
