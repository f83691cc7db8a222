"""Ranking-quality evaluation: IR metrics and the end-to-end cascade."""
from repro_torch.eval.cascade import CascadeResult, run_cascade
from repro_torch.eval.metrics import (cascade_metrics, hit_at_k,
                                      mean_percentile_rank, ndcg_at_k,
                                      ranked_rels_from_scores, recall_at_k,
                                      reciprocal_rank_at_k)

__all__ = ["CascadeResult", "run_cascade", "cascade_metrics", "hit_at_k",
           "mean_percentile_rank", "ndcg_at_k", "ranked_rels_from_scores",
           "recall_at_k", "reciprocal_rank_at_k"]
