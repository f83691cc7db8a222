"""First-stage candidate generation feeding the re-ranker."""
from repro_torch.retrieval.first_stage import (FirstStageRetriever,
                                               pool_reps, topk_stable)

__all__ = ["FirstStageRetriever", "pool_reps", "topk_stable"]
