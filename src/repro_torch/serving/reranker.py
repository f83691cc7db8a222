"""One-query re-ranking client, the port of ``repro.serving.reranker``:
``Reranker(params, cfg, index).rerank(q_tokens, q_valid, doc_ids) ->
(ranked doc ids, scores, RerankStats)``.

Each call submits one :class:`~repro_torch.serving.service.RankRequest`
to a private :class:`~repro_torch.serving.service.RankingService` and
drains it.  The model's entry points are late-bound through the
instance's ``_encode`` / ``_join`` attributes, which a caller (or a test)
may replace after construction; new code should use the service
directly.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import prettr as P
from repro_torch.serving.service import RankingService, RerankStats

__all__ = ["Reranker", "RerankStats"]


class Reranker:
    """``device`` (``None`` means the card) and ``backend`` as on the
    service; ``deadline_s`` is read at every :meth:`rerank`."""

    def __init__(self, params, cfg: P.PreTTRConfig, index,
                 micro_batch: int = 32, deadline_s: float | None = None,
                 cache_size: int = 64, backend: str | None = None,
                 device=None):
        self._service = RankingService(
            params, cfg, index, micro_batch=micro_batch,
            cache_size=cache_size, backend=backend, device=device,
            encode_fn=lambda *a: self._encode(*a),
            join_fn=lambda *a: self._join(*a))
        cfg = self._service.cfg              # with the backend applied
        self.cfg = cfg
        self.index = index
        self.deadline_s = deadline_s
        self._encode = lambda p, t, v: P.encode_query(p, cfg, t, v)
        self._join = lambda p, qr, qv, st, dv: P.join_and_score(
            p, cfg, qr, qv, st, dv)

    @property
    def params(self):
        return self._service.params

    @params.setter
    def params(self, value):
        self._service.params = value

    @property
    def micro_batch(self) -> int:
        return self._service.micro_batch

    @micro_batch.setter
    def micro_batch(self, value: int):
        self._service.micro_batch = value

    def rerank(self, q_tokens: np.ndarray, q_valid: np.ndarray,
               doc_ids: Sequence[int]):
        """-> (doc ids by descending score, scores, stats)."""
        resp = self._service.rank(q_tokens, q_valid, doc_ids,
                                  deadline_s=self.deadline_s)
        return resp.doc_ids, resp.scores, resp.stats
