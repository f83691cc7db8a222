"""RankingService: the request/response serving core of
``repro.serving.service``, ported.

* **Admission** -- :meth:`RankingService.submit` encodes each query through
  layers ``0..l`` once, through a small LRU of query reps.
* **Packing** -- candidate rows of every queued request are packed into
  fixed ``micro_batch``-row batches; padding rows replicate the last real
  row and their scores are discarded.
* **Staging** -- the candidates' stored reps are gathered on the host into
  pinned buffers and copied to the device (``TermRepIndex.stage``), then
  one ``join_and_score`` call scores the batch.
* **Responses** -- per request, doc ids sorted by descending score.

The prefetch thread, doc cache, straggler redispatch, faults and sharding
of the JAX service wait for later slices; staging and scoring run in turn.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prettr as P
from repro_torch.device import resolve_device, to_device


@dataclasses.dataclass
class RankRequest:
    """One re-ranking query: padded tokens, their validity and the
    candidate doc ids."""
    q_tokens: np.ndarray                  # [Lq] int tokens, padded
    q_valid: np.ndarray                   # [Lq] bool
    doc_ids: Sequence[int]
    request_id: str | None = None         # auto-assigned if None


@dataclasses.dataclass
class RerankStats:
    """Per-request phase split matching paper Table 5 (Query / load + H2D
    / Decompress + Combine); packed batches are attributed to their
    requests in proportion to rows."""
    query_encode_s: float = 0.0
    load_s: float = 0.0
    combine_s: float = 0.0
    n_docs: int = 0

    @property
    def total_s(self):
        return self.query_encode_s + self.load_s + self.combine_s


@dataclasses.dataclass
class RankResponse:
    request_id: str
    doc_ids: list[int]                    # sorted by descending score
    scores: np.ndarray                    # [n] float32, same order
    stats: RerankStats
    latency_s: float = 0.0                # submit -> completion wall time


@dataclasses.dataclass
class ServiceStats:
    """Aggregate counters across drained batches."""
    n_requests: int = 0
    n_batches: int = 0
    n_rows: int = 0                       # real candidate rows scored
    n_pad_rows: int = 0                   # shape-padding rows
    h2d_bytes: int = 0                    # doc-side bytes copied to device
    query_encode_s: float = 0.0
    load_s: float = 0.0
    combine_s: float = 0.0
    wall_s: float = 0.0                   # time inside drain()


class _ReqState:
    def __init__(self, req: RankRequest, rid: str):
        self.req = req
        self.rid = rid
        self.n = len(req.doc_ids)
        self.q_reps = None                # [1, Lq, d] device tensor
        self.q_valid = None               # [Lq] device bool tensor
        self.scores = np.zeros(self.n, np.float32)
        self.n_done = 0
        self.t_submit = time.perf_counter()
        self.stats = RerankStats(n_docs=self.n)


def validate_index_compat(cfg: P.PreTTRConfig, index) -> None:
    """Raise ValueError when ``index`` cannot be served under ``cfg``
    (wrong compression, rep width, split layer, or longer docs than the
    config pads to)."""
    if bool(index.compressed) != bool(cfg.compress_dim):
        raise ValueError(f"index compressed={bool(index.compressed)} but "
                         f"config compress_dim={cfg.compress_dim}")
    e = cfg.compress_dim or cfg.backbone.d_model
    if index.rep_dim != e:
        raise ValueError(f"index rep_dim={index.rep_dim} does not match the "
                         f"config's stored-rep width {e}")
    if index.l != cfg.l:
        raise ValueError(f"index was precomputed through l={index.l} but "
                         f"the config joins at l={cfg.l}")
    if index.max_doc_len > cfg.max_doc_len:
        raise ValueError(f"index max_doc_len={index.max_doc_len} exceeds "
                         f"config max_doc_len={cfg.max_doc_len}")


class RankingService:
    """Request/response re-ranking over a :class:`TermRepIndex`::

        svc = RankingService(params, cfg, index, micro_batch=32)
        svc.submit(RankRequest(q_tokens, q_valid, doc_ids))
        for resp in svc.drain():
            ...

    ``device`` (``None`` means the card) holds the params and runs the
    model; params are moved there once."""

    def __init__(self, params, cfg: P.PreTTRConfig, index, *,
                 micro_batch: int = 32, cache_size: int = 64, device=None):
        validate_index_compat(cfg, index)
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.index = index
        self.micro_batch = int(micro_batch)
        self.stats = ServiceStats()
        self._qcache: OrderedDict = OrderedDict()
        self._cache_size = cache_size
        self._queue: list[_ReqState] = []
        self._seq = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- admission -----------------------------------------------------------
    def submit(self, req: RankRequest) -> str:
        """Queue a request (its query is encoded now); returns its id."""
        rid = req.request_id or f"req-{self._seq}"
        ids = np.asarray(list(req.doc_ids), np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self.index)):
            raise ValueError(f"request {rid}: doc id out of range "
                             f"[0, {len(self.index)})")
        state = _ReqState(req, rid)
        self._seq += 1
        self.stats.n_requests += 1
        t0 = time.perf_counter()
        state.q_reps = self._query_reps(np.asarray(req.q_tokens),
                                        np.asarray(req.q_valid, bool))
        dt = time.perf_counter() - t0
        state.stats.query_encode_s = dt
        self.stats.query_encode_s += dt
        state.q_valid = torch.from_numpy(
            np.asarray(req.q_valid, bool)).to(self.device)
        self._queue.append(state)
        return rid

    def rank(self, q_tokens, q_valid, doc_ids) -> RankResponse:
        """Single-query convenience: submit + drain (drains every queued
        request; only this one's response is returned)."""
        rid = self.submit(RankRequest(q_tokens, q_valid, list(doc_ids)))
        return next(r for r in self.drain() if r.request_id == rid)

    def _query_reps(self, q_tokens: np.ndarray, q_valid: np.ndarray):
        key = (q_tokens.tobytes(), q_valid.tobytes())
        if key in self._qcache:
            self._qcache.move_to_end(key)
            return self._qcache[key]
        with torch.inference_mode():
            reps = P.encode_query(
                self.params, self.cfg,
                torch.from_numpy(q_tokens.astype(np.int64))[None]
                .to(self.device),
                torch.from_numpy(q_valid)[None].to(self.device))
        self._sync()
        self._qcache[key] = reps
        if len(self._qcache) > self._cache_size:
            self._qcache.popitem(last=False)
        return reps

    # -- packing, staging, scoring ----------------------------------------
    def _plans(self):
        rows = [(s, ci, int(d)) for s in self._queue
                for ci, d in enumerate(s.req.doc_ids)]
        for lo in range(0, len(rows), self.micro_batch):
            plan = rows[lo: lo + self.micro_batch]
            # fixed micro-batch shape; padding replicates the last real row
            yield plan + [(None, -1, plan[-1][2])] * (self.micro_batch
                                                      - len(plan))

    def _score_plan(self, plan):
        t0 = time.perf_counter()
        ids = [d for _, _, d in plan]
        reps, dvalid = self.index.stage(ids, pad_to=self.cfg.max_doc_len,
                                        device=self.device)
        last = next(s for s, _, _ in reversed(plan) if s is not None)
        qr = torch.cat([(s or last).q_reps for s, _, _ in plan])
        qv = torch.stack([(s or last).q_valid for s, _, _ in plan])
        self._sync()
        t1 = time.perf_counter()
        with torch.inference_mode():
            scores = P.join_and_score(self.params, self.cfg, qr, qv, reps,
                                      dvalid).cpu().numpy()
        t2 = time.perf_counter()
        states = [s for s, _, _ in plan if s is not None]
        self.stats.n_batches += 1
        self.stats.n_rows += len(states)
        self.stats.n_pad_rows += len(plan) - len(states)
        self.stats.h2d_bytes += reps.numel() * reps.element_size() \
            + dvalid.numel()
        self.stats.load_s += t1 - t0
        self.stats.combine_s += t2 - t1
        for i, (s, ci, _) in enumerate(plan):
            if s is None:
                continue
            s.scores[ci] = scores[i]
            s.n_done += 1
            s.stats.load_s += (t1 - t0) / len(states)
            s.stats.combine_s += (t2 - t1) / len(states)

    def drain(self) -> list[RankResponse]:
        """Score every queued request; responses in submission order."""
        t0 = time.perf_counter()
        for plan in self._plans():
            self._score_plan(plan)
        done = [self._finalize(s) for s in self._queue]
        self._queue.clear()
        self.stats.wall_s += time.perf_counter() - t0
        return done

    def _finalize(self, state: _ReqState) -> RankResponse:
        order = np.argsort(-state.scores, kind="stable")
        ids = list(state.req.doc_ids)
        return RankResponse(
            request_id=state.rid, doc_ids=[ids[i] for i in order],
            scores=state.scores[order], stats=state.stats,
            latency_s=time.perf_counter() - state.t_submit)
