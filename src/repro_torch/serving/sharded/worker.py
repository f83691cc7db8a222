"""ShardWorker: one serving shard's half of the scale-out split, the port
of ``repro.serving.sharded.worker``.

A worker owns everything on the document side of one slice of the
corpus: the :class:`~repro_torch.index.store.ShardIndexView` of its
slice (which refuses an id another shard stores), and a
:class:`~repro_torch.serving.service.BatchEngine` over it with its own
paged doc cache, prefetch thread and scoring calls, on the worker's
device.  It has no query side: the router encodes each query once and
hands the worker its reps inside :class:`ShardTask` objects, so a task's
rows score exactly as the single-process service scores the same
candidates (the same stored bytes through the same fixed micro-batch
shape, and rows do not depend on their batch).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.device import resolve_device, to_device
from repro_torch.serving import faults
from repro_torch.serving.service import (BatchEngine, RerankStats,
                                         SchedulerPolicy, ServiceStats)


@dataclasses.dataclass
class _TaskDocs:
    """The ``req`` an engine state carries (the engine reads
    ``doc_ids`` only)."""
    doc_ids: list


class ShardTask:
    """One request's candidates routed to one shard: an engine state (see
    ``BatchEngine``) plus what the router merges by: ``rid`` and
    ``cand_idx``, each row's position in the request's own candidate
    list (so repeated ids and interleavings scatter back exactly)."""

    __slots__ = ("req", "rid", "seq", "n", "priority", "deadline_s",
                 "q_reps", "q_valid", "scores", "n_done", "t_submit",
                 "stats", "cand_idx", "shard_id", "failed_idx", "error")

    def __init__(self, rid: str, seq: int, doc_ids, cand_idx, *,
                 priority: int = 0, deadline_s: float | None = None,
                 q_reps=None, q_valid=None, shard_id: int = 0):
        self.req = _TaskDocs(doc_ids=list(doc_ids))
        self.rid = rid
        self.seq = seq
        self.n = len(self.req.doc_ids)
        self.priority = priority
        self.deadline_s = deadline_s
        self.q_reps = q_reps              # [1, Lq, d] on the worker's device
        self.q_valid = q_valid            # [Lq] on the worker's device
        self.scores = np.zeros(self.n, np.float32)
        self.n_done = 0
        self.t_submit = time.perf_counter()
        self.stats = RerankStats(n_docs=self.n)
        self.cand_idx = np.asarray(cand_idx, np.int64)
        self.shard_id = shard_id
        self.failed_idx: list[int] = []   # task rows a fault failed
        self.error: BaseException | None = None

    def clone(self, sel=None, *, q_reps=None, q_valid=None,
              shard_id: int | None = None) -> "ShardTask":
        """A fresh, unscored task over rows ``sel`` of this one (None:
        all): what retry and failover enqueue, so a stale drain thread's
        late writes land in the abandoned original, never in the copy."""
        sel = list(range(self.n) if sel is None else sel)
        return ShardTask(
            self.rid, self.seq, [self.req.doc_ids[i] for i in sel],
            self.cand_idx[sel], priority=self.priority,
            deadline_s=self.deadline_s,
            q_reps=self.q_reps if q_reps is None else q_reps,
            q_valid=self.q_valid if q_valid is None else q_valid,
            shard_id=self.shard_id if shard_id is None else shard_id)


class ShardWorker:
    """One index shard's scoring node.

    ``index_view`` is the shard's :class:`ShardIndexView`; ``device``
    (``None`` means the card) holds the worker's params, staged batches
    and doc-cache pools.  Its engine's drain and prefetch thread run with
    that device current (``repro_torch.device.device_scope``): each
    worker drains on a thread of its own, and the kernels launch on the
    calling thread's current card.  The engine's fault tag is the shard
    id."""

    def __init__(self, params, cfg, index_view, *, shard_id: int,
                 device=None, micro_batch: int = 32,
                 policy: SchedulerPolicy | None = None,
                 prefetch_depth: int = 2, fused: bool = True,
                 use_layer_kv: bool | None = None,
                 doc_cache_mb: float = 0.0,
                 page_tokens: int | None = None,
                 page_bucket: bool = False):
        self.shard_id = int(shard_id)
        self.device = resolve_device(device)
        self.index = index_view
        self.engine = BatchEngine(
            to_device(params, self.device), cfg, index_view,
            micro_batch=micro_batch, policy=policy,
            prefetch_depth=prefetch_depth, fused=fused,
            use_layer_kv=use_layer_kv, doc_cache_mb=doc_cache_mb,
            page_tokens=page_tokens, page_bucket=page_bucket,
            device=self.device, fault_tag=self.shard_id)

    def put(self, x):
        """``x`` on this worker's device (itself when it is there)."""
        return x.to(self.device)

    @property
    def n_owned(self) -> int:
        return self.index.n_owned

    @property
    def stats(self) -> ServiceStats:
        return self.engine.stats

    def reset_stats(self) -> None:
        self.engine.stats = ServiceStats()

    @property
    def doc_cache(self):
        return self.engine.doc_cache

    @property
    def pending(self) -> bool:
        return self.engine.pending

    def enqueue(self, task: ShardTask) -> None:
        self.engine.enqueue(task)

    def drain(self) -> list[ShardTask]:
        """Score every enqueued task -> the completed tasks; safe to run
        beside other workers' drains."""
        faults.hit("worker.drain", tag=self.shard_id)
        return self.engine.drain()

    def abandon(self) -> list[ShardTask]:
        """Drop every enqueued, unfinished task (the router re-runs them
        elsewhere); returns the distinct tasks dropped."""
        return self.engine.abandon_pending()
