"""RankingRouter: the query side of scale-out serving, the port of
``repro.serving.sharded.router``.

The router owns what a single-process ``RankingService`` owns except the
document side: admission (ids checked against the whole corpus,
``max_queue`` shedding), the query-rep LRU (each distinct query is
encoded through layers ``0..l`` once, however many shards its candidates
fan out to), shard-affinity routing, the scatter of per-shard candidate
slices to the :class:`~repro_torch.serving.sharded.worker.ShardWorker`\\ s,
the merge of their scores and the merged accounting.

**Shard affinity.**  Each candidate goes to the shard that stores its
bytes (:meth:`TermRepIndex.serving_assignment`); a worker gathers only
through its ``ShardIndexView``, which raises on a misrouted id.  Only
query reps go out to the workers and only float32 scores come back.  The
one exception is failover (below), counted in ``stats.n_failovers``.

**Faults.**  Each worker has a :class:`WorkerHealth`: ``healthy ->
degraded`` on a failed drain, ``-> dead`` after ``dead_after`` failures
in a row or at once on a drain timeout (the stuck thread still owns the
worker's engine, so it is never reused).  Drains run on a thread each and
are waited on by events under one wall timeout
(``SchedulerPolicy.drain_timeout``, or ``drain_timeout_s``), never an
unbounded ``join``.  A failed task is retried on its own worker up to
``max_retries`` times with linear backoff (``stats.n_retries``), then
failed over to a full-index fallback ``BatchEngine`` built on first use
(``stats.n_failovers``); rows that fail there too come back degraded:
``-inf`` scores, listed in ``failed_doc_ids``, every other row bit-exact
(``stats.n_degraded``).  A kernel that fails on a worker is a worker
fault like any other: it walks this ladder, never a plain fallback.

**Bit-exactness.**  A merged response equals what a single-process
``RankingService`` over the whole index returns for the same candidates:
each row is scored from the same stored bytes in a micro-batch of the
same fixed shape, and rows do not depend on their batch.

**Placement.**  ``mesh`` (a placement mesh with a ``"shard"`` axis,
``repro_torch.dist.compat.Mesh``) pins worker ``i`` to the ``i``-th
device of :func:`~repro_torch.dist.serving_shard_devices`; ``devices``
(one torch device a worker) pins worker ``i`` to ``devices[i]``; with
neither every worker shares ``device`` (``None`` means the card).  On
one card the workers add threads, not chips.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import prettr as P
from repro_torch.device import resolve_device, to_device
from repro_torch.serving.service import (BatchEngine, RankRequest,
                                         RankResponse, RerankStats,
                                         SchedulerPolicy,
                                         ServiceOverloadError, ServiceStats,
                                         validate_doc_routing,
                                         validate_index_compat)
from repro_torch.serving.sharded.worker import ShardTask, ShardWorker


class WorkerHealth:
    """Per-worker health: ``HEALTHY`` serves; ``DEGRADED`` (a recent drain
    failed) still serves, and the next clean drain restores ``HEALTHY``;
    ``DEAD`` (``dead_after`` failures in a row, or one drain timeout)
    gets no more traffic: the fallback engine serves its documents."""

    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DEAD = "dead"

    def __init__(self, shard_id: int, dead_after: int = 3):
        self.shard_id = int(shard_id)
        self.dead_after = max(1, int(dead_after))
        self.state = self.HEALTHY
        self.consecutive_failures = 0
        self.n_failures = 0
        self.n_timeouts = 0
        self.last_error: BaseException | None = None

    def on_success(self) -> None:
        if self.state != self.DEAD:
            self.state = self.HEALTHY
            self.consecutive_failures = 0

    def on_failure(self, err: BaseException | None = None) -> None:
        self.n_failures += 1
        self.consecutive_failures += 1
        if err is not None:
            self.last_error = err
        if self.state != self.DEAD:
            self.state = (self.DEAD
                          if self.consecutive_failures >= self.dead_after
                          else self.DEGRADED)

    def on_timeout(self, timeout_s: float) -> None:
        self.n_failures += 1
        self.n_timeouts += 1
        self.consecutive_failures += 1
        self.last_error = TimeoutError(
            f"shard {self.shard_id} drain exceeded {timeout_s:.1f}s")
        self.state = self.DEAD

    def __repr__(self):
        return (f"WorkerHealth(shard={self.shard_id}, {self.state}, "
                f"failures={self.n_failures}, timeouts={self.n_timeouts})")


class _RouterReq:
    """One in-flight request on the router: its candidates, the score
    buffer tasks scatter into, the rows still pending (retry and
    failover clones resolve row subsets, so rows are counted, not
    tasks), the rows no rung could score, and the router's own copy of
    the query reps the fallback engine scores with."""

    __slots__ = ("rid", "doc_ids", "scores", "stats", "t_submit",
                 "pending_rows", "failed_idx", "q_reps", "q_valid")

    def __init__(self, rid: str, doc_ids):
        self.rid = rid
        self.doc_ids = list(doc_ids)
        self.scores = np.zeros(len(self.doc_ids), np.float32)
        self.stats = RerankStats(n_docs=len(self.doc_ids))
        self.t_submit = time.perf_counter()
        self.pending_rows = 0
        self.failed_idx: set[int] = set()
        self.q_reps = None
        self.q_valid = None


class RankingRouter:
    """Scale-out re-ranking: one router, ``n_shards`` workers.

    The request surface of ``RankingService`` (``submit`` / ``drain`` /
    ``rank`` / ``stats`` / ``reset_stats`` / ``doc_cache``), so the serve
    CLI drives either.  ``doc_cache_mb`` is per worker.  ``stats`` merges
    the router's admission counters, every worker's and the fallback
    engine's (``ServiceStats.merge``); ``worker_stats`` keeps each
    worker's, ``health`` each worker's state.  Fault knobs:
    ``max_retries`` (with ``retry_backoff_s * attempt`` sleeps),
    ``dead_after``, ``drain_timeout_s`` (overrides the policy's budget)
    and ``max_queue`` (in-flight requests; ``submit`` sheds past it)."""

    def __init__(self, params, cfg: P.PreTTRConfig, index, *,
                 n_shards: int | None = None, mesh=None, devices=None,
                 device=None, backend: str | None = None,
                 micro_batch: int = 32,
                 policy: SchedulerPolicy | None = None,
                 cache_size: int = 64, prefetch_depth: int = 2,
                 deadline_s: float | None = None, encode_fn=None,
                 validate_index: bool = True, fused: bool = True,
                 use_layer_kv: bool | None = None,
                 doc_cache_mb: float = 0.0,
                 page_tokens: int | None = None,
                 page_bucket: bool = False, max_retries: int = 1,
                 retry_backoff_s: float = 0.05, dead_after: int = 3,
                 drain_timeout_s: float | None = None,
                 max_queue: int | None = None):
        if backend is not None:
            from repro_torch.models.backend import apply_backend
            cfg = apply_backend(cfg, backend)
        if mesh is not None:
            from repro_torch.dist import serving_shard_devices
            mesh_devs = serving_shard_devices(mesh)
            if devices is None:
                devices = mesh_devs
            if n_shards is None:
                n_shards = len(devices)
            if n_shards != len(devices):
                raise ValueError(
                    f"n_shards={n_shards} but the mesh's shard axis has "
                    f"{len(mesh_devs)} positions")
        if n_shards is None:
            n_shards = len(devices) if devices else 1
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if devices is not None and len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} shards")
        if validate_index:
            validate_index_compat(cfg, index)
        self.device = resolve_device(
            device if device is not None or not devices else devices[0])
        self.cfg = cfg
        self.index = index
        self.n_shards = int(n_shards)
        self.default_deadline_s = deadline_s
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.drain_timeout_s = drain_timeout_s
        self.max_queue = max_queue
        self.assignment = index.serving_assignment(self.n_shards)
        self._policy = policy or SchedulerPolicy()
        self.params = to_device(params, self.device)
        devs = list(devices) if devices is not None \
            else [self.device] * self.n_shards
        self.workers = [
            ShardWorker(self.params, cfg,
                        index.shard_view(self.assignment, s), shard_id=s,
                        device=devs[s], micro_batch=micro_batch,
                        policy=self._policy, prefetch_depth=prefetch_depth,
                        fused=fused, use_layer_kv=use_layer_kv,
                        doc_cache_mb=doc_cache_mb, page_tokens=page_tokens,
                        page_bucket=page_bucket)
            for s in range(self.n_shards)]
        self.health = [WorkerHealth(s, dead_after=dead_after)
                       for s in range(self.n_shards)]
        self._encode = encode_fn or (
            lambda p, t, v: P.encode_query(p, cfg, t, v))
        self._qcache: OrderedDict = OrderedDict()
        self._cache_size = cache_size
        self._seq = 0
        self._inflight: dict[str, _RouterReq] = {}
        self._done_early: list[RankResponse] = []
        #: the tasks each worker owes (cloned away when it fails)
        self._routed: list[list[ShardTask]] = [[] for _ in
                                               range(self.n_shards)]
        #: tasks of dead workers, routed around them at submit
        self._fallback_queue: list[ShardTask] = []
        # the fallback engine gathers an unhealthy shard's candidates from
        # the whole index; built on the first failover, rebuilt after it
        # fails itself, never doc-cached (cold and right over stale)
        self._fallback: BatchEngine | None = None
        self._fallback_stats = ServiceStats()
        self._engine_kwargs = dict(
            micro_batch=micro_batch, prefetch_depth=prefetch_depth,
            fused=fused, use_layer_kv=use_layer_kv)
        #: the router's own counters (requests, query encode, its drain
        #: wall, the ladder's); the workers' merge in through `stats`
        self._admission_stats = ServiceStats()

    # -- accounting ----------------------------------------------------------
    @property
    def stats(self) -> ServiceStats:
        """The router, every worker and the fallback engine merged;
        ``wall_s`` is the router's drain wall, which brackets the
        concurrent worker drains."""
        out = self._admission_stats
        for w in self.workers:
            out = out.merge(w.stats)
        out = out.merge(self._fallback_stats)
        if self._fallback is not None:
            out = out.merge(self._fallback.stats)
        return out

    @property
    def worker_stats(self) -> list[ServiceStats]:
        """Each worker's counters, in shard order."""
        return [w.stats for w in self.workers]

    @property
    def doc_cache(self):
        """Worker 0's doc cache (None when caching is off); each worker's
        is ``workers[i].doc_cache``."""
        return self.workers[0].doc_cache

    def reset_stats(self) -> None:
        self._admission_stats = ServiceStats()
        self._fallback_stats = ServiceStats()
        if self._fallback is not None:
            self._fallback.stats = ServiceStats()
        for w in self.workers:
            w.reset_stats()

    # -- admission -----------------------------------------------------------
    def submit(self, req: RankRequest) -> str:
        """Queue a request: check its ids against the whole corpus, encode
        its query once, split its candidates by shard and enqueue one
        :class:`ShardTask` on each live shard that stores any (a dead
        shard's go to the fallback).  Sheds with ServiceOverloadError past
        ``max_queue`` requests in flight."""
        rid = req.request_id or f"req-{self._seq}"
        if self.max_queue is not None \
                and len(self._inflight) >= self.max_queue:
            self._admission_stats.n_shed += 1
            raise ServiceOverloadError(
                f"request {rid} shed: {len(self._inflight)} requests in "
                f"flight (max_queue={self.max_queue}); drain() or back off")
        try:
            validate_doc_routing(self.index, req.doc_ids)
        except ValueError as e:
            raise ValueError(f"request {rid}: {e}") from None
        rec = _RouterReq(rid, req.doc_ids)
        seq = self._seq
        self._seq += 1
        self._admission_stats.n_requests += 1
        if not rec.doc_ids:                # nothing to rank: respond now
            self._done_early.append(RankResponse(
                request_id=rid, doc_ids=[],
                scores=np.zeros((0,), np.float32), stats=rec.stats))
            return rid
        t0 = time.perf_counter()
        q_valid_np = np.asarray(req.q_valid, bool)
        rec.q_reps = self._query_reps(np.asarray(req.q_tokens), q_valid_np)
        dt = time.perf_counter() - t0
        rec.stats.query_encode_s = dt
        self._admission_stats.query_encode_s += dt
        rec.q_valid = torch.from_numpy(q_valid_np).to(self.device)
        deadline = (req.deadline_s if req.deadline_s is not None
                    else self.default_deadline_s)
        ids = np.asarray(rec.doc_ids, np.int64)
        homes = self.assignment[ids]
        for s in np.unique(homes):
            sel = np.flatnonzero(homes == s)
            s = int(s)
            task = ShardTask(rid, seq, ids[sel].tolist(), sel,
                             priority=req.priority, deadline_s=deadline,
                             q_reps=rec.q_reps, q_valid=rec.q_valid,
                             shard_id=s)
            if self.health[s].state == WorkerHealth.DEAD:
                self._fallback_queue.append(task)
            else:
                w = self.workers[s]
                # the query reps cross to the shard: its only inbound data
                task.q_reps = w.put(rec.q_reps)
                task.q_valid = w.put(rec.q_valid)
                w.enqueue(task)
                self._routed[s].append(task)
            rec.pending_rows += len(sel)
        self._inflight[rid] = rec
        return rid

    def rank(self, q_tokens, q_valid, doc_ids, *, priority: int = 0,
             deadline_s: float | None = None,
             request_id: str | None = None) -> RankResponse:
        """Single-query convenience: submit + drain.  It drains every
        queued request; the others' responses come with the next
        ``drain()``."""
        rid = self.submit(RankRequest(q_tokens, q_valid, list(doc_ids),
                                      request_id=request_id,
                                      priority=priority,
                                      deadline_s=deadline_s))
        out = None
        for resp in self.drain():
            if resp.request_id == rid and out is None:
                out = resp
            else:
                self._done_early.append(resp)
        return out

    def _query_reps(self, q_tokens: np.ndarray, q_valid: np.ndarray):
        key = (q_tokens.tobytes(), q_valid.tobytes())
        if key in self._qcache:
            self._qcache.move_to_end(key)
            return self._qcache[key]
        with torch.inference_mode():
            reps = self._encode(
                self.params,
                torch.from_numpy(q_tokens.astype(np.int64))[None]
                .to(self.device),
                torch.from_numpy(q_valid)[None].to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._qcache[key] = reps
        if len(self._qcache) > self._cache_size:
            self._qcache.popitem(last=False)
        return reps

    # -- scatter / gather ----------------------------------------------------
    def drain(self) -> list[RankResponse]:
        """Drain every live worker at once under one wall timeout, walk
        failed tasks down the retry -> failover -> degrade ladder, merge
        the shards' scores and return the completed responses.  Never
        raises for a worker fault and never waits past the timeout: every
        submitted request gets a response, degraded if need be."""
        t_wall = time.perf_counter()
        done: list[RankResponse] = list(self._done_early)
        self._done_early.clear()
        fallback_tasks = list(self._fallback_queue)
        self._fallback_queue.clear()
        busy = [(s, w) for s, w in enumerate(self.workers)
                if w.pending and self.health[s].state != WorkerHealth.DEAD]
        if busy:
            timeout = self._drain_timeout()
            outcomes = self._timed_drains([w for _, w in busy], timeout)
            for (s, w), (status, payload) in zip(busy, outcomes):
                if status == "timeout":
                    # the stuck thread still owns the engine: clone its
                    # tasks away (its late writes land in the abandoned
                    # originals) and never use the worker again
                    self.health[s].on_timeout(timeout)
                    fallback_tasks += [t.clone() for t in self._routed[s]]
                    self._routed[s] = []
                elif status == "error":
                    self.health[s].on_failure(payload)
                    w.abandon()
                    clones = [t.clone() for t in self._routed[s]]
                    self._routed[s] = []
                    fallback_tasks += self._retry(s, clones, done)
                else:
                    retry_clones: list[ShardTask] = []
                    err = None
                    for task in payload:
                        retry_clones += self._merge_task(task, done)
                        err = task.error or err
                    self._routed[s] = []
                    if retry_clones:
                        # micro-batches the engine failed: worker trouble
                        self.health[s].on_failure(err)
                        fallback_tasks += self._retry(s, retry_clones, done)
                    else:
                        self.health[s].on_success()
        self._failover(fallback_tasks, done)
        self._admission_stats.wall_s += time.perf_counter() - t_wall
        return done

    def _timed_drains(self, targets, timeout_s: float):
        """Each target's ``drain()`` on a thread of its own under one wall
        deadline -> ``("ok", tasks)`` / ``("error", exc)`` /
        ``("timeout", None)`` in target order.  Completion is read from
        per-thread events, never an unbounded ``join``."""
        results: list = [None] * len(targets)
        errors: list = [None] * len(targets)
        events = [threading.Event() for _ in targets]

        def _run(i, t):
            try:
                results[i] = t.drain()
            except BaseException as e:                # noqa: BLE001
                errors[i] = e
            finally:
                events[i].set()

        for i, t in enumerate(targets):
            threading.Thread(target=_run, args=(i, t), daemon=True).start()
        deadline = time.monotonic() + timeout_s
        out = []
        for i, ev in enumerate(events):
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                out.append(("timeout", None))
            elif errors[i] is not None:
                out.append(("error", errors[i]))
            else:
                out.append(("ok", results[i]))
        return out

    def _drain_timeout(self) -> float:
        if self.drain_timeout_s is not None:
            return self.drain_timeout_s
        deadlines, n_rows = [], 0
        for tasks in self._routed:
            for t in tasks:
                deadlines.append(t.deadline_s)
                n_rows += t.n
        return self._policy.drain_timeout(deadlines, n_rows)

    # -- the recovery ladder -------------------------------------------------
    def _retry(self, s: int, tasks: list[ShardTask],
               done: list) -> list[ShardTask]:
        """Re-enqueue failed tasks' clones on their own worker, at most
        ``max_retries`` times with linear backoff; returns what no attempt
        recovered (it goes on to failover)."""
        remaining = tasks
        attempt = 0
        while (remaining and attempt < self.max_retries
               and self.health[s].state != WorkerHealth.DEAD):
            attempt += 1
            self._admission_stats.n_retries += len(remaining)
            time.sleep(self.retry_backoff_s * attempt)
            w = self.workers[s]
            for t in remaining:
                w.enqueue(t)
            self._routed[s] = list(remaining)
            timeout = self._drain_timeout()
            (status, payload), = self._timed_drains([w], timeout)
            if status == "timeout":
                self.health[s].on_timeout(timeout)
                remaining = [t.clone() for t in self._routed[s]]
                self._routed[s] = []
                break
            if status == "error":
                self.health[s].on_failure(payload)
                w.abandon()
                remaining = [t.clone() for t in self._routed[s]]
                self._routed[s] = []
                continue
            next_round: list[ShardTask] = []
            err = None
            for task in payload:
                next_round += self._merge_task(task, done)
                err = task.error or err
            self._routed[s] = []
            if next_round:
                self.health[s].on_failure(err)
            else:
                self.health[s].on_success()
            remaining = next_round
        return remaining

    def _failover(self, tasks: list[ShardTask], done: list) -> None:
        """Score tasks through the full-index fallback engine (affinity
        broken on purpose: the shard that stores the bytes is
        unhealthy); rows it fails too degrade."""
        if not tasks:
            return
        self._admission_stats.n_failovers += len(tasks)
        if self._fallback is None:
            self._fallback = BatchEngine(
                self.params, self.cfg, self.index, policy=self._policy,
                device=self.device, fault_tag="fallback",
                **self._engine_kwargs)
        eng = self._fallback
        clones = []
        for t in tasks:
            rec = self._inflight.get(t.rid)
            if rec is None:
                continue
            c = t.clone(q_reps=rec.q_reps, q_valid=rec.q_valid)
            clones.append(c)
            eng.enqueue(c)
        (status, payload), = self._timed_drains([eng], self._drain_timeout())
        if status == "ok":
            for task in payload:
                for c in self._merge_task(task, done):
                    self._degrade_rows(c, done)
            return
        if status == "error":
            eng.abandon_pending()
        # a timed-out fallback's thread still owns the engine, a failed
        # one may be wedged: keep its counters, rebuild it on next use
        self._fallback_stats = self._fallback_stats.merge(eng.stats)
        self._fallback = None
        for c in clones:
            self._degrade_rows(c, done)

    # -- merge ---------------------------------------------------------------
    def _merge_task(self, task: ShardTask, done: list) -> list[ShardTask]:
        """Scatter a completed task's good rows into its request; returns
        a clone of its failed rows, if any, for the next rung."""
        rec = self._inflight.get(task.rid)
        if rec is None:
            return []
        failed = sorted(set(task.failed_idx))
        bad = set(failed)
        good = [i for i in range(task.n) if i not in bad]
        if good:
            rec.scores[task.cand_idx[good]] = task.scores[good]
            rec.pending_rows -= len(good)
        rec.stats.load_s += task.stats.load_s
        rec.stats.combine_s += task.stats.combine_s
        rec.stats.n_redispatch += task.stats.n_redispatch
        self._maybe_finish(rec, done)
        return [task.clone(failed)] if failed else []

    def _degrade_rows(self, task: ShardTask, done: list) -> None:
        """The ladder's end: every row of ``task`` is unrecoverable; it
        scores ``-inf`` (sorts last) and is listed on the response."""
        rec = self._inflight.get(task.rid)
        if rec is None:
            return
        for ci in task.cand_idx:
            rec.failed_idx.add(int(ci))
            rec.scores[ci] = -np.inf
        rec.pending_rows -= task.n
        self._maybe_finish(rec, done)

    def _maybe_finish(self, rec: _RouterReq, done: list) -> None:
        if rec.pending_rows <= 0 and rec.rid in self._inflight:
            del self._inflight[rec.rid]
            done.append(self._finalize(rec))

    def _finalize(self, rec: _RouterReq) -> RankResponse:
        order = np.argsort(-rec.scores, kind="stable")
        failed = sorted(rec.failed_idx)
        if failed:
            self._admission_stats.n_degraded += 1
        return RankResponse(
            request_id=rec.rid, doc_ids=[rec.doc_ids[i] for i in order],
            scores=rec.scores[order], stats=rec.stats,
            latency_s=time.perf_counter() - rec.t_submit,
            degraded=bool(failed),
            failed_doc_ids=[rec.doc_ids[i] for i in failed])
