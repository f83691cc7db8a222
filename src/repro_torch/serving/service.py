"""The ranking service, the port of ``repro.serving.service``.

* :class:`BatchEngine` -- scheduling, staging and scoring: candidate rows
  of every enqueued request are packed, in the order the
  :class:`SchedulerPolicy` gives, into fixed ``micro_batch``-row batches
  (padding rows replicate the last real row; their scores are discarded);
  each batch's stored streams are staged and one ``join_and_score`` call
  scores it.
* :class:`RankingService` -- admission and responses over one engine:
  :meth:`~RankingService.submit` sheds past ``max_queue``, refuses a
  request whose ids the index cannot gather (:func:`validate_doc_routing`)
  and encodes each query through layers ``0..l`` once, through a small
  LRU of query reps; responses list doc ids by descending score.
  ``encode_fn`` / ``join_fn`` replace the model's entry points (the
  ``Reranker`` client binds them late).

**Prefetch.**  With ``prefetch_depth`` > 0 (default 2) a thread stages
the next planned micro-batches while the card scores the current one:
the host gather into pinned buffers and the H2D copy run on a side CUDA
stream; the scoring stream waits on that copy's event before it reads,
and the staged tensors are recorded on the scoring stream so the caching
allocator does not reuse them early.  ``prefetch_depth=0`` stages and
scores in turn on the calling thread; scores are the same bits either
way.  With the doc cache, the host bookkeeping (``plan``) runs on the
thread and the pool inserts on the scoring thread in batch order, after
the miss rows' copy (``repro_torch.serving.doc_cache``).

**Stragglers and faults.**  A micro-batch whose scoring overshoots the
tightest deadline of its requests is split in half and re-dispatched
(``SchedulerPolicy``, bounded depth); the overshooting attempt's scores
are discarded.  An error while staging or scoring one micro-batch
(including one injected through :mod:`repro_torch.serving.faults`) fails
only that micro-batch's rows: they score ``-inf`` and their responses are
flagged ``degraded`` with the ``failed_doc_ids``; the drain goes on.

Staging is codec-aware: the raw stored streams (int8 payload and scales
for a quantising codec) are copied to the card and decoded there.  With
``use_layer_kv`` the index's stored layer-``l`` K/V go to the join too
(int8 K/V are dequantised inside the join kernel).  With ``doc_cache_mb``
the raw streams stay resident in a
:class:`~repro_torch.serving.doc_cache.DeviceDocCache` and only misses
are staged; on the ``"cuda"`` impl with stored K/V the cache's pools go
to the join as a :class:`~repro_torch.core.prettr.PagedDocKV`, otherwise
each batch is assembled from the pools by page-table gathers.
``fused=False`` scores through the legacy concat join (no stored K/V).

Phase clocks keep the JAX service's meaning: ``load_s`` sums each
micro-batch's staging time (gather, copy and its completion), which the
prefetch thread overlaps with scoring, so phase sums can exceed the wall
time; ``combine_s`` sums the scoring calls.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import Counter, OrderedDict, deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prettr as P
from repro_torch.device import resolve_device, to_device
from repro_torch.serving import faults
from repro_torch.serving.doc_cache import DeviceDocCache


@dataclasses.dataclass
class RankRequest:
    """One re-ranking query: padded tokens, their validity and the
    candidate doc ids.  ``priority``: lower is scheduled earlier (under
    :class:`DeadlinePriorityPolicy`; the default policy too orders by it).
    ``deadline_s``: the scoring deadline of a micro-batch holding this
    request's rows (defaults to the service's)."""
    q_tokens: np.ndarray                  # [Lq] int tokens, padded
    q_valid: np.ndarray                   # [Lq] bool
    doc_ids: Sequence[int]
    request_id: str | None = None         # auto-assigned if None
    priority: int = 0
    deadline_s: float | None = None


@dataclasses.dataclass
class RerankStats:
    """Per-request phase split matching paper Table 5 (Query / load + H2D
    / Decompress + Combine); packed batches are attributed to their
    requests in proportion to rows."""
    query_encode_s: float = 0.0
    load_s: float = 0.0
    combine_s: float = 0.0
    n_docs: int = 0
    n_redispatch: int = 0

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
    #: a fault failed some rows: they score -inf and sort last; every
    #: other doc id scored as in a run without the fault
    degraded: bool = False
    failed_doc_ids: list[int] = dataclasses.field(default_factory=list)


class ServiceOverloadError(RuntimeError):
    """``submit()`` shed this request: ``max_queue`` requests are already
    queued for the next drain (counted in ``ServiceStats.n_shed``).
    Nothing was enqueued."""


@dataclasses.dataclass
class ServiceStats:
    """Aggregate counters across drained batches."""
    n_requests: int = 0
    n_batches: int = 0                    # accepted (not redispatched)
    n_rows: int = 0                       # real candidate rows scored
    n_pad_rows: int = 0                   # shape-padding rows
    n_redispatch: int = 0                 # micro-batches split on deadline
    n_failed_rows: int = 0                # rows a fault failed (-inf)
    n_degraded: int = 0                   # responses with failed rows
    n_shed: int = 0                       # requests shed at admission
    h2d_bytes: int = 0                    # doc-side bytes copied to device
    n_join_dispatch: int = 0              # join_and_score calls
    n_decode_dispatch: int = 0            # standalone decode calls (none)
    n_doc_cache_hit: int = 0              # real rows served from the cache
    n_doc_cache_miss: int = 0             # real rows staged into it
    resident_docs: int = 0                # cache residents after a batch
    doc_hbm_bytes: int = 0                # doc-side bytes the join reads
    query_encode_s: float = 0.0
    load_s: float = 0.0                   # staging, overlapped by prefetch
    combine_s: float = 0.0
    discarded_s: float = 0.0              # redispatched attempts' time
    wall_s: float = 0.0                   # time inside drain()

    @property
    def pack_fill(self) -> float:
        """Fraction of scored batch rows that were real candidates."""
        return self.n_rows / max(1, self.n_rows + self.n_pad_rows)

    @property
    def doc_cache_hit_rate(self) -> float:
        n = self.n_doc_cache_hit + self.n_doc_cache_miss
        return self.n_doc_cache_hit / n if n else 0.0


class SchedulerPolicy:
    """Packing order and straggler policy: requests are admitted by
    (priority, arrival), and a micro-batch whose scoring overshoots the
    tightest deadline of its requests is split in half and re-dispatched,
    at most ``max_split_depth`` times.  Subclass to change the order
    (:meth:`admission_key`), the batch deadline (:meth:`batch_deadline`)
    or the split (:meth:`split`)."""

    def __init__(self, max_split_depth: int = 2):
        self.max_split_depth = max_split_depth

    def admission_key(self, state: "_ReqState"):
        return (state.priority, state.seq)

    def batch_deadline(self, deadlines: Sequence[float | None]
                       ) -> float | None:
        """The deadline of a packed batch: its tightest row deadline."""
        ds = [d for d in deadlines if d is not None]
        return min(ds) if ds else None

    def should_redispatch(self, elapsed_s: float, deadline_s: float | None,
                          n_rows: int, depth: int) -> bool:
        return (deadline_s is not None and elapsed_s > deadline_s
                and n_rows > 1 and depth < self.max_split_depth)

    def split(self, rows: list) -> list[list]:
        mid = len(rows) // 2
        return [rows[:mid], rows[mid:]]


class DeadlinePriorityPolicy(SchedulerPolicy):
    """Admission by (priority, tightest deadline, arrival), so urgent
    requests' rows land in the earliest micro-batches."""

    def admission_key(self, state: "_ReqState"):
        d = state.deadline_s if state.deadline_s is not None \
            else float("inf")
        return (state.priority, d, state.seq)


class _ReqState:
    def __init__(self, req: RankRequest, rid: str, seq: int,
                 deadline_s: float | None):
        self.req = req
        self.rid = rid
        self.seq = seq
        self.n = len(req.doc_ids)
        self.priority = req.priority
        self.deadline_s = deadline_s
        self.q_reps = None                # [1, Lq, d] device tensor
        self.q_valid = None               # [Lq] device bool tensor
        self.scores = np.zeros(self.n, np.float32)
        self.n_done = 0
        self.t_submit = time.perf_counter()
        self.stats = RerankStats(n_docs=self.n)
        self.failed_idx: list[int] = []   # candidate rows a fault failed
        self.error: BaseException | None = None   # the last such fault


@dataclasses.dataclass
class _Plan:
    """One planned micro-batch: rows are (state | None, candidate index,
    doc id); a None state marks a padding row.  ``depth`` counts the
    deadline splits that made it."""
    rows: list
    depth: int = 0


_STOP = object()


def validate_doc_routing(index, doc_ids) -> None:
    """Raise ValueError when any of ``doc_ids`` cannot be gathered from
    ``index``: out of its id range, or refused by the index's
    ``describe_misroute`` hook where it has one (a serving shard's view
    names the shard that stores a misrouted id).  Called at admission, so
    a bad id fails its own request, not the drain that packs it."""
    ids = np.asarray(list(doc_ids), np.int64).reshape(-1)
    if ids.size == 0:
        return
    if ids.min() < 0 or ids.max() >= len(index):
        raise ValueError(f"doc id out of range [0, {len(index)})")
    describe = getattr(index, "describe_misroute", None)
    if describe is not None:
        msg = describe(ids)
        if msg:
            raise ValueError(msg)


def validate_index_compat(cfg: P.PreTTRConfig, index) -> None:
    """Raise ValueError when ``index`` cannot be served under ``cfg``
    (wrong compression, rep width, split layer or K/V width, or longer
    docs than the config pads to)."""
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
    if index.has_layer_kv:
        want = cfg.backbone.n_kv_heads * cfg.backbone.dh
        if index.kv_dim != want:
            raise ValueError(
                f"index stores layer-l K/V streams of width {index.kv_dim} "
                f"but the config's K/V width is {want} (n_kv_heads * "
                f"head_dim)")
    # a manifest that records max_doc_len 0 falls back to the longest
    # stored document, so truncation cannot slip through
    lengths = index.doc_lengths
    idx_max = index.max_doc_len or (int(lengths.max()) if len(lengths)
                                    else 0)
    if idx_max > cfg.max_doc_len:
        raise ValueError(f"index max_doc_len={idx_max} exceeds config "
                         f"max_doc_len={cfg.max_doc_len}: serving would "
                         f"silently truncate stored documents")


class BatchEngine:
    """Schedules enqueued request states into micro-batches, stages their
    stored streams (on a prefetch thread when ``prefetch_depth`` > 0) and
    scores them.

    A state has ``req.doc_ids``, ``q_reps`` ([1, Lq, d] on the engine's
    device), ``q_valid`` ([Lq]), ``priority`` / ``seq`` / ``deadline_s``,
    ``scores`` / ``n`` / ``n_done`` / ``failed_idx`` / ``error`` and
    ``stats``.  ``fused=False`` scores through the legacy concat join.
    ``use_layer_kv`` (default: the index stores layer-``l`` K/V and the
    join is fused) feeds the stored K/V to the join; ``doc_cache_mb`` > 0
    keeps the raw streams resident in a paged device cache of that size
    (``page_tokens``, ``page_bucket`` as
    :class:`~repro_torch.serving.doc_cache.DeviceDocCache`).
    ``join_fn(params, q_reps, q_valid, doc_store, doc_valid)`` replaces
    the model's ``join_and_score``: the engine then decodes a quantising
    codec's reps in a call of its own (counted in ``n_decode_dispatch``)
    and hands it the decoded reps; it takes no stored K/V and no doc
    cache.  ``fault_tag`` names this engine at the fault-injection
    sites."""

    def __init__(self, params, cfg: P.PreTTRConfig, index, *,
                 micro_batch: int = 32, policy: SchedulerPolicy | None = None,
                 prefetch_depth: int = 2, fused: bool = True,
                 use_layer_kv: bool | None = None, join_fn=None,
                 doc_cache_mb: float = 0.0, page_tokens: int | None = None,
                 page_bucket: bool = False, device=None, fault_tag=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.index = index
        self.micro_batch = int(micro_batch)
        self.policy = policy or SchedulerPolicy()
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.fused = bool(fused)
        self.fault_tag = fault_tag
        self.stats = ServiceStats()
        self._join_fn = join_fn
        has_kv = index.has_layer_kv
        if use_layer_kv is None:
            # an injected join_fn takes the five-argument call only
            use_layer_kv = has_kv and self.fused and join_fn is None
        if join_fn is not None and (use_layer_kv or doc_cache_mb > 0):
            raise ValueError(
                "an injected join_fn scores dense decoded reps only; it "
                "takes no stored layer-l K/V (use_layer_kv) and no doc "
                "cache (doc_cache_mb)")
        if use_layer_kv and not has_kv:
            raise ValueError(
                "use_layer_kv=True but the index has no layer_k/layer_v "
                "streams; rebuild it with IndexBuilder(store_layer_kv=True)")
        if use_layer_kv and not self.fused:
            raise ValueError("stored layer-l K/V streams require the fused "
                             "join path (fused=True)")
        self.use_layer_kv = bool(use_layer_kv)
        self.codec = index.codec
        self.kv_codec = index.kv_codec
        self._kv_quant = (self.use_layer_kv and self.kv_codec is not None
                          and not self.kv_codec.decode_is_identity)
        # the streams to stage: the K/V pair only when the join reads it
        self._kv_streams = (list(index.kv_streams_spec())
                            if self.use_layer_kv else [])
        self._rep_streams = list(self.codec.streams(index.rep_dim))
        self._streams = self._rep_streams + self._kv_streams
        self._doc_lens = np.asarray(index.doc_lengths)
        self._paged_join = (self.use_layer_kv
                            and cfg.backbone.attn_impl == "cuda")
        self._cache = None
        if doc_cache_mb and doc_cache_mb > 0:
            spec = index.streams_spec()
            self._cache = DeviceDocCache(
                int(doc_cache_mb * 2**20), doc_len=cfg.max_doc_len,
                streams={s: spec[s] for s in self._streams},
                page_tokens=page_tokens, page_bucket=page_bucket,
                min_slots=2 * self.micro_batch, device=self.device)
        # staging copies run on their own stream, so they overlap scoring
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._waiting: list = []           # enqueued, not yet planned
        self._rows: deque = deque()        # planned row pool
        self._replans: deque = deque()     # deadline re-dispatch plans

    @property
    def doc_cache(self) -> DeviceDocCache | None:
        """The device doc cache (None when disabled)."""
        return self._cache

    @property
    def pending(self) -> bool:
        return bool(self._waiting or self._rows or self._replans)

    def enqueue(self, state) -> None:
        """Admit a state's rows into the next drain (ordered by the policy
        at drain time)."""
        self._waiting.append(state)

    # -- scheduling --------------------------------------------------------------
    def _admit_waiting(self):
        for state in sorted(self._waiting, key=self.policy.admission_key):
            for ci, d in enumerate(state.req.doc_ids):
                self._rows.append((state, ci, int(d)))
        self._waiting.clear()

    def _next_plan(self) -> _Plan | None:
        if self._replans:
            return self._replans.popleft()
        if not self._rows:
            return None
        rows = [self._rows.popleft()
                for _ in range(min(self.micro_batch, len(self._rows)))]
        # fixed micro-batch shape; padding replicates the last real row
        rows += [(None, -1, rows[-1][2])] * (self.micro_batch - len(rows))
        return _Plan(rows=rows)

    # -- staging -----------------------------------------------------------------
    def _stage(self, plan: _Plan):
        """Gather and copy one batch's doc-side operands -> (payload,
        seconds).  On the card the copies run on the side stream; the
        clock stops when they have completed."""
        t0 = time.perf_counter()
        ids = [d for _, _, d in plan.rows]
        faults.hit("engine.stage", tag=self.fault_tag)
        faults.hit("index.gather", tag=self.fault_tag, index=self.index,
                   doc_ids=ids)
        if self._copy_stream is None:
            payload = self._stage_rows(plan, ids)
        else:
            with torch.cuda.stream(self._copy_stream):
                payload = self._stage_rows(plan, ids)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
            ready.synchronize()
            payload["ready"] = ready
        return payload, time.perf_counter() - t0

    def _stage_rows(self, plan, ids):
        if self._cache is not None:
            return self._stage_cached(plan, ids)
        parts, valid = self.index.stage(ids, pad_to=self.cfg.max_doc_len,
                                        streams=self._streams,
                                        device=self.device)
        return {"parts": parts, "valid": valid,
                "h2d_bytes": _nbytes(parts.values()) + valid.numel(),
                "staged": [*parts.values(), valid]}

    def _stage_cached(self, plan, ids):
        """Plan pages (LRU bump + miss admission), then gather and copy
        only the misses, at the planned page-table width; the scoring
        thread inserts them."""
        cache = self._cache
        real = [d for s, _, d in plan.rows if s is not None]
        page_table, miss_ids, miss_pages = cache.plan(
            ids, lengths=self._doc_lens[ids], n_real=len(real))
        fresh = set(miss_ids)
        n_miss = sum(1 for d in real if d in fresh)
        payload = {"page_table": page_table, "h2d_bytes": 0,
                   "n_miss_rows": n_miss, "n_rows": len(real),
                   "miss": None}
        if miss_ids:
            pad = cache.bucket(len(miss_ids), self.micro_batch) \
                - len(miss_ids)
            padded = miss_ids + [miss_ids[-1]] * pad
            pages = (np.concatenate([miss_pages,
                                     np.repeat(miss_pages[-1:], pad, 0)])
                     if pad else miss_pages)
            parts, valid = self.index.stage(
                padded, pad_to=pages.shape[1] * cache.page_tokens,
                streams=self._streams, device=self.device)
            payload["miss"] = (pages, parts, valid)
            payload["h2d_bytes"] = _nbytes(parts.values()) + valid.numel()
        pt = torch.from_numpy(page_table.astype(np.int64)).to(self.device)
        payload["page_table_dev"] = pt
        payload["staged"] = [pt] + ([*parts.values(), valid]
                                    if miss_ids else [])
        return payload

    def _prefetch_loop(self, in_q: queue.Queue, out_q: queue.Queue):
        """Prefetch thread: stage the planned batches in order; an error
        travels with its plan."""
        while True:
            plan = in_q.get()
            if plan is _STOP:
                return
            out_q.put(self._staged(plan))

    def _staged(self, plan: _Plan):
        """(plan, payload, seconds, error): a staging error travels with
        its plan, so that it fails this plan only."""
        try:
            return (plan, *self._stage(plan), None)
        except Exception as e:                        # noqa: BLE001
            return (plan, None, 0.0, e)

    def _finish_plan(self, plan, payload, load_dt, err, done: list):
        """Score one staged plan, or fail it (and only it) on an error from
        its staging or its scoring."""
        if err is None:
            try:
                self._score_plan(plan, payload, load_dt, done)
                return
            except Exception as e:                    # noqa: BLE001
                err = e
        self._fail_plan(plan, err, done)

    # -- scoring -----------------------------------------------------------------
    def _handoff(self, payload):
        """Order the scoring stream after the staging copies, and keep the
        staged tensors alive for it."""
        if self._copy_stream is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(payload["ready"])
        for t in payload["staged"]:
            t.record_stream(cur)

    def _decode_reps(self, parts):
        """Join-input reps from the raw ``reps`` group on the device."""
        if self.codec.decode_is_identity:
            return parts["reps"]
        return self.codec.decode_group("reps", parts)

    def _dense_kv(self, parts):
        """The stored-K/V operand from dense raw streams: (k, v), or
        (k, v, k_scale, v_scale) for int8 K/V; None without it."""
        if not self.use_layer_kv:
            return None
        dkv = (parts["layer_k"], parts["layer_v"])
        if self._kv_quant:
            dkv += (parts[self.kv_codec.scale_stream("layer_k")],
                    parts[self.kv_codec.scale_stream("layer_v")])
        return dkv

    def _score_batch(self, qr, qv, payload):
        """One join_and_score call for the batch; with the doc cache the
        staged misses are inserted first (even if scoring then fails: the
        cache's plan already counts them resident), then every row is
        assembled from the pools."""
        cache = self._cache
        if cache is not None and payload["miss"] is not None:
            cache.insert(*payload["miss"])
        faults.hit("engine.score", tag=self.fault_tag)
        self.stats.h2d_bytes += payload["h2d_bytes"]
        self.stats.n_join_dispatch += 1
        if self._join_fn is not None:
            self.stats.doc_hbm_bytes += payload["h2d_bytes"]
            parts = payload["parts"]
            if not self.codec.decode_is_identity:
                self.stats.n_decode_dispatch += 1
            return self._join_fn(self.params, qr, qv,
                                 self._decode_reps(parts), payload["valid"])
        if self._cache is None:
            self.stats.doc_hbm_bytes += payload["h2d_bytes"]
            parts = payload["parts"]
            return P.join_and_score(self.params, self.cfg, qr, qv,
                                    self._decode_reps(parts),
                                    payload["valid"],
                                    doc_kv=self._dense_kv(parts),
                                    fused=self.fused)
        self.stats.n_doc_cache_miss += payload["n_miss_rows"]
        self.stats.n_doc_cache_hit += (payload["n_rows"]
                                       - payload["n_miss_rows"])
        self.stats.resident_docs = cache.resident_docs
        # doc-side bytes the join reads: one page per page-table entry
        self.stats.doc_hbm_bytes += payload["page_table"].size \
            * cache.page_bytes
        pt = payload["page_table_dev"]
        pools = cache.pools
        b, w = pt.shape
        dense = lambda a: a[pt].reshape(b, w * cache.page_tokens,
                                        *a.shape[2:])
        dval = dense(cache.valid_pool).bool()
        x_d = self._decode_reps({s: dense(pools[s])
                                 for s in self._rep_streams})
        if self._paged_join:
            # the paged kernel walks the page table: no dense K/V copy
            scale = self.kv_codec.scale_stream if self._kv_quant else None
            dkv = P.PagedDocKV(
                k=pools["layer_k"], v=pools["layer_v"],
                valid=cache.valid_pool, page_table=pt,
                k_scale=pools[scale("layer_k")] if scale else None,
                v_scale=pools[scale("layer_v")] if scale else None)
        else:
            dkv = self._dense_kv({s: dense(pools[s])
                                  for s in self._kv_streams})
        return P.join_and_score(self.params, self.cfg, qr, qv, x_d, dval,
                                doc_kv=dkv, fused=self.fused)

    def _score_plan(self, plan: _Plan, payload, load_dt: float, done: list):
        rows = plan.rows
        t0 = time.perf_counter()
        self._handoff(payload)
        last = next(s for s, _, _ in reversed(rows) if s is not None)
        qr = torch.cat([(s or last).q_reps for s, _, _ in rows])
        qv = torch.stack([(s or last).q_valid for s, _, _ in rows])
        with torch.inference_mode():
            scores = self._score_batch(qr, qv, payload).cpu().numpy()
        dt = time.perf_counter() - t0

        states = [s for s, _, _ in rows if s is not None]
        counts = Counter(id(s) for s in states)
        uniq = {id(s): s for s in states}
        deadline = self.policy.batch_deadline(
            [s.deadline_s for s in uniq.values()])
        if self.policy.should_redispatch(dt, deadline, len(rows),
                                         plan.depth):
            # the overshooting attempt's scores are discarded; only the
            # halves' results count
            self.stats.n_redispatch += 1
            self.stats.discarded_s += dt + load_dt
            for s in uniq.values():
                s.stats.n_redispatch += 1
            halves = [_Plan(rows=h, depth=plan.depth + 1)
                      for h in self.policy.split(rows)
                      if any(r[0] is not None for r in h)]
            self._replans.extendleft(reversed(halves))
            return
        n_real = len(states)
        self.stats.n_batches += 1
        self.stats.n_rows += n_real
        self.stats.n_pad_rows += len(rows) - n_real
        self.stats.load_s += load_dt
        self.stats.combine_s += dt
        for sid, cnt in counts.items():
            s = uniq[sid]
            s.stats.load_s += load_dt * cnt / n_real
            s.stats.combine_s += dt * cnt / n_real
        for i, (s, ci, _) in enumerate(rows):
            if s is None:
                continue
            s.scores[ci] = scores[i]
            s.n_done += 1
            if s.n_done == s.n:
                done.append(s)

    def _fail_plan(self, plan: _Plan, err: BaseException, done: list):
        """Resolve an errored plan's real rows as failed: score -inf, row
        index on the state's ``failed_idx``; the state still completes and
        no co-packed state is lost."""
        for s, ci, _ in plan.rows:
            if s is None:
                continue
            s.failed_idx.append(ci)
            s.error = err
            s.scores[ci] = -np.inf
            s.n_done += 1
            self.stats.n_failed_rows += 1
            if s.n_done == s.n:
                done.append(s)

    def drain(self) -> list:
        """Score every enqueued state; returns them in completion order."""
        t_wall = time.perf_counter()
        done: list = []
        self._admit_waiting()
        if self.prefetch_depth == 0:
            # stage and score each batch in turn on this thread
            while (plan := self._next_plan()) is not None:
                self._finish_plan(*self._staged(plan), done)
            self.stats.wall_s += time.perf_counter() - t_wall
            return done
        in_q: queue.Queue = queue.Queue()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        worker = threading.Thread(target=self._prefetch_loop,
                                  args=(in_q, out_q), daemon=True)
        worker.start()
        inflight = 0
        try:
            while True:
                while inflight < self.prefetch_depth:
                    plan = self._next_plan()
                    if plan is None:
                        break
                    in_q.put(plan)
                    inflight += 1
                if inflight == 0:
                    break
                self._finish_plan(*out_q.get(), done)
                inflight -= 1
        finally:
            in_q.put(_STOP)
            # a worker blocked on a full out_q must see its put go through
            while worker.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                worker.join(timeout=0.05)
        self.stats.wall_s += time.perf_counter() - t_wall
        return done

    def abandon_pending(self) -> list:
        """Drop every enqueued but unfinished state (a caller re-runs them
        elsewhere); returns the distinct states whose rows were dropped."""
        states: dict[int, object] = {id(s): s for s in self._waiting}
        for rows in (self._rows,
                     [r for p in self._replans for r in p.rows]):
            for s, _, _ in rows:
                if s is not None:
                    states[id(s)] = s
        self._waiting.clear()
        self._rows.clear()
        self._replans.clear()
        return list(states.values())


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class RankingService:
    """Request/response re-ranking over a :class:`TermRepIndex`::

        svc = RankingService(params, cfg, index, micro_batch=32)
        svc.submit(RankRequest(q_tokens, q_valid, doc_ids))
        for resp in svc.drain():
            ...

    ``device`` (``None`` means the card) holds the params and runs the
    model; params are moved there once.  ``backend`` (``"cuda"`` /
    ``"plain"``) reroutes every call of the config
    (:func:`~repro_torch.models.backend.apply_backend`).
    ``deadline_s`` is the default per-request deadline, ``max_queue`` the
    admission bound (``submit`` raises :class:`ServiceOverloadError` past
    it; None is unbounded).  ``encode_fn(params, q_tokens, q_valid)`` and
    ``join_fn`` (see :class:`BatchEngine`) replace the model's entry
    points, as the :class:`~repro_torch.serving.reranker.Reranker` client
    does; ``validate_index=False`` skips the index-against-config check.
    ``policy``, ``prefetch_depth``, ``fused``, ``use_layer_kv``,
    ``doc_cache_mb``, ``page_tokens`` and ``page_bucket`` configure the
    :class:`BatchEngine`."""

    def __init__(self, params, cfg: P.PreTTRConfig, index, *,
                 micro_batch: int = 32, policy: SchedulerPolicy | None = None,
                 cache_size: int = 64, backend: str | None = None,
                 prefetch_depth: int = 2, deadline_s: float | None = None,
                 encode_fn=None, join_fn=None, validate_index: bool = True,
                 fused: bool = True, use_layer_kv: bool | None = None,
                 doc_cache_mb: float = 0.0, page_tokens: int | None = None,
                 page_bucket: bool = False, device=None,
                 max_queue: int | None = None):
        if backend is not None:
            from repro_torch.models.backend import apply_backend
            cfg = apply_backend(cfg, backend)
        if validate_index:
            validate_index_compat(cfg, index)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.index = index
        self.default_deadline_s = deadline_s
        self.max_queue = max_queue
        self.engine = BatchEngine(
            to_device(params, self.device), cfg, index,
            micro_batch=micro_batch, policy=policy,
            prefetch_depth=prefetch_depth, fused=fused,
            use_layer_kv=use_layer_kv, join_fn=join_fn,
            doc_cache_mb=doc_cache_mb, page_tokens=page_tokens,
            page_bucket=page_bucket, device=self.device)
        self._encode = encode_fn or (
            lambda p, t, v: P.encode_query(p, cfg, t, v))
        self._qcache: OrderedDict = OrderedDict()
        self._cache_size = cache_size
        self._seq = 0
        self._queued = 0
        self._done_early: list[RankResponse] = []

    @property
    def params(self):
        return self.engine.params

    @params.setter
    def params(self, value):
        self.engine.params = value

    @property
    def stats(self) -> ServiceStats:
        return self.engine.stats

    @stats.setter
    def stats(self, value: ServiceStats):
        self.engine.stats = value

    def reset_stats(self) -> None:
        """Zero the aggregate counters (after a warm-up request, say)."""
        self.engine.stats = ServiceStats()

    @property
    def micro_batch(self) -> int:
        return self.engine.micro_batch

    @micro_batch.setter
    def micro_batch(self, value: int):
        self.engine.micro_batch = int(value)

    @property
    def doc_cache(self) -> DeviceDocCache | None:
        return self.engine.doc_cache

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- admission -----------------------------------------------------------
    def submit(self, req: RankRequest) -> str:
        """Queue a request (its query is encoded now); returns its id."""
        rid = req.request_id or f"req-{self._seq}"
        if self.max_queue is not None and self._queued >= self.max_queue:
            self.stats.n_shed += 1
            raise ServiceOverloadError(
                f"request {rid} shed: {self._queued} requests already "
                f"queued (max_queue={self.max_queue}); drain() or back off")
        try:
            # a bad id found later, in the prefetcher, would fail every
            # co-packed request's rows
            validate_doc_routing(self.index, req.doc_ids)
        except ValueError as e:
            raise ValueError(f"request {rid}: {e}") from None
        state = _ReqState(req, rid, self._seq,
                          req.deadline_s if req.deadline_s is not None
                          else self.default_deadline_s)
        self._seq += 1
        self.stats.n_requests += 1
        if state.n == 0:                   # nothing to rank: respond now
            self._done_early.append(self._finalize(state))
            return rid
        t0 = time.perf_counter()
        state.q_reps = self._query_reps(np.asarray(req.q_tokens),
                                        np.asarray(req.q_valid, bool))
        dt = time.perf_counter() - t0
        state.stats.query_encode_s = dt
        self.stats.query_encode_s += dt
        state.q_valid = torch.from_numpy(
            np.asarray(req.q_valid, bool)).to(self.device)
        self.engine.enqueue(state)
        self._queued += 1
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
        self._sync()
        self._qcache[key] = reps
        if len(self._qcache) > self._cache_size:
            self._qcache.popitem(last=False)
        return reps

    def drain(self) -> list[RankResponse]:
        """Score every queued request; responses in completion order."""
        done, self._done_early = self._done_early, []
        done += [self._finalize(s) for s in self.engine.drain()]
        self._queued = 0
        return done

    def _finalize(self, state: _ReqState) -> RankResponse:
        order = np.argsort(-state.scores, kind="stable")
        ids = list(state.req.doc_ids)
        failed = sorted(set(state.failed_idx))
        if failed:
            self.stats.n_degraded += 1
        return RankResponse(
            request_id=state.rid, doc_ids=[ids[i] for i in order],
            scores=state.scores[order], stats=state.stats,
            latency_s=time.perf_counter() - state.t_submit,
            degraded=bool(failed), failed_doc_ids=[ids[i] for i in failed])
