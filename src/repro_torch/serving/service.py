"""The ranking service, the port of ``repro.serving.service``.

* :class:`BatchEngine` -- packing, staging and scoring: candidate rows of
  every enqueued request are packed into fixed ``micro_batch``-row
  batches (padding rows replicate the last real row; their scores are
  discarded); each batch's stored streams are staged and one
  ``join_and_score`` call scores it.
* :class:`RankingService` -- admission and responses over one engine:
  :meth:`~RankingService.submit` encodes each query through layers
  ``0..l`` once, through a small LRU of query reps; responses list doc
  ids by descending score.

Staging is codec-aware: the raw stored streams (int8 payload and scales
for a quantising codec) are gathered on the host into pinned buffers,
copied to the card, and decoded there.  With ``use_layer_kv`` the index's
stored layer-``l`` K/V go to the join as well, so layer ``l`` skips the
doc-side projections (int8 K/V are dequantised inside the join kernel).
With ``doc_cache_mb`` the raw streams stay resident in a
:class:`~repro_torch.serving.doc_cache.DeviceDocCache` and only misses
are staged; on the ``"cuda"`` impl with stored K/V the cache's pools go
to the join as a :class:`~repro_torch.core.prettr.PagedDocKV` and no
dense K/V copy is made, otherwise each batch is assembled from the pools
by page-table gathers and then scored.

The prefetch thread, straggler redispatch, plan-failure isolation and
fault injection of the JAX service wait for a later slice; staging and
scoring run in turn.
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
from repro_torch.serving.doc_cache import DeviceDocCache


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
    n_join_dispatch: int = 0              # join_and_score calls
    n_decode_dispatch: int = 0            # standalone decode calls (none)
    n_doc_cache_hit: int = 0              # real rows served from the cache
    n_doc_cache_miss: int = 0             # real rows staged into it
    resident_docs: int = 0                # cache residents after a batch
    doc_hbm_bytes: int = 0                # doc-side bytes the join reads
    query_encode_s: float = 0.0
    load_s: float = 0.0
    combine_s: float = 0.0
    wall_s: float = 0.0                   # time inside drain()

    @property
    def doc_cache_hit_rate(self) -> float:
        n = self.n_doc_cache_hit + self.n_doc_cache_miss
        return self.n_doc_cache_hit / n if n else 0.0


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
    """Packs enqueued request states into micro-batches, stages their
    stored streams and scores them.

    A state has ``req.doc_ids``, ``q_reps`` ([1, Lq, d] on the engine's
    device), ``q_valid`` ([Lq]), ``scores`` / ``n`` / ``n_done`` and
    ``stats``.  ``use_layer_kv`` (default: whether the index stores
    layer-``l`` K/V) feeds the stored K/V to the join; ``doc_cache_mb``
    > 0 keeps the raw streams resident in a paged device cache of that
    size (``page_tokens``, ``page_bucket`` as
    :class:`~repro_torch.serving.doc_cache.DeviceDocCache`)."""

    def __init__(self, params, cfg: P.PreTTRConfig, index, *,
                 micro_batch: int = 32, use_layer_kv: bool | None = None,
                 doc_cache_mb: float = 0.0, page_tokens: int | None = None,
                 page_bucket: bool = False, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.index = index
        self.micro_batch = int(micro_batch)
        self.stats = ServiceStats()
        has_kv = index.has_layer_kv
        if use_layer_kv is None:
            use_layer_kv = has_kv
        if use_layer_kv and not has_kv:
            raise ValueError(
                "use_layer_kv=True but the index has no layer_k/layer_v "
                "streams; rebuild it with IndexBuilder(store_layer_kv=True)")
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
        self._queue: list = []

    @property
    def doc_cache(self) -> DeviceDocCache | None:
        """The device doc cache (None when disabled)."""
        return self._cache

    def enqueue(self, state) -> None:
        self._queue.append(state)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _plans(self):
        rows = [(s, ci, int(d)) for s in self._queue
                for ci, d in enumerate(s.req.doc_ids)]
        for lo in range(0, len(rows), self.micro_batch):
            plan = rows[lo: lo + self.micro_batch]
            # fixed micro-batch shape; padding replicates the last real row
            yield plan + [(None, -1, plan[-1][2])] * (self.micro_batch
                                                      - len(plan))

    # -- staging -----------------------------------------------------------------
    def _stage(self, plan):
        """Gather and copy one batch's doc-side operands -> payload."""
        ids = [d for _, _, d in plan]
        if self._cache is not None:
            return self._stage_cached(plan, ids)
        parts, valid = self.index.stage(ids, pad_to=self.cfg.max_doc_len,
                                        streams=self._streams,
                                        device=self.device)
        return {"parts": parts, "valid": valid,
                "h2d_bytes": _nbytes(parts.values()) + valid.numel()}

    def _stage_cached(self, plan, ids):
        """Plan pages (LRU bump + miss admission), then gather and insert
        only the misses, staged at the planned page-table width."""
        cache = self._cache
        real = [d for s, _, d in plan if s is not None]
        page_table, miss_ids, miss_pages = cache.plan(
            ids, lengths=self._doc_lens[ids], n_real=len(real))
        fresh = set(miss_ids)
        n_miss = sum(1 for d in real if d in fresh)
        payload = {"page_table": page_table, "h2d_bytes": 0,
                   "n_miss_rows": n_miss, "n_rows": len(real)}
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
            cache.insert(pages, parts, valid)
            payload["h2d_bytes"] = _nbytes(parts.values()) + valid.numel()
        payload["page_table_dev"] = torch.from_numpy(
            page_table.astype(np.int64)).to(self.device)
        return payload

    # -- scoring -----------------------------------------------------------------
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
        """One join_and_score call for the batch."""
        self.stats.h2d_bytes += payload["h2d_bytes"]
        self.stats.n_join_dispatch += 1
        if self._cache is None:
            self.stats.doc_hbm_bytes += payload["h2d_bytes"]
            parts = payload["parts"]
            return P.join_and_score(self.params, self.cfg, qr, qv,
                                    self._decode_reps(parts),
                                    payload["valid"],
                                    doc_kv=self._dense_kv(parts))
        cache = self._cache
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
                                doc_kv=dkv)

    def _score_plan(self, plan):
        t0 = time.perf_counter()
        payload = self._stage(plan)
        last = next(s for s, _, _ in reversed(plan) if s is not None)
        qr = torch.cat([(s or last).q_reps for s, _, _ in plan])
        qv = torch.stack([(s or last).q_valid for s, _, _ in plan])
        self._sync()
        t1 = time.perf_counter()
        with torch.inference_mode():
            scores = self._score_batch(qr, qv, payload).cpu().numpy()
        t2 = time.perf_counter()
        states = [s for s, _, _ in plan if s is not None]
        self.stats.n_batches += 1
        self.stats.n_rows += len(states)
        self.stats.n_pad_rows += len(plan) - len(states)
        self.stats.load_s += t1 - t0
        self.stats.combine_s += t2 - t1
        for i, (s, ci, _) in enumerate(plan):
            if s is None:
                continue
            s.scores[ci] = scores[i]
            s.n_done += 1
            s.stats.load_s += (t1 - t0) / len(states)
            s.stats.combine_s += (t2 - t1) / len(states)

    def drain(self) -> list:
        """Score every enqueued state; returns them in enqueue order."""
        t0 = time.perf_counter()
        for plan in self._plans():
            self._score_plan(plan)
        done, self._queue = self._queue, []
        self.stats.wall_s += time.perf_counter() - t0
        return done


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class RankingService:
    """Request/response re-ranking over a :class:`TermRepIndex`::

        svc = RankingService(params, cfg, index, micro_batch=32)
        svc.submit(RankRequest(q_tokens, q_valid, doc_ids))
        for resp in svc.drain():
            ...

    ``device`` (``None`` means the card) holds the params and runs the
    model; params are moved there once.  ``use_layer_kv``,
    ``doc_cache_mb``, ``page_tokens`` and ``page_bucket`` configure the
    :class:`BatchEngine`."""

    def __init__(self, params, cfg: P.PreTTRConfig, index, *,
                 micro_batch: int = 32, cache_size: int = 64,
                 use_layer_kv: bool | None = None, doc_cache_mb: float = 0.0,
                 page_tokens: int | None = None, page_bucket: bool = False,
                 device=None):
        validate_index_compat(cfg, index)
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.index = index
        self.engine = BatchEngine(
            self.params, cfg, index, micro_batch=micro_batch,
            use_layer_kv=use_layer_kv, doc_cache_mb=doc_cache_mb,
            page_tokens=page_tokens, page_bucket=page_bucket,
            device=self.device)
        self._qcache: OrderedDict = OrderedDict()
        self._cache_size = cache_size
        self._seq = 0

    @property
    def stats(self) -> ServiceStats:
        return self.engine.stats

    @stats.setter
    def stats(self, value: ServiceStats):
        self.engine.stats = value

    @property
    def micro_batch(self) -> int:
        return self.engine.micro_batch

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
        self.engine.enqueue(state)
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

    def drain(self) -> list[RankResponse]:
        """Score every queued request; responses in submission order."""
        return [self._finalize(s) for s in self.engine.drain()]

    def _finalize(self, state: _ReqState) -> RankResponse:
        order = np.argsort(-state.scores, kind="stable")
        ids = list(state.req.doc_ids)
        return RankResponse(
            request_id=state.rid, doc_ids=[ids[i] for i in order],
            scores=state.scores[order], stats=state.stats,
            latency_s=time.perf_counter() - state.t_submit)
