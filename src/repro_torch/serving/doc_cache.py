"""Device-resident hot-doc cache of the ranking service, the port of
``repro.serving.doc_cache``.

Serving cost is dominated by moving document representations (SDR, Cohen
et al.).  Under a skewed candidate stream the same hot documents are
gathered from the index and copied to the card again and again; this
cache keeps the index's raw stored streams (int8 payload and float32
scales for a quantising codec, raw floats otherwise) resident on the
card, so hit candidates skip the gather and the copy, and only misses are
staged.  Decoding happens after the cache (for int8 layer-``l`` K/V,
inside the join kernel), so the cache holds the narrow payload.

Design: **token-page pools**.  Each stream is one preallocated tensor
``[n_pages, page_tokens, ...]`` on the card; an LRU map gives each doc a
list of ``ceil(len / page_tokens)`` pages.  Batch assembly is a
page-table gather (``pool[page_table]``, or the paged join kernel walking
the table) and miss insertion one scatter per stream (``index_copy_``).
Page 0 is the immutable **zero page**: page-table tails point at it, so
padded positions read as zeros and its all-zero validity masks them.
Page 1 is the **scratch page**: scatter padding (miss rows staged past a
doc's page count) lands there and no page table references it.

The host bookkeeping (:meth:`plan`, :meth:`bucket`) is the JAX package's,
line for line, so both caches make the same hit, miss and eviction
decisions on the same stream.  :meth:`plan` never evicts a doc of the
batch it is planning (those ids are pinned): victims pop in LRU order and
pinned ids are set aside and re-queued at the cold end afterwards, so each
resident is examined at most once per call (``last_plan_scans``).  The
``capacity >= min_slots`` check guarantees an unpinned victim exists.
Reassigning evicted pages is safe because every batch's pool reads are
enqueued on the card's stream before any later batch's insert.

Hit and miss rows score alike by construction: every row is assembled
from the pools through the same page table.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.store import torch_dtype


class DeviceDocCache:
    """Paged device-resident LRU over the raw per-doc index streams.

    ``capacity_bytes`` bounds device memory; the page count follows from
    the per-page footprint of ``streams`` (``{name: (dtype, row_shape)}``,
    as ``TermRepIndex.streams_spec()`` gives it) plus one validity byte a
    token.  ``page_tokens=None`` gives whole-doc pages; it is rounded up
    to a multiple of 8.  ``page_bucket=True`` lets :meth:`plan` shrink the
    page-table width to the batch's longest doc (bucketed to powers of
    two) instead of the fixed ``pages_per_doc``.  The pools live on
    ``device`` (``None`` means the card)."""

    ZERO_PAGE = 0      # immutable all-zero page: page-table tail padding
    SCRATCH_PAGE = 1   # scatter-padding sink: never read

    def __init__(self, capacity_bytes: int, *, doc_len: int,
                 streams: dict, page_tokens: int | None = None,
                 page_bucket: bool = False, min_slots: int = 2,
                 device=None):
        if page_tokens is None:
            page_tokens = doc_len
        page_tokens = -(-int(page_tokens) // 8) * 8
        self.page_tokens = page_tokens
        self.pages_per_doc = -(-int(doc_len) // page_tokens)
        self.doc_len = int(doc_len)
        #: stage/assembly length -- doc_len rounded up to whole pages
        self.padded_len = self.pages_per_doc * page_tokens
        self.page_bucket = bool(page_bucket)
        self._streams = {
            name: (np.dtype(dt), tuple(shape))
            for name, (dt, shape) in streams.items()}
        row_bytes = sum(
            dt.itemsize * int(np.prod(shape, dtype=np.int64))
            for dt, shape in self._streams.values()) + 1   # + valid byte
        self.page_bytes = page_tokens * row_bytes
        n_pages = int(capacity_bytes) // self.page_bytes
        need = min_slots * self.pages_per_doc + 2          # + reserved
        if n_pages < need:
            raise ValueError(
                f"doc cache of {capacity_bytes} bytes holds only "
                f"{n_pages} pages ({self.page_bytes} B/page) but the "
                f"scheduler needs at least {need} ({min_slots} docs of "
                f"{self.pages_per_doc} pages + 2 reserved) to pin an "
                f"in-flight batch; raise doc_cache_mb to >= "
                f"{need * self.page_bytes / 2**20:.1f} MiB or shrink "
                f"micro_batch")
        self.capacity_pages = n_pages
        self.device = resolve_device(device)
        self._pools = {
            name: torch.zeros((n_pages, page_tokens, *shape),
                              dtype=torch_dtype(dt), device=self.device)
            for name, (dt, shape) in self._streams.items()}
        #: per-page token validity (int8, the paged kernel's validity pool)
        self.valid_pool = torch.zeros((n_pages, page_tokens),
                                      dtype=torch.int8, device=self.device)
        self._pages_of: OrderedDict[int, list[int]] = OrderedDict()  # LRU
        self._free = list(range(2, n_pages))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: LRU entries examined by the most recent :meth:`plan` (pinned
        #: skips + evictions) -- bounded by the resident count per call
        self.last_plan_scans = 0

    def __len__(self):
        return len(self._pages_of)

    @property
    def resident_docs(self) -> int:
        return len(self._pages_of)

    @property
    def resident_bytes(self) -> int:
        return (self.capacity_pages - 2 - len(self._free)) * self.page_bytes

    def _pages_for(self, length) -> int:
        length = self.doc_len if length is None else min(int(length),
                                                         self.doc_len)
        return max(1, -(-length // self.page_tokens))

    # -- host bookkeeping -------------------------------------------------------
    def plan(self, doc_ids, lengths=None, n_real: int | None = None):
        """Assign every doc its page list, evicting cold docs for misses.

        ``lengths`` (optional, per-row token counts) sizes each miss's
        allocation at ``ceil(len/page_tokens)`` pages; without it every
        doc gets the full ``pages_per_doc``.  Returns ``(page_table,
        miss_ids, miss_pages)``: ``page_table`` is the ``[B, W]`` int32
        gather map (rows zero-page-padded past each doc's pages),
        ``miss_ids`` the (unique, insertion-ordered) docs the caller must
        stage, and ``miss_pages`` their ``[M, W]`` scatter map
        (scratch-page-padded).  ``W = pages_per_doc`` unless
        ``page_bucket`` shrinks it to the batch maximum.

        ``n_real`` bounds the hit/miss counters to the first ``n_real``
        rows -- micro-batch shape padding (replicated trailing rows) still
        gets pages but must not inflate the hit rate."""
        if n_real is None:
            n_real = len(doc_ids)
        ids = [int(d) for d in doc_ids]
        lens = (list(lengths) if lengths is not None
                else [None] * len(ids))
        pinned = set(ids)
        cached_before = set(self._pages_of)
        pinned_popped: dict[int, list[int]] = {}
        self.last_plan_scans = 0
        width = self.pages_per_doc
        if self.page_bucket:
            width = self.bucket(max(self._pages_for(l) for l in lens),
                                self.pages_per_doc)
        miss_ids: list[int] = []
        miss_pages: list[list[int]] = []
        table: list[list[int]] = []
        for i, d in enumerate(ids):
            pages = self._pages_of.get(d)
            if pages is not None:
                self._pages_of.move_to_end(d)
            elif d in pinned_popped:            # evict-scan set it aside
                pages = self._pages_of[d] = pinned_popped.pop(d)
            else:
                need = self._pages_for(lens[i])
                pages = []
                while len(pages) < need:
                    if self._free:
                        pages.append(self._free.pop())
                        continue
                    victim = None
                    while self._pages_of:       # LRU order, skip pinned
                        victim, vpages = self._pages_of.popitem(last=False)
                        self.last_plan_scans += 1
                        if victim in pinned:
                            pinned_popped[victim] = vpages
                            victim = None
                            continue
                        break
                    if victim is None:
                        self._requeue(pinned_popped)
                        raise RuntimeError(
                            "doc cache exhausted: every resident doc is "
                            "pinned by the batch being planned (capacity "
                            "check should have prevented this)")
                    self._free.extend(vpages)
                    self.evictions += 1
                self._pages_of[d] = pages
                miss_ids.append(d)
                miss_pages.append(
                    pages + [self.SCRATCH_PAGE] * (width - len(pages)))
            if i < n_real:
                if d in cached_before:
                    self.hits += 1
                else:
                    self.misses += 1
            table.append(pages + [self.ZERO_PAGE] * (width - len(pages)))
        self._requeue(pinned_popped)
        return (np.asarray(table, np.int32), miss_ids,
                np.asarray(miss_pages, np.int32).reshape(len(miss_ids),
                                                         width))

    def _requeue(self, pinned_popped):
        """Re-insert evict-scan survivors at the cold end, preserving
        their relative LRU order."""
        for d, pages in reversed(list(pinned_popped.items())):
            self._pages_of[d] = pages
            self._pages_of.move_to_end(d, last=False)
        pinned_popped.clear()

    @staticmethod
    def bucket(n: int, cap: int) -> int:
        """Pad count: next power of two, capped at ``cap``."""
        b = 1
        while b < n:
            b *= 2
        return max(n, min(b, cap))

    # -- device ops (in batch order on the card's stream) ------------------------
    def insert(self, miss_pages, parts: dict, valid):
        """Scatter staged miss rows into the page pools, one
        ``index_copy_`` per stream.  ``parts`` maps stream name ->
        ``[M, W * page_tokens, ...]`` staged raw rows on the pools' device
        (the batch may be bucket-padded with repeats of the last miss --
        same pages, same rows); ``valid``: ``[M, W * page_tokens]``
        booleans."""
        miss_pages = np.asarray(miss_pages, np.int32)
        m, w = miss_pages.shape
        pages = torch.from_numpy(miss_pages.reshape(-1).astype(np.int64)) \
            .to(self.device)
        for name, rows in parts.items():
            pool = self._pools[name]
            pool.index_copy_(0, pages, rows.to(pool.dtype).reshape(
                m * w, self.page_tokens, *pool.shape[2:]))
        valid = torch.as_tensor(valid).to(self.device, torch.int8)
        self.valid_pool.index_copy_(0, pages,
                                    valid.reshape(m * w, self.page_tokens))

    def take(self, page_table):
        """Densify a planned batch: page-table gather per stream ->
        ``(parts, valid)`` with ``parts[name]`` shaped
        ``[B, W * page_tokens, ...]`` on the card and ``valid`` a numpy
        bool array.  Serving gathers from :attr:`pools` itself; this is
        the standalone accessor."""
        pt = self._table(page_table)
        b, w = pt.shape
        parts = {name: pool[pt].reshape(b, w * self.page_tokens,
                                        *pool.shape[2:])
                 for name, pool in self._pools.items()}
        return parts, self.valid_rows(page_table)

    @property
    def pools(self) -> dict:
        """The page pools by stream name (:attr:`valid_pool` is the
        matching validity pool)."""
        return self._pools

    def valid_rows(self, page_table) -> np.ndarray:
        pt = self._table(page_table)
        b, w = pt.shape
        return self.valid_pool[pt].reshape(b, w * self.page_tokens) \
            .bool().cpu().numpy()

    def _table(self, page_table):
        return torch.as_tensor(np.asarray(page_table, np.int64)) \
            .to(self.device)
