"""Deterministic fault injection for the port's serving stack, the port's
own copy of ``repro.serving.faults`` (numpy only).

A :class:`FaultPlan` is a seeded, nestable schedule of faults injected at
named *sites* inside the serving pipeline.  Tests install a plan (context
manager), drive traffic, and get a reproducible sequence of latency
spikes, exceptions and corrupted stored bytes.

Injection sites
---------------
Every hook passes the site name plus a ``tag`` identifying *which*
engine hit it (``BatchEngine(fault_tag=...)``); ``tag=None`` in a spec
matches any.

``"engine.stage"``
    Fired at the top of ``BatchEngine._stage``, the host-side staging of
    one planned micro-batch (gather, pinned copy, H2D), inside the
    prefetch thread when it runs.  ``latency`` models a slow host or
    disk; ``error`` a staging crash, which the engine isolates to that
    micro-batch's rows.

``"index.gather"``
    Fired right after it, before the term-rep index read.  Supports every
    kind; ``kind="corrupt"`` flips bytes of the *on-disk* stream file
    backing the first gathered doc (the reader's memmaps see the flip).

``"engine.score"``
    Fired in ``BatchEngine._score_batch`` before the join runs: a device
    fault or a wedged dispatch.

``"worker.drain"``
    Fired at the top of ``ShardWorker.drain`` (the router runs each
    worker's drain on its own thread).  ``error`` models a crashed or
    unreachable shard, ``latency`` a wedged one (past the router's drain
    timeout the worker is declared dead).

Semantics
---------
* **Deterministic**: each spec draws from its own
  ``np.random.default_rng((plan.seed, spec_index))``; with ``p=1.0`` (the
  default) no randomness is consumed, so a schedule is exactly
  reproducible given the same traffic.
* **Nestable**: installed plans form a stack; every active plan sees
  every hit and only mutates its own counters.
* **Free when inactive**: :func:`hit` returns after one truthiness check
  when no plan is installed.
* **Corruption is transactional**: a ``corrupt`` firing records the
  original bytes; with ``restore=True`` (transient bit-rot) they are
  restored at the *next* hit of the same spec, while ``restore=False``
  leaves them flipped for the plan's lifetime.  Plan exit always restores
  every outstanding flip.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np

SITES = ("index.gather", "engine.stage", "engine.score", "worker.drain")
KINDS = ("latency", "error", "corrupt")


class FaultInjected(RuntimeError):
    """Default exception raised by an ``error``-kind fault firing."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``site``/``kind``: where and what (see the module catalog).
    ``tag``: only fire for hooks carrying this tag (None = any).
    ``after``: skip the first N matching hits.  ``count``: total firing
    budget (None = unlimited).  ``p``: per-hit firing probability (seeded).
    ``latency_s``: sleep duration for ``kind="latency"``.
    ``error``: exception instance or class for ``kind="error"`` (default
    :class:`FaultInjected`).  ``stream``/``flip_bytes``/``restore``:
    corruption target stream, number of flipped bytes, and whether the
    next hit restores them (transient vs persistent rot)."""
    site: str
    kind: str
    tag: object | None = None
    after: int = 0
    count: int | None = 1
    p: float = 1.0
    latency_s: float = 0.05
    error: BaseException | type | None = None
    stream: str = "reps"
    flip_bytes: int = 1
    restore: bool = True

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown site {self.site!r}; one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; one of {KINDS}")


@dataclasses.dataclass
class FaultEvent:
    """One firing, recorded on ``plan.fired`` (deterministic given the
    traffic): which spec, at which of its matching hits, and any detail
    (e.g. the corrupted file/offset)."""
    site: str
    tag: object
    kind: str
    spec_index: int
    hit_no: int
    detail: str = ""


#: stack of installed plans (module-level so hooks need no plumbing)
_ACTIVE: list["FaultPlan"] = []


class FaultPlan:
    """A schedule of :class:`FaultSpec`\\ s.  Use as a context manager::

        with FaultPlan([FaultSpec("engine.stage", "error", tag=1)]) as plan:
            ... drive traffic ...
        assert plan.n_fired() == 1
    """

    def __init__(self, specs, seed: int = 0):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self.seed = int(seed)
        self.fired: list[FaultEvent] = []
        self._lock = threading.Lock()
        self._hits = [0] * len(self.specs)
        self._n_fired = [0] * len(self.specs)
        self._rngs = [np.random.default_rng((self.seed, i))
                      for i in range(len(self.specs))]
        #: outstanding corruption per spec: [(path, offset, orig_byte)]
        self._pending: list[list] = [[] for _ in self.specs]

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> "FaultPlan":
        _ACTIVE.append(self)
        return self

    def remove(self) -> None:
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        with self._lock:
            for i in range(len(self.specs)):
                self._restore(i)

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.remove()

    # -- accounting ----------------------------------------------------------
    def n_fired(self, kind: str | None = None,
                site: str | None = None) -> int:
        with self._lock:
            return sum(1 for e in self.fired
                       if (kind is None or e.kind == kind)
                       and (site is None or e.site == site))

    # -- firing --------------------------------------------------------------
    def _restore(self, i: int) -> None:
        for path, offset, orig in self._pending[i]:
            with open(path, "r+b") as f:
                f.seek(offset)
                f.write(orig)
        self._pending[i].clear()

    def _hit(self, site: str, tag, index, doc_ids):
        sleep_s = 0.0
        raise_exc: BaseException | None = None
        corrupt: list[tuple[int, FaultSpec]] = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.tag is not None and spec.tag != tag:
                    continue
                # a transient flip heals at the next matching hit (the
                # retry that re-reads it), before deciding to fire again
                if self._pending[i] and spec.restore:
                    self._restore(i)
                self._hits[i] += 1
                if self._hits[i] <= spec.after:
                    continue
                if spec.count is not None and self._n_fired[i] >= spec.count:
                    continue
                if spec.p < 1.0 and self._rngs[i].random() >= spec.p:
                    continue
                self._n_fired[i] += 1
                ev = FaultEvent(site, tag, spec.kind, i, self._hits[i])
                self.fired.append(ev)
                if spec.kind == "latency":
                    sleep_s = max(sleep_s, spec.latency_s)
                elif spec.kind == "error":
                    if raise_exc is None:
                        e = spec.error
                        if e is None:
                            e = FaultInjected(
                                f"injected fault at {site} (tag={tag!r}, "
                                f"spec {i}, hit {self._hits[i]})")
                        elif isinstance(e, type):
                            e = e(f"injected fault at {site} (tag={tag!r})")
                        raise_exc = e
                else:                      # corrupt
                    corrupt.append((i, spec))
                    ev.detail = "corrupt-pending"
        for i, spec in corrupt:
            detail = self._corrupt(i, spec, index, doc_ids)
            with self._lock:
                for ev in reversed(self.fired):
                    if ev.spec_index == i and ev.detail == "corrupt-pending":
                        ev.detail = detail
                        break
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if raise_exc is not None:
            raise raise_exc

    def _corrupt(self, i: int, spec: FaultSpec, index, doc_ids) -> str:
        """Flip ``spec.flip_bytes`` bytes of the on-disk stream file
        backing the first gathered doc with stored tokens.  The memmaps
        are MAP_SHARED, so the reader sees the flip immediately."""
        if index is None:
            return "no-index (corrupt spec at a site without index access)"
        table = getattr(index, "_doc_table", None)
        paths = getattr(index, "_stream_paths", None)
        if table is None or paths is None:
            return "index exposes no stream paths; nothing corrupted"
        target = None
        for d in (doc_ids or []):
            si, start, n = (int(v) for v in table[int(d)])
            if n > 0 and spec.stream in paths[si]:
                target = (si, start, n)
                break
        if target is None:
            return "no stored tokens among gathered docs; nothing corrupted"
        si, start, n = target
        path = paths[si][spec.stream]
        spec_dt, row_shape = index.streams_spec()[spec.stream]
        rowbytes = spec_dt.itemsize * int(np.prod(row_shape, dtype=np.int64))
        offset = start * rowbytes
        nbytes = max(1, int(spec.flip_bytes))
        with open(path, "r+b") as f:
            f.seek(offset)
            orig = f.read(nbytes)
            f.seek(offset)
            f.write(bytes(b ^ 0xFF for b in orig))
        with self._lock:
            self._pending[i].append((path, offset, orig))
        return f"flipped {nbytes}B at {os.path.basename(path)}+{offset}"


def active() -> bool:
    """True when at least one plan is installed."""
    return bool(_ACTIVE)


def hit(site: str, tag=None, *, index=None, doc_ids=None) -> None:
    """Serving-side hook: give every installed plan a chance to fire at
    ``site``.  No-op (one truthiness check) when no plan is installed.
    ``index``/``doc_ids`` give ``corrupt`` specs their target bytes."""
    if not _ACTIVE:
        return
    for plan in list(_ACTIVE):
        plan._hit(site, tag, index, doc_ids)
