"""The port's router under faults, as tests/test_faults.py holds the JAX
router: each rung of the retry -> failover -> degrade ladder, drain
timeouts, worker health, admission shedding, index corruption caught by
``verify_reads`` and healed by the retry, and a seeded chaos soak under a
live client thread (every request answered once, every response either
bit-exact against the fault-free service or degraded by the contract,
the stats accounting for every request).

A small fp16 index over two physical shards (checksummed, IndexBuilder's
default), float32 compute on the CPU, seeded random weights.  Timeouts
and injected latencies are short so the file runs in well under a
minute."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.prettr_bert import smoke_config
from repro_torch.core import prettr as TP
from repro_torch.index import IndexBuilder, IndexIntegrityError, TermRepIndex
from repro_torch.serving import (FaultInjected, FaultPlan, FaultSpec,
                                 RankingRouter, RankingService, RankRequest,
                                 SchedulerPolicy, ServiceOverloadError,
                                 ServiceStats, WorkerHealth)

N_DOCS, MAX_Q = 32, 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Seeded params, a 32-doc fp16 index over two shards, and 6 requests
    of 10 distinct candidates, one with repeated ids and an empty one."""
    cfg = smoke_config()
    params = TP.init_prettr(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(11)
    docs = [rng.integers(4, 512, int(n))
            for n in rng.integers(4, cfg.max_doc_len, N_DOCS)]
    path = str(tmp_path_factory.mktemp("router_faults"))
    IndexBuilder(path, cfg, params, codec="fp16", n_shards=2, batch_size=16,
                 device="cpu").build(docs)
    reqs = []
    for _ in range(6):
        q = np.zeros(MAX_Q, np.int64)
        n_q = int(rng.integers(2, MAX_Q - 1))
        q[: n_q + 2] = [1, *rng.integers(4, 512, n_q), 2]
        reqs.append((q, q != 0, [int(d) for d in
                                 rng.choice(N_DOCS, 10, False)]))
    reqs.append((reqs[0][0], reqs[0][1], [3, 3, 17, 17, 8, 30, 3]))
    reqs.append((reqs[1][0], reqs[1][1], []))
    return cfg, params, path, reqs


@pytest.fixture(autouse=True)
def _join_stale_drains():
    """A timed-out drain's thread runs on after the router gives up on
    it; let it end inside its test, not at interpreter exit."""
    before = set(threading.enumerate())
    yield
    for th in set(threading.enumerate()) - before:
        th.join(timeout=30.0)


def _drain(svc, reqs, prefix="q"):
    for i, (q, qv, cands) in enumerate(reqs):
        svc.submit(RankRequest(q, qv, cands, request_id=f"{prefix}{i}"))
    return {r.request_id: r for r in svc.drain()}


def _reference(world, reqs=None, prefix="q"):
    cfg, params, path, default = world
    svc = RankingService(params, cfg, TermRepIndex.open(path), micro_batch=4,
                         device="cpu")
    return _drain(svc, default if reqs is None else reqs, prefix)


def _router(world, index=None, **kw):
    cfg, params, path, _ = world
    kw.setdefault("micro_batch", 4)
    return RankingRouter(params, cfg, index or TermRepIndex.open(path),
                         n_shards=2, device="cpu", **kw)


def _assert_bit_exact(got, ref):
    assert set(got) == set(ref)
    for rid in ref:
        assert not got[rid].degraded, (rid, got[rid].failed_doc_ids)
        assert got[rid].doc_ids == ref[rid].doc_ids, rid
        np.testing.assert_array_equal(got[rid].scores, ref[rid].scores)


def _assert_degraded_contract(resp, ref):
    """Flagged, failed ids at -inf and last, every other id bit-exact."""
    assert resp.degraded and resp.failed_doc_ids
    want = dict(zip(ref.doc_ids, ref.scores))
    failed = set(resp.failed_doc_ids)
    for d, s in zip(resp.doc_ids, resp.scores):
        assert s == (-np.inf if d in failed else want[d]), d
    n = len(resp.doc_ids)
    assert all(resp.doc_ids[i] in failed
               for i in range(n - len(failed), n))


# -- policy, health, stats -----------------------------------------------------


def test_policy_drain_timeout():
    pol = SchedulerPolicy()
    assert pol.drain_timeout([]) == pol.drain_timeout_floor == 300.0
    assert pol.drain_timeout([None, None], 10) == pol.drain_timeout_floor
    assert pol.drain_timeout([200.0, None], n_rows=4) == 8.0 * 200.0 * 4
    assert pol.drain_timeout([0.01], n_rows=4) == pol.drain_timeout_floor


def test_worker_health_state_machine():
    h = WorkerHealth(3, dead_after=2)
    h.on_failure(FaultInjected("x"))
    assert h.state == WorkerHealth.DEGRADED and h.consecutive_failures == 1
    h.on_success()
    assert h.state == WorkerHealth.HEALTHY and h.consecutive_failures == 0
    h.on_failure()
    h.on_failure()
    assert h.state == WorkerHealth.DEAD and h.n_failures == 3
    h.on_success()                               # the dead stay dead
    assert h.state == WorkerHealth.DEAD
    t = WorkerHealth(0)
    t.on_timeout(1.5)
    assert t.state == WorkerHealth.DEAD and t.n_timeouts == 1
    assert isinstance(t.last_error, TimeoutError)
    assert "shard=0, dead" in repr(t)


def test_stats_merge_sums_the_ladder_counters():
    a, b = ServiceStats(), ServiceStats()
    for i, f in enumerate(dataclasses.fields(ServiceStats)):
        setattr(a, f.name, 2 * i + 1)
        setattr(b, f.name, i + 1)
    m = a.merge(b)
    for i, f in enumerate(dataclasses.fields(ServiceStats)):
        want = 2 * i + 1 if f.name in ("resident_docs", "wall_s") \
            else 3 * i + 2
        assert getattr(m, f.name) == want, f.name
    fa = ServiceStats(n_retries=2, n_failovers=1, n_degraded=3, n_shed=4)
    fb = ServiceStats(n_retries=5, n_failovers=6, n_degraded=7, n_shed=8)
    for name, want in [("n_retries", 7), ("n_failovers", 7),
                       ("n_degraded", 10), ("n_shed", 12)]:
        assert getattr(fa.merge(fb), name) == want
        assert getattr(fb.merge(fa), name) == want


# -- the recovery ladder ---------------------------------------------------------


def test_router_fault_free_matches_service(world):
    router = _router(world)
    _assert_bit_exact(_drain(router, world[3]), _reference(world))
    s = router.stats
    assert (s.n_retries, s.n_failovers, s.n_degraded, s.n_shed) == (0,) * 4
    assert all(h.state == WorkerHealth.HEALTHY for h in router.health)


@pytest.mark.parametrize("site,tag", [("worker.drain", 0),
                                      ("engine.score", 1),
                                      ("engine.stage", 1)])
def test_router_retry_recovers_transient_fault(world, site, tag):
    """Rung 1: one failed drain (worker.drain) or one failed micro-batch
    (engine.score / engine.stage) is retried on its own worker; the rows
    come back bit-exact and the worker healthy."""
    ref = _reference(world)
    router = _router(world, retry_backoff_s=0.0)
    with FaultPlan([FaultSpec(site, "error", tag=tag, count=1)]) as plan:
        got = _drain(router, world[3])
    assert plan.n_fired() == 1
    _assert_bit_exact(got, ref)
    s = router.stats
    assert s.n_retries > 0 and s.n_failovers == 0 and s.n_degraded == 0
    assert all(h.state == WorkerHealth.HEALTHY for h in router.health)
    assert router.health[tag].n_failures == 1
    assert isinstance(router.health[tag].last_error, FaultInjected)


def test_router_retry_backs_off_linearly(world):
    router = _router(world, retry_backoff_s=0.05, max_retries=2)
    with FaultPlan([FaultSpec("worker.drain", "error", tag=0, count=2)]):
        t0 = time.perf_counter()
        got = _drain(router, world[3])
        elapsed = time.perf_counter() - t0
    _assert_bit_exact(got, _reference(world))
    assert elapsed >= 0.05 * (1 + 2)             # attempts 1 and 2
    assert router.stats.n_failovers == 0


def test_router_failover_serves_persistent_shard_fault(world):
    """Rung 2: a shard that keeps failing is failed over to the
    full-index fallback engine, bit-exact; after dead_after failures its
    documents route to the fallback at submit."""
    ref = _reference(world)
    router = _router(world, retry_backoff_s=0.0)
    with FaultPlan([FaultSpec("worker.drain", "error", tag=0,
                              count=None)]):
        _assert_bit_exact(_drain(router, world[3]), ref)
        s = router.stats
        assert s.n_retries > 0 and s.n_failovers > 0 and s.n_degraded == 0
        assert router.health[0].state != WorkerHealth.HEALTHY
        assert router.health[1].state == WorkerHealth.HEALTHY
        for _ in range(3):
            _assert_bit_exact(_drain(router, world[3]), ref)
    assert router.health[0].state == WorkerHealth.DEAD
    n_rows_dead = router.workers[0].stats.n_rows
    # a dead worker gets no traffic; the fallback serves it, still exact
    _assert_bit_exact(_drain(router, world[3]), ref)
    assert router.workers[0].stats.n_rows == n_rows_dead
    assert router._fallback is not None


def test_router_drain_timeout_kills_stuck_worker(world):
    """A wedged shard (3 s stall against a 1 s budget) no longer holds
    drain(): the worker is declared dead at once (its stuck thread still
    owns its engine) and the fallback serves its rows."""
    ref = _reference(world)
    router = _router(world, drain_timeout_s=1.0, max_retries=0)
    with FaultPlan([FaultSpec("worker.drain", "latency", tag=1,
                              latency_s=3.0)]):
        t0 = time.perf_counter()
        got = _drain(router, world[3])
        elapsed = time.perf_counter() - t0
    assert elapsed < 2.8                         # did not wait the stall
    _assert_bit_exact(got, ref)
    h = router.health[1]
    assert h.state == WorkerHealth.DEAD and h.n_timeouts == 1
    assert isinstance(h.last_error, TimeoutError)
    assert router.stats.n_failovers > 0
    _assert_bit_exact(_drain(router, world[3]), ref)


def test_router_degrades_when_fallback_also_fails(world):
    """Rung 3: the fallback fails too -> degraded responses (failed rows
    -inf, listed, last; every other row bit-exact); every request still
    answered once, and the ladder heals once the faults stop."""
    ref = _reference(world)
    router = _router(world, retry_backoff_s=0.0)
    with FaultPlan([
            FaultSpec("worker.drain", "error", tag=0, count=None),
            FaultSpec("engine.stage", "error", tag="fallback",
                      count=None)]):
        got = _drain(router, world[3])
    degraded = [r for r in got.values() if r.degraded]
    assert degraded
    for rid, resp in got.items():
        if resp.degraded:
            _assert_degraded_contract(resp, ref[rid])
        else:
            assert resp.doc_ids == ref[rid].doc_ids
            np.testing.assert_array_equal(resp.scores, ref[rid].scores)
    s = router.stats
    assert s.n_degraded == len(degraded) and s.n_failovers > 0
    assert len(got) == len(world[3])
    _assert_bit_exact(_drain(router, world[3]), ref)


def test_router_degrades_when_the_fallback_times_out(world):
    ref = _reference(world)
    router = _router(world, retry_backoff_s=0.0, drain_timeout_s=1.0,
                     dead_after=1)
    with FaultPlan([FaultSpec("worker.drain", "error", tag=1, count=None),
                    FaultSpec("engine.stage", "latency", tag="fallback",
                              latency_s=2.5, count=1)]):
        got = _drain(router, world[3])
    assert len(got) == len(world[3])
    for rid, resp in got.items():
        if resp.degraded:
            _assert_degraded_contract(resp, ref[rid])
        else:
            assert resp.doc_ids == ref[rid].doc_ids
    assert router.stats.n_degraded > 0
    # the wedged fallback is dropped; the next failover builds a new one
    assert router._fallback is None
    _assert_bit_exact(_drain(router, world[3]), ref)
    assert router._fallback is not None


def test_router_sheds_beyond_max_queue(world):
    router = _router(world, max_queue=2)
    q, qv, cands = world[3][0]
    router.submit(RankRequest(q, qv, cands, request_id="a"))
    router.submit(RankRequest(q, qv, cands, request_id="b"))
    with pytest.raises(ServiceOverloadError, match="max_queue"):
        router.submit(RankRequest(q, qv, cands, request_id="c"))
    assert router.stats.n_shed == 1 and router.stats.n_requests == 2
    assert {r.request_id for r in router.drain()} == {"a", "b"}
    router.submit(RankRequest(q, qv, cands, request_id="c"))
    assert len(router.drain()) == 1


def test_router_detects_and_recovers_index_corruption(world):
    """verify_reads turns a flipped stored byte into a shard fault: the
    read raises IndexIntegrityError, the retry re-reads the healed bytes,
    scores stay bit-exact and the index verifies clean afterwards."""
    cfg, params, path, reqs = world
    ref = _reference(world)
    idx = TermRepIndex.open(path, verify_reads=True)
    router = _router(world, index=idx, retry_backoff_s=0.0)
    seen = []
    orig = router.health[0].on_failure
    router.health[0].on_failure = lambda e=None: (seen.append(e), orig(e))
    with FaultPlan([FaultSpec("index.gather", "corrupt", tag=0, count=1,
                              restore=True)]) as plan:
        got = _drain(router, reqs)
    assert plan.n_fired("corrupt") == 1
    _assert_bit_exact(got, ref)
    assert router.stats.n_retries > 0
    assert any(isinstance(e, IndexIntegrityError) for e in seen)
    assert idx.verify_integrity() > 0


def test_chaos_soak(world):
    """A client thread streams zipf-weighted queries while a seeded fault
    schedule (stalls, worker errors, staging errors, a score error,
    transient bit-rot) is live.  The router never deadlocks, every
    accepted request gets exactly one response, each either bit-exact
    against the fault-free service or degraded by the contract, and the
    stats account for every request."""
    cfg, params, path, reqs = world
    rng = np.random.default_rng(17)
    pool = []
    for _ in range(6):
        q = np.zeros(MAX_Q, np.int64)
        q[:MAX_Q - 1] = [1, *rng.integers(4, 512, MAX_Q - 3), 2]
        pool.append((q, q != 0))
    w = 1.0 / np.arange(1, N_DOCS + 1) ** 1.3
    stream = []
    for _ in range(30):
        q, qv = pool[min(int(rng.zipf(1.8)) - 1, len(pool) - 1)]
        cands = rng.choice(N_DOCS, size=8, replace=False, p=w / w.sum())
        stream.append((q, qv, [int(c) for c in cands]))
    ref = _reference(world, stream, prefix="s")

    idx = TermRepIndex.open(path, verify_reads=True)
    router = _router(world, index=idx, retry_backoff_s=0.0,
                     drain_timeout_s=30.0, max_queue=6)
    q0, qv0, c0 = stream[0]
    router.rank(q0, qv0, c0, request_id="warm")
    plan = FaultPlan([
        FaultSpec("worker.drain", "latency", latency_s=0.02, p=0.3,
                  count=None),
        FaultSpec("worker.drain", "error", tag=0, p=0.25, count=4),
        FaultSpec("engine.stage", "error", tag=1, p=0.2, count=3),
        FaultSpec("engine.score", "error", tag=0, p=0.2, count=2),
        FaultSpec("engine.stage", "error", tag="fallback", count=1),
        FaultSpec("index.gather", "corrupt", tag=1, after=2, count=2,
                  restore=True),
    ], seed=7)

    lock = threading.Lock()          # the router is externally synchronised
    accepted: list[str] = []
    n_shed = 0

    def client():
        nonlocal n_shed
        for i, (q, qv, c) in enumerate(stream):
            rid = f"s{i}"
            while True:
                with lock:
                    try:
                        router.submit(RankRequest(q, qv, c, request_id=rid))
                        accepted.append(rid)
                        break
                    except ServiceOverloadError:
                        n_shed += 1
                time.sleep(0.002)

    responses = {}
    t0 = time.perf_counter()
    with plan:
        th = threading.Thread(target=client, daemon=True)
        th.start()
        while th.is_alive() or responses.keys() < set(accepted):
            with lock:
                for r in router.drain():
                    assert r.request_id not in responses   # exactly once
                    responses[r.request_id] = r
            assert time.perf_counter() - t0 < 120.0, "soak deadlocked"
            time.sleep(0.002)
        th.join(timeout=60.0)
        assert not th.is_alive()

    assert len(accepted) == len(stream)
    assert set(responses) == set(accepted)
    s = router.stats
    assert s.n_requests == len(accepted) + 1                # + the warm-up
    assert s.n_shed == n_shed
    degraded = [r for r in responses.values() if r.degraded]
    assert s.n_degraded == len(degraded)
    assert plan.n_fired() > 0
    for rid, resp in responses.items():
        if resp.degraded:
            _assert_degraded_contract(resp, ref[rid])
        else:
            assert resp.doc_ids == ref[rid].doc_ids, rid
            np.testing.assert_array_equal(resp.scores, ref[rid].scores)
    assert idx.verify_integrity() > 0
    # the fleet survives: fault-free traffic after the soak is bit-exact
    router.max_queue = None
    _assert_bit_exact(_drain(router, reqs), _reference(world))
