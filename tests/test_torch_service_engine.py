"""The port's batch engine: the prefetch thread, the straggler policy,
plan-failure isolation, admission shedding and the fault injector, as
tests/test_service.py and tests/test_faults.py hold them for the JAX
service (the router's are tests/test_torch_router_faults.py).

A small fp16 index built by the port on the CPU, float32 compute, seeded
random weights.  Scores of the same micro-batch shape are compared bit
for bit; a deadline split scores its halves at other batch shapes, so
those are held to 1e-5 (float32 summation order of the smaller GEMMs)."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.prettr_bert import smoke_config
from repro_torch.core import prettr as TP
from repro_torch.index import IndexBuilder, TermRepIndex
from repro_torch.serving import (BatchEngine, DeadlinePriorityPolicy,
                                 FaultInjected, FaultPlan, FaultSpec,
                                 RankingService, RankRequest,
                                 SchedulerPolicy, ServiceOverloadError)
from repro_torch.serving import faults

N_DOCS, MAX_Q = 32, 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Seeded params, a 32-doc fp16 index over two shards, and 6 requests
    of 10 candidates plus one with repeated ids and an empty one."""
    cfg = smoke_config()
    params = TP.init_prettr(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(11)
    docs = [rng.integers(4, 512, int(n))
            for n in rng.integers(4, cfg.max_doc_len, N_DOCS)]
    path = str(tmp_path_factory.mktemp("engine_idx"))
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


def _service(world, **kw):
    cfg, params, path, _ = world
    kw.setdefault("micro_batch", 4)
    return RankingService(params, cfg, TermRepIndex.open(path),
                          device="cpu", **kw)


def _drain(svc, reqs):
    for i, (q, qv, cands) in enumerate(reqs):
        svc.submit(RankRequest(q, qv, cands, request_id=f"q{i}"))
    return {r.request_id: r for r in svc.drain()}


def _assert_bit_exact(got, ref):
    assert set(got) == set(ref)
    for rid in ref:
        assert not got[rid].degraded, (rid, got[rid].failed_doc_ids)
        assert got[rid].doc_ids == ref[rid].doc_ids
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


# -- the prefetch thread -------------------------------------------------------


@pytest.mark.parametrize("cache_mb", [0, 0.02])
def test_prefetch_depth_zero_and_two_agree(world, cache_mb):
    """The prefetch thread changes when staging runs, never a score or a
    counter; with the doc cache too (plan on the thread, insert on the
    scoring thread)."""
    _, _, _, reqs = world
    runs, stats = {}, {}
    for depth in (0, 2):
        svc = _service(world, prefetch_depth=depth, doc_cache_mb=cache_mb,
                       page_tokens=8)
        runs[depth] = [_drain(svc, reqs) for _ in range(2)]
        st = svc.stats
        stats[depth] = (st.n_batches, st.n_rows, st.n_pad_rows,
                        st.h2d_bytes, st.n_join_dispatch,
                        st.n_doc_cache_hit, st.n_doc_cache_miss,
                        st.doc_hbm_bytes, st.pack_fill)
    for a, b in zip(runs[0], runs[2]):
        _assert_bit_exact(b, a)
    assert stats[0] == stats[2]
    assert stats[2][0] == 2 * 17                   # 65 rows in 4-row plans
    if cache_mb:
        assert stats[2][5] > 0 and stats[2][6] > 0


def test_empty_request_and_nothing_pending(world):
    _, _, _, reqs = world
    svc = _service(world)
    assert svc.drain() == []
    q, qv, _ = reqs[0]
    svc.submit(RankRequest(q, qv, [], request_id="empty"))
    (resp,) = svc.drain()
    assert resp.request_id == "empty" and resp.doc_ids == []
    assert resp.scores.shape == (0,)


def test_rank_keeps_other_requests_responses(world):
    """rank() drains everything queued; the other responses come with the
    next drain()."""
    _, _, _, reqs = world
    svc = _service(world)
    q, qv, cands = reqs[0]
    svc.submit(RankRequest(q, qv, cands[:4], request_id="a"))
    ref = svc.rank(q, qv, cands[:4])
    later = svc.drain()
    assert [r.request_id for r in later] == ["a"]
    np.testing.assert_array_equal(later[0].scores, ref.scores)


# -- the straggler policy ------------------------------------------------------


def test_deadline_redispatch_under_policy(world):
    """A 0 s deadline splits the 8-row batch and its halves (depth 2)
    without changing the ranking."""
    _, _, _, reqs = world
    q, qv, cands = reqs[0]
    ref = _service(world, micro_batch=8).rank(q, qv, cands[:8])
    strag = _service(world, micro_batch=8,
                     policy=SchedulerPolicy(max_split_depth=2))
    resp = strag.rank(q, qv, cands[:8], deadline_s=0.0)
    assert resp.stats.n_redispatch == 3            # depth 0 + two halves
    assert strag.stats.n_redispatch == 3
    assert strag.stats.discarded_s > 0
    assert strag.stats.n_batches == 4              # the four quarters
    assert resp.doc_ids == ref.doc_ids
    np.testing.assert_allclose(resp.scores, ref.scores, rtol=1e-5,
                               atol=1e-5)


def test_policy_split_depth_zero_disables_redispatch(world):
    _, _, _, reqs = world
    q, qv, cands = reqs[0]
    svc = _service(world, micro_batch=8,
                   policy=SchedulerPolicy(max_split_depth=0))
    resp = svc.rank(q, qv, cands[:8], deadline_s=0.0)
    assert resp.stats.n_redispatch == 0 and svc.stats.n_redispatch == 0
    assert len(resp.doc_ids) == 8


def test_service_deadline_default_and_per_request(world):
    """The service's default deadline arms the policy; one request's
    tight deadline governs a batch that packs its rows with another's."""
    _, _, _, reqs = world
    (q0, qv0, c0), (q1, qv1, c1) = reqs[:2]
    svc = _service(world, micro_batch=8, deadline_s=0.0)
    assert svc.rank(q0, qv0, c0[:8]).stats.n_redispatch > 0
    svc = _service(world, micro_batch=8)
    svc.submit(RankRequest(q0, qv0, c0[:4], request_id="a",
                           deadline_s=0.0))
    svc.submit(RankRequest(q1, qv1, c1[:4], request_id="b"))
    resp = {r.request_id: r for r in svc.drain()}
    assert resp["a"].stats.n_redispatch > 0
    assert sorted(resp["a"].doc_ids) == sorted(c0[:4])
    assert sorted(resp["b"].doc_ids) == sorted(c1[:4])


@pytest.mark.parametrize("depth", [0, 2])
def test_priority_orders_completion(world, depth):
    """DeadlinePriorityPolicy puts urgent requests' rows into the first
    micro-batches, so they complete first."""
    _, _, _, reqs = world
    (q0, qv0, c0), (q1, qv1, c1) = reqs[:2]
    svc = _service(world, policy=DeadlinePriorityPolicy(),
                   prefetch_depth=depth)
    svc.submit(RankRequest(q0, qv0, c0[:4], request_id="low", priority=5))
    svc.submit(RankRequest(q1, qv1, c1[:4], request_id="tight",
                           priority=5, deadline_s=10.0))
    svc.submit(RankRequest(q1, qv1, c1[4:8], request_id="high",
                           priority=0))
    assert [r.request_id for r in svc.drain()] == ["high", "tight", "low"]


# -- plan-failure isolation and shedding ---------------------------------------


@pytest.mark.parametrize("site", ["engine.stage", "index.gather",
                                  "engine.score"])
@pytest.mark.parametrize("depth", [0, 2])
def test_engine_isolates_failed_plan_rows(world, site, depth):
    """A fault at any site fails only its micro-batch's rows; the drain
    goes on and every other row is bit-exact."""
    _, _, _, reqs = world
    ref = _drain(_service(world), reqs)
    svc = _service(world, prefetch_depth=depth)
    with FaultPlan([FaultSpec(site, "error", after=2)], seed=3) as plan:
        got = _drain(svc, reqs)
    assert plan.n_fired() == 1 and plan.fired[0].hit_no == 3
    degraded = [r for r in got.values() if r.degraded]
    assert degraded and svc.stats.n_degraded == len(degraded)
    assert svc.stats.n_failed_rows == 4            # one 4-row plan
    assert sum(len(r.failed_doc_ids) for r in degraded) <= 4
    for rid, resp in got.items():
        if resp.degraded:
            _assert_degraded_contract(resp, ref[rid])
        else:
            assert resp.doc_ids == ref[rid].doc_ids
            np.testing.assert_array_equal(resp.scores, ref[rid].scores)


def test_every_plan_failing_still_drains(world):
    """Errors on every staging call: each plan fails on its own, the
    queue of the prefetch thread never blocks the drain."""
    _, _, _, reqs = world
    svc = _service(world, prefetch_depth=1)
    with FaultPlan([FaultSpec("engine.stage", "error", count=None)]):
        got = _drain(svc, reqs)
    assert len(got) == len(reqs)
    assert svc.stats.n_failed_rows == sum(len(c) for _, _, c in reqs)
    assert all(r.degraded for r in got.values() if r.doc_ids)


def test_drain_stops_its_thread_when_it_raises(world, monkeypatch):
    """A failure outside the isolated steps propagates, and the prefetch
    thread is stopped and joined, not left blocked on a full queue."""
    _, _, _, reqs = world
    svc = _service(world, prefetch_depth=1)
    before = threading.active_count()

    def boom(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(svc.engine, "_score_plan", boom)
    for i, (q, qv, c) in enumerate(reqs):
        svc.submit(RankRequest(q, qv, c, request_id=f"q{i}"))
    with pytest.raises(KeyboardInterrupt):
        svc.drain()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_fault_tag_targets_one_engine(world):
    """A spec with a tag fires only at the engine carrying that tag."""
    _, _, _, reqs = world
    svc = _service(world, prefetch_depth=0)
    svc.engine.fault_tag = "shard-a"
    with FaultPlan([FaultSpec("engine.score", "error", tag="shard-b",
                              count=None)]) as plan:
        assert not any(r.degraded for r in _drain(svc, reqs).values())
    assert plan.n_fired() == 0
    with FaultPlan([FaultSpec("engine.score", "error",
                              tag="shard-a")]) as plan:
        assert any(r.degraded for r in _drain(svc, reqs).values())
    assert plan.n_fired() == 1 and plan.fired[0].tag == "shard-a"


def test_fault_free_after_plan_removal(world):
    _, _, _, reqs = world
    ref = _drain(_service(world), reqs)
    svc = _service(world)
    with FaultPlan([FaultSpec("engine.score", "error", count=2)]):
        _drain(svc, reqs)
    assert not faults.active()
    _assert_bit_exact(_drain(svc, reqs), ref)


def test_cached_service_heals_after_a_score_fault(world):
    """A scoring fault after the doc cache admitted a batch's misses
    leaves the cache consistent: later drains are bit-exact."""
    _, _, _, reqs = world
    ref = _drain(_service(world, doc_cache_mb=0.02, page_tokens=8), reqs)
    svc = _service(world, doc_cache_mb=0.02, page_tokens=8)
    with FaultPlan([FaultSpec("engine.score", "error", count=3)]):
        _drain(svc, reqs)
    _assert_bit_exact(_drain(svc, reqs), ref)


def test_service_sheds_beyond_max_queue(world):
    _, _, _, reqs = world
    svc = _service(world, max_queue=2)
    q, qv, cands = reqs[0]
    svc.submit(RankRequest(q, qv, cands, request_id="a"))
    svc.submit(RankRequest(q, qv, cands, request_id="b"))
    with pytest.raises(ServiceOverloadError, match="max_queue"):
        svc.submit(RankRequest(q, qv, cands, request_id="c"))
    assert svc.stats.n_shed == 1
    assert {r.request_id for r in svc.drain()} == {"a", "b"}
    svc.submit(RankRequest(q, qv, cands, request_id="c"))   # drained
    assert len(svc.drain()) == 1


def test_abandon_pending_returns_unfinished_states(world):
    _, _, _, reqs = world
    svc = _service(world)
    for i, (q, qv, c) in enumerate(reqs[:3]):
        svc.submit(RankRequest(q, qv, c, request_id=f"q{i}"))
    engine: BatchEngine = svc.engine
    assert engine.pending
    states = engine.abandon_pending()
    assert sorted(s.rid for s in states) == ["q0", "q1", "q2"]
    assert not engine.pending and engine.drain() == []


# -- the fault injector --------------------------------------------------------


def test_spec_validation():
    with pytest.raises(ValueError, match="unknown site"):
        FaultSpec("router.merge", "error")
    FaultSpec("worker.drain", "error")           # the shard workers' site
    with pytest.raises(ValueError, match="unknown kind"):
        FaultSpec("engine.stage", "meteor")


def test_no_plan_installed_is_noop():
    assert not faults.active()
    faults.hit("engine.stage")


def test_after_count_budget_and_tags():
    spec = FaultSpec("engine.stage", "error", tag=7, after=2, count=2)
    with FaultPlan([spec]) as plan:
        faults.hit("engine.stage", tag=3)          # wrong tag: not a hit
        faults.hit("engine.stage", tag=7)          # hits 1, 2: skipped
        faults.hit("engine.stage", tag=7)
        for _ in range(2):                         # hits 3, 4: fire
            with pytest.raises(FaultInjected):
                faults.hit("engine.stage", tag=7)
        faults.hit("engine.stage", tag=7)          # budget spent
    assert plan.n_fired() == 2
    assert [e.hit_no for e in plan.fired] == [3, 4]
    assert not faults.active()


def test_probability_is_seeded_deterministic():
    def firing_pattern(seed):
        spec = FaultSpec("engine.score", "latency", p=0.5, count=None,
                         latency_s=0.0)
        with FaultPlan([spec], seed=seed) as plan:
            pat = []
            for _ in range(64):
                before = plan.n_fired()
                faults.hit("engine.score")
                pat.append(plan.n_fired() > before)
        return pat

    a, b = firing_pattern(3), firing_pattern(3)
    assert a == b and 0 < sum(a) < 64
    assert firing_pattern(4) != a


def test_plans_nest_and_count_independently():
    outer = FaultSpec("engine.score", "latency", latency_s=0.0, count=None)
    inner = FaultSpec("engine.score", "latency", latency_s=0.0, count=1)
    with FaultPlan([outer]) as po:
        faults.hit("engine.score")
        with FaultPlan([inner]) as pi:
            faults.hit("engine.score")             # both plans see this
        faults.hit("engine.score")
    assert po.n_fired() == 3 and pi.n_fired() == 1


def test_custom_error_class_and_instance():
    with FaultPlan([FaultSpec("engine.stage", "error", error=OSError)]):
        with pytest.raises(OSError):
            faults.hit("engine.stage")
    boom = KeyError("boom")
    with FaultPlan([FaultSpec("engine.stage", "error", error=boom)]):
        with pytest.raises(KeyError):
            faults.hit("engine.stage")


def test_latency_kind_sleeps():
    with FaultPlan([FaultSpec("engine.stage", "latency", latency_s=0.08)]):
        t0 = time.perf_counter()
        faults.hit("engine.stage")
        assert time.perf_counter() - t0 >= 0.06


@pytest.mark.parametrize("restore", [True, False])
def test_corrupt_flips_stored_bytes_and_restores(world, restore):
    """A corrupt fault flips the stored bytes the next gather reads; a
    transient one heals at the next matching hit, and plan exit always
    restores."""
    _, _, path, _ = world
    index = TermRepIndex.open(path)
    clean = index.gather_raw([0])[0]["reps"].copy()
    spec = FaultSpec("index.gather", "corrupt", restore=restore)
    with FaultPlan([spec]) as plan:
        faults.hit("index.gather", index=index, doc_ids=[0])
        assert "flipped" in plan.fired[0].detail
        rotten = index.gather_raw([0])[0]["reps"]
        assert not np.array_equal(rotten.view(np.uint8),
                                  clean.view(np.uint8))
        faults.hit("index.gather", index=index, doc_ids=[0])
        again = index.gather_raw([0])[0]["reps"]
        assert np.array_equal(again.view(np.uint8),
                              clean.view(np.uint8)) == restore
    np.testing.assert_array_equal(
        index.gather_raw([0])[0]["reps"].view(np.uint8),
        clean.view(np.uint8))
