"""The port's scale-out serving (``repro_torch.serving.sharded``) against
the port's single-process service and against the JAX router, as
tests/test_sharded_serving.py holds the JAX package's.

* ``serving_assignment`` array-equal to JAX's on one 4-shard index; the
  ``ShardIndexView`` delegates what takes no ids and refuses misrouted
  and out-of-range ids in every method that takes them, ``stage`` among
  them (the port's engine reads through ``stage``).
* ``RankingRouter`` bit for bit the port's ``RankingService`` over 1 to
  4 shards, fp16, int8 + int8 K/V and PQ indexes, doc caches cold and
  warm, and deadline redispatch (both sides redispatched, so both score
  the same micro-batch shapes); within rtol = atol = 2e-5 of the JAX
  ``RankingRouter`` over a JAX-built index with bridged weights.
* ``ServiceStats.merge``, the router's merged stats, ``gather`` /
  ``load_docs`` / ``projected_storage_bytes`` against JAX's, workers
  pinned by ``devices=``, the service's engine proxies, a ``mesh=``
  without a ``"shard"`` axis refused with JAX's error
  (``test_torch_mesh_placement.py`` serves on meshes).

Small sizes, float32 compute on the CPU (the kernel wrappers' plain
versions); weights from the JAX ``init_prettr`` through the bridge,
documents and queries from numpy seeds."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prettr as JP
from repro.index import IndexBuilder as JaxIndexBuilder
from repro.index import TermRepIndex as JaxTermRepIndex
from repro.serving import RankingRouter as JaxRankingRouter
from repro.serving import RankRequest as JaxRankRequest
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.index import IndexBuilder, ShardIndexView, TermRepIndex
from repro_torch.serving import (RankingRouter, RankingService, RankRequest,
                                 SchedulerPolicy, ServiceStats,
                                 validate_doc_routing)

MAX_Q, MAX_D, N_DOCS = 8, 16, 32
TOL = dict(rtol=2e-5, atol=2e-5)
CODECS = {"fp16": dict(codec="fp16"),
          "int8_kv": dict(codec="int8", store_layer_kv=True,
                          kv_codec="int8"),
          "pq": dict(codec="pq")}


def _configs():
    kw = dict(n_layers=3, d_model=32, n_heads=2, d_ff=64, vocab_size=256,
              l=1, max_len=MAX_Q + MAX_D)
    jcfg = JP.PreTTRConfig(
        backbone=JP.make_backbone(**kw, compute_dtype=jnp.float32,
                                  attn_impl="blocked", compress_impl="plain",
                                  block_kv=8),
        l=1, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=16)
    tcfg = TP.PreTTRConfig(
        backbone=TP.make_backbone(**kw, compute_dtype=torch.float32,
                                  attn_impl="cuda", compress_impl="cuda"),
        l=1, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=16)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _world():
    """JAX params (numpy leaves), ragged docs, and 8 requests: 6 of 10
    candidates drawn with repeats, one of repeated ids, an empty one."""
    jcfg, _ = _configs()
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)
    docs = [rng.integers(5, 256, int(n))
            for n in rng.integers(4, MAX_D, N_DOCS)]
    reqs = []
    for _ in range(6):
        q = np.zeros(MAX_Q, np.int64)
        n_q = int(rng.integers(2, MAX_Q - 1))
        q[: n_q + 2] = [1, *rng.integers(5, 200, n_q), 2]
        reqs.append((q, q != 0, [int(d) for d in
                                 rng.integers(0, N_DOCS, 10)]))
    reqs.append((reqs[0][0], reqs[0][1], [3, 3, 17, 17, 8, 30, 3]))
    reqs.append((reqs[1][0], reqs[1][1], []))
    return jax.tree.map(np.asarray, params), docs, reqs


def _tparams():
    return params_from_jax(_world()[0], _configs()[1], device="cpu")


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """Port-built indexes over two physical shards, one per codec, and a
    JAX-built fp16 index over four."""
    _, tcfg = _configs()
    jcfg, _ = _configs()
    jparams, docs, _ = _world()
    root = tmp_path_factory.mktemp("sharded")
    out = {}
    for name, kw in CODECS.items():
        out[name] = str(root / name)
        IndexBuilder(out[name], tcfg, _tparams(), n_shards=2, batch_size=16,
                     device="cpu", **kw).build(docs)
    out["jax4"] = str(root / "jax4")
    JaxIndexBuilder(out["jax4"], jcfg, jax.tree.map(jnp.asarray, jparams),
                    codec="fp16", n_shards=4, batch_size=8).build(docs)
    return out


def _drain(svc, reqs, request=RankRequest):
    for i, (q, qv, cands) in enumerate(reqs):
        svc.submit(request(q, qv, cands, request_id=f"q{i}"))
    return {r.request_id: r for r in svc.drain()}


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for rid in ref:
        assert not got[rid].degraded, (rid, got[rid].failed_doc_ids)
        assert got[rid].doc_ids == ref[rid].doc_ids, rid
        np.testing.assert_array_equal(got[rid].scores, ref[rid].scores)


def _service(index, **kw):
    kw.setdefault("micro_batch", 4)
    return RankingService(_tparams(), _configs()[1], index, device="cpu",
                          **kw)


def _router(index, n_shards, **kw):
    kw.setdefault("micro_batch", 4)
    return RankingRouter(_tparams(), _configs()[1], index,
                         n_shards=n_shards, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Assignment and shard views
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_serving", [1, 2, 3, 4, 8])
def test_serving_assignment_matches_jax(indexes, n_serving):
    idx = TermRepIndex.open(indexes["jax4"])
    got = idx.serving_assignment(n_serving)
    want = JaxTermRepIndex.open(indexes["jax4"]).serving_assignment(
        n_serving)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # a partition with every shard populated, along the physical files
    assert len(np.unique(got)) == min(n_serving, len(idx))
    phys = idx._doc_table[:, 0]
    for s in np.unique(got):
        assert len(np.unique(phys[got == s])) == (
            1 if n_serving >= idx.n_shards else idx.n_shards // n_serving
            + (s < idx.n_shards % n_serving))


def test_serving_assignment_refuses_zero_shards(indexes):
    with pytest.raises(ValueError, match="n_serving"):
        TermRepIndex.open(indexes["fp16"]).serving_assignment(0)


def test_shard_view_ownership_and_delegation(indexes):
    idx = TermRepIndex.open(indexes["int8_kv"])
    a = idx.serving_assignment(2)
    view = idx.shard_view(a, 0)
    assert isinstance(view, ShardIndexView)
    assert len(view) == len(idx)
    assert (view.rep_dim, view.l, view.codec.name, view.kv_dim) == \
        (idx.rep_dim, idx.l, idx.codec.name, idx.kv_dim)
    assert view.streams_spec() == idx.streams_spec()
    np.testing.assert_array_equal(view.doc_lengths, idx.doc_lengths)
    other = idx.shard_view(a, 1)
    assert view.n_owned + other.n_owned == len(idx)
    assert not set(view.owned_ids) & set(other.owned_ids)
    owned = view.owned_ids
    assert view.owns(owned).all()
    assert not view.owns(other.owned_ids).any()
    assert not view.owns([-1, len(idx)]).any()
    assert view.describe_misroute(owned) is None
    # owned reads are the base index's bytes, raw, decoded and staged
    parts_v, valid_v = view.gather_raw(owned[:5], pad_to=MAX_D)
    parts_b, valid_b = idx.gather_raw(owned[:5], pad_to=MAX_D)
    np.testing.assert_array_equal(valid_v, valid_b)
    for name in parts_b:
        np.testing.assert_array_equal(parts_v[name], parts_b[name])
    np.testing.assert_array_equal(view.gather(owned[:5])[0],
                                  idx.gather(owned[:5])[0])
    staged, valid = view.stage(owned[:5], device="cpu")
    for name in parts_b:
        np.testing.assert_array_equal(staged[name].numpy(), parts_b[name])
    np.testing.assert_array_equal(valid.numpy(), valid_b)


@pytest.mark.parametrize("method", ["gather_raw", "gather", "load_docs",
                                    "stage"])
def test_shard_view_refuses_misrouted_and_out_of_range(indexes, method):
    idx = TermRepIndex.open(indexes["fp16"])
    a = idx.serving_assignment(2)
    view = idx.shard_view(a, 0)
    stranger = int(idx.shard_view(a, 1).owned_ids[0])
    owned = int(view.owned_ids[0])
    read = getattr(view, method)
    kw = {"device": "cpu"} if method == "stage" else {}
    with pytest.raises(IndexError, match="resident elsewhere"):
        read([owned, stranger], **kw)
    with pytest.raises(IndexError, match=f"{stranger}->shard {a[stranger]}"):
        read([stranger], **kw)
    for bad in (len(idx), -1):
        with pytest.raises(IndexError, match="out of range"):
            read([bad], **kw)
    read([owned], **kw)                          # an owned id reads
    # admission surfaces the same refusals as ValueError
    with pytest.raises(ValueError, match="resident elsewhere"):
        validate_doc_routing(view, [stranger])
    with pytest.raises(ValueError, match="out of range"):
        validate_doc_routing(view, [-1])
    validate_doc_routing(idx, [0, len(idx) - 1])


def test_shard_view_rejects_a_bad_assignment(indexes):
    idx = TermRepIndex.open(indexes["fp16"])
    with pytest.raises(ValueError, match="assignment maps"):
        idx.shard_view(np.zeros(3, np.int64), 0)
    with pytest.raises(ValueError, match="outside"):
        idx.shard_view(idx.serving_assignment(2), 2)


def test_gather_load_docs_and_projection_match_jax(indexes):
    ids = [5, 0, 31, 7, 7]
    got = TermRepIndex.open(indexes["jax4"])
    want = JaxTermRepIndex.open(indexes["jax4"])
    for name in ("gather", "load_docs"):
        (g, gv), (w, wv) = (getattr(i, name)(ids) for i in (got, want))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(gv, wv)
    for pad in (4, 20):
        np.testing.assert_array_equal(got.gather(ids, pad_to=pad)[0],
                                      want.gather(ids, pad_to=pad)[0])
    for args in [(50_000_000, 1200.0, 128, 2), (1000, 37.5, 16, 0.25, 0.5),
                 (7, 3.0, 64, 1.0)]:
        assert TermRepIndex.projected_storage_bytes(*args) == \
            JaxTermRepIndex.projected_storage_bytes(*args)
    # an int8 index decodes on the host as JAX's does
    i8 = TermRepIndex.open(indexes["int8_kv"])
    parts, valid = i8.gather_raw(ids, streams=["reps", "scales"])
    reps, valid2 = i8.gather(ids)
    np.testing.assert_array_equal(valid, valid2)
    np.testing.assert_array_equal(
        reps, parts["reps"].astype(np.float32) * parts["scales"][..., None])


# ---------------------------------------------------------------------------
# The router against the single-process service
# ---------------------------------------------------------------------------


def test_router_rejects_bad_ids_at_admission(indexes):
    router = _router(TermRepIndex.open(indexes["fp16"]), 2)
    q, qv, _ = _world()[2][0]
    for bad in ([0, N_DOCS], [-1, 2]):
        with pytest.raises(ValueError, match="out of range"):
            router.submit(RankRequest(q, qv, bad, request_id="bad"))
    assert router.stats.n_requests == 0
    # nothing half-enqueued: a good request still completes alone
    resp = router.rank(q, qv, [0, 1, 2])
    assert sorted(resp.doc_ids) == [0, 1, 2]
    assert router.stats.n_rows == 3


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("codec", list(CODECS))
def test_router_bit_matches_single_process(indexes, codec, n_shards):
    """Same candidates, same bits, over every shard count: repeated ids
    split across shards and an empty request included."""
    reqs = _world()[2]
    idx = TermRepIndex.open(indexes[codec])
    svc = _service(idx)
    ref = _drain(svc, reqs)
    router = _router(idx, n_shards)
    _assert_same(_drain(router, reqs), ref)
    # shard affinity: each row scored by the worker that stores its doc
    per_worker = [w.stats.n_rows for w in router.workers]
    assert sum(per_worker) == sum(len(c) for _, _, c in reqs)
    a = router.assignment
    for s, n in enumerate(per_worker):
        assert n == sum(int(np.sum(a[np.asarray(c, np.int64)] == s))
                        for _, _, c in reqs if c)
    st = router.stats
    assert (st.n_retries, st.n_failovers, st.n_degraded) == (0, 0, 0)
    assert st.n_decode_dispatch == 0
    if n_shards == 1:
        assert (st.n_rows, st.n_batches, st.n_pad_rows) == \
            (svc.stats.n_rows, svc.stats.n_batches, svc.stats.n_pad_rows)


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("codec", ["int8_kv", "pq"])
def test_router_doc_cache_cold_and_warm_bit_match(indexes, codec, n_shards):
    """Per-worker paged doc caches: the cold pass (misses) and the warm
    pass (hits) equal the single-process service with the same cache."""
    reqs = _world()[2]
    idx = TermRepIndex.open(indexes[codec])
    cache = dict(doc_cache_mb=1, page_tokens=8)
    svc = _service(idx, **cache)
    ref_cold, ref_warm = _drain(svc, reqs), _drain(svc, reqs)
    router = _router(idx, n_shards, **cache)
    _assert_same(_drain(router, reqs), ref_cold)
    assert router.stats.n_doc_cache_miss > 0
    assert all(w.doc_cache is not None for w in router.workers)
    router.reset_stats()
    _assert_same(_drain(router, reqs), ref_warm)
    assert router.stats.n_doc_cache_hit > 0
    # the warm pass stages nothing for resident docs
    assert router.stats.h2d_bytes < sum(w.doc_cache.resident_bytes
                                        for w in router.workers)
    assert router.stats.resident_docs == max(
        w.resident_docs for w in router.worker_stats)


def test_router_deadline_redispatch_bit_match(indexes):
    """A 0 s deadline splits every micro-batch down to its last depth in
    the service and in each worker alike; the scores are the same bits
    and the redispatch shows in the merged stats."""
    idx = TermRepIndex.open(indexes["fp16"])
    q, qv, _ = _world()[2][0]
    cands = list(range(16))
    policy = SchedulerPolicy(max_split_depth=2)
    ref = _service(idx, micro_batch=8, policy=policy).rank(
        q, qv, cands, deadline_s=0.0)
    router = _router(idx, 2, micro_batch=8, policy=policy)
    resp = router.rank(q, qv, cands, deadline_s=0.0)
    assert resp.stats.n_redispatch > 0 and router.stats.n_redispatch > 0
    assert resp.doc_ids == ref.doc_ids
    np.testing.assert_array_equal(resp.scores, ref.scores)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_router_matches_the_jax_router(indexes, n_shards):
    """One JAX-built index, bridged weights: the port's router within
    2e-5 of the JAX router, in the same order where scores are apart."""
    jcfg, tcfg = _configs()
    jparams, _, reqs = _world()
    want = _drain(JaxRankingRouter(jax.tree.map(jnp.asarray, jparams), jcfg,
                                   JaxTermRepIndex.open(indexes["jax4"]),
                                   n_shards=n_shards, micro_batch=4),
                  reqs, JaxRankRequest)
    got = _drain(_router(TermRepIndex.open(indexes["jax4"]), n_shards),
                 reqs)
    assert set(got) == set(want)
    for rid in want:
        g = dict(zip(got[rid].doc_ids, got[rid].scores))
        w = dict(zip(want[rid].doc_ids, np.asarray(want[rid].scores)))
        assert set(g) == set(w)
        np.testing.assert_allclose([g[d] for d in w], list(w.values()),
                                   **TOL)
        np.testing.assert_allclose(got[rid].scores,
                                   np.asarray(want[rid].scores), **TOL)


def test_router_empty_and_repeated_requests(indexes):
    idx = TermRepIndex.open(indexes["fp16"])
    router = _router(idx, 3)
    q, qv, _ = _world()[2][0]
    router.submit(RankRequest(q, qv, [], request_id="empty"))
    (resp,) = router.drain()
    assert resp.request_id == "empty" and resp.doc_ids == []
    assert router.drain() == []
    resp = router.rank(q, qv, [4, 4, 4])
    assert resp.doc_ids == [4, 4, 4]
    assert resp.scores[0] == resp.scores[1] == resp.scores[2]
    # the query is encoded once however many shards it fans out to
    router.reset_stats()
    router._qcache.clear()
    router.rank(q, qv, list(range(N_DOCS)))
    assert len(router._qcache) == 1


# ---------------------------------------------------------------------------
# Stats, placement, surface
# ---------------------------------------------------------------------------


def test_service_stats_merge_is_field_complete():
    """Every field merges: gauges (resident_docs) and overlapped walls
    (wall_s) by max, the rest by sum; + and sum() too."""
    fields = [f.name for f in dataclasses.fields(ServiceStats)]
    assert {"n_retries", "n_failovers"} <= set(fields)
    a = ServiceStats(**{n: i + 1 for i, n in enumerate(fields)})
    b = ServiceStats(**{n: 10 * (i + 1) for i, n in enumerate(fields)})
    m = a.merge(b)
    for i, n in enumerate(fields):
        want = 10 * (i + 1) if n in ("resident_docs", "wall_s") \
            else 11 * (i + 1)
        assert getattr(m, n) == want, n
    assert a + b == m
    assert sum([a, b]) == m
    assert b.merge(a) == m
    with pytest.raises(TypeError):
        a + 1


def test_router_stats_aggregate_consistently(indexes):
    reqs = _world()[2]
    router = _router(TermRepIndex.open(indexes["int8_kv"]), 2,
                     doc_cache_mb=1, page_tokens=8)
    _drain(router, reqs)
    agg, per = router.stats, router.worker_stats
    assert len(per) == 2
    # requests and query encodes are the router's, never a worker's
    assert agg.n_requests == len(reqs)
    assert all(w.n_requests == 0 and w.query_encode_s == 0 for w in per)
    assert agg.query_encode_s > 0
    for name in ("n_rows", "n_batches", "n_pad_rows", "n_join_dispatch",
                 "h2d_bytes", "n_doc_cache_miss", "load_s", "combine_s"):
        assert getattr(agg, name) == pytest.approx(
            sum(getattr(w, name) for w in per)), name
    assert agg.resident_docs == max(w.resident_docs for w in per)
    # the router's wall brackets the concurrent worker drains
    assert agg.wall_s >= max(w.wall_s for w in per)
    router.reset_stats()
    assert router.stats == ServiceStats()


@pytest.mark.parametrize("n_shards", [2, 3])
def test_devices_pin_each_workers_engine(indexes, n_shards):
    """``devices=`` puts worker i on devices[i]: its engine, its params
    and its doc-cache pools; all CPUs here (separate cards need a
    machine with several)."""
    reqs = _world()[2]
    idx = TermRepIndex.open(indexes["int8_kv"])
    ref = _drain(_service(idx), reqs)
    router = RankingRouter(_tparams(), _configs()[1], idx,
                           devices=[torch.device("cpu")] * n_shards,
                           micro_batch=4, doc_cache_mb=1, page_tokens=8)
    assert router.n_shards == n_shards and router.device.type == "cpu"
    for w in router.workers:
        assert w.device.type == "cpu" and w.engine.device.type == "cpu"
        leaf = w.engine.params["score_head"]
        assert leaf.device.type == "cpu"
        assert all(p.device.type == "cpu"
                   for p in w.doc_cache.pools.values())
    _assert_same(_drain(router, reqs), ref)
    with pytest.raises(ValueError, match="devices for"):
        RankingRouter(_tparams(), _configs()[1], idx, n_shards=3,
                      devices=["cpu", "cpu"])


def test_router_refuses_a_mesh_naming_its_roadmap_item(indexes):
    """The mesh refusal of ROADMAP item 7 is gone (the port has meshes);
    what is refused now is what JAX refuses, a mesh with no "shard"
    axis."""
    from repro_torch.dist.compat import Mesh
    with pytest.raises(ValueError, match="needs a mesh with a 'shard' axis"):
        RankingRouter(_tparams(), _configs()[1],
                      TermRepIndex.open(indexes["fp16"]),
                      mesh=Mesh(["cpu"] * 2, ("data",)), device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        _router(TermRepIndex.open(indexes["fp16"]), 0)


def test_service_engine_proxies(indexes):
    idx = TermRepIndex.open(indexes["int8_kv"])
    svc = _service(idx, prefetch_depth=0)
    assert (svc.prefetch_depth, svc.fused, svc.use_layer_kv) == \
        (0, True, True)
    pol = SchedulerPolicy(max_split_depth=5)
    svc.policy = pol
    assert svc.policy is pol and svc.engine.policy is pol
    legacy = _service(idx, fused=False)
    assert (legacy.fused, legacy.use_layer_kv, legacy.prefetch_depth) == \
        (False, False, 2)


def test_router_under_thread_switch_stress(indexes):
    """More workers than the machine has cores, each draining on its own
    thread beside its own prefetch thread, with the interpreter switching
    threads every 10 us: every row is scored once, by the worker that
    owns it, to the service's bits."""
    import os
    import sys

    reqs = _world()[2] * 2
    idx = TermRepIndex.open(indexes["int8_kv"])
    ref = _drain(_service(idx), reqs)
    n = min(32, (os.cpu_count() or 1) + 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        router = _router(idx, n, doc_cache_mb=1, page_tokens=8)
        got = _drain(router, reqs)
    finally:
        sys.setswitchinterval(old)
    _assert_same(got, ref)
    assert sum(w.stats.n_rows for w in router.workers) == \
        sum(len(c) for _, _, c in reqs)
    assert router.stats.n_requests == len(reqs)
