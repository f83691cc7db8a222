"""The port's paged device doc cache and the service paths through it,
against the JAX package: ``DeviceDocCache.plan`` makes the JAX cache's
page tables, miss lists and counters on a seeded zipf stream; the port's
service scores a JAX-built int8 + int8-K/V index like the JAX service,
with the cache on and off; and inside the port hit and miss rows score
bit-equal, nothing is decoded outside the scoring call, and each
micro-batch makes one ``join_and_score`` call.

float32 compute.  Scores of the same stored bytes agree to the FP16_TOL
of tests/test_torch_index_serving.py (rtol = atol = 2e-3)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prettr as JP
from repro.index import IndexBuilder as JaxIndexBuilder
from repro.index import TermRepIndex as JaxTermRepIndex
from repro.serving.doc_cache import DeviceDocCache as JaxDeviceDocCache
from repro.serving.service import RankingService as JaxRankingService
from repro.serving.service import RankRequest as JaxRankRequest
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.index import TermRepIndex
from repro_torch.serving import DeviceDocCache, RankingService, RankRequest

MAX_Q, MAX_D, N_DOCS, MICRO = 8, 24, 20, 4
FP16_TOL = dict(rtol=2e-3, atol=2e-3)
# a cache of ~11 docs at 8-token pages: evictions on a 20-doc stream
SMALL_CACHE_MB = 0.025


# ---------------------------------------------------------------------------
# plan(): the same decisions as the JAX cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_tokens", [8, None])
@pytest.mark.parametrize("page_bucket", [False, True])
def test_plan_matches_the_jax_cache(page_tokens, page_bucket):
    rng = np.random.default_rng(0)
    n_docs, batch = 60, 4
    doc_lens = rng.integers(1, MAX_D + 1, n_docs)
    streams = {"reps": (np.int8, (16,)), "scales": (np.float32, ())}
    kw = dict(doc_len=MAX_D, streams=streams, page_tokens=page_tokens,
              page_bucket=page_bucket, min_slots=2 * batch)
    ours = DeviceDocCache(11000, device="cpu", **kw)
    theirs = JaxDeviceDocCache(11000, **kw)
    assert (ours.capacity_pages, ours.page_bytes, ours.padded_len) == \
        (theirs.capacity_pages, theirs.page_bytes, theirs.padded_len)
    for step in range(60):
        ids = list(np.minimum(rng.zipf(1.3, batch), n_docs) - 1)
        n_real = batch - int(step % 5 == 0)   # a padded micro-batch
        if n_real < batch:
            ids[-1] = ids[-2]
        lens = doc_lens[ids]
        got = ours.plan(ids, lengths=lens, n_real=n_real)
        want = theirs.plan(ids, lengths=lens, n_real=n_real)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        assert ours.last_plan_scans == theirs.last_plan_scans
    assert (ours.hits, ours.misses, ours.evictions) == \
        (theirs.hits, theirs.misses, theirs.evictions)
    assert ours.evictions > 0 and ours.hits > 0
    assert ours.resident_bytes == theirs.resident_bytes


def test_cache_insert_take_round_trip():
    """Inserted rows come back through the page table; tails read the
    zero page and its zero validity."""
    streams = {"reps": (np.int8, (4,)), "scales": (np.float32, ())}
    cache = DeviceDocCache(4000, doc_len=20, streams=streams, page_tokens=8,
                           min_slots=2, device="cpu")
    table, miss_ids, miss_pages = cache.plan([5, 9], lengths=[20, 3])
    assert miss_ids == [5, 9] and table.shape == (2, 3)
    assert list(table[1, 1:]) == [cache.ZERO_PAGE] * 2
    assert list(miss_pages[1, 1:]) == [cache.SCRATCH_PAGE] * 2
    rng = np.random.default_rng(1)
    parts = {"reps": torch.from_numpy(rng.integers(-9, 9, (2, 24, 4))
                                      .astype(np.int8)),
             "scales": torch.from_numpy(rng.random((2, 24), np.float32))}
    valid = np.arange(24)[None] < np.asarray([[20], [3]])
    cache.insert(miss_pages, parts, valid)
    got, got_valid = cache.take(table)
    np.testing.assert_array_equal(got_valid, valid)
    for name in parts:
        np.testing.assert_array_equal(got[name][0].numpy(),
                                      parts[name][0].numpy())
        np.testing.assert_array_equal(got[name][1, :8].numpy(),
                                      parts[name][1, :8].numpy())
        assert not got[name][1, 8:].any()


# ---------------------------------------------------------------------------
# The service against the JAX service on a JAX-built int8 + int8-K/V index
# ---------------------------------------------------------------------------


def _configs(impl="cuda"):
    kw = dict(n_layers=4, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
              l=2, max_len=MAX_Q + MAX_D, n_kv_heads=2)
    jcfg = JP.PreTTRConfig(
        backbone=JP.make_backbone(**kw, compute_dtype=jnp.float32,
                                  attn_impl="blocked", compress_impl="plain"),
        l=2, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=16)
    tcfg = TP.PreTTRConfig(
        backbone=TP.make_backbone(**kw, compute_dtype=torch.float32,
                                  attn_impl=impl, compress_impl=impl),
        l=2, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=16)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _world():
    """JAX params (numpy leaves), raw docs and a zipf request stream."""
    jcfg, _ = _configs()
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    docs = [rng.integers(4, 512, n) for n in rng.integers(2, 40, N_DOCS)]
    p = 1.0 / np.arange(1, N_DOCS + 1) ** 1.1
    requests = []
    for n_cand in (7, 5, 9, 6):
        q = np.zeros(MAX_Q, np.int64)
        n_q = int(rng.integers(1, MAX_Q - 1))
        q[: n_q + 2] = [1, *rng.integers(4, 512, n_q), 2]
        requests.append((q, q != 0, [int(i) for i in rng.choice(
            N_DOCS, n_cand, replace=False, p=p / p.sum())]))
    return jax.tree.map(np.asarray, params), docs, requests


@pytest.fixture(scope="module")
def int8_index_dir(tmp_path_factory):
    jparams, docs, _ = _world()
    jcfg, _ = _configs()
    path = str(tmp_path_factory.mktemp("jax_int8_kv"))
    JaxIndexBuilder(path, jcfg, jax.tree.map(jnp.asarray, jparams),
                    codec="int8", store_layer_kv=True, kv_codec="int8",
                    n_shards=2, batch_size=8).build(docs)
    return path


def _serve(svc, request_cls, passes=1):
    out = []
    for _ in range(passes):
        for i, (q, qv, ids) in enumerate(_world()[2]):
            svc.submit(request_cls(q, qv, ids, request_id=f"r{i}"))
        out.append({r.request_id: r for r in svc.drain()})
    return out


@functools.lru_cache(maxsize=None)
def _jax_scores(path, cache_mb):
    jcfg, _ = _configs()
    svc = JaxRankingService(
        jax.tree.map(jnp.asarray, _world()[0]), jcfg,
        JaxTermRepIndex.open(path), micro_batch=MICRO, use_layer_kv=True,
        doc_cache_mb=cache_mb, page_tokens=8)
    return {rid: dict(zip(map(int, r.doc_ids), np.asarray(r.scores)))
            for rid, r in _serve(svc, JaxRankRequest)[0].items()}


def _port_service(path, impl, cache_mb, **kw):
    _, tcfg = _configs(impl)
    return RankingService(params_from_jax(_world()[0], tcfg, device="cpu"),
                          tcfg, TermRepIndex.open(path), micro_batch=MICRO,
                          use_layer_kv=True, doc_cache_mb=cache_mb,
                          page_tokens=8, device="cpu", **kw)


@pytest.mark.parametrize("cache_mb", [0, SMALL_CACHE_MB])
@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_port_service_matches_jax_service(int8_index_dir, impl, cache_mb):
    want = _jax_scores(int8_index_dir, cache_mb)
    got = _serve(_port_service(int8_index_dir, impl, cache_mb),
                 RankRequest)[0]
    assert sorted(got) == sorted(want)
    for rid, resp in got.items():
        assert sorted(resp.doc_ids) == sorted(want[rid])
        np.testing.assert_allclose(
            resp.scores, [want[rid][d] for d in resp.doc_ids], **FP16_TOL)


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_bucket", [False, True])
@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_hit_and_miss_rows_score_bit_equal(int8_index_dir, monkeypatch,
                                           impl, page_bucket):
    """Two passes of the stream through a cache too small for it (cold,
    then warm with evictions): every score bit-equal across the passes,
    nothing decoded outside the scoring call, one join per micro-batch,
    and the uncached service within float32 summation noise."""
    calls = []
    join = TP.join_and_score
    monkeypatch.setattr(TP, "join_and_score",
                        lambda *a, **k: calls.append(1) or join(*a, **k))
    svc = _port_service(int8_index_dir, impl, SMALL_CACHE_MB,
                        page_bucket=page_bucket)
    cold, warm = _serve(svc, RankRequest, passes=2)
    st = svc.stats
    assert len(calls) == st.n_join_dispatch == st.n_batches
    assert st.n_decode_dispatch == 0
    cache = svc.doc_cache
    assert st.n_doc_cache_hit > 0 and st.n_doc_cache_miss > 0
    assert cache.evictions > 0 and st.resident_docs == cache.resident_docs
    assert 0 < st.doc_cache_hit_rate < 1
    for rid, resp in cold.items():
        assert resp.doc_ids == warm[rid].doc_ids
        np.testing.assert_array_equal(resp.scores, warm[rid].scores)
    uncached = _serve(_port_service(int8_index_dir, impl, 0), RankRequest)[0]
    for rid, resp in uncached.items():
        np.testing.assert_allclose(
            resp.scores, [dict(zip(cold[rid].doc_ids, cold[rid].scores))[d]
                          for d in resp.doc_ids], rtol=1e-5, atol=1e-5)


def test_service_stages_only_the_streams_it_reads(int8_index_dir):
    """Without stored K/V the service stages the reps group alone; with
    them, every stream, and the K/V bytes show in h2d_bytes."""
    index = TermRepIndex.open(int8_index_dir)
    _, tcfg = _configs()
    params = params_from_jax(_world()[0], tcfg, device="cpu")
    h2d = {}
    for kv in (False, True):
        svc = RankingService(params, tcfg, index, micro_batch=MICRO,
                             use_layer_kv=kv, device="cpu")
        assert svc.engine._streams == (
            list(index.streams_spec()) if kv else ["reps", "scales"])
        _serve(svc, RankRequest)
        h2d[kv] = svc.stats.h2d_bytes
    rows = svc.stats.n_batches * MICRO * MAX_D
    assert h2d[True] - h2d[False] == rows * 2 * (index.kv_dim + 4)
    index.layer_kv = None                     # as an index without K/V
    with pytest.raises(ValueError, match="store_layer_kv"):
        RankingService(params, tcfg, index, use_layer_kv=True, device="cpu")
