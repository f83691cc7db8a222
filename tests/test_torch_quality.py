"""The port's quality loop against the JAX package: the synthetic IR world
and the hash tokenizer bit-equal for the same seed, ``pool_reps`` and the
first stage's top-k tie order, every IR metric (ties, empty pools, no
relevant docs), ``run_cascade`` over a JAX-built index, the ``Reranker``
client, ``backend="plain"`` on the service, admission's routing check and
the two command-line tools.

Weights come from the JAX ``init_prettr`` through the bridge.  float32
compute: scores agree to rtol = atol = 2e-5 (tests/test_kernels.py);
metric values are float32 means over queries of the same per-query
values, held to rtol = 1e-6."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prettr as JP
from repro.data import synthetic_ir as JS
from repro.data.tokenizer import HashTokenizer as JaxHashTokenizer
from repro.eval import metrics as JM
from repro.eval import run_cascade as jax_run_cascade
from repro.index import IndexBuilder as JaxIndexBuilder
from repro.index import TermRepIndex as JaxTermRepIndex
from repro.retrieval import pool_reps as jax_pool_reps
from repro.serving.service import RankingService as JaxRankingService
from repro.serving.service import RankRequest as JaxRankRequest
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.data import synthetic_ir as TS
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.eval import metrics as TM
from repro_torch.eval import run_cascade
from repro_torch.index import TermRepIndex
from repro_torch.models.backend import apply_backend, impls_for
from repro_torch.retrieval import FirstStageRetriever, pool_reps, topk_stable
from repro_torch.serving import (RankingService, RankRequest, Reranker,
                                 validate_doc_routing)

MAX_Q, MAX_D, N_DOCS, N_QUERIES = 8, 24, 40, 6
TOL = dict(rtol=2e-5, atol=2e-5)
METRIC_TOL = dict(rtol=1e-6, atol=1e-7)


def _configs():
    kw = dict(n_layers=4, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
              l=2, max_len=MAX_Q + MAX_D, n_kv_heads=2)
    jcfg = JP.PreTTRConfig(
        backbone=JP.make_backbone(**kw, compute_dtype=jnp.float32,
                                  attn_impl="blocked", compress_impl="plain"),
        l=2, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=16)
    tcfg = TP.PreTTRConfig(
        backbone=TP.make_backbone(**kw, compute_dtype=torch.float32,
                                  attn_impl="cuda", compress_impl="cuda"),
        l=2, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=16)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jparams_np():
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), _configs()[0])
    return jax.tree.map(np.asarray, params)


def _worlds(seed=2):
    kw = dict(n_docs=N_DOCS, n_queries=N_QUERIES, vocab_size=512,
              doc_len=MAX_D - 2, n_topics=8, seed=seed)
    return JS.SyntheticIRWorld(**kw), TS.SyntheticIRWorld(**kw)


def _tparams():
    return params_from_jax(_jparams_np(), _configs()[1], device="cpu")


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    """JAX-built fp16 and PQ indexes of the world's documents."""
    jcfg, _ = _configs()
    world, _ = _worlds()
    root = tmp_path_factory.mktemp("quality")
    out = {}
    for codec in ("fp16", "pq"):
        out[codec] = str(root / codec)
        JaxIndexBuilder(out[codec], jcfg,
                        jax.tree.map(jnp.asarray, _jparams_np()),
                        codec=codec, batch_size=16).build(list(world.docs))
    return out


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_world_is_bit_equal_to_jax(seed):
    theirs, ours = _worlds(seed)
    np.testing.assert_array_equal(ours.docs, theirs.docs)
    assert len(ours.queries) == len(theirs.queries)
    for a, b in zip(ours.queries, theirs.queries):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.qrels, theirs.qrels)
    np.testing.assert_array_equal(ours.topic_token_logits,
                                  theirs.topic_token_logits)
    np.testing.assert_array_equal(ours.n_relevant(), theirs.n_relevant())
    for qi in range(N_QUERIES):
        np.testing.assert_array_equal(ours.candidates(qi, k=9, seed=3),
                                      theirs.candidates(qi, k=9, seed=3))
        np.testing.assert_array_equal(ours.relevant_docs(qi),
                                      theirs.relevant_docs(qi))
    for a, b in zip(ours.pair_batch(np.random.default_rng(1), 3, MAX_Q,
                                    MAX_D),
                    theirs.pair_batch(np.random.default_rng(1), 3, MAX_Q,
                                      MAX_D)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for fn in ("pack_query_batch", "pack_doc_batch"):
        src = ours.queries if fn == "pack_query_batch" else ours.docs[:5]
        size = MAX_Q if fn == "pack_query_batch" else MAX_D
        for a, b in zip(getattr(TS, fn)(src, size), getattr(JS, fn)(src,
                                                                    size)):
            np.testing.assert_array_equal(a, b)
    rels = ours.qrels[0][ours.candidates(0, k=20)]
    for fn in ("precision_at_k", "ndcg_at_k", "err_at_k"):
        assert getattr(TS, fn)(rels, 10) == getattr(JS, fn)(rels, 10)


def test_hash_tokenizer_is_bit_equal_to_jax():
    ours, theirs = HashTokenizer(512), JaxHashTokenizer(512)
    text = "Precomputing Term representations for BERT ranking rank"
    assert ours.encode(text) == theirs.encode(text)
    assert ours.encode(text, max_len=3) == theirs.encode(text, max_len=3)
    assert ours.encode_pair("bert ranking", text, MAX_Q, MAX_D) \
        == theirs.encode_pair("bert ranking", text, MAX_Q, MAX_D)


# ---------------------------------------------------------------------------
# Pooling and top-k
# ---------------------------------------------------------------------------


def test_pool_reps_hand_cases_and_jax():
    reps = torch.zeros((2, 3, 2))
    reps[0, 0] = torch.tensor([1.0, 0.0])
    reps[0, 1] = torch.tensor([3.0, 4.0])
    reps[0, 2] = torch.tensor([99.0, 99.0])               # masked out
    valid = torch.tensor([[True, True, False], [False, False, False]])
    out = pool_reps(reps, valid, normalize=False)
    np.testing.assert_allclose(out.numpy(), [[2.0, 2.0], [0.0, 0.0]])
    normed = pool_reps(reps, valid).numpy()
    np.testing.assert_allclose(np.linalg.norm(normed[0]), 1.0, rtol=1e-6)
    # the all-invalid row is the zero vector, not NaN
    np.testing.assert_array_equal(normed[1], [0.0, 0.0])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 16)).astype(np.float32)
    v = rng.random((4, 9)) < 0.6
    v[2] = False
    for norm in (True, False):
        np.testing.assert_allclose(
            pool_reps(torch.from_numpy(x), torch.from_numpy(v),
                      normalize=norm).numpy(),
            np.asarray(jax_pool_reps(x, v, normalize=norm)), **TOL)


@pytest.mark.parametrize("k", [1, 5, 17, 40])
def test_topk_tie_order_equals_lax_top_k(k):
    rng = np.random.default_rng(k)
    scores = np.round(rng.standard_normal((6, 40)) * 2).astype(np.float32)
    scores[3] = 1.0                                  # one row all tied
    scores[4, ::3] = -0.0                    # +0.0 ranks above -0.0 in XLA
    assert np.signbit(scores[scores == 0]).any()
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    got_v, got_i = topk_stable(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _metric_inputs():
    rng = np.random.default_rng(4)
    q, k = 7, 12
    scores = np.round(rng.standard_normal((q, k)) * 2).astype(np.float32)
    rels = rng.integers(0, 3, (q, k)).astype(np.int32)
    valid = rng.random((q, k)) < 0.8
    valid[2] = False                                  # an empty pool
    rels[4] = 0                                       # nothing relevant
    n_relevant = rels.clip(0, 1).sum(-1) + rng.integers(0, 3, q)
    n_relevant[4] = 0
    ideal = rng.integers(0, 3, (q, 30)).astype(np.int32)
    return scores, rels, valid, n_relevant, ideal


METRICS = {
    "mrr": lambda m, r, n, x: m.reciprocal_rank_at_k(r, n, 5),
    "mrr_grade2": lambda m, r, n, x: m.reciprocal_rank_at_k(r, n, 5, 2),
    "hit": lambda m, r, n, x: m.hit_at_k(r, n, 3),
    "ndcg": lambda m, r, n, x: m.ndcg_at_k(r, n, 5),
    "ndcg_ideal": lambda m, r, n, x: m.ndcg_at_k(r, n, 5, x[1]),
    "recall": lambda m, r, n, x: m.recall_at_k(r, n, 5, x[0]),
    "mpr": lambda m, r, n, x: m.mean_percentile_rank(r, n, x[0]),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_jax(name):
    scores, rels, valid, n_rel, ideal = _metric_inputs()
    ranked, n_valid = TM.ranked_rels_from_scores(scores, rels, valid)
    jranked, jn_valid = JM.ranked_rels_from_scores(scores, rels, valid)
    np.testing.assert_array_equal(ranked.numpy(), np.asarray(jranked))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(jn_valid))
    got = METRICS[name](TM, ranked, n_valid, (n_rel, ideal))
    want = METRICS[name](JM, jranked, jn_valid, (n_rel, ideal))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **METRIC_TOL)


def test_ties_keep_candidate_order_and_cascade_metrics_match():
    ranked, n_valid = TM.ranked_rels_from_scores(np.ones((1, 4)),
                                                 np.array([[3, 0, 2, 1]]))
    assert ranked.tolist() == [[3, 0, 2, 1]] and n_valid.tolist() == [4]
    scores, rels, valid, n_rel, ideal = _metric_inputs()
    got = TM.cascade_metrics(scores, rels, valid, k=5, n_relevant=n_rel,
                             ideal_rels=ideal)
    want = JM.cascade_metrics(scores, rels, valid, k=5, n_relevant=n_rel,
                              ideal_rels=ideal)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **METRIC_TOL)


# ---------------------------------------------------------------------------
# The cascade, the retriever and the service surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["fp16", "pq"])
def test_run_cascade_matches_the_jax_cascade(jax_index, codec):
    jcfg, tcfg = _configs()
    jworld, world = _worlds()
    want = jax_run_cascade(jax.tree.map(jnp.asarray, _jparams_np()), jcfg,
                           jworld, k=16, k_metric=5, micro_batch=8,
                           index=JaxTermRepIndex.open(jax_index[codec]))
    got = run_cascade(_tparams(), tcfg, world, k=16, k_metric=5,
                      micro_batch=8, index=TermRepIndex.open(jax_index[codec]),
                      device="cpu")
    assert got.meta == want.meta
    assert sorted(got.flat()) == sorted(want.flat())
    for key, v in want.flat().items():
        np.testing.assert_allclose(got.flat()[key], v, **METRIC_TOL)
    ids, scores = got.stages["first_stage"]
    fs = FirstStageRetriever(_tparams(), tcfg,
                             TermRepIndex.open(jax_index[codec]),
                             device="cpu")
    q_tokens, q_valid = TS.pack_query_batch(world.queries, MAX_Q)
    dense = fs.score_all(q_tokens, q_valid).numpy()
    np.testing.assert_array_equal(np.sort(ids, -1),
                                  np.sort(np.argsort(-dense, -1,
                                                     kind="stable")[:, :16],
                                          -1))
    np.testing.assert_allclose(scores, np.take_along_axis(dense, ids, -1),
                               **TOL)


def test_retriever_clamps_k_and_pools_cls(jax_index):
    _, tcfg = _configs()
    index = TermRepIndex.open(jax_index["fp16"])
    _, world = _worlds()
    q_tokens, q_valid = TS.pack_query_batch(world.queries, MAX_Q)
    fs = FirstStageRetriever(_tparams(), tcfg, index, chunk=7, device="cpu")
    ids, scores = fs.retrieve(q_tokens, q_valid, k=10 * N_DOCS)
    assert ids.shape == (N_QUERIES, N_DOCS) and ids.dtype == torch.int32
    one = FirstStageRetriever(_tparams(), tcfg, index, chunk=N_DOCS,
                              device="cpu")
    np.testing.assert_allclose(one.doc_matrix.numpy(),
                               fs.doc_matrix.numpy(), **TOL)
    cls = FirstStageRetriever(_tparams(), tcfg, index, pool="cls",
                              device="cpu")
    assert not np.allclose(cls.encode_queries(q_tokens, q_valid).numpy(),
                           fs.encode_queries(q_tokens, q_valid).numpy())
    with pytest.raises(ValueError, match="pool"):
        FirstStageRetriever(_tparams(), tcfg, index, pool="max",
                            device="cpu")


def _requests(world):
    out = []
    for qi in range(3):
        q, qv = TS.pack_query(world.queries[qi], MAX_Q)
        out.append((q, qv, [int(d) for d in world.candidates(qi, k=9)]))
    return out


def test_reranker_matches_the_service(jax_index):
    _, tcfg = _configs()
    _, world = _worlds()
    index = TermRepIndex.open(jax_index["pq"])
    svc = RankingService(_tparams(), tcfg, index, micro_batch=4,
                         device="cpu")
    rr = Reranker(_tparams(), tcfg, index, micro_batch=4, device="cpu")
    for q, qv, ids in _requests(world):
        want = svc.rank(q, qv, ids)
        got_ids, got_scores, stats = rr.rerank(q, qv, ids)
        assert got_ids == want.doc_ids and stats.n_docs == len(ids)
        np.testing.assert_allclose(got_scores, want.scores, **TOL)
    # pq decodes in a call of its own before the injected join
    assert rr._service.stats.n_decode_dispatch == 3 * 3
    # the late-bound join is what scores: a row's position in its
    # micro-batch of 4
    rr._join = lambda p, qr, qv, st, dv: torch.arange(
        st.shape[0], dtype=torch.float32)
    got_ids, got_scores, _ = rr.rerank(q, qv, ids)
    assert got_ids == [ids[i] for i in (3, 7, 2, 6, 1, 5, 0, 4, 8)]
    assert list(got_scores) == [3, 3, 2, 2, 1, 1, 0, 0, 0]


def test_plain_backend_on_the_service_matches_jax(jax_index):
    jcfg, tcfg = _configs()
    _, world = _worlds()
    index = TermRepIndex.open(jax_index["fp16"])
    svc = RankingService(_tparams(), tcfg, index, micro_batch=4,
                         backend="plain", device="cpu")
    assert (svc.cfg.backbone.attn_impl, svc.cfg.backbone.compress_impl) \
        == ("plain", "plain")
    jsvc = JaxRankingService(jax.tree.map(jnp.asarray, _jparams_np()), jcfg,
                             JaxTermRepIndex.open(jax_index["fp16"]),
                             micro_batch=4, backend="plain")
    for i, (q, qv, ids) in enumerate(_requests(world)):
        svc.submit(RankRequest(q, qv, ids, request_id=str(i)))
        jsvc.submit(JaxRankRequest(q, qv, ids, request_id=str(i)))
    got = {r.request_id: r for r in svc.drain()}
    for r in jsvc.drain():
        assert got[r.request_id].doc_ids == [int(d) for d in r.doc_ids]
        np.testing.assert_allclose(got[r.request_id].scores,
                                   np.asarray(r.scores), **TOL)


@pytest.mark.parametrize("name", ["blocked", "pallas", "triton"])
def test_unknown_backends_name_the_ports_two(name):
    with pytest.raises(ValueError, match=r"\['cuda', 'plain'\]"):
        impls_for(name)
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="port's backends"):
        apply_backend(tcfg, name)
    assert apply_backend(tcfg.backbone, "plain").attn_impl == "plain"


class _ShardView:
    """A stand-in serving-shard view: owns the even doc ids and names the
    shard of an odd one through the ``describe_misroute`` hook."""

    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __len__(self):
        return len(self.base)

    def describe_misroute(self, ids):
        bad = [int(d) for d in ids if d % 2]
        return f"doc {bad[0]} is resident on shard 1" if bad else None


def test_misrouted_ids_are_refused_at_admission(jax_index):
    _, tcfg = _configs()
    index = TermRepIndex.open(jax_index["fp16"])
    svc = RankingService(_tparams(), tcfg, _ShardView(index), micro_batch=4,
                         device="cpu")
    q, qv, _ = _requests(_worlds()[1])[0]
    with pytest.raises(ValueError, match="request bad: doc 3 is resident"):
        svc.submit(RankRequest(q, qv, [0, 2, 3], request_id="bad"))
    with pytest.raises(ValueError, match="out of range"):
        svc.submit(RankRequest(q, qv, [0, N_DOCS], request_id="far"))
    assert svc.stats.n_requests == 0
    resp = svc.rank(q, qv, [0, 2, 4])
    assert sorted(resp.doc_ids) == [0, 2, 4]
    validate_doc_routing(index, [])
    with pytest.raises(ValueError, match="out of range"):
        validate_doc_routing(index, [-1])


def test_validate_index_false_skips_the_config_check(jax_index):
    _, tcfg = _configs()
    index = TermRepIndex.open(jax_index["fp16"])
    wrong = dataclasses.replace(tcfg, compress_dim=0)
    with pytest.raises(ValueError, match="compressed"):
        RankingService(_tparams(), wrong, index, device="cpu")
    RankingService(_tparams(), wrong, index, validate_index=False,
                   device="cpu")


# ---------------------------------------------------------------------------
# The command-line tools
# ---------------------------------------------------------------------------


def test_build_index_and_serve_clis_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import build_index, serve
    out = str(tmp_path / "idx")
    build_index.main(["--out", out, "--n-docs", "40", "--batch", "16",
                      "--codec", "pq", "--keep-frac", "0.5", "--shards", "2",
                      "--verify", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "40 docs" in text and "codec=pq" in text
    assert "16 docs re-encoded, stored streams byte-identical" in text
    serve.main(["--service", "--load-index", out, "--n-docs", "40",
                "--n-queries", "4", "--candidates", "12", "--micro-batch",
                "8", "--doc-cache-mb", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "pruned keep_frac=0.5" in text and "service mode: 4 queries" in text
    serve.main(["--n-docs", "24", "--n-queries", "2", "--candidates", "8",
                "--index-dir", str(tmp_path / "idx2"), "--codec", "int8",
                "--device", "cpu"])
    assert "queries x 8 candidates" in capsys.readouterr().out


@pytest.mark.parametrize("cli,argv,item", [
    ("build_index", ["--distill-steps", "3"], "item 4"),
    ("build_index", ["--data-parallel"], "item 5"),
    ("serve", ["--serving-shards", "2"], "item 5")])
def test_unported_cli_options_name_their_roadmap_item(cli, argv, item):
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    with pytest.raises(SystemExit, match=item):
        mod.main(argv + ["--device", "cpu"])
