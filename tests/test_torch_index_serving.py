"""The port's index and serving core against the JAX package: fp16
indexes built by either package open in both, the port's RankingService
serves a JAX-built index with the JAX service's order and scores, its
packed micro-batches score like direct ``join_and_score`` calls, and its
entry points raise without a card unless ``device="cpu"`` is passed.

Weights come from the JAX ``init_prettr`` through the bridge; documents
and queries are made with numpy from a seed.  float32 compute over fp16
storage: scores of the same stored bytes agree to rtol = atol = 2e-5
(tests/test_kernels.py), stored reps of two builds to one fp16 rounding
step (rtol = atol = 2e-3)."""
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
from repro.serving.service import RankingService as JaxRankingService
from repro.serving.service import RankRequest as JaxRankRequest
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.index import (IndexBuilder, IndexFormatError,
                               TermRepIndex)
from repro_torch.index import _msgpack
from repro_torch.serving import RankingService, RankRequest

MAX_Q, MAX_D, N_DOCS = 8, 24, 20
TOL = dict(rtol=2e-5, atol=2e-5)
FP16_TOL = dict(rtol=2e-3, atol=2e-3)


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
    """JAX params (numpy leaves), raw docs and three requests."""
    jcfg, _ = _configs()
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    docs = [rng.integers(4, 512, n) for n in rng.integers(2, 40, N_DOCS)]
    requests = []
    for n_cand in (7, 5, 9):
        q = np.zeros(MAX_Q, np.int64)
        n_q = int(rng.integers(1, MAX_Q - 1))
        q[: n_q + 2] = [1, *rng.integers(4, 512, n_q), 2]
        requests.append((q, q != 0, [int(i) for i in
                                     rng.choice(N_DOCS, n_cand, False)]))
    return jax.tree.map(np.asarray, params), docs, requests


@pytest.fixture(scope="module")
def jax_index_dir(tmp_path_factory):
    jparams, docs, _ = _world()
    jcfg, _ = _configs()
    path = str(tmp_path_factory.mktemp("jax_index"))
    JaxIndexBuilder(path, jcfg, jax.tree.map(jnp.asarray, jparams),
                    codec="fp16", n_shards=2, batch_size=8).build(docs)
    return path


def _port_params(tcfg):
    return params_from_jax(_world()[0], tcfg, device="cpu")


def _serve(svc, request_cls):
    for i, (q, qv, ids) in enumerate(_world()[2]):
        svc.submit(request_cls(q, qv, ids, request_id=f"r{i}"))
    return {r.request_id: r for r in svc.drain()}


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_port_serves_a_jax_index_like_the_jax_service(jax_index_dir, impl):
    jcfg, tcfg = _configs(impl)
    want = _serve(JaxRankingService(
        jax.tree.map(jnp.asarray, _world()[0]), jcfg,
        JaxTermRepIndex.open(jax_index_dir), micro_batch=4), JaxRankRequest)
    got = _serve(RankingService(_port_params(tcfg), tcfg,
                                TermRepIndex.open(jax_index_dir),
                                micro_batch=4, device="cpu"), RankRequest)
    assert sorted(got) == sorted(want)
    for rid, resp in got.items():
        assert resp.doc_ids == [int(i) for i in want[rid].doc_ids]
        np.testing.assert_allclose(resp.scores, np.asarray(want[rid].scores),
                                   **TOL)


def test_port_reads_jax_index_bytes_exactly(jax_index_dir):
    ours, theirs = (TermRepIndex.open(jax_index_dir),
                    JaxTermRepIndex.open(jax_index_dir))
    assert len(ours) == len(theirs) == N_DOCS
    assert ours.n_shards == theirs.n_shards == 2
    np.testing.assert_array_equal(ours.doc_lengths, theirs.doc_lengths)
    ids = [5, 0, 19, 5, 11]
    (parts, valid), (jparts, jvalid) = (ours.gather_raw(ids),
                                        theirs.gather_raw(ids))
    np.testing.assert_array_equal(parts["reps"], jparts["reps"])
    np.testing.assert_array_equal(valid, jvalid)
    tparts, tvalid = ours.stage(ids, device="cpu")
    assert list(tparts) == ["reps"]
    np.testing.assert_array_equal(tparts["reps"].numpy(), jparts["reps"])
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_jax_opens_a_port_built_index(jax_index_dir, tmp_path, n_shards):
    _, tcfg = _configs()
    _, docs, _ = _world()
    report = IndexBuilder(str(tmp_path), tcfg, _port_params(tcfg),
                          codec="fp16", n_shards=n_shards, batch_size=8,
                          device="cpu").build(docs)
    theirs = JaxTermRepIndex.open(str(tmp_path))
    ref = JaxTermRepIndex.open(jax_index_dir)
    assert len(theirs) == N_DOCS and theirs.n_shards == n_shards
    assert report.n_tokens == int(ref.doc_lengths.sum())
    np.testing.assert_array_equal(theirs.doc_lengths, ref.doc_lengths)
    ids = list(range(N_DOCS))
    (parts, valid), (rparts, rvalid) = (theirs.gather_raw(ids),
                                        ref.gather_raw(ids))
    np.testing.assert_array_equal(valid, rvalid)
    assert parts["reps"].dtype == np.float16
    np.testing.assert_allclose(parts["reps"].astype(np.float32),
                               rparts["reps"].astype(np.float32), **FP16_TOL)


@pytest.mark.parametrize("micro_batch", [3, 32])
def test_packed_service_scores_like_direct_join(jax_index_dir, micro_batch):
    """Cross-request packing, padding rows and the query-rep LRU leave
    every score what one direct join_and_score call gives, and responses
    come sorted by descending score."""
    _, tcfg = _configs()
    params = _port_params(tcfg)
    index = TermRepIndex.open(jax_index_dir)
    svc = RankingService(params, tcfg, index, micro_batch=micro_batch,
                         device="cpu")
    got = _serve(svc, RankRequest)
    for i, (q, qv, ids) in enumerate(_world()[2]):
        parts, dvalid = index.stage(ids, pad_to=MAX_D, device="cpu")
        reps = parts["reps"]
        qt = torch.from_numpy(q)[None]
        qvt = torch.from_numpy(qv)[None]
        qr = TP.encode_query(params, tcfg, qt, qvt)
        want = TP.join_and_score(params, tcfg, qr.expand(len(ids), -1, -1),
                                 qvt.expand(len(ids), -1), reps,
                                 dvalid).numpy()
        resp = got[f"r{i}"]
        assert np.all(np.diff(resp.scores) <= 0)
        np.testing.assert_allclose(
            resp.scores, want[[ids.index(d) for d in resp.doc_ids]], **TOL)
    n_rows = sum(len(ids) for _, _, ids in _world()[2])
    assert svc.stats.n_rows == n_rows
    assert svc.stats.n_batches == -(-n_rows // micro_batch)
    q, qv, ids = _world()[2][0]
    assert svc.rank(q, qv, ids).doc_ids == got["r0"].doc_ids
    assert len(svc._qcache) == 3              # the repeat was a cache hit


@pytest.mark.parametrize("entry", ["init_prettr", "params_from_jax",
                                   "IndexBuilder", "TermRepIndex.stage",
                                   "RankingService"])
def test_entry_points_raise_without_a_card(jax_index_dir, tmp_path,
                                           monkeypatch, entry):
    """``device=None`` means the card; with none present the entry points
    raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    index = TermRepIndex.open(jax_index_dir)
    calls = {
        "init_prettr": lambda: TP.init_prettr(tcfg, torch.Generator()),
        "params_from_jax": lambda: params_from_jax(_world()[0], tcfg),
        "IndexBuilder": lambda: IndexBuilder(str(tmp_path), tcfg,
                                             _port_params(tcfg)),
        "TermRepIndex.stage": lambda: index.stage([0]),
        "RankingService": lambda: RankingService(_port_params(tcfg), tcfg,
                                                 index),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_index_reader_rejects_what_it_cannot_serve(jax_index_dir, tmp_path):
    with pytest.raises(IndexFormatError, match="no manifest"):
        TermRepIndex.open(str(tmp_path))
    (tmp_path / "manifest.msgpack").write_bytes(
        _msgpack.packb({"version": 2, "codec": "pq", "rep_dim": 16, "l": 2,
                        "compressed": True, "max_doc_len": 24,
                        "shards": []}))
    with pytest.raises(IndexFormatError, match="not ported"):
        TermRepIndex.open(str(tmp_path))
    (tmp_path / "manifest.msgpack").write_bytes(_msgpack.packb({"version": 3}))
    with pytest.raises(IndexFormatError, match="format version 3"):
        TermRepIndex.open(str(tmp_path))
    _, tcfg = _configs()
    wrong_l = dataclasses.replace(
        tcfg, l=1, backbone=dataclasses.replace(tcfg.backbone,
                                                split_layers=1))
    with pytest.raises(ValueError, match="l=2"):
        RankingService(_port_params(tcfg), wrong_l,
                       TermRepIndex.open(jax_index_dir), device="cpu")


def test_compat_rejects_a_kv_width_the_config_does_not_have(tmp_path):
    """An index whose stored layer-l K/V are wider than the config's
    n_kv_heads * head_dim cannot be served."""
    _, tcfg = _configs()
    _, docs, _ = _world()
    IndexBuilder(str(tmp_path), tcfg, _port_params(tcfg), codec="int8",
                 store_layer_kv=True, kv_codec="int8", batch_size=8,
                 device="cpu").build(docs[:6])
    index = TermRepIndex.open(str(tmp_path))
    assert index.kv_dim == 2 * 16
    mha = dataclasses.replace(tcfg, backbone=dataclasses.replace(
        tcfg.backbone, n_kv_heads=4))
    with pytest.raises(ValueError, match="K/V streams of width 32"):
        RankingService(_port_params(mha), mha, index, device="cpu")
    RankingService(_port_params(tcfg), tcfg, index, device="cpu")


def test_compat_falls_back_to_the_longest_doc(jax_index_dir, tmp_path):
    """A manifest that records max_doc_len 0 is held to its longest stored
    document, so a config that pads shorter is refused, not truncated."""
    import shutil
    path = shutil.copytree(jax_index_dir, str(tmp_path / "idx"))
    mani_p = tmp_path / "idx" / "manifest.msgpack"
    mani = _msgpack.unpackb(mani_p.read_bytes())
    mani["max_doc_len"] = 0
    mani_p.write_bytes(_msgpack.packb(mani))
    index = TermRepIndex.open(path)
    longest = int(index.doc_lengths.max())
    assert index.max_doc_len == 0 and longest == MAX_D
    _, tcfg = _configs()
    short = dataclasses.replace(tcfg, max_doc_len=longest - 1)
    with pytest.raises(ValueError, match=f"max_doc_len={longest} exceeds"):
        RankingService(_port_params(short), short, index, device="cpu")
    got = _serve(RankingService(_port_params(tcfg), tcfg, index,
                                micro_batch=4, device="cpu"), RankRequest)
    assert sorted(got) == ["r0", "r1", "r2"]
