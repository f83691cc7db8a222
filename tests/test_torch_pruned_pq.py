"""The port's PQ codec, index-time token pruning, checksummed builds and
``verify_index`` against the JAX package.

* The PQ codec: the same float32 sample gives bit-equal codebooks, codes
  and decodes (numpy and torch) in both packages.
* ``doc_salience`` against JAX within the float32 tolerance;
  ``prune_selection`` bit-equal on the same salience.
* JAX-built PQ, ``keep_frac=0.5``, PQ + pruned and v1 indexes opened and
  served by the port within tolerance of the JAX service (PQ also through
  the paged doc cache); port-built ones opened, checksum-verified and
  served by JAX.  Near-ties in the encoders make a PQ code or a pruned
  token differ across packages at the ulp, so built bytes are never
  compared across packages: both packages score the same index instead.
* ``verify_index`` passes on a clean build and raises on an altered
  stream; ``kv_codec="pq"`` and bad pruning policies are refused.

Weights come from the JAX ``init_prettr`` through the bridge; documents
and queries are made with numpy from a seed.  float32 compute: scores of
the same stored bytes agree to rtol = atol = 2e-5 (tests/test_kernels.py).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prettr as JP
from repro.index import IndexBuilder as JaxIndexBuilder
from repro.index import TermRepIndex as JaxTermRepIndex
from repro.index import prune_selection as jax_prune_selection
from repro.index.codecs import PQCodec as JaxPQCodec
from repro.serving.service import RankingService as JaxRankingService
from repro.serving.service import RankRequest as JaxRankRequest
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.index import (IndexBuilder, IndexIntegrityError,
                               TermRepIndex, get_codec, prune_selection,
                               verify_index)
from repro_torch.index import _msgpack
from repro_torch.index.codecs import PQCodec
from repro_torch.serving import RankingService, RankRequest

MAX_Q, MAX_D, N_DOCS = 8, 24, 20
TOL = dict(rtol=2e-5, atol=2e-5)


def _configs(n_kv_heads=2, compress_dim=16):
    kw = dict(n_layers=4, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
              l=2, max_len=MAX_Q + MAX_D, n_kv_heads=n_kv_heads)
    jcfg = JP.PreTTRConfig(
        backbone=JP.make_backbone(**kw, compute_dtype=jnp.float32,
                                  attn_impl="blocked", compress_impl="plain"),
        l=2, max_query_len=MAX_Q, max_doc_len=MAX_D,
        compress_dim=compress_dim)
    tcfg = TP.PreTTRConfig(
        backbone=TP.make_backbone(**kw, compute_dtype=torch.float32,
                                  attn_impl="cuda", compress_impl="cuda"),
        l=2, max_query_len=MAX_Q, max_doc_len=MAX_D,
        compress_dim=compress_dim)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _world(n_kv_heads=2, compress_dim=16):
    """JAX params (numpy leaves), raw docs and three requests."""
    jcfg, _ = _configs(n_kv_heads, compress_dim)
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)
    docs = [rng.integers(4, 512, n) for n in rng.integers(2, 40, N_DOCS)]
    requests = []
    for n_cand in (7, 5, 9):
        q = np.zeros(MAX_Q, np.int64)
        n_q = int(rng.integers(1, MAX_Q - 1))
        q[: n_q + 2] = [1, *rng.integers(4, 512, n_q), 2]
        requests.append((q, q != 0, [int(i) for i in
                                     rng.choice(N_DOCS, n_cand, False)]))
    return jax.tree.map(np.asarray, params), docs, requests


def _jparams():
    return jax.tree.map(jnp.asarray, _world()[0])


def _tparams(tcfg):
    return params_from_jax(_world()[0], tcfg, device="cpu")


def _serve_cfg(cfg, index):
    if 0 < index.max_doc_len < cfg.max_doc_len:
        return dataclasses.replace(cfg, max_doc_len=index.max_doc_len)
    return cfg


def _serve(svc, request_cls):
    for i, (q, qv, ids) in enumerate(_world()[2]):
        svc.submit(request_cls(q, qv, ids, request_id=f"r{i}"))
    return {r.request_id: r for r in svc.drain()}


def _jax_scores(path):
    jcfg, _ = _configs()
    index = JaxTermRepIndex.open(path)
    return _serve(JaxRankingService(_jparams(), _serve_cfg(jcfg, index),
                                    index, micro_batch=4), JaxRankRequest)


def _port_scores(path, **svc_kw):
    _, tcfg = _configs()
    index = TermRepIndex.open(path)
    return _serve(RankingService(_tparams(tcfg), _serve_cfg(tcfg, index),
                                 index, micro_batch=4, device="cpu",
                                 **svc_kw), RankRequest)


def _assert_same_ranking(got, want):
    assert sorted(got) == sorted(want)
    for rid, resp in got.items():
        assert resp.doc_ids == [int(i) for i in want[rid].doc_ids]
        np.testing.assert_allclose(resp.scores, np.asarray(want[rid].scores),
                                   **TOL)


# ---------------------------------------------------------------------------
# The PQ codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_tokens", [100, 700])      # below / above k=256
def test_pq_fit_codes_and_decode_bit_equal_to_jax(n_tokens):
    rng = np.random.default_rng(n_tokens)
    sample = (rng.standard_normal((n_tokens, 16)) * 2).astype(np.float32)
    sample[:9] = sample[9]                    # duplicate rows: ties
    ours, theirs = PQCodec(), JaxPQCodec()
    assert ours.needs_fit and theirs.needs_fit
    ours.fit(sample, seed=3)
    theirs.fit(sample, seed=3)
    np.testing.assert_array_equal(ours.codebooks, theirs.codebooks)
    x = (rng.standard_normal((5, 13, 16)) * 2).astype(np.float32)
    codes, jcodes = ours.encode(x)["reps"], theirs.encode(x)["reps"]
    assert codes.dtype == jcodes.dtype == np.uint8
    np.testing.assert_array_equal(codes, jcodes)
    want = theirs.decode({"reps": jcodes})
    np.testing.assert_array_equal(ours.decode({"reps": codes}), want)
    np.testing.assert_array_equal(
        ours.decode({"reps": torch.from_numpy(codes)}).numpy(), want)
    assert ours.streams(16) == theirs.streams(16)
    assert ours.bytes_per_token(16) == theirs.bytes_per_token(16) == 4
    # the state travels through either package's manifest
    back = get_codec("pq")
    back.load_state_dict(_msgpack.unpackb(_msgpack.packb(
        theirs.state_dict())))
    np.testing.assert_array_equal(back.codebooks, theirs.codebooks)
    assert ours.state_dict() == theirs.state_dict()


def test_pq_refuses_other_groups_and_unfitted_use():
    codec = get_codec("pq")
    with pytest.raises(ValueError, match="no codebooks"):
        codec.encode(np.zeros((2, 16), np.float32))
    with pytest.raises(ValueError, match="'reps' stream group"):
        codec.stream_group("layer_k", 16)
    with pytest.raises(ValueError, match="stateless"):
        get_codec("int8").load_state_dict({"kind": "pq"})
    with pytest.raises(ValueError, match="kind 'pq'"):
        codec.load_state_dict({"kind": "other"})


def test_pq_kv_codec_is_refused(tmp_path):
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="'reps' stream group"):
        IndexBuilder(str(tmp_path), tcfg, _tparams(tcfg), codec="fp16",
                     store_layer_kv=True, kv_codec="pq", device="cpu")


# ---------------------------------------------------------------------------
# Salience and the prune selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_kv_heads,compress_dim", [(2, 16), (4, 0)])
def test_doc_salience_matches_jax(n_kv_heads, compress_dim):
    jcfg, tcfg = _configs(n_kv_heads, compress_dim)
    jparams_np, docs, _ = _world(n_kv_heads, compress_dim)
    jparams = jax.tree.map(jnp.asarray, jparams_np)
    from repro.data.synthetic_ir import pack_doc_batch
    tokens, _, valid = pack_doc_batch(docs[:6], MAX_D)
    valid[5] = False                               # an all-pad row
    store = np.array(JP.precompute_docs(jparams, jcfg, jnp.asarray(tokens),
                                        jnp.asarray(valid)))
    want = np.asarray(JP.doc_salience(jparams, jcfg, jnp.asarray(store),
                                      jnp.asarray(valid)))
    got = TP.doc_salience(params_from_jax(jparams_np, tcfg, device="cpu"),
                          tcfg, torch.from_numpy(store),
                          torch.from_numpy(valid)).numpy()
    assert got.dtype == np.float32 and got.shape == (6, MAX_D)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[5].any() and not got[~valid].any()


@pytest.mark.parametrize("keep_frac,max_kept", [(0.5, 0), (0.3, 4),
                                                (1.0, 3), (0.01, 0)])
def test_prune_selection_bit_equal_to_jax(keep_frac, max_kept):
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 24):
        # coarse values: many ties, which both take first-index first
        sal = np.round(rng.random(MAX_D) * 4).astype(np.float32)
        got = prune_selection(sal, n, keep_frac, max_kept)
        np.testing.assert_array_equal(
            got, jax_prune_selection(sal, n, keep_frac, max_kept))
        assert np.all(np.diff(got) > 0) and len(got) >= 1


@pytest.mark.parametrize("kw,match", [
    (dict(keep_frac=0.0), "keep_frac"), (dict(keep_frac=1.5), "keep_frac"),
    (dict(max_kept_tokens=-1), "max_kept_tokens"),
    (dict(checksum_chunk_bytes=-1), "checksum_chunk_bytes"),
    (dict(keep_frac=0.5, rope=True), "learned-position")])
def test_builder_refuses_bad_policies(tmp_path, kw, match):
    _, tcfg = _configs()
    if kw.pop("rope", False):
        tcfg = dataclasses.replace(tcfg, backbone=dataclasses.replace(
            tcfg.backbone, rope=True))
    with pytest.raises(ValueError, match=match):
        IndexBuilder(str(tmp_path), tcfg, _tparams(tcfg), device="cpu", **kw)


# ---------------------------------------------------------------------------
# JAX-built indexes served by the port
# ---------------------------------------------------------------------------

JAX_BUILDS = {"pq": dict(codec="pq"), "pruned": dict(keep_frac=0.5),
              "pq_pruned": dict(codec="pq", keep_frac=0.5),
              "int8_capped": dict(codec="int8", max_kept_tokens=6)}


@pytest.fixture(scope="module")
def jax_indexes(tmp_path_factory):
    """JAX-built indexes (2 shards, checksummed) and a JAX-written v1."""
    jcfg, _ = _configs()
    _, docs, _ = _world()
    root = tmp_path_factory.mktemp("jax_built")
    out = {}
    for name, kw in JAX_BUILDS.items():
        out[name] = str(root / name)
        JaxIndexBuilder(out[name], jcfg, _jparams(), n_shards=2,
                        batch_size=8, **kw).build(docs)
    from repro.data.synthetic_ir import pack_doc_batch
    tokens, lengths, valid = pack_doc_batch(docs, MAX_D)
    reps = JP.precompute_docs(_jparams(), jcfg, jnp.asarray(tokens),
                              jnp.asarray(valid))
    out["v1"] = str(root / "v1")
    v1 = JaxTermRepIndex(out["v1"], rep_dim=16, dtype="float16", l=2,
                         compressed=True, max_doc_len=MAX_D)
    v1.add_docs(np.asarray(reps), lengths)
    v1.finalize()
    return out


@pytest.mark.parametrize("name", [*JAX_BUILDS, "v1"])
def test_port_opens_and_serves_a_jax_index(jax_indexes, name):
    path = jax_indexes[name]
    ours, theirs = TermRepIndex.open(path), JaxTermRepIndex.open(path)
    assert ours.version == theirs.version
    assert ours.max_doc_len == theirs.max_doc_len
    assert ours.prune_policy == theirs.prune_policy
    np.testing.assert_array_equal(ours.doc_lengths, theirs.doc_lengths)
    np.testing.assert_array_equal(ours.orig_doc_lengths,
                                  theirs.orig_doc_lengths)
    assert ours.bytes_per_token() == theirs.bytes_per_token()
    assert ours.storage_bytes() == theirs.storage_bytes()
    assert ours.verify_integrity() == theirs.verify_integrity()
    ids = list(range(N_DOCS))
    (parts, valid), (jparts, jvalid) = (ours.gather_raw(ids),
                                        theirs.gather_raw(ids))
    np.testing.assert_array_equal(valid, jvalid)
    for k in jparts:
        np.testing.assert_array_equal(parts[k], jparts[k])
    np.testing.assert_array_equal(ours.codec.decode(parts),
                                  theirs.codec.decode(jparts))
    _assert_same_ranking(_port_scores(path), _jax_scores(path))


@pytest.mark.parametrize("name", ["pq", "pq_pruned"])
def test_port_serves_a_jax_pq_index_through_the_doc_cache(jax_indexes,
                                                           name):
    path = jax_indexes[name]
    got = _port_scores(path, doc_cache_mb=1, page_tokens=8)
    _assert_same_ranking(got, _jax_scores(path))


def test_pruned_metadata_follows_the_policy(jax_indexes):
    index = TermRepIndex.open(jax_indexes["pruned"])
    orig = np.asarray([min(len(d) + 1, MAX_D) for d in _world()[1]])
    np.testing.assert_array_equal(index.orig_doc_lengths, orig)
    np.testing.assert_array_equal(index.doc_lengths,
                                  np.maximum(1, np.ceil(0.5 * orig)))
    assert index.prune_policy == {"keep_frac": 0.5, "max_kept_tokens": 0,
                                  "layer": 2}
    assert index.max_doc_len == 12
    v1 = TermRepIndex.open(os.path.join(jax_indexes["v1"]))
    assert v1.prune_policy is None and v1.version == 1
    np.testing.assert_array_equal(v1.orig_doc_lengths, v1.doc_lengths)


# ---------------------------------------------------------------------------
# Port-built indexes: manifests, JAX reading them, verify_index
# ---------------------------------------------------------------------------

PORT_BUILDS = {"pq": dict(codec="pq"), "pruned": dict(keep_frac=0.5),
               "pq_pruned_sync": dict(codec="pq", keep_frac=0.5,
                                      writer_depth=0),
               "int8_kv_pruned": dict(codec="int8", keep_frac=0.5,
                                      store_layer_kv=True, kv_codec="int8")}


@pytest.fixture(scope="module")
def port_indexes(tmp_path_factory):
    _, tcfg = _configs()
    _, docs, _ = _world()
    root = tmp_path_factory.mktemp("port_built")
    out = {}
    for name, kw in PORT_BUILDS.items():
        out[name] = str(root / name)
        report = IndexBuilder(out[name], tcfg, _tparams(tcfg), n_shards=2,
                              batch_size=8, checksum_chunk_bytes=256,
                              device="cpu", **kw).build(docs)
        assert (report.fit_s > 0) == (kw.get("codec") == "pq")
    return out


@pytest.mark.parametrize("name", list(PORT_BUILDS))
def test_port_manifest_carries_checksums_state_and_prune(port_indexes, name):
    path = port_indexes[name]
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        mani = _msgpack.unpackb(f.read())
    kw = PORT_BUILDS[name]
    assert mani["checksum"] == {"algo": "crc32c", "chunk_bytes": 256}
    assert mani["encode_batch"] == 8
    assert ("codec_state" in mani) == (kw.get("codec") == "pq")
    assert ("prune" in mani) == ("keep_frac" in kw)
    for sh in mani["shards"]:
        assert set(sh["checksums"]) == set(TermRepIndex.open(path)
                                           .streams_spec())
        assert ("orig_lengths" in sh) == ("keep_frac" in kw)
    theirs = JaxTermRepIndex.open(path)          # verifies the CRCs
    assert theirs.verify_integrity() > 0
    assert theirs.prune_policy == TermRepIndex.open(path).prune_policy
    if "codec_state" in mani:
        np.testing.assert_array_equal(theirs.codec.codebooks,
                                      TermRepIndex.open(path).codec.codebooks)


@pytest.mark.parametrize("name", list(PORT_BUILDS))
def test_jax_serves_a_port_built_index_like_the_port(port_indexes, name):
    path = port_indexes[name]
    _assert_same_ranking(_port_scores(path), _jax_scores(path))


def test_writer_thread_and_synchronous_writes_give_the_same_bytes(
        port_indexes, tmp_path):
    _, tcfg = _configs()
    _, docs, _ = _world()
    for depth in (1, 3):
        out = str(tmp_path / f"d{depth}")
        IndexBuilder(out, tcfg, _tparams(tcfg), codec="pq", keep_frac=0.5,
                     n_shards=2, batch_size=8, checksum_chunk_bytes=256,
                     writer_depth=depth, device="cpu").build(docs)
        for sh in ("shard-00000", "shard-00001"):
            for f in ("reps.bin",):
                with open(os.path.join(out, sh, f), "rb") as a, \
                        open(os.path.join(port_indexes["pq_pruned_sync"],
                                          sh, f), "rb") as b:
                    assert a.read() == b.read()


def test_a_failing_writer_stops_the_build(tmp_path, monkeypatch):
    """The writer thread's error reaches build() and nothing deadlocks on
    the bounded queue."""
    _, tcfg = _configs()
    _, docs, _ = _world()
    builder = IndexBuilder(str(tmp_path), tcfg, _tparams(tcfg), codec="fp16",
                           batch_size=2, writer_depth=1, device="cpu")

    def boom(x):
        raise OSError("disk full")

    monkeypatch.setattr(builder.codec, "encode", boom)
    with pytest.raises(OSError, match="disk full"):
        builder.build(docs)


@pytest.mark.parametrize("name", list(PORT_BUILDS))
def test_verify_index_passes_on_a_clean_build(port_indexes, name):
    _, tcfg = _configs()
    index = TermRepIndex.open(port_indexes[name])
    assert verify_index(index, tcfg, _tparams(tcfg), _world()[1],
                        sample=N_DOCS, device="cpu") == N_DOCS


def test_verify_index_raises_on_an_altered_stream(port_indexes, tmp_path):
    import shutil
    path = shutil.copytree(port_indexes["pq_pruned_sync"],
                           str(tmp_path / "idx"))
    stream = os.path.join(path, "shard-00001", "reps.bin")
    data = bytearray(open(stream, "rb").read())
    data[5] ^= 0xFF
    open(stream, "wb").write(bytes(data))
    with pytest.raises(IndexIntegrityError, match="chunk 0"):
        TermRepIndex.open(path)
    _, tcfg = _configs()
    with pytest.raises(AssertionError, match="stream 'reps' mismatch"):
        verify_index(TermRepIndex.open(path, verify=False), tcfg,
                     _tparams(tcfg), _world()[1], sample=N_DOCS,
                     device="cpu")


def test_unchecksummed_build_opens_unverified(tmp_path):
    _, tcfg = _configs()
    IndexBuilder(str(tmp_path), tcfg, _tparams(tcfg), batch_size=8,
                 checksum_chunk_bytes=0, device="cpu").build(_world()[1])
    with open(os.path.join(str(tmp_path), "manifest.msgpack"), "rb") as f:
        assert "checksum" not in _msgpack.unpackb(f.read())
    assert TermRepIndex.open(str(tmp_path)).verify_integrity() == 0
    with pytest.raises(ValueError, match="verify_reads"):
        TermRepIndex.open(str(tmp_path), verify_reads=True)
