"""The port's int8 storage and stored layer-l K/V against the JAX package:
the int8 codec's bytes, the plain versions of the int8 and paged join
forms against the JAX Pallas kernels (interpret mode), ``precompute_doc_kv``,
``join_and_score`` with each ``doc_kv`` form against JAX ``blocked``, the
stored-vs-recomputed invariant, and int8 + layer-K/V indexes opened
across the two packages.

Inputs are made with numpy from a seed (weights through the bridge) and
fed to both packages.  Tolerances follow tests/test_kernels.py:
rtol = atol = 2e-5 in float32 and 2e-2 in bfloat16.  Reps of two builds
differ in the last float32 bits, so their int8 encodings may differ by
one quantisation step."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prettr as JP
from repro.index import IndexBuilder as JaxIndexBuilder
from repro.index import TermRepIndex as JaxTermRepIndex
from repro.index.codecs import Int8Codec as JaxInt8Codec
from repro.kernels.join_attention import dequantize_kv as jax_dequantize
from repro.kernels.join_attention import join_flash_attention as jax_join
from repro.kernels.join_attention import \
    join_flash_attention_paged as jax_join_paged
from repro.kernels.join_attention import pages_to_dense as jax_pages_to_dense
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.index import IndexBuilder, TermRepIndex
from repro_torch.index.codecs import Int8Codec, get_codec
from repro_torch.kernels.join_attention import (dequantize_kv,
                                                join_flash_attention,
                                                join_flash_attention_paged,
                                                pages_to_dense)

MAX_Q, MAX_D, BATCH, PAGE = 8, 24, 3, 8
GRID = [(0, 0, None), (2, 0, None), (2, 16, 2), (3, 0, 2)]
TOL = dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The int8 codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", ["reps", "layer_k"])
def test_int8_codec_bytes_match_the_package(group):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 24)).astype(np.float32) * 3
    x[5] = 0.0                                # an all-zero token
    ours, theirs = Int8Codec(), JaxInt8Codec()
    assert ours.stream_group(group, 24) == theirs.stream_group(group, 24)
    assert ours.bytes_per_token(24) == theirs.bytes_per_token(24)
    parts, jparts = ours.encode_group(group, x), theirs.encode_group(group, x)
    assert sorted(parts) == sorted(jparts)
    for name in parts:
        assert parts[name].dtype == jparts[name].dtype
        assert parts[name].tobytes() == jparts[name].tobytes()
    want = np.asarray(theirs.decode_group(group, jparts))
    np.testing.assert_array_equal(ours.decode_group(group, parts), want)
    tparts = {k: torch.from_numpy(v) for k, v in parts.items()}
    np.testing.assert_array_equal(ours.decode_group(group, tparts).numpy(),
                                  want)
    assert ours.encode_dtype == np.float32 and not ours.decode_is_identity


def test_pq_is_not_ported():
    """pq is ported for the reps stream group only: as in the JAX package,
    its codes cannot hold the layer-l K/V streams (``kv_codec="pq"``), and
    a name neither package has is refused."""
    codec = get_codec("pq")
    assert codec.name == "pq" and codec.needs_fit
    with pytest.raises(ValueError, match="only the 'reps' stream group"):
        codec.stream_group("layer_k", 32)
    with pytest.raises(ValueError, match="unknown storage codec"):
        get_codec("PQ")


# ---------------------------------------------------------------------------
# The plain int8 and paged join forms against the Pallas kernels
# ---------------------------------------------------------------------------


def _quant_inputs(rng, b, hq, hkv, sq, lq, ld, d):
    q = rng.standard_normal((b, hq, sq, d), np.float32)
    kq = rng.standard_normal((b, hkv, lq, d), np.float32)
    vq = rng.standard_normal((b, hkv, lq, d), np.float32)
    kd = rng.integers(-127, 128, (b, hkv, ld, d)).astype(np.int8)
    vd = rng.integers(-127, 128, (b, hkv, ld, d)).astype(np.int8)
    ks = rng.uniform(1e-3, 0.05, (b, ld)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.05, (b, ld)).astype(np.float32)
    kqv = np.arange(lq)[None] < rng.integers(1, lq + 1, (b, 1))
    kdv = np.arange(ld)[None] < rng.integers(1, ld + 1, (b, 1))
    kdv[:, min(2, ld - 1)] = False            # non-prefix validity
    kdv[:, 0] = True
    return q, kq, vq, kd, vd, ks, vs, kqv, kdv


@pytest.mark.parametrize("b,hq,hkv,sq,lq,ld,d", [
    (2, 4, 2, 16, 8, 48, 32),    # tests/test_join_attention.py's shape
    (1, 4, 1, 1, 16, 40, 16),    # CLS row (Sq = 1), MQA
])
def test_join_int8_plain_vs_pallas(b, hq, hkv, sq, lq, ld, d):
    arrays = _quant_inputs(np.random.default_rng(1), b, hq, hkv, sq, lq, ld,
                           d)
    q, kq, vq, kd, vd, ks, vs, kqv, kdv = arrays
    want = jax_join(*(jnp.asarray(a) for a in (q, kq, vq, kd, vd)),
                    jnp.asarray(kqv), jnp.asarray(kdv),
                    kd_scales=jnp.asarray(ks), vd_scales=jnp.asarray(vs),
                    interpret=True)
    t = [torch.from_numpy(a) for a in arrays]
    got = join_flash_attention(*t[:5], t[7], t[8], t[5], t[6])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        dequantize_kv(t[3], t[5]).numpy(),
        np.asarray(jax_dequantize(jnp.asarray(kd), jnp.asarray(ks))))


def _paged(rng, b, hkv, d, page, n_slots, quant):
    """Pools [P, page, Hkv, D] with page 0 all zero; rows hold distinct
    real pages, row 1 a zero-page tail and row 0 a stale last page (real
    data, zero validity)."""
    n_pool = 2 + b * n_slots
    if quant:
        k = rng.integers(-127, 128, (n_pool, page, hkv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (n_pool, page, hkv, d)).astype(np.int8)
        scales = [rng.uniform(1e-3, 0.05, (n_pool, page, 1))
                  .astype(np.float32) for _ in range(2)]
    else:
        k, v = (rng.standard_normal((n_pool, page, hkv, d), np.float32)
                for _ in range(2))
        scales = []
    valid = (rng.random((n_pool, page)) < 0.8).astype(np.int32)
    valid[:, 0] = 1
    table = (2 + rng.permutation(n_pool - 2)[: b * n_slots]) \
        .reshape(b, n_slots).astype(np.int32)
    table[1, 1:] = 0                          # short doc: zero-page tail
    valid[table[0, -1]] = 0                   # stale page behind row 0's end
    for a in (k, v, *scales, valid):
        a[0] = 0
    return k, v, table, valid, scales


@pytest.mark.parametrize("page,n_slots", [(8, 4), (16, 3), (24, 2)])
@pytest.mark.parametrize("quant", [False, True])
def test_join_paged_plain_vs_pallas(page, n_slots, quant):
    b, hq, hkv, lq, d = 2, 4, 2, 8, 32
    rng = np.random.default_rng(2)
    sq = lq + page * n_slots
    q = rng.standard_normal((b, hq, sq, d), np.float32)
    kq, vq = (rng.standard_normal((b, hkv, lq, d), np.float32)
              for _ in range(2))
    kqv = np.arange(lq)[None] < np.asarray([[6], [8]])
    k, v, table, valid, scales = _paged(rng, b, hkv, d, page, n_slots, quant)
    jscales = dict(zip(("kd_scale_pages", "vd_scale_pages"),
                       (jnp.asarray(s) for s in scales)))
    want = jax_join_paged(*(jnp.asarray(a) for a in (q, kq, vq, k, v, table,
                                                     valid, kqv)),
                          **jscales, interpret=True)
    tscales = dict(zip(("kd_scale_pages", "vd_scale_pages"),
                       (torch.from_numpy(s) for s in scales)))
    got = join_flash_attention_paged(
        *(torch.from_numpy(a) for a in (q, kq, vq, k, v, table, valid, kqv)),
        **tscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        pages_to_dense(torch.from_numpy(valid), torch.from_numpy(table))
        .numpy(), np.asarray(jax_pages_to_dense(jnp.asarray(valid),
                                                jnp.asarray(table))))


# ---------------------------------------------------------------------------
# precompute_doc_kv and join_and_score with stored K/V against JAX blocked
# ---------------------------------------------------------------------------


def _configs(l, compress_dim, n_kv_heads, impl="cuda"):
    kw = dict(n_layers=4, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
              l=l, max_len=64, n_kv_heads=n_kv_heads)
    jcfg = JP.PreTTRConfig(
        backbone=JP.make_backbone(**kw, compute_dtype=jnp.float32,
                                  block_kv=16, attn_impl="blocked",
                                  compress_impl="plain"),
        l=l, max_query_len=MAX_Q, max_doc_len=MAX_D,
        compress_dim=compress_dim, store_dtype=jnp.float32)
    tcfg = TP.PreTTRConfig(
        backbone=TP.make_backbone(**kw, compute_dtype=torch.float32,
                                  attn_impl=impl, compress_impl=impl),
        l=l, max_query_len=MAX_Q, max_doc_len=MAX_D,
        compress_dim=compress_dim, store_dtype=torch.float32)
    return jcfg, tcfg


def _inputs():
    rng = np.random.default_rng(3)
    q = rng.integers(5, 512, (BATCH, MAX_Q))
    d = rng.integers(5, 512, (BATCH, MAX_D))
    qv = np.arange(MAX_Q)[None] < rng.integers(3, MAX_Q + 1, (BATCH, 1))
    dv = np.arange(MAX_D)[None] < rng.integers(5, MAX_D + 1, (BATCH, 1))
    return q, d, qv, dv


def _doc_kv_forms(k, v, dv):
    """The three ``doc_kv`` forms of stored K/V [B, Ld, d_kv] as numpy:
    float, int8 (the codec's encoding) and paged int8 pools of PAGE
    tokens with flat rows, as the device doc cache hands them over."""
    codec = Int8Codec()
    pk, pv = codec.encode_group("layer_k", k), codec.encode_group("layer_v", v)
    quant = (pk["layer_k"], pv["layer_v"], pk["layer_k_scales"],
             pv["layer_v_scales"])
    b, ld, dkv = k.shape
    n_p = ld // PAGE
    table = (2 + np.arange(b * n_p)).reshape(b, n_p).astype(np.int32)

    def pool(a):                              # [B, Ld, ...] -> pages
        rows = a.reshape(b * n_p, PAGE, *a.shape[2:])
        return np.concatenate([np.zeros((2, *rows.shape[1:]), a.dtype),
                               rows])

    paged = dict(k=pool(quant[0]), v=pool(quant[1]),
                 valid=pool(dv.astype(np.int8)), page_table=table,
                 k_scale=pool(quant[2]), v_scale=pool(quant[3]))
    return {"float": (k, v), "int8": quant, "paged": paged}


@functools.lru_cache(maxsize=None)
def _jax_world(l, compress_dim, n_kv_heads):
    jcfg, _ = _configs(l, compress_dim, n_kv_heads)
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    q, d, qv, dv = _inputs()

    @jax.jit
    def prep(params, q, d, qv, dv):
        store = JP.precompute_docs(params, jcfg, d, dv)
        return (JP.encode_query(params, jcfg, q, qv), store,
                JP.precompute_doc_kv(params, jcfg, store))

    qr, store, (k, v) = prep(params, q, d, qv, dv)
    forms = _doc_kv_forms(np.asarray(k), np.asarray(v), dv)

    def score(form):
        dkv = forms[form]
        if form == "paged":
            dkv = JP.PagedDocKV(**{n: jnp.asarray(a) for n, a in dkv.items()})
        else:
            dkv = tuple(jnp.asarray(a) for a in dkv)
        return np.asarray(jax.jit(
            lambda p, dkv: JP.join_and_score(p, jcfg, qr, qv, store, dv,
                                             doc_kv=dkv))(params, dkv))

    scores = {form: score(form) for form in forms}
    return (jax.tree.map(np.asarray, params), np.asarray(qr),
            np.asarray(store), forms, scores)


def _port(l, compress_dim, n_kv_heads, impl):
    jparams, qr, store, forms, _ = _jax_world(l, compress_dim, n_kv_heads)
    _, tcfg = _configs(l, compress_dim, n_kv_heads, impl)
    return (tcfg, params_from_jax(jparams, tcfg, device="cpu"),
            torch.tensor(qr), torch.tensor(store), forms)


@pytest.mark.parametrize("l,compress_dim,n_kv_heads", GRID)
def test_precompute_doc_kv_matches_jax(l, compress_dim, n_kv_heads):
    tcfg, params, _, store, forms = _port(l, compress_dim, n_kv_heads,
                                          "cuda")
    k, v = TP.precompute_doc_kv(params, tcfg, store)
    np.testing.assert_allclose(k.numpy(), forms["float"][0], **TOL)
    np.testing.assert_allclose(v.numpy(), forms["float"][1], **TOL)


@pytest.mark.parametrize("form", ["float", "int8", "paged"])
@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("l,compress_dim,n_kv_heads", GRID)
def test_join_and_score_with_stored_kv_matches_jax(l, compress_dim,
                                                   n_kv_heads, impl, form):
    tcfg, params, qr, store, forms = _port(l, compress_dim, n_kv_heads, impl)
    _, _, qv, dv = (torch.from_numpy(a) for a in _inputs())
    dkv = forms[form]
    if form == "paged":
        dkv = TP.PagedDocKV(**{n: torch.tensor(a) for n, a in dkv.items()})
    else:
        dkv = tuple(torch.tensor(a) for a in dkv)
    got = TP.join_and_score(params, tcfg, qr, qv, store, dv, doc_kv=dkv)
    want = _jax_world(l, compress_dim, n_kv_heads)[4][form]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("l,compress_dim,n_kv_heads", GRID)
def test_stored_kv_matches_recompute_bitwise(l, compress_dim, n_kv_heads):
    """At float32 storage, layer-l K/V from precompute_doc_kv reproduce the
    join's own projections bit for bit under the plain impl
    (tests/test_join_attention.py asserts the same of the JAX package)."""
    tcfg, params, qr, store, _ = _port(l, compress_dim, n_kv_heads, "plain")
    _, _, qv, dv = (torch.from_numpy(a) for a in _inputs())
    doc_kv = TP.precompute_doc_kv(params, tcfg, store)
    np.testing.assert_array_equal(
        TP.join_and_score(params, tcfg, qr, qv, store, dv,
                          doc_kv=doc_kv).numpy(),
        TP.join_and_score(params, tcfg, qr, qv, store, dv).numpy())


# ---------------------------------------------------------------------------
# int8 + layer-K/V indexes across the two packages
# ---------------------------------------------------------------------------

N_DOCS = 12


def _index_configs():
    kw = dict(n_layers=3, d_model=32, n_heads=4, d_ff=64, vocab_size=256,
              l=1, max_len=MAX_Q + MAX_D, n_kv_heads=2)
    jcfg = JP.PreTTRConfig(
        backbone=JP.make_backbone(**kw, compute_dtype=jnp.float32,
                                  attn_impl="blocked", compress_impl="plain"),
        l=1, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=8)
    tcfg = TP.PreTTRConfig(
        backbone=TP.make_backbone(**kw, compute_dtype=torch.float32),
        l=1, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=8)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _index_world():
    jcfg, _ = _index_configs()
    params, _ = JP.init_prettr(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(4)
    docs = [rng.integers(4, 256, n) for n in rng.integers(2, 30, N_DOCS)]
    return jax.tree.map(np.asarray, params), docs


@pytest.fixture(scope="module")
def jax_indexes(tmp_path_factory):
    jparams, docs = _index_world()
    jcfg, _ = _index_configs()
    out = {}
    for name, kw in (("int8", dict(codec="int8", kv_codec="int8")),
                     ("fp16", dict(codec="fp16"))):
        path = str(tmp_path_factory.mktemp(f"jax_{name}_kv"))
        JaxIndexBuilder(path, jcfg, jax.tree.map(jnp.asarray, jparams),
                        store_layer_kv=True, n_shards=2, batch_size=8,
                        **kw).build(docs)
        out[name] = path
    return out


@pytest.mark.parametrize("name", ["int8", "fp16"])
def test_port_reads_jax_layer_kv_index_bytes_exactly(jax_indexes, name):
    ours = TermRepIndex.open(jax_indexes[name])
    theirs = JaxTermRepIndex.open(jax_indexes[name])
    assert ours.streams_spec() == theirs.streams_spec()
    assert ours.bytes_per_token() == theirs.bytes_per_token()
    assert (ours.has_layer_kv, ours.kv_dim) == (True, 16)
    assert (ours.kv_codec is None) == (name == "fp16")
    ids = [3, 0, 11, 3, 7]
    (parts, valid), (jparts, jvalid) = (ours.gather_raw(ids),
                                        theirs.gather_raw(ids))
    np.testing.assert_array_equal(valid, jvalid)
    assert sorted(parts) == sorted(jparts)
    for s in parts:
        assert parts[s].tobytes() == jparts[s].tobytes(), s
    tparts, _ = ours.stage(ids, streams=["layer_k", "layer_v"],
                           device="cpu")
    assert sorted(tparts) == ["layer_k", "layer_v"]
    np.testing.assert_array_equal(tparts["layer_k"].numpy(),
                                  jparts["layer_k"])
    with pytest.raises(ValueError, match="unknown stream"):
        ours.gather_raw(ids, streams=["layer_q"])


def test_jax_opens_a_port_built_int8_index(jax_indexes, tmp_path):
    """Decoded values of every int8 stream within one quantisation step
    of the JAX build's."""
    jparams, docs = _index_world()
    _, tcfg = _index_configs()
    IndexBuilder(str(tmp_path), tcfg, params_from_jax(jparams, tcfg,
                                                      device="cpu"),
                 codec="int8", store_layer_kv=True, kv_codec="int8",
                 n_shards=3, batch_size=8, device="cpu").build(docs)
    theirs = JaxTermRepIndex.open(str(tmp_path))
    ref = JaxTermRepIndex.open(jax_indexes["int8"])
    assert theirs.streams_spec() == ref.streams_spec()
    np.testing.assert_array_equal(theirs.doc_lengths, ref.doc_lengths)
    ids = list(range(N_DOCS))
    (parts, valid), (rparts, rvalid) = (theirs.gather_raw(ids),
                                        ref.gather_raw(ids))
    np.testing.assert_array_equal(valid, rvalid)
    codec = JaxInt8Codec()
    for group in ("reps", "layer_k", "layer_v"):
        got = np.asarray(codec.decode_group(group, parts))[valid]
        want = np.asarray(codec.decode_group(group, rparts))[valid]
        step = np.maximum(parts[codec.scale_stream(group)],
                          rparts[codec.scale_stream(group)])[valid]
        assert np.all(np.abs(got - want) <= 1.01 * step[:, None] + 1e-6), \
            group
