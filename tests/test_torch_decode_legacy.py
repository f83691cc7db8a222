"""The legacy concat join and the CLS-only decode layer of the port against
the JAX package: the flash-decode wrapper (its plain version on the CPU)
and its ``ref`` against the JAX ``decode_attention_ref`` and the JAX
flash-decode kernel in interpret mode, the plain ``decode_attention``
layer, ``_cls_only_layer``, ``join_and_score(fused=False)``,
``rank_forward`` (which now runs the decode layer, as the JAX one does)
and ``RankingService(fused=False)``.

Inputs are made with numpy from a seed; weights come from the JAX
``init_prettr`` through the bridge.  Tolerances follow
tests/test_kernels.py: rtol = atol = 2e-5 in float32, 2e-2 in bfloat16
(both frameworks round the same float32 inputs to the same bf16 values;
they then sum in other orders)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prettr as JP
from repro.index import IndexBuilder as JaxIndexBuilder
from repro.index import TermRepIndex as JaxTermRepIndex
from repro.kernels.decode_attention import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.decode_attention import \
    flash_decode_attention as jax_flash_decode
from repro.models import layers as JL
from repro.serving.service import RankingService as JaxRankingService
from repro.serving.service import RankRequest as JaxRankRequest
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.index import TermRepIndex
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  flash_decode_attention)
from repro_torch.models import backend as TB
from repro_torch.models import layers as TL
from repro_torch.serving import RankingService, RankRequest

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# -- the kernel: tests/test_kernels.py's sweep and its k_valid case ----------

SWEEP = [(2, 8, 2, 256, 32, -1), (2, 8, 2, 256, 32, 64),
         (1, 4, 4, 512, 64, -1), (3, 16, 8, 128, 64, 32)]


def _decode_inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, 1, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32))


def _kvalid_case():
    pos = np.arange(128)[None]
    valid = (pos < np.array([[40], [11]])) \
        | ((pos >= 64) & (pos < np.array([[100], [80]])))
    return _decode_inputs(2, 4, 2, 128, 32, 5), valid


@functools.lru_cache(maxsize=None)
def _jax_decode(case, dtype):
    """The JAX ref and the JAX kernel (interpret mode) on one case."""
    jdt = DTYPES[dtype][0]
    if case == "k_valid":
        (q, k, v), valid = _kvalid_case()
        q, k, v = (jnp.asarray(a, jdt) for a in (q, k, v))
        lengths = jnp.asarray([100, 80], jnp.int32)
        return {"ref": np.asarray(jax_decode_ref(q, k, v, lengths,
                                                 jnp.asarray(valid)),
                                  np.float32),
                "flash": np.asarray(jax_flash_decode(
                    q, k, v, None, jnp.asarray(valid), block_k=32),
                    np.float32)}
    b, hq, hkv, s, d, window = SWEEP[case]
    q, k, v = (jnp.asarray(a, jdt)
               for a in _decode_inputs(b, hq, hkv, s, d, case))
    lengths = jnp.asarray([s, s // 2, s - 7][:b], jnp.int32)
    return {"ref": np.asarray(jax_decode_ref(q, k, v, lengths,
                                             window=window), np.float32),
            "flash": np.asarray(jax_flash_decode(q, k, v, lengths,
                                                 window=window, block_k=64),
                                np.float32)}


def _port_decode(case, dtype, fn):
    tdt = DTYPES[dtype][1]
    if case == "k_valid":
        (q, k, v), valid = _kvalid_case()
        q, k, v = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
        valid = torch.from_numpy(valid)
        if fn == "flash":          # lengths from k_valid, as the JAX wrapper
            return flash_decode_attention(q, k, v, None, valid)
        return decode_attention_ref(q, k, v, torch.tensor([100, 80]), valid)
    b, hq, hkv, s, d, window = SWEEP[case]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _decode_inputs(b, hq, hkv, s, d, case))
    lengths = torch.tensor([s, s // 2, s - 7][:b], dtype=torch.int32)
    if fn == "flash":
        return flash_decode_attention(q, k, v, lengths, window=window)
    return decode_attention_ref(q, k, v, lengths, window=window)


@pytest.mark.parametrize("jax_fn", ["ref", "flash"])
@pytest.mark.parametrize("port_fn", ["flash", "ref"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [*range(len(SWEEP)), "k_valid"])
def test_flash_decode_matches_jax(case, dtype, port_fn, jax_fn):
    got = _port_decode(case, dtype, port_fn)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_decode(case, dtype)[jax_fn],
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


# -- the plain decode_attention layer ------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window,masked", [(-1, False), (-1, True),
                                           (8, False), (8, True)])
def test_decode_attention_layer_matches_jax(window, masked, dtype):
    """q [B, 1, Hq, D] against caches [B, S, Hkv, D] with positions,
    GQA 4/2, window and validity."""
    rng = np.random.default_rng(7)
    b, hq, hkv, s, d = 3, 4, 2, 40, 16
    q = rng.standard_normal((b, 1, hq, d), np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d), np.float32)
            for _ in range(2))
    k_pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    q_pos = np.array([[s - 1], [20], [5]], np.int32)
    valid = rng.random((b, s)) < 0.7 if masked else None
    if masked:
        valid[np.arange(b), q_pos[:, 0]] = True
    jdt, tdt = DTYPES[dtype]
    want = JL.decode_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), scale=d ** -0.5,
        k_pos=jnp.asarray(k_pos), q_pos=jnp.asarray(q_pos), window=window,
        k_valid=None if valid is None else jnp.asarray(valid))
    got = TL.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), scale=d ** -0.5,
        k_pos=torch.from_numpy(k_pos), q_pos=torch.from_numpy(q_pos),
        window=window,
        k_valid=None if valid is None else torch.from_numpy(valid))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


# -- the model: the CLS-only layer, the concat join, rank_forward --------------

MAX_Q, MAX_D, BATCH = 8, 24, 3
GRID = [(0, 0, None), (2, 0, None), (2, 16, 2), (3, 0, 2)]
IMPLS = ["plain", "cuda"]


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


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    q = rng.integers(5, 512, (BATCH, MAX_Q))
    d = rng.integers(5, 512, (BATCH, MAX_D))
    qv = np.arange(MAX_Q)[None] < rng.integers(3, MAX_Q + 1, (BATCH, 1))
    dv = np.arange(MAX_D)[None] < rng.integers(5, MAX_D + 1, (BATCH, 1))
    x = rng.standard_normal((BATCH, MAX_Q + MAX_D, 64), np.float32)
    return q, d, qv, dv, x


def _joint(q, d, qv, dv):
    return (np.concatenate([q, d], axis=1),
            np.concatenate([np.zeros_like(q), np.ones_like(d)], axis=1),
            np.concatenate([qv, dv], axis=1))


@functools.lru_cache(maxsize=None)
def _jax_world(l, compress_dim, n_kv_heads):
    jcfg, _ = _configs(l, compress_dim, n_kv_heads)
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    q, d, qv, dv, x = _inputs()
    positions = jnp.broadcast_to(jnp.arange(MAX_Q + MAX_D),
                                 (BATCH, MAX_Q + MAX_D))
    lp = jax.tree.map(lambda a: a[-1], params["backbone"]["layers"])
    qr = JP.encode_query(params, jcfg, q, qv)
    store = JP.precompute_docs(params, jcfg, d, dv)
    out = {"cls_only_layer": JP._cls_only_layer(
               lp, jnp.asarray(x), jcfg.backbone, positions=positions,
               valid=jnp.asarray(np.concatenate([qv, dv], 1))),
           "join_concat": JP.join_and_score(params, jcfg, qr, qv, store, dv,
                                            fused=False),
           "rank_forward": JP.rank_forward(params, jcfg, *_joint(q, d, qv,
                                                                 dv))}
    return (jax.tree.map(np.asarray, params),
            {k: np.asarray(v) for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def _port_world(l, compress_dim, n_kv_heads, impl):
    jparams, _ = _jax_world(l, compress_dim, n_kv_heads)
    _, tcfg = _configs(l, compress_dim, n_kv_heads, impl)
    params = params_from_jax(jparams, tcfg, device="cpu")
    q, d, qv, dv, x = (torch.from_numpy(a) for a in _inputs())
    positions = torch.arange(MAX_Q + MAX_D).expand(BATCH, -1)
    qr = TP.encode_query(params, tcfg, q, qv)
    store = TP.precompute_docs(params, tcfg, d, dv)
    return {"cls_only_layer": TP._cls_only_layer(
                params["backbone"]["layers"][-1], x, tcfg.backbone,
                positions=positions, valid=torch.cat([qv, dv], 1)),
            "join_concat": TP.join_and_score(params, tcfg, qr, qv, store, dv,
                                             fused=False),
            "join_fused": TP.join_and_score(params, tcfg, qr, qv, store, dv),
            "rank_forward": TP.rank_forward(
                params, tcfg, *(torch.from_numpy(a) for a in
                                _joint(*_inputs()[:4])))}


@pytest.mark.parametrize("fn", ["cls_only_layer", "join_concat",
                                "rank_forward"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("l,compress_dim,n_kv_heads", GRID)
def test_legacy_path_matches_jax_blocked(l, compress_dim, n_kv_heads, impl,
                                         fn):
    _, want = _jax_world(l, compress_dim, n_kv_heads)
    got = _port_world(l, compress_dim, n_kv_heads, impl)[fn]
    np.testing.assert_allclose(got.float().numpy(), want[fn], **F32_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("l,compress_dim,n_kv_heads", GRID)
def test_fused_and_concat_joins_are_bit_equal(l, compress_dim, n_kv_heads,
                                              impl):
    """Inside the port the fused split-residual join and the concat join
    give the same bits on the CPU (row-wise ops per segment; the CLS row
    over the same keys in the same order)."""
    out = _port_world(l, compress_dim, n_kv_heads, impl)
    np.testing.assert_array_equal(out["join_fused"].numpy(),
                                  out["join_concat"].numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_rank_forward_and_concat_dispatch_the_decode_kind(impl, monkeypatch):
    """rank_forward and the concat join end in the decode_attention kind,
    as the JAX functions do, and never reach join_attention; the fused
    join's CLS row is a join_attention call."""
    calls = []
    for kind in ("decode_attention", "join_attention"):
        fn = TB.get_impl(kind, impl)
        monkeypatch.setitem(
            TB._REGISTRY[kind], impl,
            lambda *a, _k=kind, _f=fn, **kw: calls.append(_k) or _f(*a, **kw))
    jparams, _ = _jax_world(2, 0, None)
    _, tcfg = _configs(2, 0, None, impl)
    params = params_from_jax(jparams, tcfg, device="cpu")
    q, d, qv, dv, _ = (torch.from_numpy(a) for a in _inputs())
    TP.rank_forward(params, tcfg, *(torch.from_numpy(a) for a in
                                    _joint(*_inputs()[:4])))
    assert calls == ["decode_attention"]
    qr = TP.encode_query(params, tcfg, q, qv)
    store = TP.precompute_docs(params, tcfg, d, dv)
    calls.clear()
    TP.join_and_score(params, tcfg, qr, qv, store, dv, fused=False)
    assert calls == ["decode_attention"]
    calls.clear()
    TP.join_and_score(params, tcfg, qr, qv, store, dv)
    assert calls == ["join_attention"] * 2          # layer 2, the CLS row


def test_cuda_decode_impl_needs_a_static_window():
    t = torch.zeros((1, 1, 2, 16))
    with pytest.raises(ValueError, match="static window"):
        TB.get_impl("decode_attention", "cuda")(
            t, t, t, cfg=None, scale=0.25, q_pos=None, k_pos=None,
            window=-1)


# -- the service over the concat join ------------------------------------------

N_DOCS = 20


@functools.lru_cache(maxsize=None)
def _serving_world():
    jcfg, _ = _configs(2, 16, 2)
    params, _ = JP.init_prettr(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(9)
    docs = [rng.integers(4, 512, n) for n in rng.integers(2, 30, N_DOCS)]
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
    jparams, docs, _ = _serving_world()
    jcfg, _ = _configs(2, 16, 2)
    path = str(tmp_path_factory.mktemp("legacy_index"))
    JaxIndexBuilder(path, jcfg, jax.tree.map(jnp.asarray, jparams),
                    codec="fp16", batch_size=8).build(docs)
    return path


def _serve(svc, request_cls):
    for i, (q, qv, ids) in enumerate(_serving_world()[2]):
        svc.submit(request_cls(q, qv, ids, request_id=f"r{i}"))
    return {r.request_id: r for r in svc.drain()}


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("impl", IMPLS)
def test_legacy_service_matches_the_jax_service(jax_index_dir, impl, depth):
    jcfg, tcfg = _configs(2, 16, 2, impl)
    jparams = _serving_world()[0]
    want = _serve(JaxRankingService(
        jax.tree.map(jnp.asarray, jparams), jcfg,
        JaxTermRepIndex.open(jax_index_dir), micro_batch=4, fused=False),
        JaxRankRequest)
    svc = RankingService(params_from_jax(jparams, tcfg, device="cpu"), tcfg,
                         TermRepIndex.open(jax_index_dir), micro_batch=4,
                         fused=False, prefetch_depth=depth, device="cpu")
    got = _serve(svc, RankRequest)
    assert sorted(got) == sorted(want)
    for rid, resp in got.items():
        assert resp.doc_ids == [int(i) for i in want[rid].doc_ids]
        np.testing.assert_allclose(resp.scores, np.asarray(want[rid].scores),
                                   **F32_TOL)
    assert svc.stats.n_rows == 21 and svc.stats.n_batches == 6


def test_legacy_service_takes_no_stored_kv(tmp_path):
    """use_layer_kv defaults off on the concat path and is refused on it,
    as in the JAX engine."""
    from repro_torch.index import IndexBuilder
    _, tcfg = _configs(2, 16, 2)
    params = params_from_jax(_serving_world()[0], tcfg, device="cpu")
    IndexBuilder(str(tmp_path), tcfg, params, codec="int8",
                 store_layer_kv=True, kv_codec="int8", batch_size=8,
                 device="cpu").build(_serving_world()[1][:6])
    index = TermRepIndex.open(str(tmp_path))
    svc = RankingService(params, tcfg, index, fused=False, device="cpu")
    assert not svc.engine.use_layer_kv
    assert RankingService(params, tcfg, index, device="cpu") \
        .engine.use_layer_kv
    with pytest.raises(ValueError, match="fused"):
        RankingService(params, tcfg, index, fused=False, use_layer_kv=True,
                       device="cpu")
