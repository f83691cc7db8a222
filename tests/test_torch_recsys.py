"""The port's recsys slice against the JAX package on the CPU: the plain
embedding bag (the CUDA kernel's plain version) against the Pallas
kernel in interpret mode and its oracle; the fused-table lookups; DLRM,
DeepFM and xDeepFM forward, towers and retrieval on their smoke configs,
in float32 and bf16 compute; the click-log generators; the config fields;
the weight bridge; and that every recsys function reaches the kernel's
one call site, ``embedding.padded_bag``.

Inputs and weights are made with numpy (or the JAX init, bridged) and
fed to both packages.  Tolerances: rtol = atol = 2e-5 in float32 and
2e-2 in bf16 (tests/test_kernels.py), the two summing in other orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as jax_deepfm_cfg
from repro.configs import dlrm_mlperf as jax_dlrm_cfg
from repro.configs import xdeepfm as jax_xdeepfm_cfg
from repro.data import recsys as jax_data
from repro.kernels.embedding_bag import (embedding_bag_pallas_op,
                                         embedding_bag_ref as jax_bag_ref)
from repro.models.recsys import deepfm as JF
from repro.models.recsys import dlrm as JD
from repro.models.recsys import embedding as JE
from repro_torch import bridge
from repro_torch.configs import deepfm as deepfm_cfg
from repro_torch.configs import dlrm_mlperf as dlrm_cfg
from repro_torch.configs import xdeepfm as xdeepfm_cfg
from repro_torch.data import recsys as data
from repro_torch.kernels.embedding_bag import (embedding_bag_op,
                                               embedding_bag_ref)
from repro_torch.models.recsys import deepfm as TF
from repro_torch.models.recsys import dlrm as TD
from repro_torch.models.recsys import embedding as TE

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FAMILIES = {"dlrm": (jax_dlrm_cfg, dlrm_cfg),
            "deepfm": (jax_deepfm_cfg, deepfm_cfg),
            "xdeepfm": (jax_xdeepfm_cfg, xdeepfm_cfg)}


def _tol(name):
    return dict(rtol=2e-5, atol=2e-5) if name == "float32" \
        else dict(rtol=2e-2, atol=2e-2)


def _np(x):
    """A JAX array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bag_inputs(rows, dim, n_bags, nnz, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = rng.integers(0, rows, (n_bags, nnz)).astype(np.int32)
    w = (rng.random((n_bags, nnz)) > 0.3).astype(np.float32)
    w[0] = 0.0                          # a bag of pads only
    w[1, 0] = 1.0
    w = w * rng.uniform(0.5, 2.0, w.shape).astype(np.float32)
    return table, ids, w


# ---------------------------------------------------------------------------
# The embedding bag: the kernel's plain version against Pallas and its oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dim", [1, 10, 16])
def test_plain_bag_matches_pallas_and_oracle(dim, mode, dtype):
    """Weighted sum / mean bags with weight-0 pads (which still read their
    row): the port's plain version, through the wrapper as the CPU runs
    it, against JAX ``embedding_bag_pallas_op`` in interpret mode and
    ``embedding_bag_ref``."""
    jdt, tdt = DTYPES[dtype]
    table, ids, w = _bag_inputs(40, dim, 6, 4)
    got = embedding_bag_op(_t(table).to(tdt), _t(ids), _t(w), mode=mode)
    assert got.dtype == tdt and got.shape == (6, dim)
    jt = jnp.asarray(table).astype(jdt)
    pallas = embedding_bag_pallas_op(jt, jnp.asarray(ids), jnp.asarray(w),
                                     mode=mode, interpret=True)
    oracle = jax_bag_ref(jt, jnp.asarray(ids), jnp.asarray(w), mode=mode)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_bag_cast_form_and_default_weights(mode):
    """bf16 output from a float32 table is the bag of ``table.astype(bf16)``
    (each row rounded before it is summed); no weights means weight 1; a
    bag of one is bit-equal to the cast followed by the gather."""
    table, ids, _ = _bag_inputs(30, 10, 5, 3, seed=1)
    got = embedding_bag_op(_t(table), _t(ids), mode=mode,
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = jax_bag_ref(jnp.asarray(table).astype(jnp.bfloat16),
                       jnp.asarray(ids), jnp.ones(ids.shape, jnp.float32),
                       mode=mode)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))
    one = embedding_bag_op(_t(table), _t(ids[:, :1]),
                           out_dtype=torch.bfloat16)
    assert torch.equal(one, _t(table).to(torch.bfloat16)[_t(ids[:, 0]).long()])


def test_plain_bag_out_of_range_id_is_nan_as_jnp_take():
    table, ids, w = _bag_inputs(20, 4, 3, 2, seed=2)
    ids[1, 1] = 20
    got = _np(embedding_bag_op(_t(table), _t(ids), _t(w)))
    want = _np(jax_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                           jnp.asarray(w)))
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **_tol("float32"))


# ---------------------------------------------------------------------------
# Fused-table lookups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lookups_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    vocab = (7, 30, 11)
    rng = np.random.default_rng(3)
    offsets = JE.fused_table_offsets(vocab)
    np.testing.assert_array_equal(TE.fused_table_offsets(vocab), offsets)
    table = rng.normal(size=(int(sum(vocab)), 8)).astype(np.float32)
    jt, tt = jnp.asarray(table).astype(jdt), _t(table).to(tdt)
    ids = np.stack([rng.integers(0, v, 5) for v in vocab], 1)
    np.testing.assert_allclose(
        _np(TE.lookup_single(tt, offsets, _t(ids))),
        _np(JE.lookup_single(jt, offsets, jnp.asarray(ids))), **_tol(dtype))
    flat = rng.integers(0, len(table), (4, 3))
    np.testing.assert_allclose(_np(TE.take_rows(tt, _t(flat))),
                               _np(JE.take_rows(jt, jnp.asarray(flat))),
                               **_tol(dtype))
    nnz = 4
    multi = np.stack([rng.integers(0, v, (5, nnz)) for v in vocab], 1)
    valid = rng.random((5, len(vocab), nnz)) > 0.4
    for mode in ("sum", "mean"):
        np.testing.assert_allclose(
            _np(TE.lookup_multihot(tt, offsets, _t(multi), _t(valid),
                                   mode=mode)),
            _np(JE.lookup_multihot(jt, offsets, jnp.asarray(multi),
                                   jnp.asarray(valid), mode=mode)),
            **_tol(dtype))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_segment_embedding_bag_matches_jax(mode):
    """The segment form (any ``bag_field``, per-sample weights and
    validity) through ``index_add_`` against ``segment_sum``."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 23)
    bag = rng.integers(0, 7, 23).astype(np.int64)
    w = rng.uniform(0.5, 2, 23).astype(np.float32)
    valid = rng.random(23) > 0.3
    for kw in ({}, {"weights": w, "valid": valid}):
        got = TE.embedding_bag(_t(table), None, _t(ids), _t(bag), n_bags=8,
                               mode=mode, **{k: _t(v) for k, v in kw.items()})
        want = JE.embedding_bag(jnp.asarray(table), None, jnp.asarray(ids),
                                jnp.asarray(bag), n_bags=8, mode=mode,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


def test_init_fused_table_chunks_pad_and_cast(monkeypatch):
    """Rows padded to the multiple; drawn in chunks (here of 3 rows); a
    bf16 table is the float32 one from the same seed, cast."""
    monkeypatch.setattr(TE, "_INIT_CHUNK", 3 * 4)
    gen = lambda: torch.Generator().manual_seed(5)
    f32 = TE.init_fused_table(gen(), (100, 30), 4, pad_multiple=64,
                              device="cpu")
    bf16 = TE.init_fused_table(gen(), (100, 30), 4, torch.bfloat16,
                               pad_multiple=64, device="cpu")
    assert f32.shape == (192, 4) and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    assert 0.008 < f32.std().item() < 0.012


# ---------------------------------------------------------------------------
# The models against JAX
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(family, dtype):
    """(JAX config, params) and (port config, bridged params) on the smoke
    config with compute in ``dtype``."""
    jmod, tmod = FAMILIES[family]
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jmod.smoke_config(), compute_dtype=jdt)
    tcfg = dataclasses.replace(tmod.smoke_config(), compute_dtype=tdt)
    init = JD.init_dlrm if family == "dlrm" else JF.init_deepfm
    jp, _ = init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.recsys_params_from_jax(_np_tree(jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dlrm_matches_jax(dtype):
    jcfg, jp, tcfg, tp = _models("dlrm", dtype)
    b = data.click_batch(np.random.default_rng(6), 33, n_dense=13,
                         vocab_sizes=tcfg.vocab_sizes)
    dense, sparse = b["dense"], b["sparse"]
    got = TD.dlrm_forward(tp, tcfg, _t(dense), _t(sparse))
    assert got.dtype == torch.float32 and got.shape == (33,)
    np.testing.assert_allclose(
        _np(got), _np(JD.dlrm_forward(jp, jcfg, jnp.asarray(dense),
                                      jnp.asarray(sparse))), **_tol(dtype))
    items = sparse[:, list(tcfg.item_fields)]
    np.testing.assert_allclose(
        _np(TD.item_tower(tp, tcfg, _t(items))),
        _np(JD.item_tower(jp, jcfg, jnp.asarray(items))), **_tol(dtype))
    users = sparse[:, tcfg.user_fields]
    np.testing.assert_allclose(
        _np(TD.user_tower(tp, tcfg, _t(dense), _t(users))),
        _np(JD.user_tower(jp, jcfg, jnp.asarray(dense), jnp.asarray(users))),
        **_tol(dtype))
    iv = np.random.default_rng(7).normal(size=(37, 16)).astype(np.float32)
    got = TD.retrieval_scores(tp, tcfg, _t(dense[:2]), _t(users[:2]), _t(iv))
    assert got.dtype == torch.float32 and got.shape == (2, 37)
    np.testing.assert_allclose(
        _np(got), _np(JD.retrieval_scores(jp, jcfg, jnp.asarray(dense[:2]),
                                          jnp.asarray(users[:2]),
                                          jnp.asarray(iv))), **_tol(dtype))


def test_dlrm_bf16_storage_gives_float32_storage_bits():
    """``dlrm_forward`` casts every parameter to the bf16 compute dtype
    first, and the table's cast is the kernel's row rounding, so bf16
    storage of the same weights gives the same logits, bit for bit."""
    _, jp, tcfg, tp = _models("dlrm", "bfloat16")
    tp16 = bridge.recsys_params_from_jax(_np_tree(jp), tcfg, device="cpu",
                                         table_dtype=torch.bfloat16)
    for k in ("bot", "top"):
        tp16[k] = [{n: t.to(torch.bfloat16) for n, t in lyr.items()}
                   for lyr in tp16[k]]
    cfg16 = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    b = data.click_batch(np.random.default_rng(8), 17, n_dense=13,
                         vocab_sizes=tcfg.vocab_sizes)
    dense, sparse = _t(b["dense"]), _t(b["sparse"])
    assert tp16["table"].dtype == torch.bfloat16
    assert torch.equal(TD.dlrm_forward(tp, tcfg, dense, sparse),
                       TD.dlrm_forward(tp16, cfg16, dense, sparse))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family", ["deepfm", "xdeepfm"])
def test_deepfm_matches_jax(family, dtype):
    """DeepFM (FM) and xDeepFM (CIN) forward, item vectors and retrieval
    scores."""
    jcfg, jp, tcfg, tp = _models(family, dtype)
    sparse = data.click_batch(np.random.default_rng(9), 33, n_dense=0,
                              vocab_sizes=tcfg.vocab_sizes)["sparse"]
    got = TF.deepfm_forward(tp, tcfg, _t(sparse))
    assert got.dtype == torch.float32 and got.shape == (33,)
    np.testing.assert_allclose(
        _np(got), _np(JF.deepfm_forward(jp, jcfg, jnp.asarray(sparse))),
        **_tol(dtype))
    items = sparse[:, list(tcfg.item_fields)]
    vecs, first = TF.item_vectors(tp, tcfg, _t(items))
    jvecs, jfirst = JF.item_vectors(jp, jcfg, jnp.asarray(items))
    np.testing.assert_allclose(_np(vecs), _np(jvecs), **_tol("float32"))
    np.testing.assert_allclose(_np(first), _np(jfirst), **_tol("float32"))
    users = sparse[:3, tcfg.user_fields]
    np.testing.assert_allclose(
        _np(TF.retrieval_scores(tp, tcfg, _t(users), vecs, first)),
        _np(JF.retrieval_scores(jp, jcfg, jnp.asarray(users), jvecs,
                                jfirst)), **_tol("float32"))


# ---------------------------------------------------------------------------
# Data, configs, bridge, dispatch
# ---------------------------------------------------------------------------


def test_generators_are_bit_equal_to_jax_package():
    for kw in ({"n_dense": 13, "vocab_sizes": (1000,) * 26},
               {"n_dense": 0, "vocab_sizes": dlrm_cfg.full_config()
                .vocab_sizes}):
        got = data.click_batch(np.random.default_rng(10), 64, **kw)
        want = jax_data.click_batch(np.random.default_rng(10), 64, **kw)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got = data.item_seq_batch(np.random.default_rng(11), 16, n_items=500,
                              seq_len=20)
    want = jax_data.item_seq_batch(np.random.default_rng(11), 16,
                                   n_items=500, seq_len=20)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_fields_match_jax(family):
    jmod, tmod = FAMILIES[family]
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for which in ("full_config", "smoke_config"):
        want = dataclasses.asdict(getattr(jmod, which)())
        got = dataclasses.asdict(getattr(tmod, which)())
        assert got.pop("bag_impl") == "cuda"
        for k in ("compute_dtype", "param_dtype"):
            want[k] = dt[want[k]]
        assert got == want
    full = tmod.full_config()
    assert full.vocab_sizes == jmod.full_config().vocab_sizes


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bridge_tree_matches_port_init(family):
    jcfg, _, tcfg, tp = _models(family, "float32")
    init = TD.init_dlrm if family == "dlrm" else TF.init_deepfm
    mine = init(tcfg, torch.Generator().manual_seed(0), device="cpu")

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [spec(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert spec(tp) == spec(mine)
    with pytest.raises(ValueError, match="do not match"):
        bridge.recsys_params_from_jax({"table": np.zeros((4, 16))}, tcfg,
                                      device="cpu")


class _Spy:
    """Stands in for the kernel wrapper at its one call site: records each
    bag (mode, max_nnz, table and output types) and computes it plainly."""

    def __init__(self):
        self.calls = []

    def __call__(self, table, ids, weights=None, *, mode, out_dtype):
        self.calls.append((mode, ids.shape[1], table.dtype,
                           out_dtype or table.dtype))
        return embedding_bag_ref(table, ids, weights, mode=mode,
                                 out_dtype=out_dtype)


@pytest.mark.parametrize("impl", ["cuda", "plain"])
def test_every_lookup_reaches_the_kernel_call_site(monkeypatch, impl):
    """With ``bag_impl="cuda"`` every recsys function hands its gather-
    reduce to the kernel wrapper (which launches the kernel on the card):
    bags of one for the single-hot lookups, mean bags over the 13 item /
    user fields, sum bags over the FM fields and the width-1 ``w1``; the
    bf16 rows of a float32 table come from the wrapper's cast form.  With
    ``"plain"`` none does."""
    spy = _Spy()
    monkeypatch.setattr(TE, "embedding_bag_op", spy)
    f32, bf16 = torch.float32, torch.bfloat16
    _, _, cfg, p = _models("dlrm", "bfloat16")
    cfg = dataclasses.replace(cfg, bag_impl=impl)
    b = data.click_batch(np.random.default_rng(12), 4, n_dense=13,
                         vocab_sizes=cfg.vocab_sizes)
    dense, sparse = _t(b["dense"]), _t(b["sparse"])
    users = sparse[:, cfg.user_fields]
    calls = [
        (lambda: TD.dlrm_forward(p, cfg, dense, sparse), ("sum", 1, f32, bf16)),
        (lambda: TD.item_tower(p, cfg, sparse[:, 13:]), ("mean", 13, f32, f32)),
        (lambda: TD.user_tower(p, cfg, dense, users), ("mean", 13, f32, bf16)),
        (lambda: TD.retrieval_scores(p, cfg, dense, users, p["table"][:5]),
         ("mean", 13, f32, bf16)),
        (lambda: TE.lookup_single(p["table"], np.zeros(26, np.int64), sparse,
                                  impl=impl), ("sum", 1, f32, f32)),
        (lambda: TE.lookup_multihot(p["table"], np.zeros(2, np.int64),
                                    sparse[:, :6].reshape(4, 2, 3),
                                    torch.ones((4, 2, 3), dtype=bool),
                                    mode="mean", impl=impl),
         ("mean", 3, f32, f32))]
    _, _, cfg2, p2 = _models("xdeepfm", "bfloat16")
    cfg2 = dataclasses.replace(cfg2, bag_impl=impl)
    s2 = _t(data.click_batch(np.random.default_rng(13), 4, n_dense=0,
                             vocab_sizes=cfg2.vocab_sizes)["sparse"])
    vecs, first = TF.item_vectors(p2, cfg2, s2[:, 5:])
    calls += [
        (lambda: TF.deepfm_forward(p2, cfg2, s2),
         [("sum", 1, f32, bf16), ("sum", 10, f32, f32)]),
        (lambda: TF.item_vectors(p2, cfg2, s2[:, 5:]),
         [("sum", 5, f32, f32)] * 2),
        (lambda: TF.retrieval_scores(p2, cfg2, s2[:, :5], vecs, first),
         [("sum", 5, f32, f32)] * 2)]
    for fn, want in calls:
        spy.calls.clear()
        fn()
        want = want if isinstance(want, list) else [want]
        assert spy.calls == (want if impl == "cuda" else []), fn
