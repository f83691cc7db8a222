"""The port's ``"blocked"`` attention family against the JAX package's
default one, on the CPU:

* ``models.layers.blocked_attention`` against
  ``repro.models.layers.blocked_attention``, forward and gradient
  (``jax.vjp`` against ``torch.autograd`` on a seeded cotangent): causal,
  window, split segments, ``k_valid``, GQA, Skv not a multiple of
  ``block_kv``, Sq != Skv, float32 and bf16, and a hypothesis sweep over
  seq / block / window / causal;
* the backend's ``"blocked"`` impls of ``attention``,
  ``decode_attention`` and ``join_attention`` (dense, int8 + scales,
  paged float and int8 pools, the Sq = 1 row) against JAX's;
* a 2-layer gemma3 smoke LM: ``forward`` and ``causal_lm_loss``'s
  gradient with ``attn_impl="blocked"`` against JAX's default;
* the ``"cuda"`` attention's backward (its kernel's plain version
  forward on these CPU tensors, the blocked version's gradient) forms no
  tensor whose last two dims are ``(S, S)``, where the plain impl's
  backward does; the backend family maps.

Inputs are made with numpy from a seed.  Tolerances follow the JAX
kernel tests (``tests/test_kernels.py:20-21``): rtol = atol = 2e-5 in
float32, 2e-2 in bf16."""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:             # pragma: no cover
    from _hypothesis_stub import given, settings, strategies as st

from repro.configs import gemma3_4b as JG
from repro.core import prettr as JP
from repro.models import backend as JB
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import gemma3_4b as TG
from repro_torch.core import prettr as TP
from repro_torch.models import backend as TB
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import leaves_with_paths

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """One numpy array as (JAX array, torch tensor) of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.array(a)).to(td)


# ---------------------------------------------------------------------------
# blocked_attention
# ---------------------------------------------------------------------------


# name -> (b, sq, skv, hq, hkv, d, block_kv, keywords, dtype); ``lengths``
# gives each row's valid keys, ``boundary`` the split segments' start of
# segment 1
CASES = {
    "causal": (2, 40, 40, 2, 2, 16, 16, dict(causal=True), "float32"),
    "window": (2, 40, 40, 2, 2, 16, 16, dict(causal=True, window=8),
               "float32"),
    "bidirectional_window": (2, 32, 32, 2, 2, 16, 8,
                             dict(causal=False, window=5), "float32"),
    "split": (2, 40, 40, 2, 2, 16, 16,
              dict(causal=False, boundary=12, lengths=(40, 31)), "float32"),
    "k_valid": (2, 40, 40, 2, 2, 16, 16,
                dict(causal=False, lengths=(40, 29)), "float32"),
    "gqa": (2, 40, 40, 4, 2, 16, 16, dict(causal=True), "float32"),
    "ragged_skv": (2, 37, 37, 4, 1, 16, 16,
                   dict(causal=False, lengths=(37, 20)), "float32"),
    "sq_ne_skv": (2, 12, 40, 4, 2, 16, 16, dict(causal=True, window=16),
                  "float32"),
    "bf16_gqa_causal": (2, 40, 40, 4, 2, 32, 16, dict(causal=True),
                        "bfloat16"),
    "bf16_split": (2, 40, 40, 2, 2, 32, 16,
                   dict(causal=False, boundary=12, lengths=(40, 33)),
                   "bfloat16"),
}


def _case_inputs(seed, b, sq, skv, hq, hkv, d, *, causal, window=-1,
                 boundary=None, lengths=None):
    """numpy q / k / v / cotangent and the keywords both packages take."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d), np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, sq, hq, d), np.float32)
    k_pos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv))
    q_pos = np.ascontiguousarray(k_pos[:, skv - sq:])   # the last sq keys
    kw = dict(q_pos=q_pos, k_pos=k_pos, causal=causal, window=window)
    if boundary is not None:
        kw.update(q_seg=(q_pos >= boundary).astype(np.int32),
                  k_seg=(k_pos >= boundary).astype(np.int32),
                  split_segments=True)
    if lengths is not None:
        kw["k_valid"] = np.arange(skv)[None] < np.asarray(lengths)[:, None]
    return (q, k, v, g), kw


def _both_blocked(arrays, kw, dtype, block_kv, scale):
    """Forward and (dq, dk, dv) of both packages' blocked_attention."""
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_pair(a, dtype)
                                              for a in arrays)
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
               else a) for n, a in kw.items()}
    fn = lambda q, k, v: JL.blocked_attention(
        q, k, v, scale=scale, block_kv=block_kv, **jkw)
    want, want_g = jax.jit(lambda q, k, v, g: (
        fn(q, k, v), jax.vjp(fn, q, k, v)[1](g)))(jq, jk, jv, jg)
    xs = [t.requires_grad_() for t in (tq, tk, tv)]
    got = TL.blocked_attention(*xs, scale=scale, block_kv=block_kv, **tkw)
    got_g = torch.autograd.grad(got, xs, tg)
    return (got, *got_g), (want, *want_g)


@pytest.mark.parametrize("name", list(CASES))
def test_blocked_attention_forward_and_grad_match_jax(name):
    b, sq, skv, hq, hkv, d, block_kv, kw, dtype = CASES[name]
    arrays, kw = _case_inputs(7, b, sq, skv, hq, hkv, d, **kw)
    got, want = _both_blocked(arrays, kw, dtype, block_kv, d ** -0.5)
    assert got[0].dtype == DTYPES[dtype][1] and got[0].shape == (b, sq, hq, d)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), err_msg=what,
                                   **TOL[dtype])


@settings(max_examples=8, deadline=None)
@given(seq=st.sampled_from([16, 24, 40]), block=st.sampled_from([8, 16]),
       window=st.sampled_from([-1, 4]), causal=st.booleans(),
       seed=st.integers(0, 1000))
def test_property_blocked_attention_matches_jax(seq, block, window, causal,
                                                seed):
    arrays, kw = _case_inputs(seed, 2, seq, seq, 4, 2, 16, causal=causal,
                              window=window, lengths=(seq, seq - 3))
    got, want = _both_blocked(arrays, kw, "float32", block, 0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])


def test_blocked_attention_equals_plain_attention():
    """The online softmax over blocks is the plain softmax: the port's
    blocked version within float32 rounding of its plain one, forward and
    gradient, GQA, window and ragged keys.  Every query row sees a valid
    key: a row with none is uniform over its keys, and the blocked
    version counts the padding among them, as JAX's does."""
    arrays, kw = _case_inputs(3, 2, 37, 37, 4, 2, 16, causal=True, window=9,
                              lengths=(37, 30))
    q, k, v, g = (torch.from_numpy(a).requires_grad_() for a in arrays)
    t = {n: torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
         else a for n, a in kw.items()}
    got = TL.blocked_attention(q, k, v, scale=0.25, block_kv=8, **t)
    mask = TL.attention_mask(t["q_pos"], t["k_pos"], causal=True, window=9,
                             k_valid=t["k_valid"])
    want = TL.plain_attention(q, k, v, mask[:, None], scale=0.25)
    for a, b in zip((got, *torch.autograd.grad(got, (q, k, v), g)),
                    (want, *torch.autograd.grad(want, (q, k, v), g))):
        np.testing.assert_allclose(_np(a), _np(b), **TOL["float32"])


# ---------------------------------------------------------------------------
# The backend's "blocked" impls
# ---------------------------------------------------------------------------


def _cfgs(causal=True, block_kv=16):
    """The fields the impls read, for each package."""
    return (types.SimpleNamespace(causal=causal, block_kv=block_kv,
                                  compute_dtype=jnp.float32),
            types.SimpleNamespace(causal=causal, block_kv=block_kv,
                                  compute_dtype=torch.float32))


@pytest.mark.parametrize("causal,window,split", [
    (True, -1, False), (True, 8, False), (False, -1, True)])
def test_attention_impl_matches_jax(causal, window, split):
    b, s, hq, hkv, d = 2, 40, 4, 2, 16
    (q, k, v, _), _ = _case_inputs(11, b, s, s, hq, hkv, d, causal=causal)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    segs = (pos >= 12).astype(np.int32)
    valid = np.arange(s)[None] < np.asarray([[s], [s - 7]])
    jcfg, tcfg = _cfgs(causal)
    want = JB.get_impl("attention", "blocked")(
        *(jnp.asarray(a) for a in (q, k, v)), cfg=jcfg, scale=d ** -0.5,
        positions=jnp.asarray(pos), window=window, split_flag=split,
        segs=jnp.asarray(segs), valid=jnp.asarray(valid))
    t = lambda a: torch.from_numpy(np.array(a))
    got = TB.get_impl("attention", "blocked")(
        t(q), t(k), t(v), cfg=tcfg, scale=d ** -0.5, split_flag=split,
        segs=t(segs), valid=t(valid), window=window, positions=t(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_decode_impl_matches_jax():
    b, s, hq, hkv, d = 2, 40, 4, 2, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, 1, hq, d), np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d), np.float32)
            for _ in range(2))
    k_pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    q_pos = np.asarray([[30], [39]], np.int32)
    valid = np.arange(s)[None] < np.asarray([[s], [s - 4]])
    kw = dict(scale=d ** -0.5, window=8)
    jcfg, tcfg = _cfgs()
    want = JB.get_impl("decode_attention", "blocked")(
        *(jnp.asarray(a) for a in (q, k, v)), cfg=jcfg,
        q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
        k_valid=jnp.asarray(valid), **kw)
    t = lambda a: torch.from_numpy(np.array(a))
    got = TB.get_impl("decode_attention", "blocked")(
        t(q), t(k), t(v), cfg=tcfg, q_pos=t(q_pos), k_pos=t(k_pos),
        k_valid=t(valid), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def _join_operands(rng, b, sq, lq, ld, hq, hkv, d, form, page=8):
    """numpy join operands and their doc-segment keywords: ``form`` one of
    dense, int8 (raw int8 kd / vd + per-token scales), paged or
    paged_int8 (pools of ``page`` tokens through a page table)."""
    q = rng.standard_normal((b, sq, hq, d), np.float32)
    kq, vq = (rng.standard_normal((b, lq, hkv, d), np.float32)
              for _ in range(2))
    kq_valid = np.arange(lq)[None] < np.asarray([[lq], [lq - 3]])
    kd_valid = np.arange(ld)[None] < np.asarray([[ld], [ld - 9]])
    q_valid = np.arange(sq)[None] < np.asarray([[sq], [max(sq - 2, 1)]])
    kw = dict(q_valid=q_valid, kq_valid=kq_valid, kd_valid=kd_valid)
    int8 = form in ("int8", "paged_int8")
    if form in ("dense", "int8"):
        if int8:
            kd, vd = (rng.integers(-127, 128, (b, ld, hkv, d))
                      .astype(np.int8) for _ in range(2))
            kw.update(kd_scale=rng.uniform(1e-3, 0.05, (b, ld))
                      .astype(np.float32),
                      vd_scale=rng.uniform(1e-3, 0.05, (b, ld))
                      .astype(np.float32))
        else:
            kd, vd = (rng.standard_normal((b, ld, hkv, d), np.float32)
                      for _ in range(2))
        return (q, kq, vq, kd, vd), kw, None
    n_pages = -(-ld // page)
    n_pool = 1 + b * n_pages
    if int8:
        pools = [rng.integers(-127, 128, (n_pool, page, hkv, d))
                 .astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(1e-3, 0.05, (n_pool, page, 1))
                  .astype(np.float32) for _ in range(2)]
    else:
        pools = [rng.standard_normal((n_pool, page, hkv, d), np.float32)
                 for _ in range(2)]
        scales = [None, None]
    table = (1 + rng.permutation(n_pool - 1)).reshape(b, n_pages) \
        .astype(np.int32)
    paged = dict(k=pools[0], v=pools[1],
                 valid=np.ones((n_pool, page), np.int32), page_table=table,
                 k_scale=scales[0], v_scale=scales[1])
    return (q, kq, vq, None, None), kw, paged


@pytest.mark.parametrize("form", ["dense", "int8", "paged", "paged_int8"])
@pytest.mark.parametrize("sq", [24, 1])
def test_join_impl_matches_jax(form, sq):
    """Sq = 24 runs the blocked core over 16 + 36 keys (block 16, padded);
    Sq = 1 the decode row; the doc segment dense, raw int8 with scales,
    or paged over float or int8 pools."""
    b, lq, ld, hq, hkv, d = 2, 16, 36, 4, 2, 16
    arrays, kw, paged = _join_operands(np.random.default_rng(9), b, sq, lq,
                                       ld, hq, hkv, d, form)
    jcfg, tcfg = _cfgs(causal=False)
    opt = lambda f, a: None if a is None else f(np.array(a))
    jarr = [opt(jnp.asarray, a) for a in arrays]
    tarr = [opt(torch.from_numpy, a) for a in arrays]
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    tkw = {n: torch.from_numpy(np.array(a)) for n, a in kw.items()}
    if paged is not None:
        jkw["paged"] = JP.PagedDocKV(**{n: opt(jnp.asarray, a)
                                        for n, a in paged.items()})
        tkw["paged"] = TP.PagedDocKV(**{n: opt(torch.from_numpy, a)
                                        for n, a in paged.items()})
    want = JB.get_impl("join_attention", "blocked")(
        *jarr, cfg=jcfg, scale=d ** -0.5, **jkw)
    got = TB.get_impl("join_attention", "blocked")(
        *tarr, cfg=tcfg, scale=d ** -0.5, **tkw)
    assert got.shape == (b, sq, hq, d)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_blocked_family_maps_and_validates():
    """``"blocked"`` is a family of the port: its compressor is the plain
    one (there is no blocked compressor, as in JAX), every attention kind
    has its impl, and ``compress_impl="blocked"`` stays refused."""
    assert TB.impls_for("blocked") == JB.impls_for("blocked") \
        == ("blocked", "plain")
    for kind in ("attention", "decode_attention", "join_attention"):
        assert "blocked" in TB.available(kind)
    for kind in ("compress", "decompress"):
        assert "blocked" not in TB.available(kind)
    cfg = TT.TransformerConfig(attn_impl="blocked", compress_impl="plain")
    assert TB.apply_backend(cfg, "cuda").attn_impl == "cuda"
    with pytest.raises(ValueError, match="compress_impl"):
        TT.TransformerConfig(compress_impl="blocked")


# ---------------------------------------------------------------------------
# A 2-layer LM
# ---------------------------------------------------------------------------


def _lm_world():
    """gemma3's smoke config cut to one local (window 8) and one global
    layer, block_kv 16; JAX's default impl, the port's "blocked"."""
    cut = dict(n_layers=2, window_pattern=(1, -1), logits_chunk=16)
    jcfg = dataclasses.replace(JG.smoke_config(), **cut)
    tcfg = dataclasses.replace(TG.smoke_config(attn_impl="blocked"), **cut)
    assert jcfg.attn_impl == "blocked" and jcfg.block_kv == tcfg.block_kv
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              tcfg, device="cpu")


def test_lm_forward_and_loss_gradient_match_jax_default():
    jcfg, tcfg, jp, tp = _lm_world()
    toks = np.random.default_rng(1).integers(4, tcfg.vocab_size, (2, 41))
    h_j, _, _ = jax.jit(JT.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks[:, :-1]))
    h_t, _, _ = TT.forward(tp, tcfg, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(_np(h_t), _np(h_j), **TOL["float32"])

    want, jg = jax.jit(jax.value_and_grad(lambda p: JT.causal_lm_loss(
        p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))))(jp)
    leaves = [t.requires_grad_() for _, t in leaves_with_paths(tp)]
    got = TT.causal_lm_loss(tp, tcfg, torch.from_numpy(toks[:, :-1]),
                            torch.from_numpy(toks[:, 1:]))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               **TOL["float32"])
    want_g = dict(leaves_with_paths(lm_params_from_jax(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu")))
    got_g = dict(zip((k for k, _ in leaves_with_paths(tp)), grads))
    assert sorted(got_g) == sorted(want_g)
    for k in got_g:
        np.testing.assert_allclose(_np(got_g[k]), _np(want_g[k]), err_msg=k,
                                   **TOL["float32"])


# ---------------------------------------------------------------------------
# The "cuda" attention's gradient forms no [S, S] tensor
# ---------------------------------------------------------------------------


class _OutputShapes(TorchDispatchMode):
    """The shape of every tensor an op returns while the mode is on."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("impl", ["cuda", "plain"])
def test_cuda_attention_backward_forms_no_square_scores(impl):
    """S = 64, block_kv 16, causal, GQA 4/2: the backward of the "cuda"
    op (the blocked gradient) records ``[B, H, S, 16]`` block scores and
    no ``(S, S)`` tensor; the plain impl's backward, the control, does
    record one.  Its gradient equals the plain one's within float32
    rounding."""
    b, s, hq, hkv, d = 2, 64, 4, 2, 16
    (q, k, v, g), _ = _case_inputs(13, b, s, s, hq, hkv, d, causal=True)
    cfg = types.SimpleNamespace(causal=True, block_kv=16)
    valid = torch.arange(s)[None] < torch.tensor([[s], [s - 10]])

    def grads(name):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = TB.get_impl("attention", name)(
            *xs, cfg=cfg, scale=d ** -0.5, split_flag=False, segs=None,
            valid=valid)
        with _OutputShapes() as rec:
            gs = torch.autograd.grad(out, xs, torch.from_numpy(g))
        return gs, rec.shapes

    got, shapes = grads(impl)
    square = [sh for sh in shapes if sh[-2:] == (s, s)]
    if impl == "plain":
        assert square                       # the detector sees them
        return
    assert not square, square
    assert (b, hq, s, 16) in shapes
    for a, w in zip(got, grads("plain")[0]):
        np.testing.assert_allclose(_np(a), _np(w), **TOL["float32"])
