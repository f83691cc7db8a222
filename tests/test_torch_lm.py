"""The port's transformer LM path against the JAX package, on
``gemma3_4b.smoke_config()`` (6 layers, d 64, GQA 4/2, head dim 16,
window 8, 5 local : 1 global): the LM layers (RMSNorm, RoPE, masks, the
gated MLP), ``forward``, ``decode_step`` and ``logits``, the weight
bridge, and the split-attention plain version's causal, window and int8
forms against JAX's reference and Pallas kernel (interpret mode).

Weights come from JAX ``init_params`` (norm scales perturbed so that
``1 + scale`` is exercised) through ``lm_params_from_jax``; inputs are
made with numpy from a seed.  Tolerances follow the JAX tests:
rtol = atol = 2e-5 for float32 attention and hidden states
(``tests/test_kernels.py``, ``tests/test_models.py``), 2e-4 for logits
(``tests/test_models.py``), 2e-2 in bfloat16."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import gemma3_4b as JG
from repro.kernels.split_attention import split_attention_ref as jax_ref
from repro.kernels.split_attention import split_flash_attention as jax_split
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import gemma3_4b as TG
from repro_torch.kernels.split_attention import (split_attention_ref,
                                                 split_flash_attention)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
IMPLS = ("plain", "cuda")             # "cuda" takes the plain kernels on CPU


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_apply_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3
    scale, bias = (rng.standard_normal(64, np.float32) for _ in range(2))
    np.testing.assert_allclose(_np(TL.rms_norm(_t(x), _t(scale))),
                               _np(JL.rms_norm(x, scale)), **TOL)
    for kind in ("rmsnorm", "layernorm"):
        p = {"scale": scale, "bias": bias}
        np.testing.assert_allclose(
            _np(TL.apply_norm({k: _t(v) for k, v in p.items()}, _t(x),
                              kind)),
            _np(JL.apply_norm(p, x, kind)), **TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("base", [1e4, 1e6])
def test_rope_matches_jax(fraction, base):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16), np.float32)
    pos = np.stack([np.arange(40), 1000 + np.arange(40)]).astype(np.int32)
    got = TL.rope(_t(x), _t(pos), base=base, fraction=fraction)
    want = JL.rope(x, pos, base=base, fraction=fraction)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("causal,window,split", [
    (True, -1, False), (True, 8, False), (False, 8, False),
    (False, -1, True), (True, 4, True)])
def test_attention_mask_matches_jax(causal, window, split):
    rng = np.random.default_rng(2)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    seg = (np.arange(24)[None] >= 10).astype(np.int32).repeat(2, 0)
    qv, kv = (rng.random((2, 24)) < 0.8 for _ in range(2))
    got = TL.attention_mask(_t(pos), _t(pos), causal=causal, window=window,
                            q_seg=_t(seg), k_seg=_t(seg),
                            split_segments=split, q_valid=_t(qv),
                            k_valid=_t(kv))
    want = JL.attention_mask(pos, pos, causal=causal, window=window,
                             q_seg=seg, k_seg=seg, split_segments=split,
                             q_valid=qv, k_valid=kv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gated,bias", [(True, False), (False, True),
                                        (False, False)])
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu"])
def test_mlp_matches_jax(gated, bias, activation):
    jp, _ = JL.init_mlp(jax.random.PRNGKey(3), 32, 48, gated=gated,
                        dtype=jnp.float32, bias=bias)
    rng = np.random.default_rng(3)
    jp = {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)
                              .astype(np.float32) if k.startswith("b_")
                              else 0) for k, v in jp.items()}
    x = rng.standard_normal((4, 7, 32), np.float32)
    got = TL.mlp({k: _t(v) for k, v in jp.items()}, _t(x), gated=gated,
                 activation=activation)
    want = JL.mlp(jp, x, gated=gated, activation=activation)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _configs(**kw):
    return dataclasses.replace(JG.smoke_config(), **kw), \
        dataclasses.replace(TG.smoke_config(), **kw)


def _jax_params(jcfg, seed=0):
    """JAX init_params with every norm scale perturbed (they start at 0,
    which would hide the ``1 + scale``), as numpy leaves."""
    params, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "norm" in name or "scale" in name:
            a = a + 0.2 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _world(seed=0, **kw):
    jcfg, tcfg = _configs(**kw)
    jp = _jax_params(jcfg, seed)
    return jcfg, tcfg, jp, lm_params_from_jax(jp, tcfg, device="cpu")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("jax_impl", ["plain", "blocked"])
def test_forward_matches_jax(jax_impl, impl):
    """24 tokens: the local layers' 8-key window bites; the collected K/V
    and the last position's logits too."""
    jcfg, tcfg, jp, tp = _world()
    toks = _tokens(2, 24, jcfg.vocab_size)
    jcfg = dataclasses.replace(jcfg, attn_impl=jax_impl)
    h_j, kv_j, _ = jax.jit(JT.forward, static_argnums=1,
                           static_argnames="collect_cache")(
        jp, jcfg, toks, collect_cache=True)
    h_t, kv_t, aux = TT.forward(tp, dataclasses.replace(tcfg, attn_impl=impl),
                                _t(toks).long(), collect_cache=True)
    np.testing.assert_allclose(_np(h_t), _np(h_j), **TOL)
    for a, b in zip(kv_t, kv_j):
        assert tuple(a.shape) == b.shape == (6, 2, 24, 2, 16)
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    assert float(aux) == 0.0
    np.testing.assert_allclose(
        _np(TT.logits(tp, tcfg, h_t[:, -1:])),
        _np(JT.logits(jp, jcfg, h_j[:, -1:])), **LOGIT_TOL)


def test_dense_layers_build_no_aux_tensor():
    """A dense block's aux is the Python 0.0, so the layer loop (decode
    and the PreTTR ranges run it too) launches nothing for a loss it does
    not have; ``forward`` still returns a float32 scalar."""
    _, tcfg, _, tp = _world()
    toks = _t(_tokens(2, 8, tcfg.vocab_size)).long()
    pos = torch.arange(8).expand(2, 8)
    _, _, aux = TT._run_layers(tp, tcfg, TT.embed(tp, tcfg, toks, pos, None),
                               0, tcfg.n_layers, positions=pos)
    assert aux == 0.0 and not torch.is_tensor(aux)
    _, _, aux = TT.forward(tp, tcfg, toks)
    assert aux.dtype == torch.float32 and aux.shape == () and aux == 0


def _jax_decode(jp, jcfg, toks, steps, max_len):
    """JAX prefill over ``toks`` then teacher-forced decode of ``steps``
    ([B, n]); returns each step's logits."""
    _, kv, _ = JT.forward(jp, jcfg, toks, collect_cache=True)
    ck, cv = JT.init_decode_cache(jcfg, toks.shape[0], max_len,
                                  dtype=jnp.float32)
    s = toks.shape[1]
    cache = (ck.at[:, :, :s].set(kv[0]), cv.at[:, :, :s].set(kv[1]))
    step = jax.jit(JT.decode_step, static_argnums=1)
    out = []
    for i in range(steps.shape[1]):
        lg, cache = step(jp, jcfg, steps[:, i:i + 1], cache, s + i)
        out.append(np.asarray(lg))
    return out


def _torch_decode(tp, tcfg, toks, steps, max_len):
    _, kv, _ = TT.forward(tp, tcfg, toks, collect_cache=True)
    cache = TT.init_decode_cache(tcfg, toks.shape[0], max_len,
                                 dtype=torch.float32, device="cpu")
    s = toks.shape[1]
    cache[0][:, :, :s] = kv[0]
    cache[1][:, :, :s] = kv[1]
    out = []
    for i in range(steps.shape[1]):
        lg, cache = TT.decode_step(tp, tcfg, steps[:, i:i + 1], cache, s + i)
        out.append(lg)
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_jax(impl):
    """Prefill of 16, then 4 teacher-forced steps past the 8-key window."""
    jcfg, tcfg, jp, tp = _world(seed=2)
    toks = _tokens(2, 20, jcfg.vocab_size, seed=3)
    want = _jax_decode(jp, dataclasses.replace(jcfg, attn_impl="plain"),
                       toks[:, :16], toks[:, 16:], 24)
    got = _torch_decode(tp, dataclasses.replace(tcfg, attn_impl=impl),
                        _t(toks[:, :16]).long(), _t(toks[:, 16:]).long(), 24)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 1, 512) \
            and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), w, **LOGIT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_matches_forward(impl):
    """The port's own invariant (tests/test_models.py's): prefill + decode
    reproduces the full forward's logits at every decoded position."""
    _, tcfg, _, tp = _world(seed=4)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    toks = _t(_tokens(2, 21, tcfg.vocab_size, seed=5)).long()
    got = _torch_decode(tp, tcfg, toks[:, :16], toks[:, 16:], 24)
    h, _, _ = TT.forward(tp, tcfg, toks)
    full = TT.logits(tp, tcfg, h)
    for i, g in enumerate(got):
        np.testing.assert_allclose(_np(g[:, 0]), _np(full[:, 16 + i]),
                                   **LOGIT_TOL)


def test_decode_writes_the_cache_in_place():
    _, tcfg, _, tp = _world(seed=6)
    cache = TT.init_decode_cache(tcfg, 2, 8, device="cpu")
    before = cache[0].clone()
    _, out = TT.decode_step(tp, tcfg, torch.tensor([[3], [4]]), cache, 0)
    assert out[0] is cache[0] and out[1] is cache[1]
    assert not torch.equal(cache[0][:, :, 0], before[:, :, 0])
    assert torch.equal(cache[0][:, :, 1:], before[:, :, 1:])


@pytest.mark.parametrize("lo,hi", [(0, 5), (5, 6)])
def test_uniform_layer_ranges_match_jax_pallas(lo, hi):
    """The kernel forms against the JAX Pallas kernel over the ranges
    its pallas impl takes: the local layers [0, 5) and the global [5, 6)."""
    jcfg, tcfg, jp, tp = _world(seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    want, _ = JT.run_layer_range(
        jp, dataclasses.replace(jcfg, attn_impl="pallas"), jnp.asarray(x),
        lo, hi, positions=jnp.asarray(pos))
    got = TT.run_layer_range(tp, tcfg, _t(x), lo, hi,
                             positions=_t(pos).long())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("tie", [True, False])
def test_bridge_and_init_match_the_jax_tree(tie):
    jcfg, tcfg, jp, tp = _world(tie_embeddings=tie)
    native = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = lambda layer: {k: (tuple(v.shape) if not isinstance(v, dict)
                                else shapes(v)) for k, v in layer.items()}
    assert shapes(native["layers"][0]) == shapes(tp["layers"][0])
    assert {k for k in native if k != "layers"} \
        == {k for k in tp if k != "layers"} \
        == ({"embed", "final_norm"} | (set() if tie else {"lm_head"}))
    assert len(native["layers"]) == len(tp["layers"]) == 6
    h = _t(np.random.default_rng(9).standard_normal((2, 3, 64))
           .astype(np.float32))
    np.testing.assert_allclose(_np(TT.logits(tp, tcfg, h)),
                               _np(JT.logits(jp, jcfg, h.numpy())),
                               **LOGIT_TOL)


def test_config_matches_jax():
    for jcfg, tcfg in ((JG.full_config(), TG.full_config()),
                       (JG.smoke_config(), TG.smoke_config())):
        assert tcfg.layer_windows() == jcfg.layer_windows()
        assert tcfg.layer_rope_bases() == jcfg.layer_rope_bases()
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.num_active_params() == jcfg.num_active_params()
        for f in dataclasses.fields(tcfg):
            if hasattr(jcfg, f.name) and "dtype" not in f.name \
                    and f.name not in ("attn_impl", "compress_impl"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    # MoE configs construct (the MoE FFN is ported: test_torch_moe.py)
    moe = dataclasses.replace(TG.smoke_config(), n_experts=4, top_k=2)
    assert (moe.n_experts, moe.capacity_factor) == (4, 1.25)


def test_scale_embeddings_rounds_sqrt_d_to_the_compute_dtype():
    cfg = dataclasses.replace(TG.smoke_config(), d_model=2560,
                              compute_dtype=torch.bfloat16)
    params = {"embed": {"tokens": torch.ones((4, 2560))}}
    x = TT.embed(params, cfg, torch.tensor([[1]]), None, None)
    assert float(x[0, 0, 0]) == 50.5        # sqrt(2560) = 50.596 in bf16


# ---------------------------------------------------------------------------
# The split-attention plain version: causal, window and int8 forms
# ---------------------------------------------------------------------------

# tests/test_kernels.py's causal / window grid, plus D = 256 (gemma3)
SPLIT_LM = [
    (2, 4, 2, 64, 32, True, -1),      # causal
    (1, 4, 4, 96, 64, True, 16),      # sliding window
    (1, 8, 8, 48, 128, True, 8),      # window + causal, d=128
    (2, 2, 2, 40, 32, False, 8),      # window, bidirectional
    (1, 8, 4, 40, 256, True, 16),     # gemma3's head dim, GQA 8/4
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", SPLIT_LM)
def test_split_attention_masks_match_jax(b, hq, hkv, s, d, causal, window,
                                         dtype):
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((b, h, s, d), np.float32)
               for h in (hq, hkv, hkv))
    lengths = np.asarray([s, s - 10][:b], np.int32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(tdt) for a in (q, k, v))
    kw = dict(causal=causal, window=window)
    got = split_flash_attention(tq, tk, tv, _t(lengths), **kw)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(
        _np(got), _np(jax_ref(jq, jk, jv, jnp.asarray(lengths), **kw)),
        **tol)
    # the Pallas kernel skips the tiles of a row that sees no key (here
    # rows past lengths + window - 1 of the bidirectional window), so it
    # differs from both references there, by design (ROADMAP Queue 3)
    pos = np.arange(s)
    key_ok = pos[None, None, :] < lengths[:, None, None]  # [B, Sq, Skv]
    if causal:
        key_ok = key_ok & (pos[None, :] <= pos[:, None])
    if window > 0:
        key_ok = key_ok & (pos[:, None] - pos[None, :] < window)
    sees = key_ok.any(-1)                                    # [B, Sq]
    assert sees.mean() > 0.9
    np.testing.assert_allclose(
        _np(got).transpose(0, 2, 1, 3)[sees],
        _np(jax_split(jq, jk, jv, jnp.asarray(lengths), block_q=16,
                      block_k=16, interpret=True, **kw))
        .transpose(0, 2, 1, 3)[sees], **tol)


@pytest.mark.parametrize("causal,window,boundary", [
    (False, -1, -1), (False, -1, 24), (True, -1, -1), (True, 8, -1)])
@pytest.mark.parametrize("d", [32, 256])
def test_split_attention_int8_matches_jax(causal, window, boundary, d):
    """Raw int8 K/V with per-token scales (dequantise, then attend),
    against JAX's reference and its kernel's fused dequant."""
    rng = np.random.default_rng(11)
    b, hq, hkv, s = 2, 4, 2, 48
    q = rng.standard_normal((b, hq, s, d), np.float32)
    k8, v8 = (rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 0.05, (b, s)).astype(np.float32)
              for _ in range(2))
    valid = np.arange(s)[None] < np.asarray([[s], [s - 7]])
    valid[:, 1] = False
    kw = dict(causal=causal, window=window, seg_boundary=boundary)
    got = split_flash_attention(_t(q), _t(k8), _t(v8), None, _t(valid),
                                _t(ks), _t(vs), **kw)
    lengths = jnp.asarray([s, s - 7], jnp.int32)
    j = [jnp.asarray(a) for a in (q, k8, v8)]
    np.testing.assert_allclose(
        _np(got), _np(jax_ref(*j, lengths, jnp.asarray(valid),
                              jnp.asarray(ks), jnp.asarray(vs), **kw)), **TOL)
    np.testing.assert_allclose(
        _np(got), _np(jax_split(*j, None, jnp.asarray(valid),
                                jnp.asarray(ks), jnp.asarray(vs),
                                block_q=16, block_k=16, interpret=True,
                                **kw)), **TOL)
    # the plain version's own rule: dequantise, then the float form
    deq = [_t(a.astype(np.float32) * sc[:, None, :, None])
           for a, sc in ((k8, ks), (v8, vs))]
    np.testing.assert_allclose(
        _np(got), _np(split_attention_ref(_t(q), *deq, _t(lengths), _t(valid),
                                          **kw)), **TOL)
    with pytest.raises(ValueError, match="both"):
        split_flash_attention(_t(q), _t(k8), _t(v8), None, None, _t(ks))
