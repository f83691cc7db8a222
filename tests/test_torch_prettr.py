"""The port's PreTTR path against the JAX package: ``encode_query``,
``precompute_docs``, ``join_and_score`` and ``rank_forward`` against the
JAX ``blocked`` backend's fused path on the same weights (bridged from
JAX) and the same numpy inputs, the soundness invariant inside the port,
and the backend's config-time and not-ported errors (the legacy concat
join is held against JAX in tests/test_torch_decode_legacy.py).

float32 compute and storage, so the tolerance is rtol = atol = 2e-5
(tests/test_kernels.py); the soundness invariant stores fp16 and holds to
5e-3, as tests/test_join_attention.py does."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prettr as JP
from repro_torch.bridge import params_from_jax
from repro_torch.core import prettr as TP
from repro_torch.models import backend as TB
from repro_torch.models.transformer import TransformerConfig

MAX_Q, MAX_D, BATCH = 8, 24, 3
GRID = [(0, 0, None), (2, 0, None), (2, 16, 2), (3, 0, 2)]
IMPLS = ["plain", "cuda"]
TOL = dict(rtol=2e-5, atol=2e-5)


def _configs(l, compress_dim, n_kv_heads, impl="cuda",
             store=(jnp.float32, torch.float32)):
    kw = dict(n_layers=4, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
              l=l, max_len=64, n_kv_heads=n_kv_heads)
    jcfg = JP.PreTTRConfig(
        backbone=JP.make_backbone(**kw, compute_dtype=jnp.float32,
                                  block_kv=16, attn_impl="blocked",
                                  compress_impl="plain"),
        l=l, max_query_len=MAX_Q, max_doc_len=MAX_D,
        compress_dim=compress_dim, store_dtype=store[0])
    tcfg = TP.PreTTRConfig(
        backbone=TP.make_backbone(**kw, compute_dtype=torch.float32,
                                  attn_impl=impl, compress_impl=impl),
        l=l, max_query_len=MAX_Q, max_doc_len=MAX_D,
        compress_dim=compress_dim, store_dtype=store[1])
    return jcfg, tcfg


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    q = rng.integers(5, 512, (BATCH, MAX_Q))
    d = rng.integers(5, 512, (BATCH, MAX_D))
    qv = np.arange(MAX_Q)[None] < rng.integers(3, MAX_Q + 1, (BATCH, 1))
    dv = np.arange(MAX_D)[None] < rng.integers(5, MAX_D + 1, (BATCH, 1))
    return q, d, qv, dv


def _joint(q, d, qv, dv):
    tokens = np.concatenate([q, d], axis=1)
    segs = np.concatenate([np.zeros_like(q), np.ones_like(d)], axis=1)
    return tokens, segs, np.concatenate([qv, dv], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_world(l, compress_dim, n_kv_heads):
    """JAX params (as numpy) and the JAX outputs on the shared inputs."""
    jcfg, _ = _configs(l, compress_dim, n_kv_heads)
    params, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    q, d, qv, dv = _inputs()

    @jax.jit
    def run(params, q, d, qv, dv, tokens, segs, valid):
        qr = JP.encode_query(params, jcfg, q, qv)
        store = JP.precompute_docs(params, jcfg, d, dv)
        return {"encode_query": qr, "precompute_docs": store,
                "join_and_score": JP.join_and_score(params, jcfg, qr, qv,
                                                    store, dv),
                "rank_forward": JP.rank_forward(params, jcfg, tokens, segs,
                                                valid)}

    out = run(params, q, d, qv, dv, *_joint(q, d, qv, dv))
    return (jax.tree.map(np.asarray, params),
            {k: np.asarray(v) for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def _bridged_outputs(l, compress_dim, n_kv_heads, impl):
    jparams, _ = _jax_world(l, compress_dim, n_kv_heads)
    _, tcfg = _configs(l, compress_dim, n_kv_heads, impl)
    return _torch_outputs(tcfg, params_from_jax(jparams, tcfg, device="cpu"))


def _torch_outputs(tcfg, params):
    q, d, qv, dv = (torch.from_numpy(a) for a in _inputs())
    qr = TP.encode_query(params, tcfg, q, qv)
    store = TP.precompute_docs(params, tcfg, d, dv)
    return {"encode_query": qr, "precompute_docs": store,
            "join_and_score": TP.join_and_score(params, tcfg, qr, qv, store,
                                                dv),
            "rank_forward": TP.rank_forward(
                params, tcfg, *(torch.from_numpy(a) for a in
                                _joint(*_inputs())))}


@pytest.mark.parametrize("fn", ["encode_query", "precompute_docs",
                                "join_and_score", "rank_forward"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("l,compress_dim,n_kv_heads", GRID)
def test_port_matches_jax_blocked(l, compress_dim, n_kv_heads, impl, fn):
    _, want = _jax_world(l, compress_dim, n_kv_heads)
    got = _bridged_outputs(l, compress_dim, n_kv_heads, impl)[fn]
    np.testing.assert_allclose(got.float().numpy(), want[fn], **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("l,compress_dim", [(2, 16), (1, 0), (3, 16)])
def test_soundness_invariant(impl, l, compress_dim):
    """rank_forward == join_and_score(encode_query, precompute_docs) up to
    the fp16 storage rounding (core/prettr.py:27-30), inside the port."""
    _, tcfg = _configs(l, compress_dim, None, impl,
                       store=(jnp.float16, torch.float16))
    params = TP.init_prettr(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = _torch_outputs(tcfg, params)
    np.testing.assert_allclose(out["join_and_score"].numpy(),
                               out["rank_forward"].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_init_prettr_has_the_bridged_tree():
    jparams, _ = _jax_world(2, 16, 2)
    _, tcfg = _configs(2, 16, 2)
    bridged = params_from_jax(jparams, tcfg, device="cpu")
    native = TP.init_prettr(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(bridged) == shapes(native)
    assert "lm_head" not in bridged["backbone"]


def test_unknown_impl_fails_at_config_time():
    with pytest.raises(ValueError, match="unknown attn_impl"):
        TransformerConfig(attn_impl="pallas")
    with pytest.raises(ValueError, match="unknown compress_impl"):
        TransformerConfig(compress_impl="blocked")


def _attn_args(b=2, s=6, h=2, d=16):
    t = torch.zeros((b, s, h, d))
    return t, dict(scale=0.25, q_valid=None, kq_valid=None, kd_valid=None)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("operand", ["kd_scale", "paged"])
def test_unported_join_operands_raise(impl, operand):
    """The int8 and paged doc operands are ported; malformed ones raise:
    a lone scale, or a paged segment beside dense K/V."""
    t, kw = _attn_args()
    kw[operand] = torch.ones((2, 6))
    with pytest.raises(ValueError, match="both|replaces"):
        TB.get_impl("join_attention", impl)(t, t, t, t, t,
                                            cfg=TransformerConfig(), **kw)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("causal,window", [(True, -1), (False, 16)])
def test_unported_masks_raise(impl, causal, window):
    """The causal and window masks raised until the LM slice ported them;
    now both impls apply them, as plain attention under
    ``attention_mask`` does."""
    from repro_torch.models import layers as TL
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 20, 2, 16), generator=g) for _ in range(3))
    cfg = TransformerConfig(causal=causal)
    valid = torch.ones((2, 20), dtype=torch.bool)
    valid[1, 15:] = False
    got = TB.get_impl("attention", impl)(
        q, k, v, cfg=cfg, scale=0.25, split_flag=False,
        segs=torch.zeros((2, 20), dtype=torch.long), valid=valid,
        window=window)
    pos = torch.arange(20).expand(2, 20)
    mask = TL.attention_mask(pos, pos, causal=causal, window=window,
                             k_valid=valid)
    want = TL.plain_attention(q, k, v, mask[:, None], scale=0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_join_and_score_rejects_unported_paths():
    _, tcfg = _configs(2, 0, None)
    params = TP.init_prettr(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    q, d, qv, dv = (torch.from_numpy(a) for a in _inputs())
    qr = TP.encode_query(params, tcfg, q, qv)
    store = TP.precompute_docs(params, tcfg, d, dv)
    with pytest.raises(ValueError, match="fused"):
        TP.join_and_score(params, tcfg, qr, qv, store, dv,
                          doc_kv=TP.precompute_doc_kv(params, tcfg, store),
                          fused=False)
    # the concat path is ported: it scores what the fused path scores
    np.testing.assert_allclose(
        TP.join_and_score(params, tcfg, qr, qv, store, dv,
                          fused=False).numpy(),
        TP.join_and_score(params, tcfg, qr, qv, store, dv).numpy(), **TOL)
    with pytest.raises(ValueError, match="split_layers"):
        dataclasses.replace(tcfg, l=1)
