"""The kernel impl's refusal of a layer range whose split flags differ.

The split-attention kernel takes the PreTTR split mask as one static
``seg_boundary``; it cannot mask by per-token segment ids.  So
``transformer._run_layers`` on ``attn_impl="cuda"`` refuses a range that
mixes split and unsplit layers before any layer runs, as the JAX
``pallas`` impl refuses it (src/repro/models/transformer.py), while
uniform ranges, mixed windows (gemma3's pattern) and the plain impl run.
Before this check the kernel impl dropped the split mask of such a
range without a word.  On the CPU the kernel wrappers run their plain
versions, so a range the kernel impl accepts is checked against the
plain impl here."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_jax
from repro_torch.models import transformer as T

B, S = 2, 12


def _cfgs(split_layers=1, n_layers=3, window_pattern=(-1,)):
    kw = dict(n_layers=n_layers, d_model=32, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab_size=64, causal=False, rope=False,
              learned_pos=S, segment_vocab=2, norm="layernorm",
              gated_mlp=False, activation="gelu", qkv_bias=True,
              tie_embeddings=True, split_layers=split_layers,
              window_pattern=window_pattern, window_size=4)
    return (JT.TransformerConfig(**kw, compute_dtype=jnp.float32,
                                 attn_impl="pallas"),
            T.TransformerConfig(**kw, compute_dtype=torch.float32,
                                attn_impl="cuda"))


def _inputs():
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, 64, (B, S))
    segs = (rng.random((B, S)) < 0.5).astype(np.int64)   # any position
    valid = np.ones((B, S), bool)
    valid[1, -3:] = False
    return tokens, segs, valid


def _params(jcfg, tcfg):
    params, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return params, lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")


@pytest.mark.parametrize("lo,hi", [(0, 3), (0, 2), (1, 3)])
def test_mixed_split_range_refused_like_pallas(lo, hi, monkeypatch):
    jcfg, tcfg = _cfgs(split_layers=2 if hi == 3 and lo == 1 else 1)
    jparams, tparams = _params(jcfg, tcfg)
    tokens, segs, valid = _inputs()
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    x = T.embed(tparams, tcfg, torch.from_numpy(tokens),
                torch.from_numpy(pos), torch.from_numpy(segs))

    def no_layer(*args, **kw):
        raise AssertionError("a layer ran before the refusal")

    monkeypatch.setattr(T, "_layer_step", no_layer)
    with pytest.raises(ValueError) as got:
        T.run_layer_range(tparams, tcfg, x, lo, hi,
                          segs=torch.from_numpy(segs),
                          valid=torch.from_numpy(valid))
    jx = JT.embed(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                  jnp.asarray(segs))
    with pytest.raises(ValueError) as want:
        JT.run_layer_range(jparams, jcfg, jx, lo, hi,
                           positions=jnp.asarray(pos),
                           segs=jnp.asarray(segs), valid=jnp.asarray(valid))
    flags = [i < tcfg.split_layers for i in range(lo, hi)]
    for err, impl in ((got, "cuda"), (want, "pallas")):
        msg = str(err.value)
        assert f"attn_impl='{impl}' requires a uniform" in msg
        assert f"layers [{lo}, {hi})" in msg and f"splits={flags}" in msg


def test_forward_refuses_on_cuda_and_runs_on_plain():
    jcfg, tcfg = _cfgs()
    _, tparams = _params(jcfg, tcfg)
    tokens, segs, valid = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="uniform split-flag"):
        T.forward(tparams, tcfg, tokens, segs=segs, valid=valid)
    plain = dataclasses.replace(tcfg, attn_impl="plain")
    hidden, _, _ = T.forward(tparams, plain, tokens, segs=segs, valid=valid)
    assert torch.isfinite(hidden).all()


@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 3)])
def test_uniform_split_ranges_run_on_cuda_as_on_plain(lo, hi):
    """PreTTR's ranges: 0..l (all split, one segment here, so the kernel's
    seg_boundary=-1 is exact) and l..n (none split)."""
    jcfg, tcfg = _cfgs()
    _, tparams = _params(jcfg, tcfg)
    tokens, _, valid = (torch.from_numpy(a) for a in _inputs())
    segs = torch.ones((B, S), dtype=torch.long)
    pos = torch.arange(S).expand(B, S)
    x = T.embed(tparams, tcfg, tokens, pos, segs)
    got = T.run_layer_range(tparams, tcfg, x, lo, hi, segs=segs, valid=valid)
    want = T.run_layer_range(tparams, dataclasses.replace(
        tcfg, attn_impl="plain"), x, lo, hi, segs=segs, valid=valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_mixed_windows_still_run_on_cuda():
    """Only split flags are refused: each layer passes its own window, so
    a gemma3-style window mix runs through the kernel impl."""
    jcfg, tcfg = _cfgs(split_layers=0, window_pattern=(4, 4, -1))
    _, tparams = _params(jcfg, tcfg)
    tokens, segs, valid = (torch.from_numpy(a) for a in _inputs())
    got, _, _ = T.forward(tparams, tcfg, tokens, segs=segs, valid=valid)
    want, _, _ = T.forward(tparams, dataclasses.replace(
        tcfg, attn_impl="plain"), tokens, segs=segs, valid=valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
