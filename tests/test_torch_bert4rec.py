"""The port's BERT4Rec (``repro_torch.models.recsys.bert4rec``) against the
JAX package's at its smoke config (``configs.bert4rec.smoke_config``):
``forward_hidden``, ``serve_scores``, ``serve_topk`` (values; ids where
the values are apart), ``cloze_loss`` and its gradients, and PreTTR's
split (``precompute_history`` + ``serve_scores_from_reps``), all at
rtol = atol = 2e-5 (float32, tests/test_kernels.py); ``two_stage_topk``
against one ``torch.topk``; the registry entry and the bridge; and the
kernel impl's refusal of ``forward_hidden``'s mixed-split range beside
JAX's ``pallas`` refusal, while the split's two ranges run on it.

Weights come from the JAX ``init_bert4rec`` through the bridge; item
sequences from ``item_seq_batch`` (numpy, seeded).  On the CPU the
``"cuda"`` impl runs the kernel wrappers' plain versions."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.bert4rec import smoke_config as jax_smoke
from repro.data.recsys import item_seq_batch as jax_item_seq_batch
from repro.models.recsys import bert4rec as JB
from repro_torch.bridge import bert4rec_params_from_jax
from repro_torch.configs import get_arch
from repro_torch.configs.bert4rec import full_config, smoke_config
from repro_torch.data.recsys import item_seq_batch
from repro_torch.models.recsys import bert4rec as TB

TOL = dict(rtol=2e-5, atol=2e-5)
BATCH = 6


def _plain():
    return dataclasses.replace(smoke_config(), attn_impl="plain")


@functools.lru_cache(maxsize=None)
def _world():
    """JAX params (numpy leaves) and one seeded Cloze batch."""
    params, _ = JB.init_bert4rec(jax.random.PRNGKey(0), jax_smoke())
    batch = item_seq_batch(np.random.default_rng(0), BATCH,
                           n_items=jax_smoke().n_items,
                           seq_len=jax_smoke().seq_len)
    return jax.tree.map(np.asarray, params), batch


def _jax():
    params, batch = _world()
    return (jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})


def _port(cfg=None):
    params, batch = _world()
    tp = bert4rec_params_from_jax(params, cfg or _plain(), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["item_seq"], tb["targets"] = tb["item_seq"].long(), \
        tb["targets"].long()
    return tp, tb


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_item_seq_batch_matches_jax():
    got = item_seq_batch(np.random.default_rng(4), 5, n_items=500,
                         seq_len=20)
    want = jax_item_seq_batch(np.random.default_rng(4), 5, n_items=500,
                              seq_len=20)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_forward_hidden_matches_jax():
    jp, jb = _jax()
    tp, tb = _port()
    want = JB.forward_hidden(jp, jax_smoke(), jb["item_seq"], jb["valid"])
    got = TB.forward_hidden(tp, _plain(), tb["item_seq"], tb["valid"])
    assert got.shape == (BATCH, 20, 32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_serve_scores_matches_jax():
    jp, jb = _jax()
    tp, tb = _port()
    want = JB.serve_scores(jp, jax_smoke(), jb["item_seq"], jb["valid"])
    got = TB.serve_scores(tp, _plain(), tb["item_seq"], tb["valid"])
    assert got.shape == (BATCH, 502) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("vocab_shards,batch_chunk", [(1, 4), (2, 4),
                                                      (16, 2), (3, 8)])
def test_serve_topk_matches_jax(vocab_shards, batch_chunk):
    jp, jb = _jax()
    tp, tb = _port()
    wv, wi = JB.serve_topk(jp, jax_smoke(), jb["item_seq"], jb["valid"],
                           k=10, batch_chunk=batch_chunk,
                           vocab_shards=vocab_shards)
    gv, gi = TB.serve_topk(tp, _plain(), tb["item_seq"], tb["valid"], k=10,
                           batch_chunk=batch_chunk,
                           vocab_shards=vocab_shards)
    assert gv.shape == gi.shape == (BATCH, 10)
    np.testing.assert_allclose(_np(gv), _np(wv), **TOL)
    # ids agree wherever the value is apart from its neighbours
    wv, wi, gi = _np(wv), _np(wi), _np(gi)
    gap = np.minimum(np.abs(np.diff(wv, prepend=np.inf, axis=1)),
                     np.abs(np.diff(wv, append=-np.inf, axis=1)))
    apart = gap > 1e-4
    assert apart.mean() > 0.5
    np.testing.assert_array_equal(gi[apart], wi[apart])
    # and they are the full scores' top 10
    full = _np(TB.serve_scores(tp, _plain(), tb["item_seq"], tb["valid"]))
    np.testing.assert_allclose(np.take_along_axis(full, gi, 1), _np(gv),
                               **TOL)


def test_cloze_loss_and_gradients_match_jax():
    jp, jb = _jax()
    tp, tb = _port()
    want, wgrad = jax.value_and_grad(
        lambda p: JB.cloze_loss(p, jax_smoke(), jb, max_masked=8,
                                logits_chunk=3))(jp)

    def leaf(t):
        if isinstance(t, dict):
            return {k: leaf(v) for k, v in t.items()}
        if isinstance(t, list):
            return [leaf(v) for v in t]
        return t.detach().clone().requires_grad_(True)

    tp = leaf(tp)
    got = TB.cloze_loss(tp, _plain(), tb, max_masked=8, logits_chunk=3)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(_np(tp["embed"]["tokens"].grad),
                               _np(wgrad["embed"]["tokens"]), **TOL)
    np.testing.assert_allclose(_np(tp["embed"]["pos"].grad),
                               _np(wgrad["embed"]["pos"]), **TOL)
    for i in range(2):
        for group, name in (("attn", "wq"), ("attn", "bv"), ("mlp", "w_in"),
                            ("ln1", "scale")):
            np.testing.assert_allclose(
                _np(tp["layers"][i][group][name].grad),
                _np(wgrad["layers"][group][name][i]), **TOL,
                err_msg=f"layer {i} {group}.{name}")
    np.testing.assert_allclose(_np(tp["final_norm"]["bias"].grad),
                               _np(wgrad["final_norm"]["bias"]), **TOL)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_prettr_split_matches_jax(impl):
    """precompute_history (one segment through layers 0..l) and
    serve_scores_from_reps (the [MASK] slot through 0..l alone, then
    layers l..n unsplit): uniform ranges, so the kernel impl runs them."""
    jp, jb = _jax()
    cfg = dataclasses.replace(smoke_config(), attn_impl=impl)
    tp, tb = _port(cfg)
    want_h = JB.precompute_history(jp, jax_smoke(), jb["item_seq"],
                                   jb["valid"])
    got_h = TB.precompute_history(tp, cfg, tb["item_seq"], tb["valid"])
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)
    want = JB.serve_scores_from_reps(jp, jax_smoke(), want_h, jb["valid"])
    got = TB.serve_scores_from_reps(tp, cfg, got_h, tb["valid"])
    assert got.shape == (BATCH, 502) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 7])
def test_two_stage_topk_matches_one_stage(n_shards):
    gen = torch.Generator().manual_seed(n_shards)
    scores = torch.randn(5, 64, generator=gen)
    vals, ids = TB.two_stage_topk(scores, 6, n_shards)
    want_v, want_i = torch.topk(scores, 6, dim=-1)
    np.testing.assert_array_equal(vals.numpy(), want_v.numpy())
    np.testing.assert_array_equal(ids.numpy(), want_i.numpy())
    np.testing.assert_array_equal(
        torch.take_along_dim(scores, ids, 1).numpy(), vals.numpy())


def test_cuda_impl_refuses_forward_hidden_as_pallas_does():
    """forward_hidden runs layers 0..n in one range whose split flags
    differ ([True, False] at prettr_l = 1 of 2), with [MASK] slots at any
    position: the kernel impl refuses it before running a layer, as the
    JAX pallas impl does."""
    jp, jb = _jax()
    tp, tb = _port(smoke_config())

    @dataclasses.dataclass(frozen=True)
    class PallasConfig(JB.Bert4RecConfig):
        def backbone(self):
            return dataclasses.replace(super().backbone(),
                                       attn_impl="pallas")

    jcfg = PallasConfig(**{f.name: getattr(jax_smoke(), f.name)
                           for f in dataclasses.fields(jax_smoke())})
    msgs = []
    for fn, args in ((TB.forward_hidden, (tp, smoke_config(),
                                          tb["item_seq"], tb["valid"])),
                     (JB.forward_hidden, (jp, jcfg, jb["item_seq"],
                                          jb["valid"]))):
        with pytest.raises(ValueError, match="requires a uniform") as e:
            fn(*args)
        msgs.append(str(e.value))
    for msg in msgs:
        assert "layers [0, 2)" in msg and "splits=[True, False]" in msg
    for fn in (TB.serve_scores, TB.serve_topk):
        with pytest.raises(ValueError, match="uniform split-flag"):
            fn(tp, smoke_config(), tb["item_seq"], tb["valid"])
    with pytest.raises(ValueError, match="uniform split-flag"):
        TB.cloze_loss(tp, smoke_config(), tb, max_masked=8)


def test_registry_and_configs():
    spec = get_arch("bert4rec")
    full = full_config()
    assert spec.config == full and spec.smoke == smoke_config()
    assert (full.n_items + 2, full.seq_len, full.embed_dim, full.n_blocks,
            full.n_heads, full.prettr_l) == (2 ** 20, 200, 64, 2, 2, 1)
    assert full.compute_dtype == torch.bfloat16
    bb = full.backbone()
    assert (bb.vocab_size, bb.dh, bb.d_ff, bb.split_layers, bb.causal,
            bb.tie_embeddings) == (2 ** 20, 32, 256, 1, False, True)
    # the bridged smoke params have the port's init tree
    tp, _ = _port()
    ref = TB.init_bert4rec(_plain(), torch.Generator().manual_seed(0),
                           device="cpu")
    assert set(tp) == set(ref) and "lm_head" not in tp
    assert len(tp["layers"]) == len(ref["layers"]) == 2
    for a, b in zip(tp["layers"], ref["layers"]):
        assert {k: {n: t.shape for n, t in v.items()} for k, v in a.items()} \
            == {k: {n: t.shape for n, t in v.items()} for k, v in b.items()}
