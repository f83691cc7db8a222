"""The port's training surface against the JAX package on the CPU: the
paper's pairwise loss (``rank_pairs_loss``) and the compressor's Eq. 2
loss (``attention_mse_loss``) with their gradients, ``causal_lm_loss``,
the recsys ``bce_loss``, AdamW (``adam_update``) over several steps, the
schedules, whole ``prettr_train_step``s from a bridged JAX init, and the
kernel wrappers' refusal of inputs that require grad.

Weights come from the JAX init (bridged); inputs are made with numpy
(the synthetic world's draws) and fed to both packages.  JAX runs its
"plain" attention and compressor.  Tolerances: rtol = atol = 2e-5 in
float32 (tests/test_kernels.py) for losses, gradients and updated
state; bf16 parameters and moments 2e-2."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as jax_deepfm_cfg
from repro.configs import dlrm_mlperf as jax_dlrm_cfg
from repro.configs import gemma3_4b as jax_gemma_cfg
from repro.configs import prettr_bert as jax_prettr_cfg
from repro.configs import xdeepfm as jax_xdeepfm_cfg
from repro.core import compression as JC
from repro.core import prettr as JP
from repro.models import transformer as JT
from repro.models.recsys import deepfm as JF
from repro.models.recsys import dlrm as JD
from repro.optim import adam as JA
from repro.optim import schedules as JS
from repro_torch import bridge
from repro_torch.configs import deepfm as deepfm_cfg
from repro_torch.configs import dlrm_mlperf as dlrm_cfg
from repro_torch.configs import gemma3_4b as gemma_cfg
from repro_torch.configs import prettr_bert as prettr_cfg
from repro_torch.configs import xdeepfm as xdeepfm_cfg
from repro_torch.core import compression as TC
from repro_torch.core import prettr as TP
from repro_torch.data import recsys as data
from repro_torch.data.synthetic_ir import SyntheticIRWorld
from repro_torch.kernels.decode_attention import flash_decode_attention
from repro_torch.kernels.embedding_bag import embedding_bag_op
from repro_torch.kernels.fused_compress import (fused_compress,
                                                fused_decompress)
from repro_torch.kernels.join_attention import (join_flash_attention,
                                                join_flash_attention_paged)
from repro_torch.kernels.split_attention import split_flash_attention
from repro_torch.launch.train import batch_tensors, prettr_train_step
from repro_torch.models import transformer as TT
from repro_torch.models.recsys import deepfm as TF
from repro_torch.models.recsys import dlrm as TD
from repro_torch.optim import adam as TA
from repro_torch.optim import schedules as TS
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=2e-5, atol=2e-5)
TOL16 = dict(rtol=2e-2, atol=2e-2)
PAIRS = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_trees(got, want, tol=TOL):
    """Two port-layout trees, leaf by leaf (same keys)."""
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_allclose(_f32(g[k]), _f32(w[k]), err_msg=k, **tol)


@functools.lru_cache(maxsize=None)
def _world():
    return SyntheticIRWorld(n_docs=48, n_queries=6, vocab_size=512,
                            doc_len=38, seed=3)


def _prettr(l, compress_dim):
    jcfg = jax_prettr_cfg.smoke_config(l=l, compress_dim=compress_dim,
                                       attn_impl="plain",
                                       compress_impl="plain")
    tcfg = prettr_cfg.smoke_config(l=l, compress_dim=compress_dim,
                                   attn_impl="plain", compress_impl="plain")
    jp, _ = JP.init_prettr(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, bridge.params_from_jax(_np_tree(jp), tcfg,
                                                  device="cpu")


def _pairs(cfg, seed):
    pos, neg = _world().pair_batch(np.random.default_rng(seed), PAIRS,
                                   cfg.max_query_len, cfg.max_doc_len)
    return pos, neg


# ---------------------------------------------------------------------------
# Losses and their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l,compress_dim", [(0, 0), (2, 16)])
def test_rank_pairs_loss_and_grads_match_jax(l, compress_dim):
    jcfg, jp, tcfg, tp = _prettr(l, compress_dim)
    pos, neg = _pairs(tcfg, 1)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: JP.rank_pairs_loss(p, jcfg, jax.tree.map(jnp.asarray, pos),
                                     jax.tree.map(jnp.asarray, neg))))(jp)
    got, tg = value_and_grad(
        lambda p: TP.rank_pairs_loss(p, tcfg, batch_tensors(pos, "cpu"),
                                     batch_tensors(neg, "cpu")), tp)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_trees(tg, bridge.params_from_jax(_np_tree(jg), tcfg,
                                            device="cpu"))
    # the gradient is not trivially small: the loss moves the weights
    assert float(np.abs(_f32(tg["score_head"])).max()) > 1e-3


def test_attention_mse_loss_and_compressor_grads_match_jax():
    """The loss (~1e-4) and the compressor's gradients (~1e-5) lie far
    below the absolute 2e-5, so both are held to 2e-5 of their own
    scale: the loss relative, each gradient leaf to 2e-5 of its largest
    entry."""
    jcfg, jp, tcfg, tp = _prettr(2, 16)
    toks = _world().car_pairs(np.random.default_rng(2), PAIRS,
                              tcfg.max_query_len, tcfg.max_doc_len)["tokens"]
    want, jg = jax.jit(jax.value_and_grad(
        lambda c: JC.attention_mse_loss(jp["backbone"], c, jcfg.backbone,
                                        jnp.asarray(toks), l=jcfg.l)))(
        jp["compressor"])
    got, tg = value_and_grad(
        lambda c: TC.attention_mse_loss(tp["backbone"], c, tcfg.backbone,
                                        torch.from_numpy(toks).long(),
                                        l=tcfg.l), tp["compressor"])
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5, atol=0)
    for k, g in leaves_with_paths(tg):
        w = np.asarray(functools.reduce(lambda t, p: t[p], k.split("/"), jg))
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(_f32(g), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max(), err_msg=k)
    # the backbone is frozen: only the compressor's leaves get gradients
    assert sorted(k for k, _ in leaves_with_paths(tg)) == sorted(
        k for k, _ in leaves_with_paths(tp["compressor"]))


@pytest.mark.parametrize("chunk", [16, 24])
@pytest.mark.parametrize("masked", [False, True])
def test_causal_lm_loss_and_grads_match_jax(chunk, masked):
    jcfg = dataclasses.replace(jax_gemma_cfg.smoke_config(),
                               attn_impl="plain", logits_chunk=chunk)
    tcfg = dataclasses.replace(gemma_cfg.smoke_config(attn_impl="plain"),
                               logits_chunk=chunk)
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.lm_params_from_jax(_np_tree(jp), tcfg, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(4, tcfg.vocab_size, (2, 65))
    mask = (rng.random((2, 64)) < 0.7).astype(np.float32) if masked else None
    want, jg = jax.jit(jax.value_and_grad(lambda p: JT.causal_lm_loss(
        p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]),
        label_mask=None if mask is None else jnp.asarray(mask))))(jp)
    got, tg = value_and_grad(lambda p: TT.causal_lm_loss(
        p, tcfg, torch.from_numpy(toks[:, :-1]),
        torch.from_numpy(toks[:, 1:]),
        label_mask=None if mask is None else torch.from_numpy(mask)), tp)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_trees(tg, bridge.lm_params_from_jax(_np_tree(jg), tcfg,
                                               device="cpu"))


RECSYS = {"dlrm": (jax_dlrm_cfg, dlrm_cfg, JD.init_dlrm, JD.bce_loss,
                   TD.bce_loss, 13),
          "deepfm": (jax_deepfm_cfg, deepfm_cfg, JF.init_deepfm, JF.bce_loss,
                     TF.bce_loss, 0),
          "xdeepfm": (jax_xdeepfm_cfg, xdeepfm_cfg, JF.init_deepfm,
                      JF.bce_loss, TF.bce_loss, 0)}


@pytest.mark.parametrize("family", list(RECSYS))
def test_bce_loss_and_grads_match_jax(family):
    jmod, tmod, init, jloss, tloss, n_dense = RECSYS[family]
    jcfg = jmod.smoke_config()
    tcfg = dataclasses.replace(tmod.smoke_config(), bag_impl="plain")
    jp, _ = init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.recsys_params_from_jax(_np_tree(jp), tcfg, device="cpu")
    b = data.click_batch(np.random.default_rng(5), 32, n_dense=n_dense,
                         vocab_sizes=tcfg.vocab_sizes)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jcfg, jax.tree.map(jnp.asarray, b))))(jp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got, tg = value_and_grad(lambda p: tloss(p, tcfg, tb), tp)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_trees(tg, bridge.recsys_params_from_jax(_np_tree(jg), tcfg,
                                                   device="cpu"))


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------

ADAM_CASES = {
    "clip": (dict(grad_clip=1.0), jnp.float32, torch.float32),
    "no_clip": (dict(grad_clip=0.0), jnp.float32, torch.float32),
    "weight_decay": (dict(weight_decay=0.1, grad_clip=0.5), jnp.float32,
                     torch.float32),
    "bf16_params": (dict(m_dtype="bf16"), jnp.bfloat16, torch.bfloat16),
}


def _opt_cfgs(kw):
    jkw, tkw = dict(kw, lr=1e-2), dict(kw, lr=1e-2)
    if kw.get("m_dtype") == "bf16":
        jkw["m_dtype"], tkw["m_dtype"] = jnp.bfloat16, torch.bfloat16
    return JA.OptimizerConfig(**jkw), TA.OptimizerConfig(**tkw)


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_update_three_steps_matches_jax(case):
    kw, jdt, tdt = ADAM_CASES[case]
    jcfg, tcfg = _opt_cfgs(kw)
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}}
    init = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), init)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), init)
    jo, to = JA.init_opt_state(jp, jcfg), TA.init_opt_state(tp, tcfg)
    for _ in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 2)
                         .astype(np.float32), init)
        jp, jo, jgn = JA.adam_update(jax.tree.map(
            lambda a: jnp.asarray(a).astype(jdt), g), jo, jp, jcfg,
            lr=jcfg.lr)
        tp, to, tgn = TA.adam_update(jax.tree.map(
            lambda a: torch.from_numpy(a).to(tdt), g), to, tp, tcfg,
            lr=tcfg.lr)
    np.testing.assert_allclose(float(tgn), float(jgn),
                               **(TOL if tdt == torch.float32 else TOL16))
    assert int(to["step"]) == int(jo["step"]) == 3
    assert to["step"].dtype == torch.int32
    for name, tree, tol in (("params", (tp, jp), tdt),
                            ("m", (to["m"], jo["m"]), tcfg.m_dtype),
                            ("v", (to["v"], jo["v"]), tcfg.v_dtype),
                            ("master", (to["master"], jo["master"]),
                             torch.float32)):
        got, want = (dict(leaves_with_paths(t)) for t in tree)
        for k in got:
            assert got[k].dtype == tol, (name, k)
            np.testing.assert_allclose(
                _f32(got[k]), _f32(want[k]), err_msg=f"{name}/{k}",
                **(TOL if tol == torch.float32 else TOL16))


def test_schedules_match_jax():
    steps = [0, 1, 4, 9, 10, 11, 37, 99, 100, 150]
    for jfn, tfn in ((JS.constant(3e-4), TS.constant(3e-4)),
                     (JS.warmup_cosine(1e-3, 10, 100),
                      TS.warmup_cosine(1e-3, 10, 100)),
                     (JS.warmup_cosine(2e-3, 0, 50, final_frac=0.0),
                      TS.warmup_cosine(2e-3, 0, 50, final_frac=0.0))):
        for s in steps:
            got = tfn(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                float(got), float(jfn(jnp.asarray(s, jnp.int32))), rtol=1e-6,
                atol=1e-12, err_msg=f"step {s}")


# ---------------------------------------------------------------------------
# Whole training steps
# ---------------------------------------------------------------------------


def test_prettr_train_steps_match_jax():
    """At the paper's learning rate, 2e-5 (the optimizer's default).  Adam
    turns a gradient that is rounding noise (the K bias's: softmax is
    shift-invariant, so its gradient is 0 up to rounding) into a step of
    about lr, whose sign the two packages need not share; at 2e-5 three
    steps keep every leaf within the tolerance (about 7e-6 off at most,
    on a K bias), at 3e-3 they would not."""
    jcfg, jp, tcfg, tp = _prettr(2, 16)
    opt_j = JA.OptimizerConfig()
    opt_t = TA.OptimizerConfig()
    assert opt_j.lr == opt_t.lr == 2e-5
    jo, to = JA.init_opt_state(jp, opt_j), TA.init_opt_state(tp, opt_t)

    @jax.jit
    def jstep(params, opt, pos, neg):
        loss, g = jax.value_and_grad(
            lambda p: JP.rank_pairs_loss(p, jcfg, pos, neg))(params)
        params, opt, gn = JA.adam_update(g, opt, params, opt_j, lr=opt_j.lr)
        return params, opt, loss, gn

    # the port's step runs the plain backend whatever the config says
    tcfg_cuda = prettr_cfg.smoke_config(l=2, compress_dim=16)
    for i in range(3):
        pos, neg = _pairs(tcfg, 10 + i)
        jp, jo, jloss, jgn = jstep(jp, jo, jax.tree.map(jnp.asarray, pos),
                                   jax.tree.map(jnp.asarray, neg))
        tp, to, tloss, tgn = prettr_train_step(
            tp, to, tcfg_cuda, opt_t, batch_tensors(pos, "cpu"),
            batch_tensors(neg, "cpu"))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
        np.testing.assert_allclose(float(tgn), float(jgn), **TOL)
    assert int(to["step"]) == 3
    _close_trees(tp, bridge.params_from_jax(_np_tree(jp), tcfg,
                                            device="cpu"))
    _close_trees(to["master"], bridge.params_from_jax(
        _np_tree(jo["master"]), tcfg, device="cpu"))


# ---------------------------------------------------------------------------
# The kernel wrappers refuse a gradient
# ---------------------------------------------------------------------------


def _wrapper_calls():
    """One small call of each public kernel wrapper, by name; ``grad``
    marks the input that requires grad."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    b, h, s, d = 2, 2, 8, 16

    def split(grad):
        q = r(b, h, s, d).requires_grad_(grad)
        return split_flash_attention(q, r(b, h, s, d), r(b, h, s, d))

    def decode(grad):
        q = r(b, h, 1, d).requires_grad_(grad)
        return flash_decode_attention(q, r(b, h, s, d), r(b, h, s, d))

    def join(grad):
        q = r(b, h, s, d)
        kd = r(b, h, s, d).requires_grad_(grad)
        return join_flash_attention(q, r(b, h, 4, d), r(b, h, 4, d), kd,
                                    r(b, h, s, d))

    def join_paged(grad):
        pages = r(3, 4, h, d).requires_grad_(grad)
        return join_flash_attention_paged(
            r(b, h, 4, d), r(b, h, 4, d), r(b, h, 4, d), pages,
            r(3, 4, h, d), torch.tensor([[1, 2], [2, 0]]),
            torch.ones((3, 4), dtype=torch.bool))

    def compress(grad):
        w = r(d, 8).requires_grad_(grad)
        return fused_compress(r(b, s, d), w, torch.zeros(8))

    def decompress(grad):
        return fused_decompress(r(b, s, 8).half(), r(8, d),
                                torch.zeros(d).requires_grad_(grad),
                                torch.ones(d), torch.zeros(d))

    def bag(grad):
        table = r(20, d).requires_grad_(grad)
        return embedding_bag_op(table, torch.tensor([[1, 3], [4, 0]]))

    return {"split_flash_attention": split,
            "flash_decode_attention": decode,
            "join_flash_attention": join,
            "join_flash_attention_paged": join_paged,
            "fused_compress": compress, "fused_decompress": decompress,
            "embedding_bag_op": bag}


@pytest.mark.parametrize("wrapper", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_a_gradient(wrapper):
    """The refusal comes before the CPU branch, so the plain version that
    stands in for the kernel here refuses as the kernel does; without a
    gradient to record (grad off, or no input requiring it) it runs."""
    call = _wrapper_calls()[wrapper]
    with pytest.raises(RuntimeError, match=f"{wrapper}.*plain backend"):
        call(True)
    assert call(False) is not None
    with torch.no_grad():
        assert call(True) is not None
    with torch.inference_mode():
        assert call(True) is not None


# ---------------------------------------------------------------------------
# The "cuda" backend ops train: the kernel forward, the plain gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["attention_split", "attention_causal",
                                  "attention_window", "decode_attention",
                                  "compress", "decompress", "embedding_bag"])
def test_cuda_backend_ops_take_the_plain_gradient(case):
    """Under autograd the "cuda" backend ops (and ``padded_bag``'s "cuda"
    impl) run the kernel wrapper forward (its plain version on these CPU
    tensors) and a reference op's gradient backward
    (``models.backend._ReferenceGradient``: the blocked attention's at
    ``block_kv`` 16, over 24 keys padded to 32, the other ops' plain
    versions'): output within TOL of the plain op's (fp16 stores within
    one fp16 step), and the gradient by every float input within TOL of
    the plain op's, recomputed from the same inputs; without a gradient
    to record the op runs the wrapper alone."""
    import _backend_ops as O

    got, got_g, _ = O.run(case, "cuda", "cpu")
    want, want_g, _ = O.run(case, "plain", "cpu")
    assert got.grad_fn is not None and got.dtype == want.dtype
    tol = dict(rtol=2 ** -10, atol=2e-5) if got.dtype == torch.float16 \
        else TOL
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.detach().float().numpy(), **tol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **TOL)
    with torch.no_grad():
        call, _ = O.CASES[case]
        fn, xs = call(torch.Generator().manual_seed(0), "cpu")
        assert fn("cuda", *(x.requires_grad_() for x in xs)).grad_fn is None
