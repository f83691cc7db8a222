"""The port's four remaining LM configurations against the JAX package,
on the CPU, at their ``smoke_config``s: granite-moe and qwen3-moe (MoE
FFN; qwen3 with qk-norm), chatglm3 (half-rotary RoPE, QKV bias) and
mistral-large (dense GQA).  For each: the config and registry entry
field for field, the weight bridge (the stacked ``moe`` leaves among
them), ``forward`` (hidden states, collected K/V, the MoE aux loss),
``logits``, ``decode_step`` and ``causal_lm_loss`` with its gradient,
on the ``"plain"`` and ``"cuda"`` impls (the CPU runs the kernels'
plain versions), and prefill + decode against the full forward.

Weights come from JAX ``init_params`` (norm scales perturbed so that
``1 + scale`` is exercised, QKV biases drawn so they are not 0) through
``lm_params_from_jax``; tokens are made with numpy from a seed.
Tolerances follow the JAX tests: rtol = atol = 2e-5 for float32 hidden
states, losses and gradients, 2e-4 for logits (``tests/test_models.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.configs import chatglm3_6b as JG
from repro.configs import granite_moe_3b as JGR
from repro.configs import mistral_large_123b as JMI
from repro.configs import qwen3_moe_235b as JQ
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import chatglm3_6b as TG
from repro_torch.configs import granite_moe_3b as TGR
from repro_torch.configs import mistral_large_123b as TMI
from repro_torch.configs import qwen3_moe_235b as TQ
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths
from test_torch_lm import _jax_decode, _torch_decode

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
IMPLS = ("plain", "cuda")             # "cuda" takes the plain kernels on CPU
ARCHS = {"granite-moe-3b-a800m": (JGR, TGR), "qwen3-moe-235b-a22b": (JQ, TQ),
         "chatglm3-6b": (JG, TG), "mistral-large-123b": (JMI, TMI)}
MOE = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _world(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params as numpy, bridged port params)."""
    jmod, tmod = ARCHS[arch]
    jcfg = dataclasses.replace(jmod.smoke_config(), attn_impl="plain", **kw)
    tcfg = dataclasses.replace(tmod.smoke_config(), **kw)
    params, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "norm" in name or "scale" in name or name.endswith("['bq']") \
                or name.endswith("['bk']") or name.endswith("['bv']"):
            a = a + 0.2 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, params)
    return jcfg, tcfg, jp, lm_params_from_jax(jp, tcfg, device="cpu")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# Configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_jax(arch):
    jmod, tmod = ARCHS[arch]
    for jcfg, tcfg in ((jmod.full_config(), tmod.full_config()),
                       (jmod.smoke_config(), tmod.smoke_config())):
        assert tcfg.layer_windows() == jcfg.layer_windows()
        assert tcfg.layer_rope_bases() == jcfg.layer_rope_bases()
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.num_active_params() == jcfg.num_active_params()
        for f in dataclasses.fields(tcfg):
            if hasattr(jcfg, f.name) and "dtype" not in f.name \
                    and f.name not in ("attn_impl", "compress_impl"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert str(tcfg.compute_dtype).removeprefix("torch.") \
            == jnp.dtype(jcfg.compute_dtype).name
    spec = TC.get_arch(arch)
    assert spec.config == tmod.full_config() \
        and spec.smoke == tmod.smoke_config()
    assert TC.arch_cells(arch) == JC.arch_cells(arch)
    # the dtype and impl arguments gemma3's config takes
    cfg = tmod.full_config(attn_impl="plain", compute_dtype=torch.float32,
                           param_dtype=torch.bfloat16)
    assert (cfg.attn_impl, cfg.compute_dtype, cfg.param_dtype) \
        == ("plain", torch.float32, torch.bfloat16)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_and_bridge_match_the_jax_tree(arch):
    """The port's own init gives the JAX tree (``moe`` in place of
    ``mlp`` where there are experts), and the bridge carries every
    stacked leaf across, the ``[L, E, d, f]`` expert weights among them."""
    jcfg, tcfg, jp, tp = _world(arch)
    native = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = lambda tree: {k: tuple(v.shape) for k, v in
                           leaves_with_paths(tree)}
    assert shapes(native["layers"][0]) == shapes(tp["layers"][0])
    assert len(native["layers"]) == len(tp["layers"]) == jcfg.n_layers
    assert ("moe" in tp["layers"][0]) == (arch in MOE) \
        and ("mlp" in tp["layers"][0]) == (arch not in MOE)
    for path, leaf in leaves_with_paths(jp["layers"]):
        node = tp["layers"][1]
        for key in path.split("/"):
            node = node[key]
        np.testing.assert_array_equal(node.numpy(), leaf[1], err_msg=path)
    if arch in MOE:
        e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
        moe = tp["layers"][0]["moe"]
        assert (tuple(moe["w_gate"].shape), tuple(moe["w_down"].shape),
                tuple(moe["router"].shape)) == ((e, d, f), (e, f, d), (d, e))


def test_bridge_refuses_a_wrong_leading_axis_on_the_expert_leaves():
    _, tcfg, jp, _ = _world("granite-moe-3b-a800m")
    bad = jax.tree.map(lambda a: a, jp)
    bad["layers"]["moe"]["w_up"] = bad["layers"]["moe"]["w_up"][:3]
    with pytest.raises(ValueError, match="leading sizes"):
        lm_params_from_jax(bad, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# The model against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch, impl):
    """24 tokens x 2: hidden states, the collected K/V, the aux loss and
    the logits (all positions)."""
    jcfg, tcfg, jp, tp = _world(arch)
    toks = _tokens(2, 24, jcfg.vocab_size)
    h_j, kv_j, aux_j = jax.jit(JT.forward, static_argnums=1,
                               static_argnames="collect_cache")(
        jp, jcfg, toks, collect_cache=True)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    h_t, kv_t, aux_t = TT.forward(tp, tcfg, _t(toks).long(),
                                  collect_cache=True)
    np.testing.assert_allclose(_np(h_t), _np(h_j), **TOL)
    for a, b in zip(kv_t, kv_j):
        assert tuple(a.shape) == b.shape == (
            jcfg.n_layers, 2, 24, jcfg.n_kv_heads, jcfg.dh)
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    assert (float(aux_t) > 0) == (arch in MOE)
    np.testing.assert_allclose(_np(TT.logits(tp, tcfg, h_t)),
                               _np(JT.logits(jp, jcfg, h_j)), **LOGIT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_step_matches_jax(arch, impl):
    """Prefill of 16, then 4 teacher-forced steps."""
    jcfg, tcfg, jp, tp = _world(arch, seed=2)
    toks = _tokens(2, 20, jcfg.vocab_size, seed=3)
    want = _jax_decode(jp, jcfg, toks[:, :16], toks[:, 16:], 24)
    got = _torch_decode(tp, dataclasses.replace(tcfg, attn_impl=impl),
                        _t(toks[:, :16]).long(), _t(toks[:, 16:]).long(), 24)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 1, jcfg.vocab_size) \
            and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), w, **LOGIT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_then_decode_matches_forward(arch, impl):
    """prefill + decode reproduces the full forward's logits at every
    decoded position.  An MoE config runs at capacity factor E / k, whose
    capacity is at least T: at 1.25 the longer forward drops other slots
    than the prefill did, in the JAX package as well."""
    jmod, tmod = ARCHS[arch]
    kw = {}
    if arch in MOE:
        cfg = tmod.smoke_config()
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    _, tcfg, _, tp = _world(arch, seed=4, **kw)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    toks = _t(_tokens(2, 21, tcfg.vocab_size, seed=5)).long()
    got = _torch_decode(tp, tcfg, toks[:, :16], toks[:, 16:], 24)
    h, _, _ = TT.forward(tp, tcfg, toks)
    full = TT.logits(tp, tcfg, h)
    for i, g in enumerate(got):
        np.testing.assert_allclose(_np(g[:, 0]), _np(full[:, 16 + i]),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_causal_lm_loss_and_grads_match_jax(arch):
    """The loss (with ``0.01 * aux / n_layers`` for MoE) and its gradient
    on the plain impl, the one training runs; the loss alone on the
    kernel impl (its wrappers refuse inputs that require grad)."""
    jcfg, tcfg, jp, tp = _world(arch, seed=6)
    toks = np.random.default_rng(7).integers(4, jcfg.vocab_size, (2, 33))
    want, jg = jax.jit(jax.value_and_grad(lambda p: JT.causal_lm_loss(
        p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))))(jp)
    args = (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]))
    got, tg = value_and_grad(lambda p: TT.causal_lm_loss(
        p, dataclasses.replace(tcfg, attn_impl="plain"), *args), tp)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    want_g = lm_params_from_jax(jax.tree.map(np.asarray, jg), tcfg,
                                device="cpu")
    g, w = dict(leaves_with_paths(tg)), dict(leaves_with_paths(want_g))
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), err_msg=k, **TOL)
    with torch.no_grad():
        cuda = TT.causal_lm_loss(tp, dataclasses.replace(tcfg,
                                                         attn_impl="cuda"),
                                 *args)
    np.testing.assert_allclose(float(cuda), float(want), **TOL)


def test_train_driver_takes_an_moe_arch(tmp_path):
    out = train.main(["--arch", "qwen3-moe-235b-a22b", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "2", "--eval-every",
                      "2"])
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    assert "moe" in out["state"]["params"]["layers"][0]
