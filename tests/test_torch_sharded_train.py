"""The train cells through the sharded route on gloo ranks on the CPU,
against single-device JAX: ``make_lm_train_step`` (``causal_lm_loss``
over two micro-batches, the float32 gradients summed in each rank's
shard layout, AdamW with the global norm summed over the ranks) and the
``rank_train`` cell (``rank_pairs_loss``, AdamW), under
``default_rules`` on a (2, 2) mesh: FSDP over ``data``; heads, ``d_ff``,
vocab and experts over ``model``.

Each rank takes its part of the bridged JAX state and of the seeded
batch through the cell's own ``local``; a micro-batch is the
reference's (global rows ``[j gb / 2, (j + 1) gb / 2)``, two rows a
data rank).  The loss and ``grad_norm`` of every rank, and the updated
params gathered whole (``gather_tree``), are held against JAX's
``causal_lm_loss`` / ``rank_pairs_loss`` gradients (summed over the
micro-batches as JAX's ``make_lm_train_step`` sums them) and
``adam_update`` on one device.

Configs: gemma3's smoke config (tied vocab-parallel head, windows,
qk-norm), granite-moe's with its 5 experts (``model`` cuts every
expert's ``d_ff``: the float32 all-reduce's backward) and with 4
(expert parallelism: the gathered expert outputs' backward), both at
capacity factor E / k so that the mesh's dispatch groups drop no token,
as JAX's one group drops none; PreTTR-BERT's (split at l = 2, e = 16).

Tolerance: rtol = atol = 1e-5 for the loss, ``grad_norm`` and every
updated parameter."""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _spmd_cell_ranks as R
from repro.configs import gemma3_4b as JG
from repro.configs import granite_moe_3b as JGR
from repro.configs import prettr_bert as JPB
from repro.core import prettr as JP
from repro.launch.steps import _lm_opt_cfg
from repro.models import transformer as JT
from repro.optim import adam as JA
from repro_torch import bridge
from repro_torch.configs import gemma3_4b as TG
from repro_torch.configs import granite_moe_3b as TGR
from repro_torch.configs import prettr_bert as TPB
from repro_torch.launch.mesh import run_spmd
from repro_torch.tree import leaves_with_paths, tree_map

TIMEOUT_S = 240
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, SEQ, PAIRS, ACCUM = 8, 16, 4, 2
CASES = ("gemma3", "granite_ff", "granite_ep", "prettr")


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.asarray(a).dtype.kind == "f"
                        else np.asarray(a), tree)


def _port_np(tree, cfg):
    """A JAX ``{"params", "opt"}`` state (numpy) as the port's, numpy."""
    return tree_map(lambda t: t.numpy(),
                    bridge.train_state_from_jax(tree, cfg, device="cpu"))


def _lm_cfgs(case):
    jmod, tmod = (JG, TG) if case == "gemma3" else (JGR, TGR)
    jcfg = dataclasses.replace(jmod.smoke_config(), attn_impl="plain")
    tcfg = tmod.smoke_config(attn_impl="plain")
    if case != "gemma3":
        e = 4 if case == "granite_ep" else tcfg.n_experts
        kw = dict(n_experts=e, capacity_factor=e / tcfg.top_k)
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
    return jcfg, tcfg


def _lm_case(case, seed):
    """(the ranks' case, a function that computes JAX's reference)."""
    jcfg, tcfg = _lm_cfgs(case)
    opt_cfg = _lm_opt_cfg(jcfg)
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    state = {"params": jp, "opt": JA.init_opt_state(jp, opt_cfg)}
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, jcfg.vocab_size, (BATCH, SEQ))
             .astype(np.int32) for k in ("tokens", "labels")}

    def want():
        # JAX's train step without its mesh: the micro-batches'
        # value_and_grad summed in float32, divided, then AdamW
        vg = jax.jit(jax.value_and_grad(
            lambda p, t, y: JT.causal_lm_loss(p, jcfg, t, y)))
        n = BATCH // ACCUM
        gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
        lsum = 0.0
        for j in range(ACCUM):
            rows = slice(j * n, (j + 1) * n)
            lj, g = vg(jp, jnp.asarray(batch["tokens"][rows]),
                       jnp.asarray(batch["labels"][rows]))
            gsum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                gsum, g)
            lsum = lsum + lj
        grads = jax.tree.map(lambda g: g / ACCUM, gsum)
        new, _, gn = JA.adam_update(grads, state["opt"], jp, opt_cfg,
                                    lr=opt_cfg.lr)
        return (float(lsum / ACCUM), float(gn),
                tree_map(lambda t: t.numpy(), bridge.lm_params_from_jax(
                    _np(new), tcfg, device="cpu")))

    arch = "gemma3-4b" if case == "gemma3" else "granite-moe-3b-a800m"
    return ("lm", arch, tcfg, ACCUM, BATCH, SEQ, _port_np(_np(state), tcfg),
            (batch,)), want


def _pairs(rng, cfg):
    lq, ld = cfg.max_query_len, cfg.max_doc_len
    valid = np.concatenate(
        [np.arange(n)[None] < rng.integers(2, n + 1, (PAIRS, 1))
         for n in (lq, ld)], 1)
    segs = np.concatenate([np.zeros((PAIRS, lq)), np.ones((PAIRS, ld))],
                          1).astype(np.int32)
    toks = (rng.integers(0, cfg.backbone.vocab_size, (PAIRS, lq + ld))
            * valid).astype(np.int32)
    return {"tokens": toks, "segs": segs, "valid": valid}


def _prettr_case(seed):
    jcfg = JPB.smoke_config(attn_impl="plain", compress_impl="plain")
    tcfg = TPB.smoke_config(attn_impl="plain", compress_impl="plain")
    opt_cfg = JA.OptimizerConfig()
    jp, _ = JP.init_prettr(jax.random.PRNGKey(seed), jcfg)
    state = {"params": jp, "opt": JA.init_opt_state(jp, opt_cfg)}
    rng = np.random.default_rng(seed)
    pos, neg = _pairs(rng, jcfg), _pairs(rng, jcfg)

    def want():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JP.rank_pairs_loss(p, jcfg, pos, neg)))(jp)
        new, _, gn = JA.adam_update(grads, state["opt"], jp, opt_cfg,
                                    lr=opt_cfg.lr)
        return (float(loss), float(gn), tree_map(
            lambda t: t.numpy(), bridge.params_from_jax(_np(new), tcfg,
                                                        device="cpu")))

    return ("prettr", "prettr-bert", tcfg, 1, PAIRS, None,
            _port_np(_np(state), tcfg), (pos, neg)), want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run (in their own processes, waited on by a thread)
    while JAX computes its references here."""
    tmp = tmp_path_factory.mktemp("spmd_train")
    cases, refs = {}, {}
    for seed, case in enumerate(CASES):
        cases[case], refs[case] = (_prettr_case(seed) if case == "prettr"
                                   else _lm_case(case, seed))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_spmd, R.train_world, (2, 2),
                            ("data", "model"), args=(cases,),
                            device_type="cpu", timeout_s=TIMEOUT_S,
                            store_dir=str(tmp), threads=1)
        want = {case: ref() for case, ref in refs.items()}
        return ranks.result(), want


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_loss_and_grad_norm_match_jax(runs, case):
    """Every rank's loss (the mean over every rank's micro-batch tokens or
    pairs) and ``grad_norm`` (summed over the ranks that hold a leaf's
    other blocks) against JAX's."""
    got, want = runs
    assert len(got) == 4
    for r in got:
        loss, gn, _ = r[case]
        np.testing.assert_allclose(loss, want[case][0], **TOL)
        np.testing.assert_allclose(gn, want[case][1], **TOL)


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_updated_params_match_jax(runs, case):
    """Every parameter after the AdamW step, gathered whole."""
    got, want = runs
    g = dict(leaves_with_paths(got[0][case][2]))
    w = dict(leaves_with_paths(want[case][2]))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def test_backward_on_another_thread_recomputes_under_the_rules(runs):
    """Autograd runs the backward pass on its own thread on the card,
    where the thread-local rules are not installed; the route's
    checkpointed layers (the expert-parallel MoE FFN among them, which
    reads the rules) recompute under the rules they were made with, so
    the gradient equals the one from this thread on every rank."""
    got, _ = runs
    for r in got:
        assert r["grad_thread"] == 0.0, r["grad_thread"]
