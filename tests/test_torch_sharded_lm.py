"""The transformer over an SPMD mesh (``models/transformer_spmd.py``) on
gloo ranks on the CPU, against single-device JAX: FSDP over ``data``,
tensor parallelism over ``model`` (heads, ``d_ff``, vocab), the batch
over ``data``.

Each rank takes its shards (``dist.spmd.shard_tree`` under
``default_rules``) of params that JAX ``init_params`` made and the
bridge carried across (norm scales perturbed so that ``1 + scale`` is
exercised), and its data rows of seeded tokens; the sharded
``causal_lm_loss`` and its gradient, gathered back to whole leaves
(``gather_tree``), are held against JAX ``causal_lm_loss`` and
``jax.grad`` on one device.  JAX's own sharded test
(``tests/test_distributed.py::test_sharded_transformer_matches_single_
device``) fails under jax 0.9 and is not the oracle.

Configs: the JAX test's (4 layers, d 64, 4/2 heads, d_ff 128, vocab 256,
float32), gemma3's smoke config (windows, qk-norm, post-norms, tied
head; one kv head two ranks share on ``model`` 2) and granite-moe's (5
experts: ``divisible_spec`` puts ``model`` on ``d_ff``; forward only, at
capacity factor E / k, where no token is dropped under any grouping, so
the mesh's dispatch groups compute JAX's one group).  Meshes: (4, 2) and
(8,) ``data`` on 8 ranks, (2, 2) on 4; each world spawns once a module.

Tolerances: the loss rtol 1e-5; every gradient leaf rtol = atol = 1e-5.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _spmd_lm_ranks as R
from repro.configs import gemma3_4b as JG
from repro.configs import granite_moe_3b as JGR
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import gemma3_4b as TG
from repro_torch.configs import granite_moe_3b as TGR
from repro_torch.dist import default_rules, divisible_spec
from repro_torch.dist.compat import AbstractMesh
from repro_torch.launch.mesh import run_spmd
from repro_torch.models import transformer as TT
from repro_torch.models import transformer_spmd as SP
from repro_torch.tree import leaves_with_paths, tree_map

import torch

TIMEOUT_S = 240
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# world of 8: (4, 2) and (8,) data; world of 4: (2, 2)
MESHES = {"4x2": 8, "8_data": 8, "2x2": 4}
CASES = ("dense", "gemma3", "granite")
GRAD_CASES = ("dense", "gemma3")


def _dense_cfgs():
    kw = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=256, logits_chunk=8)
    return (JT.TransformerConfig(compute_dtype=jnp.float32,
                                 attn_impl="plain", block_kv=16, **kw),
            TT.TransformerConfig(compute_dtype=torch.float32,
                                 attn_impl="plain", **kw))


def _cfgs(case):
    if case == "dense":
        return _dense_cfgs()
    jmod, tmod = (JG, TG) if case == "gemma3" else (JGR, TGR)
    jcfg = dataclasses.replace(jmod.smoke_config(), attn_impl="plain")
    tcfg = tmod.smoke_config(attn_impl="plain")
    if case == "granite":
        cf = tcfg.n_experts / tcfg.top_k
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    return jcfg, tcfg


def _world(case, seed):
    """(jax cfg, port cfg, JAX params as numpy, bridged port params as
    numpy, tokens [8, 33])."""
    jcfg, tcfg = _cfgs(case)
    params, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if "norm" in jax.tree_util.keystr(path):
            a = a + 0.2 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, params)
    tp = tree_map(lambda t: t.numpy(),
                  lm_params_from_jax(jp, tcfg, device="cpu"))
    toks = rng.integers(0, jcfg.vocab_size, (8, 33))
    return jcfg, tcfg, jp, tp, toks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's loss (and gradient) per case on one device, then the two
    worlds of ranks, each spawned once."""
    tmp = tmp_path_factory.mktemp("spmd_lm")
    cases, want = {}, {}
    for seed, case in enumerate(CASES):
        jcfg, tcfg, jp, tp, toks = _world(case, seed)
        grad = case in GRAD_CASES
        loss_fn = lambda p: JT.causal_lm_loss(
            p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
        if grad:
            loss, g = jax.jit(jax.value_and_grad(loss_fn))(jp)
            g = tree_map(lambda t: t.numpy(), lm_params_from_jax(
                jax.tree.map(np.asarray, g), tcfg, device="cpu"))
        else:
            loss, g = jax.jit(loss_fn)(jp), None
        want[case] = (float(loss), g)
        cases[case] = (tcfg, tp, toks, grad)
    kw = dict(device_type="cpu", timeout_s=TIMEOUT_S, store_dir=str(tmp),
              threads=1)
    got = {}
    for r in run_spmd(R.sharded_lm, (4, 2), ("data", "model"),
                      args=(cases, [((8,), ("data",))]), **kw):
        for key, res in r.items():
            got.setdefault(key, []).append(res)
    for r in run_spmd(R.sharded_lm, (2, 2), ("data", "model"),
                      args=(cases, []), **kw):
        for key, res in r.items():
            got.setdefault(key, []).append(res)
    return {"want": want, "got": got, "cases": cases}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_loss_matches_single_device_jax(runs, mesh, case):
    """Every rank's loss, the global masked mean, within rtol 1e-5 of
    JAX's on one device."""
    ranks = runs["got"][mesh]
    assert len(ranks) == MESHES[mesh]
    want = runs["want"][case][0]
    for r in ranks:
        np.testing.assert_allclose(r[case][0], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_gradients_match_jax_grad(runs, mesh, case):
    """Every gathered gradient leaf (FSDP's reduce-scatter, the
    tensor-parallel all-reduces, the vocab-parallel cross-entropy) within
    rtol = atol = 1e-5 of ``jax.grad`` on one device."""
    got = dict(leaves_with_paths(runs["got"][mesh][0][case][1]))
    want = dict(leaves_with_paths(runs["want"][case][1]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_granite_smoke_cuts_d_ff_over_model():
    """5 experts on ``model`` 2: the rules put ``model`` on each expert
    weight's ``d_ff`` (the column / row-parallel expert products), the
    vocab 512 over ``model`` and ``embed`` over ``data``."""
    _, tcfg = _cfgs("granite")
    rules = default_rules(AbstractMesh((4, 2), ("data", "model")))
    lp = TT.param_axes(tcfg)["layers"][0]["moe"]
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(divisible_spec(rules, lp["w_gate"], (e, d, f))) \
        == (None, "data", "model")
    assert tuple(divisible_spec(rules, lp["w_down"], (e, f, d))) \
        == (None, "model", "data")
    assert tuple(divisible_spec(rules, ("vocab", "embed"),
                                (tcfg.vocab_size, d))) == ("model", "data")


class _Rank:
    """A mesh's shape and one rank's place on it (what ``plan`` reads)."""

    def __init__(self, sizes, names, rank):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
        self.rank = rank


@pytest.mark.parametrize("hq,hkv,m", [(8, 4, 8), (8, 4, 4), (8, 4, 2),
                                      (32, 2, 4), (4, 2, 4), (6, 3, 2),
                                      (12, 3, 4), (24, 8, 4), (5, 5, 2)])
def test_plan_gives_each_rank_the_kv_heads_its_query_heads_read(hq, hkv, m):
    """Query head h reads kv head h // (Hq / Hkv): every rank's local
    heads (GQA groups whole where they align, one kv head a query head
    where they straddle) reproduce that map; heads ``model`` does not
    divide run whole on every rank."""
    dh = 4
    cfg = TT.TransformerConfig(n_heads=hq, n_kv_heads=hkv, head_dim=dh,
                               d_model=16, d_ff=32, vocab_size=64)
    for j in range(m):
        p = SP.plan(cfg, _Rank((1, m), ("data", "model"), j))
        if hq % m:
            assert not p.attn_split and p.local.n_heads == hq
            continue
        hl = hq // m
        assert p.q_cols == (j * hl * dh, hl * dh)
        hl_, hkv_l = p.local.n_heads, p.local.n_kv_heads
        assert hl_ == hl and hl % hkv_l == 0
        if isinstance(p.kv_cols, tuple):
            kv_local = [p.kv_cols[0] // dh + i for i in range(hkv_l)]
        else:
            kv_local = p.kv_cols.reshape(hkv_l, dh)[:, 0].div(
                dh, rounding_mode="floor").tolist()
        for i in range(hl):
            assert kv_local[i // (hl // hkv_l)] == (j * hl + i) \
                // (hq // hkv), (j, i)
