"""Prefill and decode through the sharded transformer on gloo ranks on
the CPU, against single-device JAX: the ``prefill_32k`` and
``decode_32k`` cells (``launch.steps.make_lm_cell``) under
``default_rules``, FSDP over ``data`` and heads / kv heads / vocab over
``model``.

A rank's K/V cache holds its data rows and the kv heads its query heads
read (``transformer_spmd.cache_block``; a kv head that several ranks
read is held whole by each); JAX's ``DECODE_CACHE_AXES`` cut the
sequence over ``model`` instead (ROADMAP Queue 3, "Known, by design").
Each rank's prefill logits and collected K/V, then four teacher-forced
``decode_step`` logits, are held against the matching block of JAX's
``forward(collect_cache=True)`` + ``logits`` and ``decode_step`` on one
device, bf16 weights from the JAX init (the cells' ``icfg``), float32
compute and float32 caches (so that only the arithmetic is compared).

Configs: gemma3's smoke config (4/2 heads, windows of 8 under a
12-token prompt, qk-norm, tied vocab-parallel head) and chatglm3's (8/2
heads, QKV bias, half-rotated RoPE): on ``model`` 2 each rank reads its
own kv head, on ``model`` 4 two ranks share one.  Meshes: (1, 2) on two
ranks; (2, 2) and (1, 4) on four; each world spawns once a module.

Tolerance: rtol = atol = 2e-5 (float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _spmd_cell_ranks as R
from repro.configs import chatglm3_6b as JC
from repro.configs import gemma3_4b as JG
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import chatglm3_6b as TC
from repro_torch.configs import gemma3_4b as TG
from repro_torch.launch.mesh import run_spmd
from repro_torch.tree import tree_map

TIMEOUT_S = 240
TOL = dict(rtol=2e-5, atol=2e-5)
B, PROMPT, STEPS = 2, 12, 4
CASES = {"gemma3": ("gemma3-4b", JG, TG),
         "chatglm3": ("chatglm3-6b", JC, TC)}
MESHES = {"1x2": 2, "2x2": 4, "1x4": 4}


def _case(name, seed):
    """(port case for the ranks, JAX's whole results)."""
    arch, jmod, tmod = CASES[name]
    jcfg = dataclasses.replace(jmod.smoke_config(), attn_impl="plain",
                               param_dtype=jnp.bfloat16)
    tcfg = tmod.smoke_config(attn_impl="plain")
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, jcfg.vocab_size, (B, PROMPT))
    fed = rng.integers(0, jcfg.vocab_size, (B, STEPS))
    forward = jax.jit(JT.forward, static_argnums=1,
                      static_argnames="collect_cache")
    hidden, kv, _ = forward(jp, jcfg, jnp.asarray(prompt),
                            collect_cache=True)
    want = {"prefill_logits": np.asarray(JT.logits(jp, jcfg,
                                                   hidden[:, -1:])),
            "k": np.asarray(kv[0], np.float32),
            "v": np.asarray(kv[1], np.float32), "steps": []}
    shape = (jcfg.n_layers, B, PROMPT + STEPS, jcfg.n_kv_heads, jcfg.dh)
    cache = tuple(jnp.zeros(shape, jnp.float32).at[:, :, :PROMPT].set(c)
                  for c in kv)
    step = jax.jit(JT.decode_step, static_argnums=1)
    for i in range(STEPS):
        lg, cache = step(jp, jcfg, jnp.asarray(fed[:, i:i + 1]), cache,
                         PROMPT + i)
        want["steps"].append(np.asarray(lg))
    params = tree_map(lambda t: t.float().numpy(), lm_params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg,
        device="cpu"))
    return (arch, tcfg, params, prompt, fed, want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_decode")
    cases = {name: _case(name, seed) for seed, name in enumerate(CASES)}
    kw = dict(device_type="cpu", timeout_s=TIMEOUT_S, store_dir=str(tmp),
              threads=1)
    got = {}
    for sizes, extra in (((1, 2), []), ((2, 2), [((1, 4),
                                                   ("data", "model"))])):
        for r in run_spmd(R.decode_world, sizes, ("data", "model"),
                          args=(cases, extra), **kw):
            for key, res in r.items():
                got.setdefault(key, []).append(res)
    return got


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_prefill_matches_jax(runs, mesh, case):
    """Every rank's last-position logits (whole vocab) and its block of
    the collected K/V against JAX's ``forward(collect_cache=True)``."""
    ranks = runs[mesh]
    assert len(ranks) == MESHES[mesh]
    for r in ranks:
        for what in ("prefill_logits", "k", "v"):
            got, want = r[case][what]
            assert got.shape == want.shape, what
            np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_decode_steps_match_jax(runs, mesh, case):
    """Four ``decode_step``s from the prefilled cache: every rank's
    logits (its data rows, whole vocab) against JAX's."""
    for r in runs[mesh]:
        for i in range(STEPS):
            got, want = r[case][f"step{i}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, err_msg=f"step {i}",
                                       **TOL)
