"""The port's collective consumers on gloo ranks on the CPU, against the
JAX package: ``compressed_psum`` over 8 ranks against the JAX function
under ``shard_map`` on 8 host devices (three steps, the residual carried);
``sharded_lookup`` on (2, 2) and (4,) worlds against ``take * keep`` from
JAX's ``_bucket_group`` and against JAX's ``sharded_lookup`` itself
(under ``jax.set_mesh``); ``moe_ffn`` on a (2, 2) world against JAX's
``moe_ffn(..., n_groups=G)``, one token a data group among the cases (one
group over every token, JAX's fallback); DLRM's forward with rules installed
against one device.

The ranks start once per world through module-scoped fixtures
(``repro_torch.launch.mesh.run_spmd``: spawn, a ``FileStore`` under
``tmp_path``, one thread a rank, a timeout that kills them); the JAX
side runs in one subprocess with
``--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it.  Tolerances: 1e-6 of the largest
mean for ``compressed_psum`` (the ranks' float32 scale sums may add in
another order), bit-equal residuals and lookups, rtol = atol = 2e-5 for
the MoE FFN and DLRM (``tests/test_kernels.py``)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _spmd_ranks as R
from repro.models import moe as JM
from repro.models.recsys.embedding import _bucket_group as jax_bucket_group
from repro_torch.configs.dlrm_mlperf import smoke_config as dlrm_smoke
from repro_torch.launch.mesh import run_spmd
from repro_torch.models.recsys import dlrm as D

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 240
ROWS, DIM, N_IDS, STEPS = 256, 16, 64, 3
ID_CASES = {"uniform_cf8": 8.0, "zipf_cf1": 1.0, "uniform_cf4": 4.0}
# (mesh key, data groups)
LOOKUP_MESHES = {"2x2": 2, "4_data": 4, "4_model": 1}
MOE_CASES = {f"E{e}_cf{cf}": (e, cf) for e in (8, 5) for cf in (1.25, 8.0)}
MOE_D, MOE_F, MOE_T = 32, 48, 64
# one token a data group: fewer than a data group's dispatch groups, so
# the mesh runs one group over every token (JAX's fallback)
ONE_GROUP_CASES = {"one_group_E5": (5, 1.25)}
ONE_GROUP_T = 2

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.dist.compat import shard_map
    from repro.dist.context import install_rules
    from repro.dist.sharding import default_rules
    from repro.models.recsys.embedding import sharded_lookup
    from repro.optim.compression import compressed_psum

    inp = dict(np.load(sys.argv[1]))
    out = {}
    mesh = jax.make_mesh((8,), ("pod",), axis_types=(AxisType.Auto,))
    fb = None
    for s in range(int(inp["steps"])):
        g = {k: jnp.asarray(inp[f"psum/{s}/{k}"]) for k in ("w", "b")}
        if fb is None:
            fb = {k: jnp.zeros(v.shape, jnp.float32) for k, v in g.items()}
        specs = {k: P("pod", *([None] * (v.ndim - 1))) for k, v in g.items()}
        sm = shard_map(lambda g, e: compressed_psum(g, e, "pod"), mesh=mesh,
                       in_specs=(specs, specs), out_specs=(specs, specs))
        mean, fb = jax.jit(sm)(g, fb)
        for k in g:
            out[f"psum/{s}/mean/{k}"] = np.asarray(mean[k])
            out[f"psum/{s}/fb/{k}"] = np.asarray(fb[k])
    table = jnp.asarray(inp["table"])
    for key, shape, names in (("2x2", (2, 2), ("data", "model")),
                              ("4_data", (4,), ("data",)),
                              ("4_model", (4,), ("model",))):
        m = jax.make_mesh(shape, names, devices=jax.devices()[:4],
                          axis_types=(AxisType.Auto,) * len(shape))
        rules = default_rules(m)
        g_axes = tuple(a for a in ("data",) if a in names)
        for case in inp["cases"]:
            ids = jnp.asarray(inp[f"ids/{case}"])
            cf = float(inp[f"cf/{case}"])
            with jax.set_mesh(m):
                tbl = jax.device_put(table, NamedSharding(m, P(names, None)))
                ids_s = jax.device_put(ids, NamedSharding(m, P(g_axes or None)))
                def f(t, i):
                    with install_rules(rules):
                        return sharded_lookup(t, i, m, capacity_factor=cf)
                out[f"lookup/{key}/{case}"] = np.asarray(jax.jit(f)(tbl, ids_s))
    np.savez(sys.argv[2], **out)
""")


def _inputs():
    rng = np.random.default_rng(0)
    d = {"table": rng.standard_normal((ROWS, DIM)).astype(np.float32),
         "steps": STEPS, "cases": np.array(list(ID_CASES))}
    for case, cf in ID_CASES.items():
        d[f"ids/{case}"] = (np.minimum(rng.zipf(1.3, N_IDS) - 1, ROWS - 1)
                            if case.startswith("zipf")
                            else rng.integers(0, ROWS, N_IDS))
        d[f"cf/{case}"] = cf
    for s in range(STEPS):
        d[f"psum/{s}/w"] = rng.standard_normal((8, 64)).astype(np.float32)
        d[f"psum/{s}/b"] = (rng.standard_normal((8, 3, 5)) * 10 ** s) \
            .astype(np.float32)
    return d


def _moe_params(n_experts):
    jp, _ = JM.init_moe(jax.random.PRNGKey(n_experts), MOE_D, MOE_F,
                        n_experts, jnp.float32)
    return {k: np.array(v) for k, v in jp.items()}


def _moe_x():
    return np.random.default_rng(7).standard_normal((MOE_T, MOE_D)) \
        .astype(np.float32)


def _dlrm_case():
    cfg = dlrm_smoke()
    params = D.init_dlrm(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(3)
    b = 8
    dense = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes], 1)
    return cfg, params, dense, sparse


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 8-rank and the 4-rank worlds, run once;
    the JAX process runs beside the ranks."""
    tmp = tmp_path_factory.mktemp("spmd")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        grads = [{k: inp[f"psum/{s}/{k}"] for k in ("w", "b")}
                 for s in range(STEPS)]
        psum = run_spmd(R.psum_steps, (8,), ("pod",), device_type="cpu",
                        args=(grads, "pod"), timeout_s=TIMEOUT_S,
                        store_dir=str(tmp), threads=1)
        # the groups that do not split the tokens first: the last case
        # is the gradient's (tests/_spmd_ranks.py)
        moe = {**{name: (_moe_params(e), _moe_x()[:ONE_GROUP_T], 2, cf)
                  for name, (e, cf) in ONE_GROUP_CASES.items()},
               **{name: (_moe_params(e), _moe_x(), 2, cf)
                  for name, (e, cf) in MOE_CASES.items()}}
        dlrm = _dlrm_case()
        ids = {c: (inp[f"ids/{c}"], cf) for c, cf in ID_CASES.items()}
        world4 = run_spmd(R.world4, (2, 2), ("data", "model"),
                          device_type="cpu",
                          args=(inp["table"], ids, moe, dlrm),
                          timeout_s=TIMEOUT_S, store_dir=str(tmp), threads=1)
        _, err = jax_proc.communicate(timeout=TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, err
    return {"inp": inp, "jax": dict(np.load(tmp / "out.npz")), "psum": psum,
            "world4": world4, "moe": moe, "dlrm": dlrm}


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", range(STEPS))
def test_compressed_psum_matches_jax_on_8_ranks(runs, step):
    want = runs["jax"]
    for rank, (steps, _, _) in enumerate(runs["psum"]):
        mean, fb = steps[step]
        for k in ("w", "b"):
            ref = want[f"psum/{step}/mean/{k}"][rank:rank + 1]
            scale = np.abs(ref).max()
            assert np.abs(mean[k] - ref).max() <= 1e-6 * scale, (rank, k)
            # the residual is local arithmetic: bit for bit
            np.testing.assert_array_equal(
                fb[k], want[f"psum/{step}/fb/{k}"][rank:rank + 1])


def test_compressed_psum_mean_is_the_same_on_every_rank(runs):
    first = runs["psum"][0][0]
    for step in range(STEPS):
        for k in ("w", "b"):
            for steps, _, _ in runs["psum"][1:]:
                np.testing.assert_array_equal(steps[step][0][k],
                                              first[step][0][k])


@pytest.mark.parametrize("step", range(STEPS))
def test_compressed_psum_within_its_int8_bound(runs, step):
    """Against the plain float32 mean of what each rank sent (its
    gradient plus its residual): at most each rank's rounding to its own
    scale and the ranks' mean scale in its place (the bound of
    ``mesh_check.psum_error``), the bound the card's checks hold."""
    for rank, (_, _, over) in enumerate(runs["psum"]):
        assert over[step] <= 1.0, (rank, step, over)


def test_compressed_psum_needs_rules_over_an_spmd_mesh():
    from repro_torch.dist import default_rules, install_rules
    from repro_torch.dist.compat import AbstractMesh
    from repro_torch.optim import compressed_psum, init_error_feedback
    g = {"w": torch.ones(4)}
    with pytest.raises(ValueError, match="SPMD mesh"):
        compressed_psum(g, init_error_feedback(g), "pod")
    with install_rules(default_rules(AbstractMesh((8,), ("pod",)))):
        with pytest.raises(ValueError, match="SPMD mesh"):
            compressed_psum(g, init_error_feedback(g), "pod")


# ---------------------------------------------------------------------------
# sharded_lookup
# ---------------------------------------------------------------------------


def _group_of(key, rank):
    return {"2x2": rank // 2, "4_data": rank, "4_model": 0}[key]


@pytest.mark.parametrize("case", list(ID_CASES))
@pytest.mark.parametrize("key", list(LOOKUP_MESHES))
def test_sharded_lookup_equals_take_times_keep(runs, key, case):
    inp = runs["inp"]
    g = LOOKUP_MESHES[key]
    ids, cf = inp[f"ids/{case}"], ID_CASES[case]
    ng = N_IDS // g
    cap = int(max(4, cf * ng / 4))
    cap = -(-cap // 8) * 8
    dropped = 0
    for rank in range(4):
        gi = _group_of(key, rank)
        idg = ids[gi * ng:(gi + 1) * ng]
        keep = np.asarray(jax_bucket_group(jnp.asarray(idg, jnp.int32), 4,
                                           ROWS // 4, cap)[3])
        want = inp["table"][idg] * keep[:, None].astype(np.float32)
        np.testing.assert_array_equal(
            runs["world4"][rank][f"lookup/{key}/{case}"], want)
        dropped += int((~keep).sum())
    if case == "zipf_cf1":
        assert dropped                       # the case drops ids


@pytest.mark.parametrize("case", list(ID_CASES))
@pytest.mark.parametrize("key", list(LOOKUP_MESHES))
def test_sharded_lookup_matches_the_jax_sharded_lookup(runs, key, case):
    want = runs["jax"][f"lookup/{key}/{case}"]
    ng = N_IDS // LOOKUP_MESHES[key]
    for rank in range(4):
        gi = _group_of(key, rank)
        np.testing.assert_array_equal(
            runs["world4"][rank][f"lookup/{key}/{case}"],
            want[gi * ng:(gi + 1) * ng])


# ---------------------------------------------------------------------------
# moe_ffn on a (2, 2) world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_ffn_matches_jax_groups(runs, name):
    n_experts, cf = MOE_CASES[name]
    params, x, top_k, _ = runs["moe"][name]
    # expert parallelism: one group a data group; else one a device
    groups = 2 if n_experts % 2 == 0 else 4
    want, want_aux = JM.moe_ffn({k: jnp.asarray(v) for k, v in
                                 params.items()}, jnp.asarray(x),
                                top_k=top_k, capacity_factor=cf,
                                n_groups=groups)
    want = np.asarray(want)
    half = MOE_T // 2
    for rank in range(4):
        got, aux = runs["world4"][rank][f"moe/{name}"]
        g = rank // 2
        np.testing.assert_allclose(got, want[g * half:(g + 1) * half],
                                   rtol=2e-5, atol=2e-5)
        assert aux == pytest.approx(float(want_aux), rel=2e-5, abs=2e-5)
    if cf == 8.0:
        # no slot drops: any grouping gives the one-group result
        one, one_aux = JM.moe_ffn({k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(x),
                                  top_k=top_k, capacity_factor=cf,
                                  n_groups=1)
        got = np.concatenate([runs["world4"][r][f"moe/{name}"][0]
                              for r in (0, 2)])
        np.testing.assert_allclose(got, np.asarray(one), rtol=2e-5,
                                   atol=2e-5)
        assert runs["world4"][0][f"moe/{name}"][1] == pytest.approx(
            float(one_aux), rel=2e-5, abs=2e-5)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_ffn_model_ranks_agree(runs, name):
    """The two model ranks of a data group hold the same output, bit for
    bit (the gather replicates it)."""
    for g in (0, 1):
        a, b = (runs["world4"][2 * g + j][f"moe/{name}"] for j in (0, 1))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def test_moe_ffn_runs_one_group_where_the_groups_do_not_split(runs):
    """One token a data group and 5 experts: 4 dispatch groups, 2 a data
    group, do not split its token, so the mesh runs one group over both
    tokens, JAX's fallback for a T its groups do not divide: every rank's
    row, the aux loss and the gradient of ``sum(y^2) + aux`` (d/dx of the
    rank's row; each parameter's summed over the two data groups) against
    JAX's ``moe_ffn(..., n_groups=4)`` within rtol = atol = 2e-5."""
    params, x, top_k, cf = runs["moe"]["one_group_E5"]
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def loss(p, xx):
        y, aux = JM.moe_ffn(p, xx, top_k=top_k, capacity_factor=cf,
                            n_groups=4)
        return jnp.sum(jnp.square(y)) + aux, (y, aux)

    (want, (y, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    ranks = [runs["world4"][r] for r in range(4)]
    for rank, r in enumerate(ranks):
        g = rank // 2
        got, got_aux = r["moe/one_group_E5"]
        np.testing.assert_allclose(got, np.asarray(y)[g:g + 1], rtol=2e-5,
                                   atol=2e-5)
        assert got_aux == pytest.approx(float(aux), rel=2e-5, abs=2e-5)
        l, g_x, _ = r["moe_one_group_grad"]
        assert l == pytest.approx(float(want), rel=2e-5)
        np.testing.assert_allclose(g_x, np.asarray(gx)[g:g + 1], rtol=2e-5,
                                   atol=2e-5)
    for k in params:
        np.testing.assert_allclose(
            ranks[0]["moe_one_group_grad"][2][k]
            + ranks[2]["moe_one_group_grad"][2][k], np.asarray(gp[k]),
            rtol=2e-5, atol=2e-5, err_msg=k)


def test_moe_ffn_under_an_spmd_mesh_refuses_a_gradient(runs):
    """(The name is the forward-only FFN's.)  Under the (2, 2) mesh the
    FFN now takes a gradient: ``sum(y^2)`` over every token plus the aux
    loss, with 5 experts (each model rank routes half of its data group's
    tokens through whole weights) at capacity factor 8 (no slot drops),
    against ``jax.grad`` of the same loss in one group: every rank's loss,
    its rows of d/dx, and each parameter's gradient summed over the two
    data groups (the caller's sum; the model ranks of a group hold the
    same) within rtol = atol = 2e-5."""
    params, x, top_k, cf = runs["moe"]["E5_cf8.0"]

    def loss(p, xx):
        y, aux = JM.moe_ffn(p, xx, top_k=top_k, capacity_factor=cf,
                            n_groups=1)
        return jnp.sum(jnp.square(y)) + aux

    want, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    half = MOE_T // 2
    ranks = [runs["world4"][r]["moe_grad"] for r in range(4)]
    for rank, (got, g_x, _) in enumerate(ranks):
        assert got == pytest.approx(float(want), rel=2e-5)
        g = rank // 2
        np.testing.assert_allclose(g_x, np.asarray(gx)[g * half:
                                                       (g + 1) * half],
                                   rtol=2e-5, atol=2e-5)
    for k in params:
        np.testing.assert_array_equal(ranks[0][2][k], ranks[1][2][k])
        np.testing.assert_allclose(ranks[0][2][k] + ranks[2][2][k],
                                   np.asarray(gp[k]), rtol=2e-5, atol=2e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# DLRM with rules installed
# ---------------------------------------------------------------------------


def test_dlrm_forward_with_rules_matches_one_device(runs):
    cfg, params, dense, sparse = runs["dlrm"]
    want = D.dlrm_forward(params, cfg, torch.from_numpy(dense),
                          torch.from_numpy(sparse)).numpy()
    half = len(dense) // 2
    for rank in range(4):
        g = rank // 2
        np.testing.assert_allclose(runs["world4"][rank]["dlrm"],
                                   want[g * half:(g + 1) * half],
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# run_spmd itself
# ---------------------------------------------------------------------------


def test_run_spmd_raises_a_ranks_failure(tmp_path):
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        run_spmd(R.fails, (2,), ("data",), device_type="cpu",
                 timeout_s=60, store_dir=str(tmp_path), threads=1)


def test_run_spmd_kills_ranks_past_its_timeout(tmp_path):
    with pytest.raises(TimeoutError):
        run_spmd(R.sleeps, (2,), ("data",), device_type="cpu",
                 args=(600,), timeout_s=8, store_dir=str(tmp_path),
                 threads=1)
    assert not list(tmp_path.iterdir())      # its store is gone too


def test_spmd_mesh_groups_and_coordinates(runs, tmp_path):
    got = run_spmd(R.coordinates, (2, 2), ("data", "model"),
                   device_type="cpu", timeout_s=60, store_dir=str(tmp_path),
                   threads=1)
    for rank, coords in enumerate(got):
        d, m = divmod(rank, 2)
        assert coords["data"] == (d, [m, m + 2])
        assert coords["model"] == (m, [2 * d, 2 * d + 1])
        assert coords[("data", "model")] == (rank, [0, 1, 2, 3])
    # (2, 2, 2): the groups of two axes of three are made at build
    for rank, (_, coords, _) in enumerate(runs["psum"]):
        p, d, m = rank // 4, rank // 2 % 2, rank % 2
        assert coords["pod"] == (p, [d * 2 + m, 4 + d * 2 + m])
        assert coords[("pod", "data")] == (
            2 * p + d, [m, 2 + m, 4 + m, 6 + m])
        assert coords[("data", "model")] == (2 * d + m, [4 * p + i
                                                         for i in range(4)])
        assert coords[("pod", "data", "model")] == (rank, list(range(8)))
