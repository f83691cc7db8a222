"""DimeNet's edge-sharded route (``models.gnn.dimenet_spmd``) on gloo
ranks on the CPU, against single-device JAX: a world of 4 over a (2, 2)
``data`` x ``model`` mesh and a (4,) ``data`` mesh, and a world of 2 over
a (2,) ``model`` mesh, each rank holding its blocks under
``default_rules`` (the GNN cell's specs: edges and triplets over every
axis, node features over ``table_rows``, params under ``dimenet_axes``).

* ``dimenet_forward`` (a rank's share of the node rows; the energies
  whole), ``node_cls_loss`` / ``energy_loss`` and every gradient leaf
  (gathered whole) against ``repro.models.gnn.dimenet`` and
  ``jax.value_and_grad`` on the same seeded graphs and JAX's weights
  (carried by ``bridge``): features with node classification and
  molecules with energies, the blocked triplet layout and a shuffled
  one through the unblocked path (``blocked_triplets=False``), a masked
  loss over 131 nodes (which no world divides, so ``node_feat`` stays
  whole) and 130 nodes (cut over ``data`` alone on (2, 2): the ``model``
  ranks of a data group embed the same rows).  rtol = atol = 2e-5 in
  float32, the atol of an output or a gradient leaf taken of its largest
  |value| where that exceeds 1 (:func:`_close`): random weights drive
  the logits to ~100, where the one-process port's sit up to 1.7 x 2e-5
  from JAX's element by element, and the energy task's gradients far
  above, where JAX's own float32 gradient sits up to 527 x 2e-5 from a
  float64 one (``test_torch_dimenet`` holds both within 2e-5 of the
  largest).
* bf16 compute: the route's logits within twice JAX's own bf16-versus-
  float32 distance of JAX's float32 ones (the bound of
  ``test_torch_dimenet.test_forward_bf16_within_twice_jax_rounding``).
* On (2, 2): one AdamW step of the GNN cell (``launch.steps``; the smoke
  config at ``full_graph_sm``, its graph cut 20) against JAX's
  ``value_and_grad`` + ``adam_update``, the parameters compared above
  rounding (``tools/cell_check.ROUNDING_FLOOR``); the remat backward on a
  thread with no rules installed; and the refusals: rules that cut the
  edges over ``data`` alone, whole params, whole node features.

The ranks start once a world (``launch.mesh.run_spmd``: spawn, a
``FileStore`` under ``tmp_path``, a timeout that kills them)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _spmd_gnn_ranks as R
from repro.configs import dimenet as JC
from repro.models.gnn import dimenet as JD
from repro.optim.adam import OptimizerConfig as JOptimizerConfig
from repro.optim.adam import adam_update as jax_adam_update
from repro.optim.adam import init_opt_state as jax_init_opt_state
from repro_torch import bridge
from repro_torch.data import graphs as TG
from repro_torch.dist import default_rules
from repro_torch.dist.compat import AbstractMesh
from repro_torch.dist.sharding import divisible_spec
from repro_torch.launch.mesh import run_spmd
from repro_torch.tools.cell_check import ROUNDING_FLOOR, _held
from repro_torch.tree import leaves_with_paths, tree_map

TIMEOUT_S = 300
TOL = dict(rtol=2e-5, atol=2e-5)
ONE = default_rules(AbstractMesh((1, 1), ("data", "model")))
KEYS = ("node_feat", "positions", "edge_src", "edge_dst", "edge_valid",
        "trip_kj", "trip_ji", "trip_valid")
# case -> (task, d_feat, blocked layout, compute dtype)
CASES = {"feat_blocked": ("node_cls", 16, True, torch.float32),
         "feat_unblocked": ("node_cls", 16, False, torch.float32),
         "feat_odd_masked": ("node_cls", 16, True, torch.float32),
         "feat_data_rows": ("node_cls", 16, True, torch.float32),
         "energy_blocked": ("energy", 0, True, torch.float32),
         "energy_unblocked": ("energy", 0, False, torch.float32),
         "feat_bf16": ("node_cls", 16, True, torch.bfloat16)}
F32 = [k for k, v in CASES.items() if v[3] == torch.float32]
MESHES = [(world, key) for world, ms in R.MESHES.items() for key in ms]


def _graph(name):
    """The case's graph as a dict of numpy arrays: 128 nodes and 512 edges
    with 16 features, 131 nodes with a label mask, 130 nodes, or 6
    molecules of 12 atoms and 24 edges; fanout cap 4; the unblocked
    cases' triplet slots shuffled."""
    rng = np.random.default_rng(7)
    if name.startswith("energy"):
        g = TG.make_molecule_batch(6, 12, 24, fanout_cap=4, seed=2)
    elif name == "feat_odd_masked":
        g = TG.make_graph_batch(131, 512, d_feat=16, fanout_cap=4,
                                n_classes=8, seed=1)
    elif name == "feat_data_rows":
        g = TG.make_graph_batch(130, 512, d_feat=16, fanout_cap=4,
                                n_classes=8, seed=3)
    else:
        g = TG.make_graph_batch(128, 512, d_feat=16, fanout_cap=4,
                                n_classes=8, seed=0)
    b = {k: getattr(g, k) for k in (*KEYS, "labels")}
    if g.graph_ids is not None:
        b["graph_ids"] = g.graph_ids
    if name == "feat_odd_masked":
        b["label_mask"] = (rng.random(131) < 0.6).astype(np.float32)
    if name.endswith("unblocked"):
        perm = rng.permutation(len(g.trip_kj))
        for k in ("trip_kj", "trip_ji", "trip_valid"):
            b[k] = b[k][perm]
    return b


def _jax_cfg(task, d_feat, blocked, dtype):
    return dataclasses.replace(
        JC.smoke_config(), **R.SMALL, task=task, d_feat=d_feat,
        blocked_triplets=blocked,
        compute_dtype=jnp.bfloat16 if dtype == torch.bfloat16
        else jnp.float32)


def _jax_forward(params, cfg, b):
    kw = {k: b[k] for k in KEYS}
    if cfg.task == "energy":
        kw.update(graph_ids=b["graph_ids"], n_graphs=int(b["labels"].shape[0]))
    return jax.jit(lambda p: JD.dimenet_forward(p, cfg, **kw))(params)


def _jax_loss(cfg):
    return JD.energy_loss if cfg.task == "energy" else JD.node_cls_loss


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cases():
    """Per case: JAX's params and config, and the numpy params and graph
    the ranks take."""
    cases, jax_side = {}, {}
    for i, (name, (task, d_feat, blocked, dtype)) in enumerate(CASES.items()):
        jcfg = _jax_cfg(task, d_feat, blocked, dtype)
        pj, _ = JD.init_dimenet(jax.random.PRNGKey(i), jcfg)
        pj = jax.tree.map(np.asarray, pj)
        params = tree_map(lambda t: t.numpy(), bridge.dimenet_params_from_jax(
            pj, R.config(task, d_feat, blocked), device="cpu"))
        b = _graph(name)
        cases[name] = (task, d_feat, blocked, dtype, params, b)
        jax_side[name] = (jcfg, pj)
    return cases, jax_side


def _references(cases, jax_side):
    """Per case JAX's float32 forward, loss and gradient (bf16: its
    forward at bf16 and at float32)."""
    want = {}
    for name, (jcfg, pj) in jax_side.items():
        bj = {k: jnp.asarray(v) for k, v in cases[name][5].items()}
        if jcfg.compute_dtype == jnp.bfloat16:
            j32 = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
            want[name] = {"forward": _f32(_jax_forward(pj, j32, bj)),
                          "forward_bf16": _f32(_jax_forward(pj, jcfg, bj))}
            continue
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: _jax_loss(jcfg)(p, jcfg, bj)))(pj)
        want[name] = {"forward": _f32(_jax_forward(pj, jcfg, bj)),
                      "loss": float(loss),
                      "grads": dict(leaves_with_paths(
                          jax.tree.map(np.asarray, grads)))}
    return want


def _jax_train_step():
    """The GNN cell's AdamW step in JAX on the cell's own seeded args (one
    process): (loss, grad_norm, params, gradient)."""
    c = R.cell(ONE)
    state, batch = R.cell_inputs(c)
    tcfg = _cell_cfg()
    jcfg = dataclasses.replace(JC.smoke_config(), d_feat=tcfg.d_feat,
                               n_classes=tcfg.n_classes, task=tcfg.task,
                               compute_dtype=jnp.float32)
    pj = tree_map(lambda x: jnp.asarray(x.numpy()), state["params"])
    bj = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    opt_cfg = JOptimizerConfig()

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(
            lambda q: JD.node_cls_loss(q, jcfg, bj))(p)
        params, _, gn = jax_adam_update(grads, jax_init_opt_state(p, opt_cfg),
                                        p, opt_cfg, lr=opt_cfg.lr)
        return loss, gn, params, grads

    loss, gn, params, grads = step(pj)
    np_tree = lambda t: dict(leaves_with_paths(jax.tree.map(np.asarray, t)))
    return float(loss), float(gn), np_tree(params), np_tree(grads)


def _cell_cfg():
    from repro_torch.configs import dimenet as DC
    from repro_torch.launch.steps import gnn_cell_config

    spec = DC.spec()
    spec = dataclasses.replace(spec, config=spec.smoke)
    return gnn_cell_config(spec, R.CELL[0], R.CELL[1]).cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks run while this process computes JAX's side."""
    from concurrent.futures import ThreadPoolExecutor

    cases, jax_side = _cases()

    def spawn(world):
        shape, names = next(iter(R.MESHES[world].values()))
        return run_spmd(R.world, shape, names, device_type="cpu",
                        args=(cases,), timeout_s=TIMEOUT_S,
                        store_dir=str(tmp_path_factory.mktemp(
                            f"gnn_spmd_{world}")), threads=1)

    with ThreadPoolExecutor(len(R.MESHES)) as pool:
        futures = {w: pool.submit(spawn, w) for w in R.MESHES}
        want = _references(cases, jax_side)
        train = _jax_train_step()
        got = {}
        for world, f in futures.items():
            res = f.result()
            for key in R.MESHES[world]:
                got[world, key] = [r[key] for r in res]
    return {"got": got, "want": want, "train": train}


def _close(got, want, err_msg="", scale=None):
    """rtol = atol = 2e-5, atol times max(1, max|want|) (or ``scale``)."""
    if scale is None:
        scale = float(np.abs(want).max())
    scale = max(1.0, scale)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale, err_msg=err_msg)


def _ids(pairs):
    return [f"{w}ranks-{k}" for w, k in pairs]


@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
@pytest.mark.parametrize("case", F32)
def test_forward_matches_jax(runs, mesh, case):
    """Each rank's share of the node logits (or the whole energies)."""
    want = runs["want"][case]["forward"]
    covered = 0
    for r in runs["got"][mesh]:
        got = r[case]
        if CASES[case][0] == "energy":
            _close(got["forward"], want)
            continue
        start, n = got["rows"]
        assert got["forward"].shape == (n, want.shape[1])
        _close(got["forward"], want[start:start + n],
               scale=float(np.abs(want).max()))
        covered += n
    if CASES[case][0] != "energy":
        assert covered == len(want)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
@pytest.mark.parametrize("case", F32)
def test_loss_matches_jax_on_every_rank(runs, mesh, case):
    for r in runs["got"][mesh]:
        np.testing.assert_allclose(r[case]["loss"],
                                   runs["want"][case]["loss"], **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
@pytest.mark.parametrize("case", F32)
def test_gradient_matches_jax(runs, mesh, case):
    """Every leaf of the gradient, gathered whole from the ranks' blocks
    (each rank's block the sum over every rank's edges and nodes)."""
    want = runs["want"][case]["grads"]
    for r in runs["got"][mesh]:
        got = dict(leaves_with_paths(r[case]["grads"]))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            _close(got[k], w, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_bf16_forward_within_twice_jax_rounding(runs, mesh):
    want = runs["want"]["feat_bf16"]
    rounding = np.abs(want["forward_bf16"] - want["forward"]).max()
    for r in runs["got"][mesh]:
        start, n = r["feat_bf16"]["rows"]
        apart = np.abs(r["feat_bf16"]["forward"]
                       - want["forward"][start:start + n]).max()
        assert 0 < apart <= 2 * rounding, (apart, rounding)


def test_node_feat_stays_whole_where_the_world_does_not_divide(runs):
    """131 nodes: ``divisible_spec`` leaves ``node_feat`` whole on every
    mesh, 128 cut it over every axis, 130 over ``data`` alone on (2, 2);
    the heads' shares cover the nodes in every case."""
    for world, key in MESHES:
        shape, names = R.MESHES[world][key]
        rules = default_rules(AbstractMesh(shape, names))
        cut = lambda n: divisible_spec(rules, ("table_rows", None),
                                       (n, 16))[0]
        assert cut(131) is None
        assert cut(128) == (names[0] if len(names) == 1 else names)
        if key == "2x2":
            assert cut(130) == "data"
        for case, n in (("feat_odd_masked", 131), ("feat_data_rows", 130),
                        ("feat_blocked", 128)):
            rows = [r[case]["rows"] for r in runs["got"][world, key]]
            assert sum(k for _, k in rows) == n


def test_cell_adamw_step_matches_jax(runs):
    """One AdamW step of the GNN cell on (2, 2) against JAX's: the loss,
    ``grad_norm`` (summed over the ranks' blocks) and every updated
    parameter, gathered whole, where its gradient lies above rounding."""
    loss, gn, params, grads = runs["train"]
    held = dict(zip(grads, _held([(k, torch.from_numpy(np.array(g)))
                                  for k, g in grads.items()])))
    assert ROUNDING_FLOOR == 1e-3
    n_held = 0
    for r in runs["got"][4, "2x2"]:
        got_loss, got_gn, got_params = r["train_step"]
        np.testing.assert_allclose(got_loss, loss, **TOL)
        np.testing.assert_allclose(got_gn, gn, **TOL)
        got = dict(leaves_with_paths(got_params))
        assert sorted(got) == sorted(params)
        for k, w in params.items():
            if held[k] is None:
                continue
            m = held[k].numpy()
            n_held += 1
            np.testing.assert_allclose(got[k][m], w[m], **TOL, err_msg=k)
    assert n_held >= 4 * (len(params) - 2)


def test_remat_backward_on_another_thread_recomputes_under_the_rules(runs):
    """Autograd runs the backward pass on its own thread on the card; each
    interaction block's recomputation (its all-gather of the messages
    among it) runs under the rules it was made with, so the gradient
    equals the one from this thread on every rank."""
    for r in runs["got"][4, "2x2"]:
        assert r["grad_thread"] == 0.0, r["grad_thread"]


@pytest.mark.parametrize("refusal", ["edges_over_data", "whole_params",
                                     "whole_node_feat"])
def test_the_route_refuses_what_it_cannot_honour(runs, refusal):
    """Rules that leave ``model`` out of the edges' cut, params or node
    features whole where the rules cut them: every rank raises, none runs
    one process's arithmetic on its block."""
    for r in runs["got"][4, "2x2"]:
        err = r["refusals"][refusal]
        assert err is not None, refusal
        if refusal == "edges_over_data":
            assert "every mesh axis" in err
