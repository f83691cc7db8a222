"""The port's DimeNet slice against the JAX package on the CPU: the graph
generators, triplet enumeration and neighbour sampler array-equal to
``repro.data.graphs``; the geometry bases, ``dimenet_forward`` (node
classification with features and with atom types, the energy task, both
triplet-aggregation branches, smoke and full widths, float32 and bf16),
the losses and their gradients, remat, one ``gnn_train_step`` against
``jax.value_and_grad`` + ``repro.optim.adam_update``, the cell table and
FLOPs of ``repro.launch.steps``, ``init_dimenet``'s tree and the weight
bridge.

JAX's weights cross by ``bridge.dimenet_params_from_jax``.  Limits scale
to the data (random weights drive logits to ~1e3-1e4 through the
envelope's 1/d term): float32 outputs within 1e-5 of max|jax|, each
gradient leaf within 2e-5 of that leaf's max|jax| (both packages sit
~1e-5 from a float64 run there), bf16 logits within twice JAX's own
bf16-versus-float32 distance."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as JC
from repro.data import graphs as JG
from repro.launch import steps as JS
from repro.models.gnn import dimenet as JD
from repro.optim.adam import OptimizerConfig as JOptimizerConfig
from repro.optim.adam import adam_update as jax_adam_update
from repro.optim.adam import init_opt_state as jax_init_opt_state
from repro_torch import bridge
from repro_torch.configs import dimenet as TC
from repro_torch.data import graphs as TG
from repro_torch.launch import steps as TS
from repro_torch.models.gnn import dimenet as TD
from repro_torch.optim import OptimizerConfig, init_opt_state, value_and_grad
from repro_torch.tree import leaves_with_paths

F32_REL, GRAD_REL = 1e-5, 2e-5
KEYS = ("node_feat", "positions", "edge_src", "edge_dst", "edge_valid",
        "trip_kj", "trip_ji", "trip_valid")
CFGS = {"smoke": (JC.smoke_config, TC.smoke_config),
        "full": (JC.full_config, TC.full_config)}


def _cfgs(width="smoke", **kw):
    """The JAX and port configs of ``width`` with the same overrides
    (``compute_dtype`` given as a torch dtype)."""
    cd = kw.pop("compute_dtype", torch.float32)
    j, t = (f() for f in CFGS[width])
    jcd = jnp.bfloat16 if cd == torch.bfloat16 else jnp.float32
    return (dataclasses.replace(j, compute_dtype=jcd, **kw),
            dataclasses.replace(t, compute_dtype=cd, **kw))


def _params(cfg_j, cfg_t, seed=0):
    pj, _ = JD.init_dimenet(jax.random.PRNGKey(seed), cfg_j)
    return pj, bridge.dimenet_params_from_jax(
        jax.tree.map(np.asarray, pj), cfg_t, device="cpu")


def _batches(g: TG.GraphBatch):
    """The same graph as JAX arrays and as the port's CPU tensors."""
    bj = {k: jnp.asarray(getattr(g, k)) for k in (*KEYS, "labels")}
    if g.graph_ids is not None:
        bj["graph_ids"] = jnp.asarray(g.graph_ids)
    return bj, TG.graph_batch_tensors(g, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    """max|got - want| / max|want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fwd_j(params, cfg, b):
    kw = {k: b[k] for k in KEYS}
    if cfg.task == "energy":
        kw.update(graph_ids=b["graph_ids"], n_graphs=int(b["labels"].shape[0]))
    return jax.jit(lambda p: JD.dimenet_forward(p, cfg, **kw))(params)


def _fwd_t(params, cfg, b):
    kw = {k: b[k] for k in KEYS}
    if cfg.task == "energy":
        kw.update(graph_ids=b["graph_ids"], n_graphs=b["labels"].shape[0])
    with torch.no_grad():
        return TD.dimenet_forward(params, cfg, **kw)


def _graph(kind, seed=0):
    if kind == "energy":
        return TG.make_molecule_batch(6, 12, 24, fanout_cap=4, seed=seed)
    return TG.make_graph_batch(60, 300, d_feat=16 if kind == "feat" else 0,
                               fanout_cap=4, n_classes=8, seed=seed)


def _task_kw(kind):
    return {"feat": {"d_feat": 16}, "atoms": {},
            "energy": {"task": "energy"}}[kind]


# ---------------------------------------------------------------------------
# Data: array-equal to repro.data.graphs
# ---------------------------------------------------------------------------


def _same_batch(got: TG.GraphBatch, want: JG.GraphBatch):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.mark.parametrize("d_feat", [0, 16])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_graph_batch_equals_jax(d_feat, seed):
    _same_batch(TG.make_graph_batch(80, 400, d_feat=d_feat, fanout_cap=4,
                                    n_classes=8, seed=seed),
                JG.make_graph_batch(80, 400, d_feat=d_feat, fanout_cap=4,
                                    n_classes=8, seed=seed))


def test_make_molecule_batch_equals_jax():
    _same_batch(TG.make_molecule_batch(8, 15, 32, fanout_cap=8, seed=2),
                JG.make_molecule_batch(8, 15, 32, fanout_cap=8, seed=2))


def test_build_triplets_equals_jax_where_the_cap_bites():
    """A dense graph (in-degree ~20 against a cap of 4): the cap's
    ``rng.choice`` draws, edge by edge, pick the same triplets."""
    _, _, src, dst, _ = JG.random_graph(50, 1000, seed=1)
    got = TG.build_triplets(src, dst, 4, seed=5)
    want = JG.build_triplets(src, dst, 4, seed=5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    in_deg = np.bincount(dst, minlength=50)[src]
    assert (in_deg > 8).all() and got[2].all()       # every edge capped
    # the blocked layout: edge e's triplets in slots [4e, 4e + 4)
    assert np.array_equal(got[1], np.repeat(np.arange(1000), 4))


def test_neighbor_sampler_equals_jax():
    """Two samples in turn (the sampler's rng advances) at fanouts that
    bite on some nodes and not on others; the CSR arrays too."""
    _, _, src, dst, _ = JG.random_graph(500, 3000, seed=2)
    got, want = (m.NeighborSampler(src, dst, 500, seed=7) for m in (TG, JG))
    assert np.array_equal(got.nbr, want.nbr)
    assert np.array_equal(got.starts, want.starts)
    for seeds in (np.arange(16), np.arange(100, 132)):
        a, b = got.sample(seeds, (8, 4)), want.sample(seeds, (8, 4))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert np.array_equal(a[2][:len(seeds)], seeds)   # seeds first


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_stable_argsort_is_numpys(dtype):
    keys = np.random.default_rng(0).integers(0, 37, 20000).astype(dtype)
    assert np.array_equal(TG._stable_argsort(keys),
                          np.argsort(keys, kind="stable"))


def test_graph_batch_tensors_types():
    b = TG.graph_batch_tensors(_graph("energy"), device="cpu")
    assert set(b) == {*KEYS, "labels", "graph_ids"}
    for k in ("node_feat", "edge_src", "edge_dst", "trip_kj", "trip_ji",
              "graph_ids"):
        assert b[k].dtype == torch.int64, k
    for k in ("edge_valid", "trip_valid"):
        assert b[k].dtype == torch.bool, k
    assert b["positions"].dtype == b["labels"].dtype == torch.float32
    b = TG.graph_batch_tensors(_graph("feat"), device="cpu")
    assert "graph_ids" not in b and b["node_feat"].dtype == torch.float32
    assert b["labels"].dtype == torch.int64


def test_graph_batch_tensors_and_init_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.graph_batch_tensors(_graph("feat"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.init_dimenet(TC.smoke_config(), torch.Generator())


# ---------------------------------------------------------------------------
# Geometry bases
# ---------------------------------------------------------------------------


def test_bases_match_jax():
    """On a graph's edges and triplets, with distances spread past the
    cutoff and two near 0 (where the envelope's 1/d is huge)."""
    g = _graph("atoms")
    pos = g.positions.copy()
    pos[g.edge_dst[:2]] = pos[g.edge_src[:2]] + np.float32(1e-4)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    js, jd = jnp.asarray(g.edge_src), jnp.asarray(g.edge_dst)
    ts, td = (torch.from_numpy(a).long() for a in (g.edge_src, g.edge_dst))
    d_j, u_j = JD.edge_geometry(jpos, js, jd)
    d_t, u_t = TD.edge_geometry(tpos, ts, td)
    assert float(d_j.min()) < 1e-3 and float(d_j.max()) > 5.0
    assert _rel(d_t, d_j) <= F32_REL and _rel(u_t, u_j) <= F32_REL
    ds = np.linspace(0.0, 1.5, 301, dtype=np.float32)
    assert _rel(TD.envelope(torch.from_numpy(ds[1:]), 6),
                JD.envelope(jnp.asarray(ds[1:]), 6)) <= F32_REL
    assert _rel(TD.radial_basis(d_t, 6, 5.0, 6),
                JD.radial_basis(d_j, 6, 5.0, 6)) <= F32_REL
    kj, ji = jnp.asarray(g.trip_kj), jnp.asarray(g.trip_ji)
    tkj, tji = (torch.from_numpy(a).long() for a in (g.trip_kj, g.trip_ji))
    a_j = JD.triplet_angles(u_j, kj, ji)
    a_t = TD.triplet_angles(u_t, tkj, tji)
    assert _rel(a_t, a_j) <= F32_REL
    assert _rel(TD.spherical_basis(d_t[tkj], a_t, 7, 6, 5.0, 6),
                JD.spherical_basis(d_j[kj], a_j, 7, 6, 5.0, 6)) <= F32_REL


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

FORWARD_CASES = [("smoke", "feat", True), ("smoke", "feat", False),
                 ("smoke", "atoms", True), ("smoke", "atoms", False),
                 ("smoke", "energy", True), ("smoke", "energy", False),
                 ("full", "feat", True), ("full", "feat", False),
                 ("full", "energy", True)]


@pytest.mark.parametrize("width,kind,blocked", FORWARD_CASES)
def test_forward_matches_jax(width, kind, blocked):
    cfg_j, cfg_t = _cfgs(width, blocked_triplets=blocked, **_task_kw(kind))
    pj, pt = _params(cfg_j, cfg_t)
    bj, bt = _batches(_graph(kind))
    want, got = _fwd_j(pj, cfg_j, bj), _fwd_t(pt, cfg_t, bt)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= F32_REL


def test_forward_unblocked_layout_sums_by_index():
    """Triplets in a shuffled order (trip_ji no longer t // cap): only the
    index branch is right, in both packages."""
    g = _graph("feat")
    perm = np.random.default_rng(0).permutation(len(g.trip_kj))
    g = dataclasses.replace(g, trip_kj=g.trip_kj[perm],
                            trip_ji=g.trip_ji[perm],
                            trip_valid=g.trip_valid[perm])
    cfg_j, cfg_t = _cfgs(d_feat=16, blocked_triplets=False)
    pj, pt = _params(cfg_j, cfg_t)
    bj, bt = _batches(g)
    assert _rel(_fwd_t(pt, cfg_t, bt), _fwd_j(pj, cfg_j, bj)) <= F32_REL


@pytest.mark.parametrize("kind", ["feat", "atoms"])
def test_forward_bf16_within_twice_jax_rounding(kind):
    """bf16 compute (float32 params and bases), node classification: the
    port's distance from JAX's float32 logits within twice JAX's own
    bf16-vs-float32 one, over 480 logits.  (The energy task's handful of
    per-graph sums of ~1e5 node terms is too few for a max to compare:
    over 6-128 molecules the port's and JAX's bf16 distances differ by
    0.45-5x either way, the six blocks amplifying single roundings.)"""
    cfg_j, cfg_t = _cfgs("full", **_task_kw(kind))
    cfg_jb, cfg_tb = _cfgs("full", compute_dtype=torch.bfloat16,
                           **_task_kw(kind))
    pj, pt = _params(cfg_j, cfg_t)
    bj, bt = _batches(_graph(kind))
    want32 = _np(_fwd_j(pj, cfg_j, bj))
    rounding = np.abs(_np(_fwd_j(pj, cfg_jb, bj)) - want32).max()
    got = _fwd_t(pt, cfg_tb, bt)
    assert got.dtype == torch.bfloat16
    assert 0 < np.abs(_np(got) - want32).max() <= 2 * rounding


# ---------------------------------------------------------------------------
# Losses, gradients, remat, the training step
# ---------------------------------------------------------------------------


def _grads_close(got, want):
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, want)))
    got = dict(leaves_with_paths(got))
    assert set(got) == set(want)
    for k, g in got.items():
        scale = np.abs(want[k]).max()
        err = np.abs(_np(g) - want[k]).max()
        assert err <= GRAD_REL * scale, (k, err, scale)


def _loss_fns(kind):
    return (JD.energy_loss, TD.energy_loss) if kind == "energy" \
        else (JD.node_cls_loss, TD.node_cls_loss)


@pytest.mark.parametrize("kind,masked", [("feat", False), ("feat", True),
                                         ("atoms", True),
                                         ("energy", False)])
def test_loss_and_grads_match_jax(kind, masked):
    cfg_j, cfg_t = _cfgs(**_task_kw(kind))
    pj, pt = _params(cfg_j, cfg_t)
    bj, bt = _batches(_graph(kind))
    if masked:
        mask = np.random.default_rng(1).random(bt["labels"].shape[0]) < 0.3
        bj["label_mask"], bt["label_mask"] = jnp.asarray(mask), \
            torch.from_numpy(mask)
    jl, tl = _loss_fns(kind)
    lj, gj = jax.jit(jax.value_and_grad(lambda p: jl(p, cfg_j, bj)))(pj)
    lt, gt = value_and_grad(lambda p: tl(p, cfg_t, bt), pt)
    assert abs(float(lt) - float(lj)) <= GRAD_REL * abs(float(lj))
    _grads_close(gt, gj)


def test_sampled_subgraph_loss_matches_jax():
    """The minibatch_lg pipeline at a small size: a sampled subgraph's
    triplets, the loss masked to the seed nodes the sampler puts first."""
    feat, pos, src, dst, labels = JG.random_graph(300, 2400, d_feat=8,
                                                  n_classes=8, seed=0)
    ssrc, sdst, node_map = TG.NeighborSampler(src, dst, 300).sample(
        np.arange(12), (6, 3))
    t_kj, t_ji, t_valid = TG.build_triplets(ssrc, sdst, fanout_cap=4)
    g = TG.GraphBatch(feat[node_map], pos[node_map], ssrc, sdst,
                      np.ones(len(ssrc), bool), t_kj, t_ji, t_valid,
                      labels[node_map])
    mask = np.arange(len(node_map)) < 12
    cfg_j, cfg_t = _cfgs(d_feat=8)
    pj, pt = _params(cfg_j, cfg_t)
    bj, bt = _batches(g)
    bj["label_mask"], bt["label_mask"] = jnp.asarray(mask), \
        torch.from_numpy(mask)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: JD.node_cls_loss(p, cfg_j, bj)))(pj)
    lt, gt = value_and_grad(lambda p: TD.node_cls_loss(p, cfg_t, bt), pt)
    assert abs(float(lt) - float(lj)) <= GRAD_REL * abs(float(lj))
    _grads_close(gt, gj)


@pytest.mark.parametrize("kind", ["feat", "energy"])
def test_remat_gradients_bit_equal(kind, monkeypatch):
    """Each block runs under torch.utils.checkpoint when grad is enabled
    (once per block), and its gradients are those of the block run
    without it, bit for bit."""
    _, cfg_t = _cfgs(**_task_kw(kind))
    pt = TD.init_dimenet(cfg_t, torch.Generator().manual_seed(0),
                         device="cpu")
    bt = TG.graph_batch_tensors(_graph(kind), device="cpu")
    loss = _loss_fns(kind)[1]
    calls = []
    real = TD.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TD, "checkpoint", counting)
    l_r, g_r = value_and_grad(lambda p: loss(p, cfg_t, bt), pt)
    assert calls == [{"use_reentrant": False}] * cfg_t.n_blocks
    monkeypatch.setattr(TD, "checkpoint", lambda fn, *a, **kw: fn(*a))
    l_p, g_p = value_and_grad(lambda p: loss(p, cfg_t, bt), pt)
    assert torch.equal(l_r, l_p)
    for (k, a), (_, b) in zip(leaves_with_paths(g_r), leaves_with_paths(g_p)):
        assert torch.equal(a, b), k
    with torch.no_grad():
        calls.clear()
        monkeypatch.setattr(TD, "checkpoint", counting)
        loss(pt, cfg_t, bt)
    assert not calls                      # no remat without grad


@pytest.mark.parametrize("kind", ["feat", "energy"])
def test_gnn_train_step_matches_jax(kind):
    """One step: the loss and gradient norm, then the params and AdamW
    moments, against jax.value_and_grad + repro.optim.adam_update at
    OptimizerConfig()'s defaults."""
    cfg_j, cfg_t = _cfgs(**_task_kw(kind))
    pj, pt = _params(cfg_j, cfg_t)
    bj, bt = _batches(_graph(kind))
    jl = _loss_fns(kind)[0]
    jcfg, tcfg = JOptimizerConfig(), OptimizerConfig()
    lj, gj = jax.jit(jax.value_and_grad(lambda p: jl(p, cfg_j, bj)))(pj)
    pj2, oj2, gnj = jax_adam_update(gj, jax_init_opt_state(pj, jcfg), pj,
                                    jcfg, lr=jcfg.lr)
    pt2, ot2, out = TS.gnn_train_step(pt, init_opt_state(pt, tcfg), cfg_t,
                                      tcfg, bt)
    assert abs(float(out["loss"]) - float(lj)) <= GRAD_REL * abs(float(lj))
    assert abs(float(out["grad_norm"]) - float(gnj)) <= \
        GRAD_REL * float(gnj)
    for got, want in ((pt2, pj2), (ot2["m"], oj2["m"]),
                      (ot2["v"], oj2["v"])):
        want = dict(leaves_with_paths(jax.tree.map(np.asarray, want)))
        for k, g in leaves_with_paths(got):
            scale = np.abs(want[k]).max()
            assert np.abs(_np(g) - want[k]).max() <= GRAD_REL * scale, k
    assert int(ot2["step"]) == 1
    assert not torch.equal(pt2["blocks"][0]["w_src"],
                           pt["blocks"][0]["w_src"])


# ---------------------------------------------------------------------------
# Cells, params, bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(JC.spec().shapes))
def test_gnn_cell_config_and_flops_match_jax(shape):
    """gnn_cell_config against make_gnn_cell: the config it closes over
    (dtypes by name), its sizes and its model FLOPs."""
    from repro.dist.sharding import default_rules
    from repro.launch.mesh import make_host_mesh
    jcell = JS.make_gnn_cell(JC.spec(), shape, default_rules(make_host_mesh()))
    cell = TS.gnn_cell_config(TC.spec(), shape)
    jcfg = inspect.getclosurevars(jcell.fn).nonlocals["cfg"]
    for f in dataclasses.fields(jcfg):
        g, w = getattr(cell.cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("compute_dtype", "param_dtype"):
            assert str(g).removeprefix("torch.") == jnp.dtype(w).name
        else:
            assert g == w, f.name
    assert jcell.notes == (f"nodes={cell.n_nodes} edges={cell.n_edges} "
                           f"trip={cell.n_trip}")
    assert jcell.kind == cell.kind
    assert cell.model_flops == jcell.model_flops
    assert TS._dimenet_flops(cell.cfg, cell.n_edges, cell.n_trip,
                             cell.n_nodes, cell.cfg.d_feat) == \
        JS._dimenet_flops(jcfg, cell.n_edges, cell.n_trip, cell.n_nodes,
                          jcfg.d_feat)
    labels = jcell.args[1]["labels"].shape
    assert labels == ((cell.n_graphs,) if cell.cfg.task == "energy"
                      else (cell.n_nodes,))
    assert (TS.FANOUT_CAP, TS._pad_mult(1000), TS._pad_mult(1024)) == \
        (JS.FANOUT_CAP, JS._pad_mult(1000), JS._pad_mult(1024))


@pytest.mark.parametrize("kind", ["feat", "atoms", "energy"])
def test_init_dimenet_tree_matches_jax(kind):
    """The full config's tree: keys, list lengths, shapes and dtypes as
    JAX's; dense weights N(0, 1/d_in), biases 0, the atom embedding N(0,
    0.25)."""
    kw = {"feat": {"d_feat": 1433}, "atoms": {},
          "energy": {"task": "energy"}}[kind]
    cfg_j, cfg_t = _cfgs("full", **kw)
    pj, _ = JD.init_dimenet(jax.random.PRNGKey(0), cfg_j)
    pt = TD.init_dimenet(cfg_t, torch.Generator().manual_seed(0),
                         device="cpu")
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, pj)))
    got = dict(leaves_with_paths(pt))
    assert list(got) == list(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape and t.dtype == torch.float32
        if k.endswith("/b"):
            assert not t.any(), k
            continue
        std = 0.5 if k == "embed" and kind != "feat" \
            else 1 / np.sqrt(t.shape[0])
        assert abs(float(t.std()) / std - 1) < 6 / np.sqrt(t.numel()) + 0.05, k
    bf = TD.init_dimenet(dataclasses.replace(cfg_t,
                                             param_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0), device="cpu")
    assert {t.dtype for _, t in leaves_with_paths(bf)} == {torch.bfloat16}


def test_bridge_tree_handles_lists_leaf_for_leaf():
    """bridge._tree keeps dicts and lists (a tuple becomes a list) and
    every leaf's values and dtype."""
    rng = np.random.default_rng(0)
    tree = {"a": [{"w": rng.normal(size=(2, 3)).astype(np.float32),
                   "b": np.arange(3, dtype=np.int32)},
                  [np.ones(2, bool), (np.zeros(1, np.float32),)]],
            "c": rng.normal(size=4).astype(np.float32)}
    out = bridge._tree(tree, torch.device("cpu"))
    assert isinstance(out["a"], list) and isinstance(out["a"][1][1], list)
    got, want = leaves_with_paths(out), leaves_with_paths(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, t), (_, a) in zip(got, want):
        assert t.numpy().dtype == a.dtype and np.array_equal(t.numpy(), a), k


def test_dimenet_bridge_refuses_a_tree_of_another_config():
    cfg_j, cfg_t = _cfgs()
    tree = jax.tree.map(np.asarray, JD.init_dimenet(jax.random.PRNGKey(0),
                                                    cfg_j)[0])
    with pytest.raises(ValueError, match="n_blocks=3"):
        bridge.dimenet_params_from_jax(
            tree, dataclasses.replace(cfg_t, n_blocks=3), device="cpu")
    with pytest.raises(ValueError, match="'head/1/b'"):
        bridge.dimenet_params_from_jax(
            tree, dataclasses.replace(cfg_t, n_classes=5), device="cpu")
    with pytest.raises(ValueError, match="'embed'"):
        bridge.dimenet_params_from_jax(
            tree, dataclasses.replace(cfg_t, d_feat=7), device="cpu")
