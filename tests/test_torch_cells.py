"""The port's cells (``launch.steps``) against the JAX package's, in one
process on the CPU.

* Every (arch, shape) of ``cell_names()`` (the LMs, DimeNet, PreTTR and
  the recsys cells): ``kind``, ``notes``, ``donate`` and
  ``model_flops`` (rel 1e-12) equal JAX's ``build_cell``, and every arg's
  shape, dtype and ``PartitionSpec`` under ``default_rules`` on the
  production 16 x 16 mesh and a (2, 2) mesh (layer by layer: the port
  keeps a list of layer dicts; the port's PreTTR tree has no
  ``lm_head``, so JAX's is compared without it).  ``cell_names()`` is
  JAX's list.
* ``backend_support`` equals JAX's for every arch, ``"cuda"`` standing
  for JAX's ``"pallas"``, but for one stated difference: a layer range
  that mixes windows (gemma3-4b) is ``"applied"`` under ``"cuda"`` (the
  split kernel takes the window at runtime) and ``"unsupported"`` under
  JAX's ``"pallas"``.
* The cell functions at the smoke configs against the JAX functions they
  wrap, on the same inputs (the port's ``cell_inputs``, weights from the
  JAX init carried over by ``bridge``): ``prefill`` against
  ``forward(collect_cache=True)`` + ``logits``; ``decode`` against
  ``decode_step``; ``train`` against ``causal_lm_loss``'s gradient over
  the micro-batches + ``adam_update`` (granite-moe's two micro-batches;
  gemma3's step: ``test_torch_sharded_train``); ``index_docs`` against
  ``precompute_docs``, ``serve_join`` against ``join_and_score`` and
  ``rank_train`` against ``rank_pairs_loss``'s gradient +
  ``adam_update``.  rtol = atol = 2e-5
  in float32; the stored fp16 reps (valid tokens) within one fp16 step
  (float32 sums in other orders, rounded).
* The DimeNet cells' ``inputs`` (``graph_cut`` on the large graphs): the
  graph JAX's generators make at the cut sizes, padded to the specs'
  shapes and dtypes; ``local`` on each rank of a (2, 2) ``SpmdMesh`` (a
  fake process group in a subprocess) gives each leaf's spec block.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ALL_ARCHS, get_arch as jax_arch
from repro.core import prettr as JP
from repro.dist import sharding as JS
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.optim import adam as JA
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.dist import default_rules
from repro_torch.dist.compat import AbstractMesh
from repro_torch.launch import steps as ST
from repro_torch.models.backend import transformer_config_of
from repro_torch.models.transformer import TransformerConfig
from repro_torch.tree import leaves_with_paths, tree_map

MESHES = {"production_16x16": ((16, 16), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
CELLS = ST.cell_names()
# the archs whose layers mix windows: "applied" under the port's "cuda",
# "unsupported" under JAX's "pallas"
MIXED_WINDOWS = ("gemma3-4b",)
TOL = dict(rtol=2e-5, atol=2e-5)
ONE = default_rules(AbstractMesh((1, 1), ("data", "model")))


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    dtype: str
    spec: tuple


def _leaf(shape, dtype, spec):
    spec = tuple(spec)
    return Leaf(tuple(shape), str(dtype).replace("torch.", ""),
                spec + (None,) * (len(shape) - len(spec)))


def _jax_sds(s, drop=0):
    spec = () if s.sharding is None else tuple(s.sharding.spec)
    return _leaf(s.shape[drop:], s.dtype, spec[drop:])


def _jax_tree(tree):
    """A JAX arg tree in the port's layout: every stacked ``layers``
    dict as one dict a layer, leaves as :class:`Leaf`."""
    if isinstance(tree, jax.ShapeDtypeStruct):
        return _jax_sds(tree)
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "layers" and isinstance(v, dict):
                n = jax.tree.leaves(v)[0].shape[0]
                one = jax.tree.map(lambda s: _jax_sds(s, 1), v)
                out[k] = [one] * n
            else:
                out[k] = _jax_tree(v)
        return out
    return [_jax_tree(v) for v in tree]


def _port_tree(tree):
    if isinstance(tree, ST.TensorSpec):
        return _leaf(tree.shape, tree.dtype, tree.spec)
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    return [_port_tree(v) for v in tree]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module", params=list(MESHES))
def both(request):
    sizes, names = MESHES[request.param]
    jr = JS.default_rules(JaxAbstractMesh(sizes, names))
    tr = default_rules(AbstractMesh(sizes, names))
    return {c: (JST.build_cell(*c, jr), ST.build_cell(*c, tr)) for c in CELLS}


def test_cell_names_equal_jax():
    assert ST.cell_names() == JST.cell_names()
    assert ST.cell_names(include_prettr=False) \
        == JST.cell_names(include_prettr=False)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_cell_fields_equal_jax(both, cell):
    want, got = both[cell]
    assert (got.arch, got.shape, got.kind, got.notes, got.donate) \
        == (want.arch, want.shape, want.kind, want.notes, want.donate)
    assert got.model_flops == pytest.approx(want.model_flops, rel=1e-12)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_cell_arg_specs_equal_jax(both, cell):
    want, got = both[cell]
    w = _flat(_jax_tree(list(want.args)))
    w = {k: v for k, v in w.items() if "backbone/lm_head" not in k}
    g = _flat(_port_tree(list(got.args)))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k] == w[k], k


# ---------------------------------------------------------------------------
# backend_support
# ---------------------------------------------------------------------------


def test_mixed_window_archs_are_the_named_ones():
    mixed = [a for a in ALL_ARCHS
             if (t := transformer_config_of(get_arch(a).config)) is not None
             and len(set(t.layer_windows())) > 1]
    assert tuple(mixed) == MIXED_WINDOWS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_backend_support_matches_jax(arch):
    jc, tc = jax_arch(arch).config, get_arch(arch).config
    for b in (None, "plain"):
        assert ST.backend_support(tc, b) == JST.backend_support(jc, b)
    want, got = JST.backend_support(jc, "pallas"), \
        ST.backend_support(tc, "cuda")
    if arch in MIXED_WINDOWS:
        assert (want, got) == ("unsupported", "applied")
    else:
        assert got == want


def test_backend_support_refuses_mixed_split_flags_as_jax():
    from repro.models.transformer import TransformerConfig as JaxConfig

    got = ST.backend_support(TransformerConfig(n_layers=4, split_layers=2),
                             "cuda")
    want = JST.backend_support(JaxConfig(n_layers=4, split_layers=2),
                               "pallas")
    assert got == want == "unsupported"
    with pytest.raises(ValueError):
        ST.backend_support(get_arch("gemma3-4b").config, "pallas")


# ---------------------------------------------------------------------------
# The cell functions against the JAX functions they wrap
# ---------------------------------------------------------------------------


def _j(x):
    """A port tensor as a JAX array of its dtype."""
    if x.dtype in (torch.bfloat16, torch.float16):
        dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float16
        return jnp.asarray(x.float().numpy()).astype(dt)
    return jnp.asarray(x.numpy())


def _close(got, want, what, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               err_msg=what, **tol)


def _np32(tree):
    """JAX leaves as numpy, floating ones (bf16 among them) as
    float32."""
    return jax.tree.map(lambda a: np.asarray(
        a, np.float32 if jnp.issubdtype(a.dtype, jnp.floating) else None),
        tree)


def _lm_inputs(arch, shape, seed, backend="plain", **cut):
    """The port's cell (``backend``'s impls, smoke config), its whole
    inputs with the bridged JAX params, the JAX config and params."""
    cell = ST.build_cell(arch, shape, ONE, backend=backend, smoke=True,
                         **cut)
    jcfg = dataclasses.replace(jax_arch(arch).smoke, attn_impl="plain")
    tcfg = get_arch(arch).smoke
    if cell.kind != "train":
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    args = list(ST.cell_inputs(cell, torch.Generator().manual_seed(seed),
                               "cpu", whole=True))
    tp = tree_map(lambda t: t.to(tcfg.param_dtype), bridge.lm_params_from_jax(
        _np32(jp), tcfg, device="cpu"))
    return cell, args, jcfg, jp, tp


def test_prefill_cell_matches_jax_forward():
    cell, (_, toks), jcfg, jp, tp = _lm_inputs(
        "gemma3-4b", "prefill_32k", 0, batch=2, seq=20)
    lg, (k, v) = cell.fn(tp, toks)
    hidden, kv, _ = JT.forward(jp, jcfg, _j(toks), collect_cache=True)
    _close(lg, JT.logits(jp, jcfg, hidden[:, -1:]), "logits")
    _close(k, kv[0], "k")
    _close(v, kv[1], "v")


def test_decode_cell_matches_jax_decode_step():
    cell, (_, toks, cache, pos), jcfg, jp, tp = _lm_inputs(
        "gemma3-4b", "decode_32k", 1, batch=2, seq=20)
    # the cache in the smoke config's float32 compute dtype (the bf16
    # draws widened), as JAX's decode_step writes the step's K/V uncast
    cache = tuple(c.float() for c in cache)
    want_lg, want_cache = JT.decode_step(jp, jcfg, _j(toks),
                                         tuple(_j(c) for c in cache),
                                         int(pos))
    lg, got = cell.fn(tp, toks, tuple(c.clone() for c in cache), pos)
    _close(lg, want_lg, "logits")
    for g, w, what in zip(got, want_cache, "kv"):
        _close(g, w, what)


# "cuda" on the CPU: the wrappers' plain versions forward, the backend's
# reference gradient backward (models.backend._ReferenceGradient: the
# blocked attention's, the other ops' plain versions')
@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m"])
def test_lm_train_cell_matches_jax_step(arch, backend):
    cell, (state, batch), jcfg, jp, _ = _lm_inputs(arch, "train_4k", 2,
                                                   backend, batch=4, seq=16)
    opt_cfg = JST._lm_opt_cfg(jcfg)
    accum = JST._lm_accum(arch)
    assert cell.notes == f"grad_accum={accum}"
    jstate = {"params": jp, "opt": JA.init_opt_state(jp, opt_cfg)}
    state = bridge.train_state_from_jax(_np32(jstate), cell_cfg(arch),
                                        device="cpu")
    new, out = cell.fn(state, batch)
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, y: JT.causal_lm_loss(p, jcfg, t, y)))
    n = 4 // accum
    gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    lsum = 0.0
    for j in range(accum):
        rows = slice(j * n, (j + 1) * n)
        lj, g = vg(jp, _j(batch["tokens"][rows]), _j(batch["labels"][rows]))
        gsum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), gsum, g)
        lsum = lsum + lj
    want, wopt, gn = JA.adam_update(
        jax.tree.map(lambda g: g / accum, gsum), jstate["opt"], jp, opt_cfg,
        lr=opt_cfg.lr)
    _close(out["loss"], lsum / accum, "loss")
    _close(out["grad_norm"], gn, "grad_norm")
    _close_trees(new, bridge.train_state_from_jax(
        _np32({"params": want, "opt": wopt}), cell_cfg(arch), device="cpu"))


def cell_cfg(arch):
    return get_arch(arch).smoke


def _close_trees(got, want):
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert sorted(g) == sorted(w)
    for k in w:
        _close(g[k], w[k].float() if w[k].is_floating_point() else w[k], k)


def _prettr_inputs(shape, seed, backend="plain", **cut):
    cell = ST.build_cell("prettr-bert", shape, ONE, backend=backend,
                         smoke=True, **cut)
    jcfg = jax_arch("prettr-bert").smoke
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, attn_impl="plain", compress_impl="plain"))
    jp, _ = JP.init_prettr(jax.random.PRNGKey(seed), jcfg)
    tcfg = get_arch("prettr-bert").smoke
    args = list(ST.cell_inputs(cell, torch.Generator().manual_seed(seed),
                               "cpu", whole=True))
    return cell, args, jcfg, jp, tcfg


def test_index_docs_cell_matches_jax_precompute_docs():
    cell, (_, docs, valid), jcfg, jp, tcfg = _prettr_inputs("index_docs", 3,
                                                            batch=4)
    got = cell.fn(bridge.params_from_jax(_np32(jp), tcfg, device="cpu"),
                  docs, valid)
    assert got.dtype == torch.float16
    want = np.asarray(JP.precompute_docs(jp, jcfg, _j(docs), _j(valid)),
                      np.float32)
    # the valid tokens (the index stores those); float32 sums in other
    # orders, rounded to fp16: one fp16 step apart at most
    _close(got[valid], want[valid.numpy()], "reps",
           dict(rtol=2 ** -10, atol=2e-5))


def test_serve_join_cell_matches_jax_join_and_score():
    cell, (_, q, qv, store, dv), jcfg, jp, tcfg = _prettr_inputs(
        "serve_join", 4, batch=4)
    got = cell.fn(bridge.params_from_jax(_np32(jp), tcfg, device="cpu"),
                  q, qv, store, dv)
    want = JP.join_and_score(jp, jcfg, _j(q), _j(qv), _j(store), _j(dv))
    _close(got, want, "scores")


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_rank_train_cell_matches_jax_step(backend):
    cell, (_, pos, neg), jcfg, jp, tcfg = _prettr_inputs("rank_train", 5,
                                                         backend, batch=4)
    opt_cfg = JA.OptimizerConfig()
    jstate = {"params": jp, "opt": JA.init_opt_state(jp, opt_cfg)}
    state = bridge.train_state_from_jax(_np32(jstate), tcfg, device="cpu")
    new, out = cell.fn(state, pos, neg)
    jpos, jneg = ({k: _j(v) for k, v in d.items()} for d in (pos, neg))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JP.rank_pairs_loss(p, jcfg, jpos, jneg)))(jp)
    want, wopt, gn = JA.adam_update(grads, jstate["opt"], jp, opt_cfg,
                                    lr=opt_cfg.lr)
    _close(out["loss"], loss, "loss")
    _close(out["grad_norm"], gn, "grad_norm")
    _close_trees(new, bridge.train_state_from_jax(
        _np32({"params": want, "opt": wopt}), tcfg, device="cpu"))


# ---------------------------------------------------------------------------
# DimeNet cells: inputs with graph_cut, and each rank's blocks
# ---------------------------------------------------------------------------

# shape -> graph_cut for the CPU (the molecule cell runs as published)
GNN_CUTS = {"full_graph_sm": 20, "ogb_products": 20000, "minibatch_lg": 200,
            "molecule": None}
LOCAL_SCRIPT = """
import hashlib, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.dist import default_rules
from repro_torch.dist.compat import AbstractMesh, spmd_mesh
from repro_torch.launch import steps as ST
from repro_torch.tree import leaves_with_paths
cuts = json.loads(sys.argv[1])
whole = {}
for shape, cut in cuts.items():
    c = ST.build_cell("dimenet", shape, default_rules(AbstractMesh(
        (2, 2), ("data", "model"))), graph_cut=cut)
    whole[shape] = ST.cell_inputs(c, torch.Generator().manual_seed(0),
                                  "cpu", whole=True)
out = []
for rank in range(4):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=4)
    mesh = spmd_mesh((2, 2), ("data", "model"), "cpu")
    got = {}
    for shape, cut in cuts.items():
        c = ST.build_cell("dimenet", shape, default_rules(mesh),
                          graph_cut=cut)
        got[shape] = {k: [list(t.shape), hashlib.sha1(
            t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()]
                      for k, t in leaves_with_paths(c.local(whole[shape]))
                      if torch.is_tensor(t) and t.dim()}
    out.append(got)
    dist.destroy_process_group()
print(json.dumps(out))
"""


def _gnn_cell(shape, rules):
    return ST.build_cell("dimenet", shape, rules, graph_cut=GNN_CUTS[shape])


def _gnn_whole(shape, rules):
    cell = _gnn_cell(shape, rules)
    return cell, ST.cell_inputs(cell, torch.Generator().manual_seed(0), "cpu",
                                whole=True)


def _jax_graph(shape, cut):
    """The graph JAX's generators make at the cell's sizes (seed 0)."""
    from repro.configs import GNN_SHAPES
    from repro.data import graphs as JG

    info, cut = GNN_SHAPES[shape], cut or 1
    if shape == "molecule":
        return JG.make_molecule_batch(info["batch"], info["n_nodes"],
                                      info["n_edges"], fanout_cap=8, seed=0)
    if shape != "minibatch_lg":
        return JG.make_graph_batch(
            info["n_nodes"] // cut, info["n_edges"] // cut,
            d_feat=info["d_feat"], fanout_cap=8,
            n_classes=47 if shape == "ogb_products" else 16, seed=0)
    n = info["n_nodes"] // cut
    feat, pos, src, dst, labels = JG.random_graph(
        n, info["n_edges"] // cut, d_feat=602, n_classes=41, seed=0)
    sampler = JG.NeighborSampler(src, dst, n, seed=0)
    seeds = np.random.default_rng(0).choice(n, info["batch_nodes"],
                                            replace=False)
    s_src, s_dst, node_map = sampler.sample(seeds, info["fanout"])
    t_kj, t_ji, t_valid = JG.build_triplets(s_src, s_dst, 8)
    return JG.GraphBatch(feat[node_map], pos[node_map], s_src, s_dst,
                         np.ones(len(s_src), bool), t_kj, t_ji, t_valid,
                         labels[node_map])


@pytest.mark.parametrize("shape", list(GNN_CUTS))
def test_dimenet_cell_inputs_are_the_jax_graph_at_the_specs(shape):
    """``cell_inputs`` of a DimeNet cell (``graph_cut`` where the graph is
    large): every leaf has its spec's shape and dtype, the graph is the one
    JAX's generators make at the cut sizes (seed 0), padded with zero
    rows, invalid edges and invalid triplet slots (the blocked layout
    kept), and the params are the seeded init's."""
    cell, (state, batch) = _gnn_whole(shape, ONE)
    specs = cell.args[1]
    assert sorted(batch) == sorted(specs)
    for k, t in batch.items():
        assert tuple(t.shape) == specs[k].shape, k
        assert t.dtype == specs[k].dtype, k
    for (k, t), (_, s) in zip(leaves_with_paths(state),
                              leaves_with_paths(cell.args[0])):
        assert tuple(t.shape) == s.shape and t.dtype == s.dtype, k
    g = _jax_graph(shape, GNN_CUTS[shape])
    n, e = len(g.positions), len(g.edge_src)
    for k in ("node_feat", "positions", "edge_src", "edge_dst", "edge_valid",
              "trip_kj", "trip_ji", "trip_valid", "graph_ids", "labels"):
        want = getattr(g, k)
        if want is None:
            continue
        got = batch[k].numpy()
        np.testing.assert_array_equal(got[:len(want)], want, err_msg=k)
        assert not got[len(want):].any(), k
    assert e * 8 == len(g.trip_kj) and batch["edge_valid"].sum() == e
    assert n <= batch["positions"].shape[0]
    trip = batch["trip_ji"].numpy()
    valid = batch["trip_valid"].numpy()
    assert (trip[valid] == np.nonzero(valid)[0] // 8).all()


def test_dimenet_graph_cut_keeps_the_published_config_and_dtype():
    spec = get_arch("dimenet")
    full = ST.gnn_cell_config(spec, "ogb_products")
    cut = ST.gnn_cell_config(spec, "ogb_products", 48)
    assert (cut.n_nodes, cut.n_edges, cut.n_trip) == (51021, 1288960,
                                                      10311680)
    assert cut.cfg == full.cfg and cut.cfg.compute_dtype == torch.bfloat16
    small = ST.gnn_cell_config(spec, "ogb_products", 20000)
    assert small.cfg.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="graph_cut"):
        ST.build_cell("dimenet", "molecule", ONE, graph_cut=2)
    with pytest.raises(ValueError, match="seed"):
        ST.gnn_cell_config(spec, "minibatch_lg", 1000)
    with pytest.raises(ValueError, match="graph_cut"):
        ST.build_cell("gemma3-4b", "train_4k", ONE, graph_cut=2)


def test_dimenet_cell_local_gives_each_rank_its_spec_blocks():
    """``cell.local`` on each rank of a (2, 2) ``SpmdMesh`` (a fake
    process group in a subprocess): every leaf is the block of the whole
    leaf that its spec and the rank's coordinates select -- contiguous
    edge and triplet blocks of a quarter, node features cut where four
    divide the nodes, the rest whole."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    p = subprocess.run([sys.executable, "-c", LOCAL_SCRIPT,
                        json.dumps(GNN_CUTS)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    ranks = json.loads(p.stdout.strip().splitlines()[-1])
    rules = default_rules(AbstractMesh((2, 2), ("data", "model")))
    cut_edges = 0
    for shape in GNN_CUTS:
        cell, whole = _gnn_whole(shape, rules)
        specs = dict(leaves_with_paths(cell.args))
        for rank, got in enumerate(ranks):
            coord = {"data": rank // 2, "model": rank % 2}
            for k, t in leaves_with_paths(whole):
                if not torch.is_tensor(t) or not t.dim():
                    continue
                want = t
                for d, entry in enumerate(specs[k].spec):
                    axes = () if entry is None else \
                        (entry,) if isinstance(entry, str) else entry
                    if axes:
                        i = 0
                        for a in axes:
                            i = i * 2 + coord[a]
                        size = want.shape[d] // 2 ** len(axes)
                        want = want.narrow(d, i * size, size)
                        cut_edges += k.endswith("edge_src")
                shape_got, digest = got[shape][k]
                assert shape_got == list(want.shape), (shape, k)
                assert digest == hashlib.sha1(want.contiguous().view(
                    torch.uint8).numpy().tobytes()).hexdigest(), (shape, k)
    assert cut_edges == 4 * len(GNN_CUTS)
