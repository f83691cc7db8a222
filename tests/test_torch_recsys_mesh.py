"""The recsys paths on gloo ranks on the CPU (a world of 4, three meshes
over it: (2, 2) ``data`` x ``model``, (4,) ``data``, (4,) ``model``),
against one process and the JAX package:

* ``sharded_lookup``'s table gradient (the reverse all-to-all, the
  ``model`` ranks' copies kept once) against JAX's ``jax.grad`` of the
  single-device ``take * keep`` (``keep`` from JAX's ``_bucket_group`` of
  each data group), Zipf ids past capacity among the cases;
* DLRM's and DeepFM's forward, towers / item vectors and retrieval
  under ``default_rules`` with each table row-sharded (DeepFM's ``w1``
  among them: the fault repaired here read it by global ids in a local
  block) against the same functions in one process;
* the recsys cells (``launch.steps``): DLRM's, DeepFM's, xDeepFM's and
  BERT4Rec's train steps (loss, ``grad_norm`` and the whole updated
  state, moments included), DeepFM's serve logits, DLRM's retrieval
  scores (the rank's block of the candidates) and BERT4Rec's
  vocab-sharded top-k (values; ids wherever the values are not tied)
  against the same cells in one process.

Limits: 1e-5 (rtol = atol), ids equal.  The ranks start once for the
module (``launch.mesh.run_spmd``: spawn, a ``FileStore`` under
``tmp_path``, one thread a rank, a timeout that kills them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _spmd_recsys_ranks as R
from repro.models.recsys.embedding import _bucket_group as jax_bucket_group
from repro_torch.configs import get_arch
from repro_torch.dist import default_rules
from repro_torch.dist.compat import AbstractMesh
from repro_torch.launch.mesh import run_spmd
from repro_torch.models.recsys import deepfm as F
from repro_torch.models.recsys import dlrm as D
from repro_torch.models.recsys.embedding import lookup_capacity
from repro_torch.tree import leaves_with_paths, tree_map

TIMEOUT_S = 300
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS, DIM, N_IDS = 256, 16, 64
ID_CASES = {"uniform_cf8": 8.0, "zipf_cf1": 1.0, "uniform_cf4": 4.0}
# data groups of each mesh (every mesh has 4 table shards)
GROUPS = {"2x2": 2, "4_data": 4, "4_model": 1}
B, N_CAND = 8, 64
ONE = default_rules(AbstractMesh((1, 1), ("data", "model")))


def _lookup_cases():
    rng = np.random.default_rng(0)
    out = {}
    for case, cf in ID_CASES.items():
        ids = (np.minimum(rng.zipf(1.3, N_IDS) - 1, ROWS - 1)
               if case.startswith("zipf") else rng.integers(0, ROWS, N_IDS))
        w = rng.standard_normal((N_IDS, DIM)).astype(np.float32)
        out[case] = (ids, w, cf)
    return out


def _jax_table_grad(table, ids, w, cf, groups):
    """JAX's gradient of ``sum(take(table, ids) * keep * w)`` over the
    data groups, ``keep`` from its ``_bucket_group`` at the group's
    capacity."""
    n = N_IDS // groups
    cap = lookup_capacity(n, 4, cf)

    def loss(t):
        total = 0.0
        for g in range(groups):
            ig = jnp.asarray(ids[g * n:(g + 1) * n])
            keep = jax_bucket_group(ig, 4, ROWS // 4, cap)[3]
            total = total + jnp.sum(jnp.take(t, ig, axis=0)
                                    * keep[:, None] * w[g * n:(g + 1) * n])
        return total

    return np.asarray(jax.grad(loss)(jnp.asarray(table)))


def _model_case():
    """DLRM's and DeepFM's smoke params (seeded) and inputs as numpy, and
    their one-process outputs."""
    rng = np.random.default_rng(1)
    case, want = {}, {}
    for fam, arch in (("dlrm", "dlrm-mlperf"), ("deepfm", "deepfm")):
        cfg = get_arch(arch).smoke
        init = D.init_dlrm if fam == "dlrm" else F.init_deepfm
        params = init(cfg, torch.Generator().manual_seed(2), device="cpu")
        vocab = cfg.vocab_sizes
        ids = lambda fields: np.stack(
            [rng.integers(0, vocab[f], B) for f in fields], 1)
        inp = {"sparse": ids(range(len(vocab))),
               "items": ids(cfg.item_fields), "users": ids(cfg.user_fields),
               "cand_vecs": (rng.standard_normal((N_CAND, cfg.embed_dim))
                             * 0.01).astype(np.float32)}
        if fam == "dlrm":
            inp["dense"] = rng.standard_normal((B, cfg.n_dense)) \
                .astype(np.float32)
        else:
            inp["cand_first"] = (rng.standard_normal(N_CAND) * 0.01) \
                .astype(np.float32)
        x = {k: torch.from_numpy(v) for k, v in inp.items()}
        with torch.no_grad():
            if fam == "dlrm":
                out = {"forward": D.dlrm_forward(params, cfg, x["dense"],
                                                 x["sparse"]),
                       "item_tower": D.item_tower(params, cfg, x["items"]),
                       "user_tower": D.user_tower(params, cfg, x["dense"],
                                                  x["users"]),
                       "retrieval": D.retrieval_scores(
                           params, cfg, x["dense"], x["users"],
                           x["cand_vecs"])}
            else:
                vecs, first = F.item_vectors(params, cfg, x["items"])
                out = {"forward": F.deepfm_forward(params, cfg, x["sparse"]),
                       "item_vectors": vecs, "item_first": first,
                       "retrieval": F.retrieval_scores(
                           params, cfg, x["users"], x["cand_vecs"],
                           x["cand_first"])}
        case[fam] = (cfg, tree_map(lambda t: t.numpy(), params), inp)
        want[fam] = {k: v.float().numpy() for k, v in out.items()}
    return case, want


def _one_process_cells():
    """Every cell of ``R.CELLS`` in one process on the same seeded whole
    inputs: a train cell's (loss, grad_norm, state), a serve cell's
    outputs, as numpy."""
    out = {}
    for key, (arch, shape, over, batch) in R.CELLS.items():
        c = R.cell(arch, shape, over, batch, ONE)
        res = c.fn(*R.cell_inputs(c))
        if c.kind == "rec_train":
            new, o = res
            out[key] = (float(o["loss"]), float(o["grad_norm"]),
                        tree_map(lambda t: t.detach().float().numpy(), new))
            continue
        res = res if isinstance(res, tuple) else (res,)
        out[key] = [r.numpy() if r.dtype == torch.int64
                    else r.detach().float().numpy() for r in res]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recsys_spmd")
    table = np.random.default_rng(3).standard_normal((ROWS, DIM)) \
        .astype(np.float32)
    lookups = _lookup_cases()
    case, want = _model_case()
    cells = _one_process_cells()
    cell_want = {k: v for k, v in cells.items() if isinstance(v, list)}
    res = run_spmd(R.world, (2, 2), ("data", "model"), device_type="cpu",
                   args=(table, lookups, case, want, cell_want),
                   timeout_s=TIMEOUT_S, store_dir=str(tmp), threads=1)
    return {"table": table, "lookups": lookups, "ranks": res,
            "cells": cells}


@pytest.mark.parametrize("mesh", list(GROUPS))
@pytest.mark.parametrize("case", list(ID_CASES))
def test_sharded_lookup_table_gradient_matches_jax(runs, mesh, case):
    ids, w, cf = runs["lookups"][case]
    want = _jax_table_grad(runs["table"], ids, w, cf, GROUPS[mesh])
    per = ROWS // 4
    for r in runs["ranks"]:
        i, _ = r[mesh]["coord"]
        np.testing.assert_allclose(r[mesh]["lookup"][case],
                                   want[i * per:(i + 1) * per], **TOL,
                                   err_msg=f"{mesh} block {i}")
    if case == "zipf_cf1":
        # the case drops ids past capacity, which take no gradient
        full = _jax_table_grad(runs["table"], ids, w, 64.0, GROUPS[mesh])
        assert not np.allclose(want, full)


@pytest.mark.parametrize("mesh", list(GROUPS))
@pytest.mark.parametrize("what", ["dlrm/forward", "dlrm/item_tower",
                                  "dlrm/user_tower", "dlrm/retrieval",
                                  "deepfm/forward", "deepfm/item_vectors",
                                  "deepfm/item_first", "deepfm/retrieval"])
def test_recsys_functions_on_a_mesh_match_one_process(runs, mesh, what):
    """Every table read under row sharding goes through the sharded
    lookup (the DeepFM ``w1`` reads and the towers' mean bags among them;
    before, ``padded_bag`` read global ids in a rank's block)."""
    for r in runs["ranks"]:
        got, want = r[mesh]["models"][what]
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)


@pytest.mark.parametrize("mesh", list(GROUPS))
@pytest.mark.parametrize("key", [k for k, v in R.CELLS.items()
                                 if v[1] == "train_batch"])
def test_recsys_train_cells_on_a_mesh_match_one_process(runs, mesh, key):
    loss, gn, state = runs["cells"][key]
    got_loss, got_gn, got_state = runs["ranks"][0][mesh]["cells"][key][0]
    np.testing.assert_allclose(got_loss, loss, **TOL)
    np.testing.assert_allclose(got_gn, gn, **TOL)
    g, w = dict(leaves_with_paths(got_state)), dict(leaves_with_paths(state))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)
    for r in runs["ranks"][1:]:
        assert r[mesh]["cells"][key][0][:2] == (got_loss, got_gn)


@pytest.mark.parametrize("mesh", list(GROUPS))
@pytest.mark.parametrize("key", ["deepfm_serve", "dlrm_retrieval",
                                 "bert4rec_serve"])
def test_recsys_serve_cells_on_a_mesh_match_one_process(runs, mesh, key):
    for r in runs["ranks"]:
        got, want = r[mesh]["cells"][key]
        np.testing.assert_allclose(got[0], want[0], **TOL, err_msg=key)
        if len(got) == 2:
            # the top-k ids, wherever the values are not tied
            v = want[0]
            gap = np.minimum(np.abs(np.diff(v, prepend=np.inf, axis=1)),
                             np.abs(np.diff(v, append=-np.inf, axis=1)))
            apart = gap > 1e-5
            assert apart.mean() > 0.5
            np.testing.assert_array_equal(got[1][apart], want[1][apart])
