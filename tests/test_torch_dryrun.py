"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: three
cells (gemma3-4b's ``prefill_32k``, ``dlrm-mlperf``'s ``train_batch`` and
``prettr-bert``'s ``serve_join``) traced on fake tensors as rank 0 of a
fake process group, one subprocess a mesh ((2, 2) and the production 16
x 16), against reckonings made without it:

* ``argument_bytes_per_device`` equals the bytes of the shards of the
  JAX cell's args (``NamedSharding.shard_shape`` of ``build_cell``'s
  specs; PreTTR's unused ``lm_head`` left out);
* DLRM's all-to-all bytes equal the sharded lookup's exact count: the
  forward's ``S C`` int32 ids and ``S C D`` float32 rows, and the
  backward's ``S C D`` float32 gradient rows, ``C`` the data group's
  capacity;
* the FLOPs reach at least the cell's ``model_flops`` a device times
  the share of it that is matmuls run on every token (a prefill's token
  table is a lookup and its head runs on the last position; PreTTR's
  tables are lookups, its LM head never runs and its last layer runs the
  CLS row alone);
* the DimeNet cells (``molecule``, ``ogb_products``) trace on 16 x 16
  through the edge-sharded route: their argument bytes the JAX shards',
  their c10d bytes the messages' all-gathers, reduce-scatters and
  all-reduces.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.dist import sharding as JS
from repro.launch import steps as JST
from repro_torch.configs import get_arch
from repro_torch.models.recsys.embedding import lookup_capacity

ROOT = os.path.join(os.path.dirname(__file__), "..")
CELLS = (("gemma3-4b", "prefill_32k"), ("dlrm-mlperf", "train_batch"),
         ("prettr-bert", "serve_join"))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch.dryrun import run_cell
    sizes, names, cells = json.loads(sys.argv[1])
    print(json.dumps([run_cell(a, s, sizes, names) for a, s in cells]))
""")


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", SCRIPT, json.dumps([*m, CELLS])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, m in MESHES.items()}
    out = {}
    for k, p in procs.items():
        stdout, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        out[k] = dict(zip(CELLS, json.loads(stdout.strip().splitlines()[-1])))
    return out


def _cell_ids(cells):
    return ["/".join(c) for c in cells]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", CELLS, ids=_cell_ids(CELLS))
def test_dryrun_argument_bytes_equal_the_jax_shards(records, mesh, cell):
    rec = records[mesh][cell]
    assert rec["ok"] and rec["devices"] == math.prod(MESHES[mesh][0])
    jcell = JST.build_cell(*cell, JS.default_rules(
        JaxAbstractMesh(*MESHES[mesh])))
    want = sum(int(np.prod(s.sharding.shard_shape(s.shape)))
               * s.dtype.itemsize
               for path, s in jax.tree_util.tree_leaves_with_path(jcell.args)
               if "lm_head" not in jax.tree_util.keystr(path))
    assert rec["argument_bytes_per_device"] == want
    assert rec["fits_80gb"] == (rec["peak_bytes_per_device"] <= 80e9)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_lookup_all_to_all_bytes_are_exact(records, mesh):
    rec = records[mesh][("dlrm-mlperf", "train_batch")]
    sizes, names = MESHES[mesh]
    cfg = get_arch("dlrm-mlperf").config
    n_shards, groups = math.prod(sizes), sizes[names.index("data")]
    ids = 65536 // groups * cfg.n_sparse
    slots = n_shards * lookup_capacity(ids, n_shards)
    want = slots * 4 + 2 * slots * cfg.embed_dim * 4
    assert rec["collective_bytes_per_device"]["alltoall_base_"] == want


def _matmul_share(arch):
    cfg = get_arch(arch).config
    if arch == "dlrm-mlperf":
        return 1.0
    if arch == "prettr-bert":
        b = cfg.backbone
        # the token table (and the untied head the cell never runs), the
        # position and segment tables
        heads = 1 if b.tie_embeddings else 2
        table = (heads * b.vocab_size + b.learned_pos + b.segment_vocab) \
            * b.d_model
        n = b.num_params()
        return (n - table) / n * (b.n_layers - cfg.l - 1) \
            / (b.n_layers - cfg.l)
    n = cfg.num_active_params()
    return (n - cfg.vocab_size * cfg.d_model) / n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", CELLS, ids=_cell_ids(CELLS))
def test_dryrun_flops_reach_the_model_matmuls(records, mesh, cell):
    rec = records[mesh][cell]
    share = _matmul_share(cell[0])
    assert 0 < share <= 1
    assert rec["op_flops_per_device"] >= share * rec["model_flops"] \
        / rec["devices"]
    assert rec["roofline_step_s"] == max(rec["roofline"].values())


DIMENET_CELLS = (("dimenet", "molecule"), ("dimenet", "ogb_products"))


@pytest.fixture(scope="module")
def dimenet_records():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", SCRIPT,
         json.dumps([*MESHES["16x16"], DIMENET_CELLS])], env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return dict(zip(DIMENET_CELLS,
                    json.loads(p.stdout.strip().splitlines()[-1])))


@pytest.mark.parametrize("cell", DIMENET_CELLS, ids=_cell_ids(DIMENET_CELLS))
def test_dryrun_traces_dimenet_edge_sharded(dimenet_records, cell):
    """The DimeNet cells trace through the edge-sharded route on 16 x 16:
    ``ok``, a rank's argument bytes those of the JAX cell's shards, the
    messages' all-gathers, their gradients' reduce-scatters and the node
    sums' all-reduces among the c10d bytes."""
    rec = dimenet_records[cell]
    assert rec["ok"] is True, rec.get("error")
    jcell = JST.build_cell(*cell, JS.default_rules(
        JaxAbstractMesh(*MESHES["16x16"])))
    want = sum(int(np.prod(s.sharding.shard_shape(s.shape)))
               * s.dtype.itemsize for s in jax.tree_util.tree_leaves(
                   jcell.args))
    assert rec["argument_bytes_per_device"] == want
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] > 0
    for op in ("allgather_", "_reduce_scatter_base_", "allreduce_"):
        assert coll[op] > 0, op
    assert rec["peak_bytes_per_device"] > rec["argument_bytes_per_device"]
    assert rec["fits_80gb"] is True
