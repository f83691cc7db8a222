"""The port's sharding rules and context (``repro_torch.dist``) against
the JAX package's (``repro.dist``), in one process on the CPU.

Rule resolution is shape arithmetic, so the JAX side runs on
``jax.sharding.AbstractMesh(axis_sizes, axis_names)`` and the port on its
own ``AbstractMesh``: ``divisible_spec`` over every ``(shape, axes)``
leaf that the JAX ``init_*`` functions of the registry return, at the
full configs, and the JAX tests' own cases; the rule constructors'
refusals; the context stack; ``_bucket_group`` array-equal to JAX's;
and the MoE FFN's group count from installed rules against JAX's
``moe_ffn(..., n_groups=G)``."""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro import dist as JD
from repro.configs import ALL_ARCHS, get_arch
from repro.launch.steps import eval_params
from repro.models import moe as JM
from repro.models.recsys.embedding import _bucket_group as jax_bucket_group
from repro_torch import dist as TD
from repro_torch.dist.compat import AbstractMesh, Mesh, P
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import moe as TM
from repro_torch.models.recsys.embedding import (_bucket_group,
                                                 lookup_capacity)

MESHES = {"data4_model2": ((4, 2), ("data", "model")),
          "pod8": ((8,), ("pod",)),
          "pod2_data16_model16": ((2, 16, 16), ("pod", "data", "model")),
          "shard4": ((4,), ("shard",)),
          "pod2_data4_model2": ((2, 4, 2), ("pod", "data", "model")),
          "shard2_data2": ((2, 2), ("shard", "data"))}
# the meshes every parameter leaf is resolved on
PARAM_MESHES = ("data4_model2", "pod8", "pod2_data16_model16", "shard4")
RULES = ("default_rules", "replicated_serving_rules")


def _meshes(key):
    sizes, names = MESHES[key]
    return JaxAbstractMesh(sizes, names), AbstractMesh(sizes, names)


def _init_fn(spec):
    cfg = spec.config
    if spec.name == "prettr-bert":
        from repro.core.prettr import init_prettr
        return lambda k: init_prettr(k, cfg)
    if spec.family == "lm":
        from repro.models.transformer import init_params
        return lambda k: init_params(k, cfg)
    if spec.family == "gnn":
        from repro.models.gnn.dimenet import init_dimenet
        return lambda k: init_dimenet(k, cfg)
    if spec.name == "dlrm-mlperf":
        from repro.models.recsys.dlrm import init_dlrm
        return lambda k: init_dlrm(k, cfg)
    if spec.name == "bert4rec":
        from repro.models.recsys.bert4rec import init_bert4rec
        return lambda k: init_bert4rec(k, cfg)
    from repro.models.recsys.deepfm import init_deepfm
    return lambda k: init_deepfm(k, cfg)


@pytest.fixture(scope="module")
def param_leaves():
    """{arch: [(shape, logical axes), ...]} of the JAX init functions at
    the registry's full configs (abstract: nothing is allocated)."""
    out = {}
    for arch in ALL_ARCHS:
        shapes, axes = eval_params(_init_fn(get_arch(arch)))
        sl = jax.tree.leaves(shapes)
        al = jax.tree.flatten(axes, is_leaf=lambda x: isinstance(x, tuple))[0]
        assert len(sl) == len(al), arch
        out[arch] = [(s.shape, a) for s, a in zip(sl, al)]
    return out


@pytest.mark.parametrize("mesh_key", PARAM_MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_divisible_spec_matches_jax_on_every_param_leaf(param_leaves, arch,
                                                        mesh_key):
    jm, tm = _meshes(mesh_key)
    for rules_fn in RULES:
        jr, tr = getattr(JD, rules_fn)(jm), getattr(TD, rules_fn)(tm)
        assert dict(tr.rules) == dict(jr.rules)
        for shape, axes in param_leaves[arch]:
            want = JD.divisible_spec(jr, axes, shape)
            got = TD.divisible_spec(tr, axes, shape)
            assert isinstance(got, P)
            assert tuple(got) == tuple(want), (rules_fn, shape, axes)


# the JAX tests' own cases (tests/test_dist.py), and a few more
SPEC_CASES = [
    ("data4_model2", "default_rules", ("batch", None), (8, 16)),
    ("data4_model2", "default_rules", ("embed", "heads"), (64, 8)),
    ("data4_model2", "default_rules", ("batch", None), (6, 16)),
    ("data4_model2", "default_rules", ("embed", "heads"), (64, 3)),
    ("data4_model2", "default_rules", ("experts", "embed", "mlp"),
     (8, 64, 128)),
    ("data4_model2", "default_rules", ("experts", "embed", "mlp"),
     (5, 64, 128)),
    ("pod2_data4_model2", "default_rules", ("table_rows", None), (512, 16)),
    ("pod2_data4_model2", "default_rules", ("table_rows", None), (8, 16)),
    ("data4_model2", "default_rules", ("no_such_axis", None), (8, 8)),
    ("data4_model2", "default_rules", ("batch",), (8, 8, 8)),
    ("data4_model2", "replicated_serving_rules", ("batch", None), (8, 16)),
    ("data4_model2", "replicated_serving_rules", ("embed", "mlp"),
     (64, 128)),
    ("data4_model2", "default_rules", ("batch", "embed_tp"), (7, 9)),
    ("pod2_data16_model16", "default_rules", ("edges", None), (1024, 4)),
    ("pod2_data16_model16", "default_rules", ("edges", None), (96, 4)),
    ("shard4", "sharded_serving_rules", ("batch", None), (8, 16)),
    ("shard2_data2", "sharded_serving_rules", ("batch", None), (8, 16)),
    ("data4_model2", "default_rules", "batch", (8,)),
]


@pytest.mark.parametrize("mesh_key,rules_fn,axes,shape", SPEC_CASES)
def test_divisible_spec_matches_the_jax_cases(mesh_key, rules_fn, axes,
                                              shape):
    jm, tm = _meshes(mesh_key)
    want = JD.divisible_spec(getattr(JD, rules_fn)(jm), axes, shape)
    got = TD.divisible_spec(getattr(TD, rules_fn)(tm), axes, shape)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("mesh_key", ["data4_model2", "pod8"])
@pytest.mark.parametrize("fn", ["sharded_serving_rules",
                                "serving_shard_devices"])
def test_serving_rules_refuse_a_mesh_without_a_shard_axis(mesh_key, fn):
    jm, tm = _meshes(mesh_key)
    with pytest.raises(ValueError) as want:
        JD.sharded_serving_rules(jm)
    with pytest.raises(ValueError) as got:
        getattr(TD, fn)(tm)
    assert str(got.value) == str(want.value)


def test_serving_shard_devices_takes_each_shards_first_replica():
    devs = np.array([["cpu:0", "cpu:1"], ["cpu:2", "cpu:3"],
                     ["cpu:4", "cpu:5"]], dtype=object)
    mesh = Mesh(devs, ("shard", "data"))
    assert TD.serving_shard_devices(mesh) == [torch.device(d) for d in
                                              ("cpu:0", "cpu:2", "cpu:4")]
    flipped = Mesh(devs.T, ("data", "shard"))
    assert TD.serving_shard_devices(flipped) == \
        TD.serving_shard_devices(mesh)
    assert TD.sharded_serving_rules(mesh).rules == {"batch": ("data",)}


def test_meshes_shapes_and_refusals():
    mesh = Mesh(["cpu"] * 8, ("data",))
    assert mesh.shape == {"data": 8} and mesh.size == 8
    assert Mesh(np.array(["cpu"] * 8, dtype=object).reshape(4, 2),
                ("data", "model")).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 4, ("data", "model"))
    with pytest.raises(ValueError):
        AbstractMesh((2, 2), ("data", "data"))
    prod = make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1} and \
        list(host.devices.reshape(-1)) == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# install_rules / current_rules / maybe_shard
# ---------------------------------------------------------------------------


def test_install_rules_nesting_and_restoration():
    outer = TD.default_rules(AbstractMesh((4, 2), ("data", "model")))
    inner = TD.replicated_serving_rules(AbstractMesh((4, 2),
                                                     ("data", "model")))
    assert TD.current_rules() is None
    with TD.install_rules(outer):
        assert TD.current_rules() is outer
        with TD.install_rules(inner) as got:
            assert got is inner and TD.current_rules() is inner
        assert TD.current_rules() is outer
    assert TD.current_rules() is None


def test_install_rules_restores_on_error():
    rules = TD.default_rules(AbstractMesh((4, 2), ("data", "model")))
    with TD.install_rules(rules):
        with pytest.raises(RuntimeError):
            with TD.install_rules(TD.default_rules(AbstractMesh((2,),
                                                                ("data",)))):
                raise RuntimeError("boom")
        assert TD.current_rules() is rules
    assert TD.current_rules() is None


def test_installed_rules_are_per_thread():
    rules = TD.default_rules(AbstractMesh((4, 2), ("data", "model")))
    seen = []
    with TD.install_rules(rules):
        t = threading.Thread(target=lambda: seen.append(TD.current_rules()))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert seen == [None]


def test_maybe_shard_is_the_identity():
    x = torch.ones(8, 16)
    assert TD.maybe_shard(x, ("batch", None)) is x
    with TD.install_rules(TD.default_rules(AbstractMesh((4, 2),
                                                        ("data", "model")))):
        assert TD.maybe_shard(x, ("batch", None)) is x


# ---------------------------------------------------------------------------
# _bucket_group and the capacity rule
# ---------------------------------------------------------------------------


def _ids(kind, n, rows, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, rows, n)
    return np.minimum(rng.zipf(1.2, n) - 1, rows - 1)


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_bucket_group_matches_jax(kind, cf, n_shards):
    rows, n = 512, 200
    ids = _ids(kind, n, rows, seed=n_shards)
    # the JAX capacity rule (repro/models/recsys/embedding.py)
    cap = int(max(4, cf * n / n_shards))
    cap = -(-cap // 8) * 8
    assert lookup_capacity(n, n_shards, cf) == cap
    want = jax_bucket_group(jnp.asarray(ids, jnp.int32), n_shards,
                            rows // n_shards, cap)
    got = _bucket_group(torch.from_numpy(ids), n_shards, rows // n_shards,
                        cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind == "zipf" and cf == 1.0 and n_shards > 1:
        assert not got[3].all()            # the case drops ids


# ---------------------------------------------------------------------------
# the MoE FFN's group count from installed rules (single process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_experts,mesh_shape,groups", [
    (8, (4, 2), 4),       # E % model == 0: one group a data group
    (5, (4, 2), 8),       # else one a device
    (8, (2, 1), 2),
    (6, (4, 4), 16),      # 6 % 4: one a device
    (8, (3, 2), 1),       # 64 tokens % 3: one group, as JAX falls back
])
def test_moe_groups_from_installed_rules_match_jax(n_experts, mesh_shape,
                                                   groups):
    d, f, t = 16, 24, 64
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), d, f, n_experts, jnp.float32)
    x = np.random.default_rng(1).standard_normal((t, d)).astype(np.float32)
    want, want_aux = JM.moe_ffn(jp, jnp.asarray(x), top_k=2,
                                capacity_factor=1.25, n_groups=groups)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    with TD.install_rules(TD.default_rules(mesh)):
        got, aux = TM.moe_ffn(tp, torch.from_numpy(x), top_k=2,
                              capacity_factor=1.25)
        pinned, _ = TM.moe_ffn(tp, torch.from_numpy(x), top_k=2,
                               capacity_factor=1.25, n_groups=1)
    unsharded, _ = TM.moe_ffn(tp, torch.from_numpy(x), top_k=2,
                              capacity_factor=1.25, n_groups=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=2e-5)
    # an explicit n_groups still wins over the rules
    torch.testing.assert_close(pinned, unsharded, rtol=0, atol=0)
