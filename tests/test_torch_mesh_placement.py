"""Placement meshes in one process on the CPU: ``RankingRouter(mesh=)``
and ``IndexBuilder(mesh=)``, the consumers that place work on a mesh's
devices as the JAX package does by ``device_put``
(``repro/serving/sharded/router.py:159-214``,
``repro/index/builder.py:310-330``).

A mesh of repeated ``cpu`` entries models 4 devices, as the JAX tests do
with ``--xla_force_host_platform_device_count``.  The router on a mesh
is bit for bit the router on ``devices=`` and the single-process
service, and raises JAX's errors.  The data-parallel build splits each
batch in four: its streams are byte-equal to the one-device build's
where the rows encode alike in the smaller batch (here every fp16 and
int8 stream), and ``verify_index`` replays its per-device batch shape.
Small sizes, float32 compute, port weights from a seed."""
import numpy as np
import pytest
import torch

from repro_torch.core import prettr as TP
from repro_torch.dist.compat import AbstractMesh, Mesh
from repro_torch.index import IndexBuilder, TermRepIndex, verify_index
from repro_torch.serving import RankingRouter, RankingService, RankRequest

MAX_Q, MAX_D, N_DOCS = 8, 16, 40
CODECS = {"fp16": dict(codec="fp16"),
          "int8_kv": dict(codec="int8", store_layer_kv=True,
                          kv_codec="int8")}


def _cfg():
    return TP.PreTTRConfig(
        backbone=TP.make_backbone(n_layers=3, d_model=32, n_heads=2, d_ff=64,
                                  vocab_size=256, l=1,
                                  max_len=MAX_Q + MAX_D,
                                  compute_dtype=torch.float32,
                                  attn_impl="cuda", compress_impl="cuda"),
        l=1, max_query_len=MAX_Q, max_doc_len=MAX_D, compress_dim=16)


def _params():
    return TP.init_prettr(_cfg(), torch.Generator().manual_seed(0),
                          device="cpu")


def _docs():
    rng = np.random.default_rng(5)
    return [rng.integers(5, 256, int(n))
            for n in rng.integers(3, MAX_D, N_DOCS)]


def _requests():
    rng = np.random.default_rng(9)
    reqs = []
    for _ in range(6):
        q = np.zeros(MAX_Q, np.int64)
        n_q = int(rng.integers(2, MAX_Q - 1))
        q[: n_q + 2] = [1, *rng.integers(5, 200, n_q), 2]
        reqs.append((q, q != 0, [int(d) for d in
                                 rng.integers(0, N_DOCS, 12)]))
    return reqs


def _cpu_mesh(shape, names):
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = ["cpu"] * grid.size
    return Mesh(grid.reshape(shape), names)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Each codec built on one device and on a ("data",) mesh of 4."""
    root = tmp_path_factory.mktemp("mesh_builds")
    out = {}
    for name, kw in CODECS.items():
        for how, mesh in (("one", None),
                          ("mesh", _cpu_mesh((4,), ("data",)))):
            path = str(root / f"{name}_{how}")
            builder = IndexBuilder(path, _cfg(), _params(), n_shards=2,
                                   batch_size=16, device="cpu", mesh=mesh,
                                   **kw)
            out[name, how] = (path, builder, builder.build(_docs()))
    return out


def _drain(svc, reqs):
    for i, (q, qv, cands) in enumerate(reqs):
        svc.submit(RankRequest(q, qv, cands, request_id=f"q{i}"))
    return {r.request_id: r for r in svc.drain()}


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for rid in ref:
        assert not got[rid].degraded
        assert got[rid].doc_ids == ref[rid].doc_ids
        np.testing.assert_array_equal(got[rid].scores, ref[rid].scores)


# ---------------------------------------------------------------------------
# RankingRouter(mesh=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,names", [((4,), ("shard",)),
                                         ((2, 2), ("shard", "data")),
                                         ((2, 3), ("data", "shard"))])
@pytest.mark.parametrize("codec", list(CODECS))
def test_router_on_a_mesh_bit_matches_devices_and_the_service(
        builds, codec, shape, names):
    index = TermRepIndex.open(builds[codec, "one"][0])
    reqs = _requests()
    kw = dict(micro_batch=4, use_layer_kv=codec == "int8_kv")
    ref = _drain(RankingService(_params(), _cfg(), index, device="cpu",
                                **kw), reqs)
    mesh = _cpu_mesh(shape, names)
    n = mesh.shape["shard"]
    router = RankingRouter(_params(), _cfg(), index, mesh=mesh, **kw)
    assert router.n_shards == n
    assert [w.device for w in router.workers] == [torch.device("cpu")] * n
    _assert_same(_drain(router, reqs), ref)
    by_devices = RankingRouter(_params(), _cfg(), index,
                               devices=["cpu"] * n, **kw)
    _assert_same(_drain(by_devices, reqs), ref)
    assert router.stats.n_rows == by_devices.stats.n_rows


def test_router_refuses_a_mesh_as_jax_does(builds):
    index = TermRepIndex.open(builds["fp16", "one"][0])
    with pytest.raises(ValueError, match="needs a mesh with a 'shard' axis; "
                                         r"got axes \('data',\)"):
        RankingRouter(_params(), _cfg(), index,
                      mesh=_cpu_mesh((4,), ("data",)))
    with pytest.raises(ValueError, match="n_shards=3 but the mesh's shard "
                                         "axis has 4 positions"):
        RankingRouter(_params(), _cfg(), index, n_shards=3,
                      mesh=_cpu_mesh((4,), ("shard",)))


# ---------------------------------------------------------------------------
# IndexBuilder(mesh=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", list(CODECS))
def test_data_parallel_build_matches_the_one_device_build(builds, codec):
    one_path, one, one_report = builds[codec, "one"]
    dp_path, dp, dp_report = builds[codec, "mesh"]
    assert (dp.batch_size, len(dp.devices)) == (16, 4)
    assert dp_report.n_tokens == one_report.n_tokens
    a, b = TermRepIndex.open(one_path), TermRepIndex.open(dp_path)
    assert a.streams_spec() == b.streams_spec()
    ids = list(range(N_DOCS))
    pa, va = a.gather_raw(ids)
    pb, vb = b.gather_raw(ids)
    np.testing.assert_array_equal(va, vb)
    for name in pa:
        np.testing.assert_array_equal(pb[name], pa[name], err_msg=name)
    # the manifest records the batch one device encoded
    assert b.encode_batch == 4 and a.encode_batch == 16


@pytest.mark.parametrize("codec", list(CODECS))
def test_data_parallel_build_encodes_within_float32_of_one_device(codec):
    """Before the codec: each device's rows against the same rows of the
    one-device batch, within the float32 2e-5 (a smaller batch may block
    its products otherwise)."""
    from repro_torch.index.builder import pack_doc_batch

    kw = CODECS[codec]
    tokens, _, valid = pack_doc_batch(_docs()[:16], MAX_D)
    one = IndexBuilder(None, _cfg(), _params(), batch_size=16, device="cpu",
                       **kw)
    dp = IndexBuilder(None, _cfg(), _params(), batch_size=16, device="cpu",
                      mesh=_cpu_mesh((4,), ("data",)), **kw)
    want = one._host_batch(one._device_batch(tokens, valid))
    parts = dp._device_batch(tokens, valid)
    assert len(parts) == 4 and all(p[0].shape[0] == 4 for p in parts)
    got = dp._host_batch(parts)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    if kw.get("store_layer_kv"):
        for g, w in zip(got[1], want[1]):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def test_data_parallel_build_verifies_and_serves(builds):
    path, _, _ = builds["int8_kv", "mesh"]
    index = TermRepIndex.open(path)
    assert verify_index(index, _cfg(), _params(), _docs(), sample=16,
                        device="cpu") == 16
    reqs = _requests()
    ref = _drain(RankingService(_params(), _cfg(),
                                TermRepIndex.open(builds["int8_kv", "one"][0]),
                                device="cpu", micro_batch=4,
                                use_layer_kv=True), reqs)
    _assert_same(_drain(RankingService(_params(), _cfg(), index,
                                       device="cpu", micro_batch=4,
                                       use_layer_kv=True), reqs), ref)


def test_data_parallel_build_rounds_its_batch_and_needs_a_data_axis():
    mesh = _cpu_mesh((4,), ("data",))
    b = IndexBuilder(None, _cfg(), _params(), batch_size=10, device="cpu",
                     mesh=mesh)
    assert b.batch_size == 12
    with pytest.raises(ValueError, match="'data' axis"):
        IndexBuilder(None, _cfg(), _params(), device="cpu",
                     mesh=_cpu_mesh((4,), ("shard",)))
    with pytest.raises(ValueError, match="'data' axis"):
        IndexBuilder(None, _cfg(), _params(), device="cpu",
                     mesh=AbstractMesh((4,), ("model",)))


def test_build_index_cli_data_parallel_on_one_device(tmp_path, capsys):
    from repro_torch.launch import build_index
    build_index.main(["--out", str(tmp_path / "idx"), "--n-docs", "24",
                      "--batch", "8", "--data-parallel", "--verify",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert "--data-parallel: one device visible, running single-host" \
        in text
    assert "24 docs" in text and "byte-identical" in text
