"""The embedding-bag kernels' work map (csrc/embedding_bag.cu), modelled in
numpy on the CPU before any card runs it; the kernels themselves are held
against their plain version on the card by tests/test_torch_cuda.py.

``rt_embedding_bag`` routes a call to ``embedding_bag_wide_kernel`` (rows of
a multiple of 16 bytes from a 16-byte aligned table), to
``embedding_bag_narrow_kernel`` (rows of at most 64 bytes read in 8- or
4-byte words) or to the generic one-warp-a-bag kernel; ``_embedding_bag_map``
models the rule and the map's parameters, and its ``ROUTES`` (the entry's
choices written out, which the card tests hold the entry to) checks the
model.  ``work_map`` repeats, step for step, what a routed kernel's
warps do: the persistent grid's tiles, the staged chunks of (bag, slot)
entries (as ``stage_chunk`` fills them), the slots loaded before their
FMAs, each lane's loads (wide: words ``sub + k G`` of a row; narrow: words
``lane + 32 i`` of the tile's flat span) and its stores.  For every dim
1-256, float32 and bf16 tables, the table's and the bf16 output type, and
both routes, the map must write every output element once, read every
slot of every bag once, align every load and store to its width, and sum
each output column over its bag's slots in slot order, in one lane.

The emulated order is then run on seeded inputs (fmaf as a float64
product, exact for float32 factors, and one float64 sum rounded to
float32: a double rounding that can move the last bit in rare ties) and
held against the port's plain version and the JAX package's
``embedding_bag_ref`` and ``embedding_bag_pallas_op`` (interpret mode):
rtol = atol = 2e-5 in float32, 2e-2 in bf16 (tests/test_kernels.py:20-21);
bags of one are bit-equal to the cast followed by the gather."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.embedding_bag import embedding_bag_pallas_op
from repro.kernels.embedding_bag import embedding_bag_ref as jax_bag_ref
from repro_torch.kernels.embedding_bag import embedding_bag_ref
from repro_torch.kernels.embedding_bag.ops import GENERIC, NARROW, WIDE

import _embedding_bag_map as P

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "embedding_bag.cu").read_text()
ELT = {"float32": 4, "bfloat16": 2}
# (table type, output type): each type in its own, and bf16 rows from a
# float32 table (the cast form)
FORMS = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("float32", "bfloat16")]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
N_BLOCKS = 2             # a small grid, so the persistent loop wraps


def _source_int(name):
    m = re.search(rf"(?:constexpr int {name} = |#define {name} )(\d+)", SOURCE)
    assert m, name
    return int(m.group(1))


def test_plan_constants_are_the_kernel_sources():
    """The model's copies of the constants the map depends on, and the
    wrapper's route codes, are the CUDA source's."""
    assert P.VEC_WARPS == _source_int("kVecWarps")
    assert P.WIDE_BYTES == _source_int("kWideBytes")
    assert P.NARROW_MAX_BYTES == _source_int("kNarrowMaxBytes")
    assert P.STAGE == _source_int("kStage")
    m = re.search(r"constexpr int kOneRawWords = (\d+), kRawWords = (\d+);",
                  SOURCE)
    assert (P.ONE_RAW_WORDS, P.RAW_WORDS) == tuple(map(int, m.groups()))
    m = re.search(r"constexpr int kAccFloats = (\d+), "
                  r"kNarrowAccFloats = (\d+);", SOURCE)
    assert (P.ACC_FLOATS, P.NARROW_ACC_FLOATS) == tuple(map(int, m.groups()))
    assert re.search(r"kRanGeneric = %d, kRanWide = %d, kRanNarrow = %d"
                     % (GENERIC, WIDE, NARROW), SOURCE)


@pytest.mark.parametrize("table_offset", [0, 8, 4, 2])
@pytest.mark.parametrize("table_type", ["float32", "bfloat16"])
def test_router_picks_the_c_entry_kernel(table_type, table_offset):
    """The model's router gives the entry's choices as ``ROUTES`` writes
    them out, for a table base 0, 8, 4 or 2 bytes past a 16-byte boundary;
    bags of no slot and an output not 16-byte aligned take the generic
    kernel; the main paths' shapes take the routed ones."""
    elt = ELT[table_type]
    for table_addr in (table_offset, 256 + table_offset):
        for dim in P.ROUTE_DIMS:
            for nnz in (1, 2, 13, 39):
                assert P.plan(dim, nnz, elt, table_addr).kernel == P.route(
                    table_type, table_offset, dim), (dim, nnz)
            assert P.plan(dim, 0, elt, table_addr).kernel == P.GENERIC
            assert P.plan(dim, 1, elt, table_addr, 8).kernel == P.GENERIC
    assert P.plan(128, 1, 2).kernel == P.WIDE            # DLRM serve_bulk
    assert P.plan(128, 13, 2).kernel == P.WIDE           # DLRM item tower
    assert P.plan(10, 1, 4).kernel == P.NARROW           # DeepFM cast
    assert P.plan(1, 39, 4).kernel == P.NARROW           # DeepFM w1
    assert P.plan(10, 19, 4).kernel == P.NARROW          # item vectors


def _staged(p, bag0, c, n_bags, nnz):
    """stage_chunk: entry e of chunk c is (bag0 + e // J, c J + e % J), or
    (-1, -1) where that is past the bags or the slots."""
    jshift = p.j.bit_length() - 1
    e = np.arange(p.tb << jshift)
    assert e.size <= P.STAGE                       # the chunk fits
    bag = bag0 + (e >> jshift)
    slot = c * p.j + (e & (p.j - 1))
    ok = (bag < n_bags) & (slot < nnz)
    return np.where(ok, bag, -1), np.where(ok, slot, -1)


def work_map(p, n_bags, nnz, elt, out_elt):
    """Every FMA and store of a routed call, as the kernel's warps issue
    them.  Returns ``fma`` [n, 6] (lane, sequence, bag, slot, row byte,
    bytes) and ``store`` [m, 4] (lane, bag, output byte, bytes); a lane is
    numbered block * 256 + warp * 32 + lane."""
    lanes = np.arange(32)
    jshift = p.j.bit_length() - 1
    n_chunks = -(-nnz // p.j)
    n_tiles = -(-n_bags // p.tb)
    warps = N_BLOCKS * P.VEC_WARPS
    vo = p.v * out_elt // elt              # bytes a store
    fma, store = [], []
    seq = 0
    if p.kernel == P.WIDE:
        ng = 32 // p.g
        g, sub = lanes // p.g, lanes % p.g
        # (u, k) -> the lane's bag in the tile and its 16-byte word
        part = [(u * ng + g, sub + k * p.g) for u in range(p.u)
                for k in range(p.k)]
    else:
        span = p.tb * p.r
        wd = lanes[None] + 32 * np.arange(p.k)[:, None]       # [K, 32]
        part = [(np.where(wd[i] < span, wd[i] // p.r, p.tb), wd[i] % p.r)
                for i in range(p.k)]
    for gw in range(warps):
        for tile in range(gw, n_tiles, warps):
            lane_id = gw * 32 + lanes
            for c in range(n_chunks):
                sbag, sslot = _staged(p, tile * p.tb, c, n_bags, nnz)
                ns = min(p.j, nnz - c * p.j)
                for s0 in range(0, ns, p.s):
                    for b, word in part:           # u, k (wide) or i (narrow)
                        for q in range(p.s):       # slot order
                            seq += 1
                            s = s0 + q
                            live = (s < ns) & (b < p.tb) \
                                & (tile * p.tb + b < n_bags) & (word < p.r)
                            e = (np.minimum(b, p.tb - 1) << jshift) + s
                            e = np.minimum(e, sbag.size - 1)
                            rows = np.stack([lane_id, np.full(32, seq),
                                             sbag[e], sslot[e], word * p.v,
                                             np.full(32, p.v)], 1)[live]
                            assert (rows[:, 2] == tile * p.tb + b[live]).all()
                            assert (rows[:, 3] == c * p.j + s).all()
                            fma.append(rows)
            for b, word in part:
                bag = tile * p.tb + b
                live = (bag < n_bags) & (word < p.r) & (b < p.tb)
                out_byte = (bag * p.r + word) * vo
                store.append(np.stack([lane_id, bag, out_byte,
                                       np.full(32, vo)], 1)[live])
    return np.concatenate(fma), np.concatenate(store)


def _check_map(p, n_bags, nnz, elt, out_elt, table_addr, ids):
    fma, store = work_map(p, n_bags, nnz, elt, out_elt)
    rb, ob = p.r * p.v, p.r * p.v * out_elt // elt
    # every output byte written exactly once, by whole aligned stores
    written = np.zeros(n_bags * ob, np.int64)
    for w in np.unique(store[:, 3]):
        sel = store[store[:, 3] == w]
        assert (sel[:, 2] % w == 0).all()          # out is 16-byte aligned
        for d in range(w):
            np.add.at(written, sel[:, 2] + d, 1)
    assert (written == 1).all()
    # every slot of every bag reads each byte of its row once
    read = np.zeros((n_bags, nnz, rb), np.int64)
    for d in range(p.v):
        np.add.at(read, (fma[:, 2], fma[:, 3], fma[:, 4] + d), 1)
    assert (read == 1).all()
    # every load aligned to its width at the table bases the router takes
    addr = table_addr + ids[fma[:, 2], fma[:, 3]] * rb + fma[:, 4]
    assert (addr % p.v == 0).all()
    # each (bag, word) summed in slot order, by one lane
    order = np.lexsort((fma[:, 1], fma[:, 4], fma[:, 2]))
    f = fma[order].reshape(n_bags * p.r, nnz, 6)
    assert (f[:, :, 3] == np.arange(nnz)).all()
    assert (f[:, :, 0] == f[:, :1, 0]).all()


# table bases the routes take: 16 bytes (wide where the row allows), 8 and
# 4 (narrow only)
ALIGNMENTS = (16, 8, 4)


@pytest.mark.parametrize("dims", [range(lo, lo + 32)
                                  for lo in range(1, 257, 32)],
                         ids=lambda r: f"dim{r.start}-{r.stop - 1}")
@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(f))
def test_work_map_covers_aligns_and_orders(form, dims):
    """For each dim, bag sizes 1, 3 and 13 and every table base the
    routes take: outputs written once, slots read once, loads and stores
    aligned, each column summed in slot order by one lane, over a grid
    that wraps (N_BLOCKS blocks, at least two tiles a warp)."""
    table_type, out_type = form
    elt, out_elt = ELT[table_type], ELT[out_type]
    rng = np.random.default_rng(dims.start)
    routed = set()
    for dim in dims:
        for table_addr in ALIGNMENTS:
            for nnz in (1, 3, 13):
                p = P.plan(dim, nnz, elt, table_addr)
                if p.kernel == P.GENERIC:
                    continue
                routed.add(p.kernel)
                n_bags = 2 * N_BLOCKS * P.VEC_WARPS * p.tb + p.tb // 2 + 1
                ids = rng.integers(0, 1 << 20, (n_bags, nnz))
                _check_map(p, n_bags, nnz, elt, out_elt, table_addr, ids)
    assert routed        # every block of dims reaches a routed kernel


# ---------------------------------------------------------------------------
# The emulated order on seeded inputs, against the references
# ---------------------------------------------------------------------------


def emulate(table, ids, weights, mode, out_type):
    """The routed kernels' arithmetic: each output column one fmaf chain
    over the bag's slots in slot order (the order test_work_map_* holds
    the map to), rows rounded through the output type first, the weights
    summed in the same order, one rounding at the end."""
    tab = table.astype(np.float32)
    if out_type == "bfloat16":
        tab = torch.from_numpy(tab).bfloat16().float().numpy()
    n_bags, nnz = ids.shape
    w = np.ones(ids.shape, np.float32) if weights is None else weights
    acc = np.zeros((n_bags, tab.shape[1]), np.float32)
    wsum = np.zeros((n_bags, 1), np.float32)
    for j in range(nnz):
        prod = tab[ids[:, j]].astype(np.float64) * w[:, j:j + 1]
        acc = (acc.astype(np.float64) + prod).astype(np.float32)
        wsum = (wsum + w[:, j:j + 1]).astype(np.float32)
    if mode == "mean":
        acc = acc / np.maximum(wsum, np.float32(1.0))
    return torch.from_numpy(acc).to(getattr(torch, out_type))


def _inputs(seed, rows, dim, n_bags, nnz, table_type, weighted):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim), np.float32)
    if table_type == "bfloat16":
        table = torch.from_numpy(table).bfloat16().float().numpy()
    ids = rng.integers(0, rows, (n_bags, nnz))
    w = None
    if weighted:
        w = ((rng.random((n_bags, nnz)) > 0.3)
             * (0.5 + 1.5 * rng.random((n_bags, nnz)))).astype(np.float32)
        w[0] = 0.0                                # a bag of pads only
    return table, ids, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", [
    ("bfloat16", "bfloat16", 128, 1, "sum"),      # DLRM serve_bulk
    ("bfloat16", "bfloat16", 128, 13, "mean"),    # DLRM item tower
    ("float32", "bfloat16", 10, 1, "sum"),        # DeepFM serve_bulk (cast)
    ("float32", "float32", 1, 39, "sum"),         # DeepFM w1
    ("float32", "float32", 10, 19, "sum"),        # DeepFM item vectors
    ("float32", "float32", 96, 3, "mean"),
    ("float32", "float32", 256, 5, "sum"),
], ids=lambda c: "-".join(map(str, c)))
def test_emulated_order_matches_plain_and_jax(case, weighted):
    """The map's order on seeded inputs against the port's plain version,
    the JAX reference and the Pallas kernel in interpret mode."""
    table_type, out_type, dim, nnz, mode = case
    assert P.plan(dim, nnz, ELT[table_type]).kernel != P.GENERIC
    table, ids, w = _inputs(dim * 100 + nnz, 500, dim, 24, nnz, table_type,
                            weighted)
    got = emulate(table, ids, w, mode, out_type)
    tt = torch.from_numpy(table).to(getattr(torch, table_type))
    tw = None if w is None else torch.from_numpy(w)
    plain = embedding_bag_ref(tt, torch.from_numpy(ids), tw, mode=mode,
                              out_dtype=getattr(torch, out_type))
    # the JAX models cast the table to the compute type before the gather
    jt = jnp.asarray(table, getattr(jnp, out_type))
    jw = None if w is None else jnp.asarray(w)
    refs = {"plain": plain.float().numpy(),
            "jax_ref": np.asarray(jax_bag_ref(
                jt, jnp.asarray(ids), jnp.ones(ids.shape, jnp.float32)
                if jw is None else jw, mode=mode).astype(jnp.float32)),
            "pallas": np.asarray(embedding_bag_pallas_op(
                jt, jnp.asarray(ids), jw, mode=mode, interpret=True)
                .astype(jnp.float32))}
    for name, want in refs.items():
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **TOL[out_type], err_msg=name)
    if nnz == 1 and not weighted:
        want = torch.from_numpy(table).to(getattr(torch, out_type))[ids[:, 0]]
        assert torch.equal(got, want)              # bags of one are the rows
