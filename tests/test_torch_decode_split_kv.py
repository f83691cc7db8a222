"""The split-KV Sq = 1 kernel's arithmetic (csrc/decode_attention.cuh),
emulated in plain torch on the CPU and held against the JAX package
before any card runs it (the kernel itself is held against the plain
versions on the card by tests/test_torch_cuda.py).

The kernel cuts each row's visible keys ``[lo, hi)`` into the planner's
``n_splits`` chunks (``kernels/decode_attention/plan.py``).  Inside a
block, D / 8 lanes own a key and 128 / (D / 8) lane groups take 4 keys of
each tile in turn, each group folding them into its own float32 online
softmax (one max and one rescale a tile); the groups then merge, and
with more than one split a merge kernel combines the splits' (m, l, acc)
in split order, skipping empty splits, whose acc it never wrote.
``split_kv_emulate`` repeats exactly those steps; empty splits' acc is
NaN here, so a merge that read it would show.

References: the JAX package's ``flash_decode_attention`` (the Pallas
kernel in interpret mode on the CPU, as tests/test_kernels.py runs it)
and ``join_attention_ref``, float32, rtol = atol = 2e-5.  Rows that see
no key are compared only with the port's documented 0 (the Pallas
kernel averages the masked keys of the tiles it visits there)."""
import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention import (
    flash_decode_attention as jax_flash_decode)
from repro.kernels.join_attention.ref import (
    join_attention_ref as jax_join_ref)
from repro_torch.kernels.decode_attention.plan import (ALIGN, BLOCK_ROWS,
                                                       decode_span,
                                                       plan_splits,
                                                       row_groups,
                                                       split_bounds)

NEG_INF = -1e30
H100_SMS = 132
KEYS = 4            # keys a lane group takes from each tile
THREADS = 128
TOL = dict(rtol=2e-5, atol=2e-5)


def split_kv_emulate(q, k, v, ok, lo, hi, n_splits):
    """q: [B, Hkv, R, D]; k, v: [B, Hkv, S, D] (the kernel's key
    positions); ok: [B, S] key validity; lo, hi: [B] each row's range.
    Returns float32 [B, Hkv, R, D]."""
    b, hkv, r, d = q.shape
    s = k.shape[2]
    lpk = d // 8
    kg = THREADS // lpk
    bn = KEYS * kg
    q, k, v = q.float(), k.float(), v.float()
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # [B, S, Hkv, D]
    rows = torch.arange(b)[:, None, None]
    within = (torch.arange(KEYS)[:, None] * kg
              + torch.arange(kg)[None])                     # [KEYS, KG]
    parts = []
    for sp in range(n_splits):
        s_lo, s_hi = split_bounds(lo, hi, n_splits, sp)
        m = torch.full((b, hkv, kg, r), NEG_INF)
        l = torch.zeros((b, hkv, kg, r))
        acc = torch.zeros((b, hkv, kg, r, d))
        n_tiles = int(((s_hi - s_lo + bn - 1) // bn).clamp_min(0).max())
        for i in range(n_tiles):
            j = s_lo[:, None, None] + i * bn + within[None]  # [B, KEYS, KG]
            jc = j.clamp(0, s - 1)
            okk = (j < s_hi[:, None, None]) & ok[rows, jc]
            # [B, Hkv, KG, KEYS, D] rows, a [B, 1, KG, KEYS, 1] mask
            kk = kt[rows, jc].permute(0, 3, 2, 1, 4)
            vv = vt[rows, jc].permute(0, 3, 2, 1, 4)
            mask = okk.transpose(1, 2)[:, None, :, :, None]
            sc = torch.einsum("bhrd,bhgkd->bhgkr", q, kk) / math.sqrt(d)
            sc = torch.where(mask, sc, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, sc.amax(3))
            corr = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(sc - m_new[:, :, :, None]),
                            torch.tensor(0.0))
            l = l * corr + p.sum(3)
            acc = acc * corr[..., None] \
                + torch.einsum("bhgkr,bhgkd->bhgrd", p, vv)
            m = m_new
        # the block's lane groups merge in shared memory
        mx = m.amax(2)
        w = torch.exp(m - mx[:, :, None])
        den = (l * w).sum(2)
        num = (acc * w[..., None]).sum(2)
        if n_splits == 1:
            return num / den.clamp_min(1e-30)[..., None]
        empty = (s_lo >= s_hi)[:, None, None]
        parts.append((torch.where(empty, torch.tensor(NEG_INF), mx),
                      torch.where(empty, torch.tensor(0.0), den),
                      torch.where(empty[..., None], torch.tensor(math.nan),
                                  num)))
    return merge(parts)


def merge(parts):
    """sq1_merge_kernel: the splits' (m, l, acc) in split order."""
    ms, ls, accs = (torch.stack(x) for x in zip(*parts))
    used = ls > 0
    mx = torch.where(used, ms, torch.tensor(NEG_INF)).amax(0)
    w = torch.where(used, torch.exp(ms - mx), torch.tensor(0.0))
    den = (ls * w).sum(0)
    num = torch.where(used[..., None], accs * w[..., None],
                      torch.tensor(0.0)).sum(0)
    return num / den.clamp_min(1e-30)[..., None]


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, np.float32))


def _grouped(q, hkv):
    """[B, Hq, 1, D] -> [B, Hkv, R, D], the kernel's GQA rows."""
    b, hq, _, d = q.shape
    return q[:, :, 0].reshape(b, hkv, hq // hkv, d)


def _decode_range(lengths, s, window):
    """Each row's [lo, hi), as OneSeq::range computes it."""
    length = torch.as_tensor(lengths)
    hi = length.clamp_max(s)
    lo = (length - window).clamp_min(0) if window > 0 \
        else torch.zeros_like(length)
    return lo, hi


def _jax_decode(q, k, v, lengths, valid, window):
    out = jax_flash_decode(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()),
        None if lengths is None else jnp.asarray(np.asarray(lengths,
                                                            np.int32)),
        None if valid is None else jnp.asarray(valid.numpy()),
        window=window)
    return torch.from_numpy(np.array(out, np.float32))


def _splits(choice, blocks, span):
    return {"one": 1, "two": 2,
            "planner": plan_splits(blocks, span, H100_SMS)}[choice]


def _hold(got, want, seen):
    """got [B, Hkv, R, D] against want [B, Hq, 1, D]; rows that see no
    key (``seen`` [B] False) must be 0."""
    want = want[:, :, 0].reshape(got.shape)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got[seen], want[seen], **TOL)
    assert torch.equal(got[~seen], torch.zeros_like(got[~seen]))


# -- the planner and the chunk bounds ----------------------------------------


@pytest.mark.parametrize("blocks,span,want", [
    (4 * 4, decode_span(2080, -1), 17),      # gemma3 decode, global layers
    (4 * 4, decode_span(2080, 1024), 16),    # gemma3 decode, window layers
    (32 * 12, decode_span(512, -1), 1),      # CLS-only layer, micro-batch 32
    (32 * 12, 32 + 480, 1),                  # the join's CLS row
    (4 * 12, 512, 6),                        # rank_forward's 4 pairs
    (4 * 4, 63, 1),                          # fewer keys than MIN_KEYS
    (1, 100_000, 264),                       # one block: 2 an SM
])
def test_planner_fills_the_card_from_shapes(blocks, span, want):
    assert plan_splits(blocks, span, H100_SMS) == want


def test_planner_reads_no_device_value():
    """The planner takes Python ints (shapes) and nothing else: a tensor,
    whose value could sit on the card, is refused before it is read."""
    with pytest.raises(TypeError, match="Python ints"):
        plan_splits(torch.tensor(16), 2080, H100_SMS)
    with pytest.raises(TypeError, match="Python ints"):
        plan_splits(16, torch.tensor([2064]), H100_SMS)
    assert row_groups(8) == 1 and row_groups(12) == 2


def _row_blocks(r):
    """A KV head's blocks for a GQA group of ``r`` query heads, as
    ``sq1::launch`` and the kernel cut it: RB rows a block (1, 2, 4 or
    BLOCK_ROWS), and each block's first row and row count."""
    rb = 1 if r == 1 else 2 if r == 2 else 4 if r <= 4 else BLOCK_ROWS
    return rb, [(r0, min(rb, r - r0)) for r0 in range(0, r, rb)]


# the four LMs' decode groups: granite 24/8 (R = 3, padded to 4 rows),
# mistral 96/8 (12: a full row group and a partial one of 4), chatglm3
# 32/2 and qwen3 64/4 (16: two full ones), and 24 (three)
LM_GROUPS = {"granite": (4, 24, 8), "mistral": (4, 96, 8),
             "chatglm3": (4, 32, 2), "qwen3": (4, 64, 4),
             "r24": (2, 48, 2)}


@pytest.mark.parametrize("model", list(LM_GROUPS))
def test_row_groups_address_each_head_once(model):
    """Every query head is written by exactly one block, none past
    Hq - 1, and the split partials of every block stay inside the
    planner's [B, Hq, n_splits, D + 2] buffer; the planner counts the
    blocks the kernel launches."""
    b, hq, hkv = LM_GROUPS[model]
    r, d = hq // hkv, 128
    rb, blocks = _row_blocks(r)
    assert len(blocks) == row_groups(r) == -(-r // BLOCK_ROWS)
    n_splits = plan_splits(b * hkv * row_groups(r),
                           decode_span(2080, -1), H100_SMS)
    written, top = [], 0
    for hk in range(hkv):
        for r0, nr in blocks:
            assert 0 < nr <= rb
            h0 = hk * r + r0
            written.extend(range(h0, h0 + nr))
            last = ((b - 1) * hq + h0 + nr - 1) * n_splits + n_splits - 1
            top = max(top, (last + 1) * (d + 2))
    assert sorted(written) == list(range(hq))
    assert top == b * hq * n_splits * (d + 2)


@pytest.mark.parametrize("window", [-1, 40])
@pytest.mark.parametrize("r", [3, 12, 16, 24])
def test_large_groups_split_kv_match_pallas(r, window):
    """GQA groups above 8 rows through the emulated kernel, one row group
    at a time, against the Pallas flash decode (whose block takes the
    whole group): D = 64, ragged lengths over 300 keys, two splits."""
    rng = np.random.default_rng(31)
    b, hkv, s, d = 2, 2, 300, 64
    q = _f32(rng, b, hkv * r, 1, d)
    k, v = _f32(rng, b, hkv, s, d), _f32(rng, b, hkv, s, d)
    lengths = [300, 137]
    want = _jax_decode(q, k, v, lengths, None, window)
    lo, hi = _decode_range(lengths, s, window)
    rows = _grouped(q, hkv)
    got = torch.cat([split_kv_emulate(rows[:, :, r0:r0 + nr], k, v,
                                      torch.ones((b, s), dtype=torch.bool),
                                      lo, hi, 2)
                     for r0, nr in _row_blocks(r)[1]], dim=2)
    _hold(got, want, torch.ones(b, dtype=torch.bool))


@pytest.mark.parametrize("n_splits", [1, 2, 6, 17, 33])
def test_split_bounds_cover_each_row_once(n_splits):
    """Splits are disjoint, in order, start at lo + a multiple of ALIGN,
    and together cover [lo, hi); ints and tensors agree."""
    rows = [(0, 0), (0, 1), (0, 64), (477, 1501), (1040, 2064), (0, 2080),
            (5, 3)]
    lo = torch.tensor([r[0] for r in rows])
    hi = torch.tensor([r[1] for r in rows])
    for i, (a, z) in enumerate(rows):
        covered = []
        for sp in range(n_splits):
            s_lo, s_hi = split_bounds(a, z, n_splits, sp)
            t_lo, t_hi = split_bounds(lo, hi, n_splits, sp)
            assert (s_lo, s_hi) == (int(t_lo[i]), int(t_hi[i]))
            assert (s_lo - a) % ALIGN == 0
            covered.extend(range(s_lo, s_hi))
        assert covered == list(range(a, max(a, z)))


# -- flash decode against the Pallas kernel ----------------------------------

# gemma3's decode shape cut to 2 KV heads: GQA 4/2, D = 256, a 2080-key
# cache; queries at positions 0, 63, 64, 1023, 1500, 2063.  With the
# 1024-key window the rows start at 0, 477 (off the 16-key grid) and 1040
# (on it)
GEMMA_POS = [0, 63, 64, 1023, 1500, 2063]


@functools.lru_cache(maxsize=None)
def _gemma_world(window):
    rng = np.random.default_rng(30)
    b, hq, hkv, s, d = len(GEMMA_POS), 4, 2, 2080, 256
    q = _f32(rng, b, hq, 1, d)
    k, v = _f32(rng, b, hkv, s, d), _f32(rng, b, hkv, s, d)
    lengths = [p + 1 for p in GEMMA_POS]
    return q, k, v, lengths, _jax_decode(q, k, v, lengths, None, window)


@pytest.mark.parametrize("choice", ["one", "two", "planner"])
@pytest.mark.parametrize("window", [-1, 1024])
def test_gemma3_decode_split_kv(window, choice):
    q, k, v, lengths, want = _gemma_world(window)
    b, hkv, s = k.shape[0], k.shape[1], k.shape[2]
    lo, hi = _decode_range(lengths, s, window)
    n = _splits(choice, b * hkv, decode_span(s, window))
    got = split_kv_emulate(_grouped(q, hkv), k, v,
                           torch.ones((b, s), dtype=torch.bool), lo, hi, n)
    _hold(got, want, torch.ones(b, dtype=torch.bool))


@pytest.mark.parametrize("choice", ["one", "two", "planner"])
def test_cls_layer_two_prefixes_with_masked_splits(choice):
    """The CLS-only layer at q [4, 12, 1, 64] against a query prefix in
    [0, 32) and a doc prefix from 32: short docs leave whole splits of the
    planner's 6 masked; the last row sees no key.  No lengths: every key
    up to S is in range and the mask decides, as the wrapper calls it."""
    rng = np.random.default_rng(31)
    b, h, lq, ld, d = 4, 12, 32, 480, 64
    s = lq + ld
    q, k, v = _f32(rng, b, h, 1, d), _f32(rng, b, h, s, d), \
        _f32(rng, b, h, s, d)
    pos = torch.arange(s)[None]
    q_len = torch.tensor([[3], [32], [17], [0]])
    d_len = torch.tensor([[20], [480], [101], [0]])
    valid = (pos < q_len) | ((pos >= lq) & (pos < lq + d_len))
    want = _jax_decode(q, k, v, None, valid, -1)
    lo, hi = _decode_range([s] * b, s, -1)     # no lengths: S
    n = _splits(choice, b * h, s)
    got = split_kv_emulate(_grouped(q, h), k, v, valid, lo, hi, n)
    _hold(got, want, valid.any(1))


@pytest.mark.parametrize("choice", ["one", "two", "planner"])
@pytest.mark.parametrize("window", [-1, 300])
def test_ragged_cache_not_a_multiple_of_the_chunk(window, choice):
    """S = 1100 (not a multiple of the 64-key tile at D = 64 nor of any
    split), GQA 8/2, lengths 1100, 613 and 7 with a non-prefix mask."""
    rng = np.random.default_rng(32)
    b, hq, hkv, s, d = 3, 8, 2, 1100, 64
    q = _f32(rng, b, hq, 1, d)
    k, v = _f32(rng, b, hkv, s, d), _f32(rng, b, hkv, s, d)
    lengths = [1100, 613, 7]
    valid = torch.from_numpy(rng.random((b, s)) < 0.8)
    valid[torch.arange(b), torch.tensor(lengths) - 1] = True
    want = _jax_decode(q, k, v, lengths, valid, window)
    lo, hi = _decode_range(lengths, s, window)
    n = _splits(choice, b * hkv, decode_span(s, window))
    got = split_kv_emulate(_grouped(q, hkv), k, v, valid, lo, hi, n)
    _hold(got, want, torch.ones(b, dtype=torch.bool))


# -- the join's CLS row against the JAX reference ---------------------------


@pytest.mark.parametrize("choice", ["one", "two", "planner"])
def test_join_cls_row_split_kv(choice):
    """q [4, 12, 1, 64] against a 32-key query segment and a 480-key doc
    segment with non-prefix doc validity: the kernel's key positions are
    the query segment's, then the doc segment's."""
    rng = np.random.default_rng(33)
    b, h, lq, ld, d = 4, 12, 32, 480, 64
    q = _f32(rng, b, h, 1, d)
    kq, vq = _f32(rng, b, h, lq, d), _f32(rng, b, h, lq, d)
    kd, vd = _f32(rng, b, h, ld, d), _f32(rng, b, h, ld, d)
    kqv = torch.arange(lq)[None] < torch.tensor([[5], [32], [1], [12]])
    kdv = torch.from_numpy(rng.random((b, ld)) < 0.85)
    kdv[2, 40:] = False                       # a short doc: masked splits
    want = jax_join_ref(*(jnp.asarray(t.numpy())
                          for t in (q, kq, vq, kd, vd, kqv, kdv)))
    want = torch.from_numpy(np.array(want, np.float32))
    n = _splits(choice, b * h, lq + ld)
    got = split_kv_emulate(
        _grouped(q, h), torch.cat([kq, kd], 2), torch.cat([vq, vd], 2),
        torch.cat([kqv, kdv], 1), torch.zeros(b, dtype=torch.long),
        torch.full((b,), lq + ld), n)
    _hold(got, want, torch.ones(b, dtype=torch.bool))


def test_merge_repeats_bit_for_bit():
    """The fixed-order merge gives the same bits on every call, and the
    planner's many splits of the gemma3 window form agree with one split
    to float32 rounding."""
    q, k, v, lengths, _ = _gemma_world(1024)
    b, hkv, s = k.shape[0], k.shape[1], k.shape[2]
    lo, hi = _decode_range(lengths, s, 1024)
    ok = torch.ones((b, s), dtype=torch.bool)
    n = plan_splits(b * hkv, decode_span(s, 1024), H100_SMS)
    runs = [split_kv_emulate(_grouped(q, hkv), k, v, ok, lo, hi, n)
            for _ in range(2)]
    assert n > 1 and torch.equal(runs[0], runs[1])
    one = split_kv_emulate(_grouped(q, hkv), k, v, ok, lo, hi, 1)
    torch.testing.assert_close(runs[0], one, **TOL)
