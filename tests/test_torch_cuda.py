"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same inputs, the wrappers' argument checks, and
the smoke-size service through the kernels against the plain impl (fused
and legacy concat joins, prefetched and synchronous drains, an injected
staging fault), gemma3's smoke_config forward and decode through the
kernels against the plain impl, the embedding-bag kernel with the
recsys smoke models through it (a train cell among them: the kernel
forward, the plain gradient), the sharded router against the service
and the split kernel at BERT4Rec's head dim 32.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; this file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol = atol = 2e-5 in float32 and 2e-2 in bfloat16/float16
(tests/test_kernels.py), the kernel and its plain version summing in
different orders."""
import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  flash_decode_attention)
from repro_torch.kernels.embedding_bag import (embedding_bag_op,
                                               embedding_bag_ref)
from repro_torch.kernels.fused_compress import (compress_ref, decompress_ref,
                                                fused_compress,
                                                fused_decompress)
from repro_torch.kernels.join_attention import (join_attention_ref,
                                                join_attention_ref_paged,
                                                join_attention_ref_quant,
                                                join_flash_attention,
                                                join_flash_attention_paged)
from repro_torch.kernels.masking import last_valid_lengths
from repro_torch.kernels.split_attention import (split_attention_ref,
                                                 split_flash_attention)

import _embedding_bag_map as bag_map

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _tol(name):
    return dict(rtol=2e-5, atol=2e-5) if name == "float32" \
        else dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode "
                    "(their plain versions are held against JAX in "
                    "tests/test_torch_kernels.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _close(got, want, name):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(name))


SPLIT_SHAPES = [
    (2, 4, 2, 64, 32, -1),       # GQA, single segment
    (2, 2, 1, 80, 32, 24),       # split, off-tile boundary, MQA
    (1, 4, 4, 40, 16, 8),        # split, D=16 (smoke_config heads)
    (2, 12, 12, 480, 64, -1),    # precompute_docs at full width
    (2, 12, 12, 512, 64, 32),    # rank_forward at full width
    (1, 12, 12, 32, 64, -1),     # encode_query at full width
    (2, 8, 8, 48, 128, 20),      # D=128
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,boundary", SPLIT_SHAPES)
def test_split_attention_kernel(dev, b, hq, hkv, s, d, boundary, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    dt = DTYPES[dtype]
    q, k, v = (_rand(g, dev, dt, b, h, s, d) for h in (hq, hkv, hkv))
    valid = torch.arange(s, device=dev)[None] < torch.randint(
        s // 2, s + 1, (b, 1), device=dev, generator=g)
    valid[:, 1] = False                       # non-prefix validity
    valid[:, 0] = True
    if boundary >= 0:
        valid[:, boundary] = True
    got = split_flash_attention(q, k, v, None, k_valid=valid,
                                seg_boundary=boundary)
    want = split_attention_ref(q, k, v, last_valid_lengths(valid), valid,
                               seg_boundary=boundary)
    _close(got, want, dtype)


def _visible_rows(sq, skv, lengths, valid, causal, window, boundary):
    """[B, Sq]: rows that see at least one key.  A row that sees none is
    out of the kernel's contract (it skips that row's tiles, as the Pallas
    kernel does; the plain version averages every key)."""
    dev = lengths.device
    qp = torch.arange(sq, device=dev)[:, None]
    kp = torch.arange(skv, device=dev)[None, :]
    ok = (kp < lengths[:, None, None]) & valid[:, None, :] & (qp >= 0)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    if boundary >= 0:
        ok = ok & ((qp >= boundary) == (kp >= boundary))
    return ok.any(-1)


# form, (causal, window, seg_boundary, int8 K/V), its launch counter
SPLIT_FORMS = {
    "causal": (True, -1, -1, False, "causal_launches"),
    "window": (True, 24, -1, False, "window_launches"),
    "window_bidirectional": (False, 40, -1, False, "window_launches"),
    "int8": (False, -1, -1, True, "int8_launches"),
    "int8_causal_window": (True, 24, -1, True, "int8_launches"),
    "seg_boundary": (False, -1, 37, False, "launches"),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("form", list(SPLIT_FORMS))
def test_split_attention_lm_forms_kernel(dev, form, d, dtype):
    """Every mask form and the int8 form at every head dim, GQA 8/4, ragged
    Sq = 70 and Skv = 100 (neither a multiple of the 16- or 32-key tile),
    ragged lengths and non-prefix validity, against the plain version on
    the rows that see a key; each form counts in its own counter."""
    causal, window, boundary, int8, counter = SPLIT_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(14)
    dt = DTYPES[dtype]
    b, sq, skv = 3, 70, 100
    q = _rand(g, dev, dt, b, 8, sq, d)
    if int8:
        k, v = (torch.randint(-127, 128, (b, 4, skv, d), generator=g,
                              device=dev, dtype=torch.int32).to(torch.int8)
                for _ in range(2))
        ks, vs = (1e-3 + 0.05 * torch.rand((b, skv), generator=g, device=dev)
                  for _ in range(2))
    else:
        k, v = (_rand(g, dev, dt, b, 4, skv, d) for _ in range(2))
        ks = vs = None
    lengths = torch.tensor([skv, 61, 83], device=dev, dtype=torch.int32)
    valid = torch.rand((b, skv), generator=g, device=dev) < 0.85
    valid[:, 0] = True
    kw = dict(causal=causal, window=window, seg_boundary=boundary)
    before = getattr(split_flash_attention, counter)
    got = split_flash_attention(q, k, v, lengths, valid, ks, vs, **kw)
    assert getattr(split_flash_attention, counter) == before + 1
    want = split_attention_ref(q, k, v, lengths, valid, ks, vs, **kw)
    rows = _visible_rows(sq, skv, lengths, valid, causal, window, boundary)
    assert rows.float().mean() > 0.8
    _close(got.transpose(1, 2)[rows], want.transpose(1, 2)[rows], dtype)


def test_split_attention_gemma3_prefill_shape(dev):
    """The LM slice's prefill shape: [4, 8, 2048, 256] bf16 against GQA
    [4, 4, 2048, 256], causal and causal + 1024-key window."""
    g = torch.Generator(device=dev).manual_seed(15)
    q = _rand(g, dev, torch.bfloat16, 4, 8, 2048, 256)
    k, v = (_rand(g, dev, torch.bfloat16, 4, 4, 2048, 256) for _ in range(2))
    for window in (-1, 1024):
        _close(split_flash_attention(q, k, v, causal=True, window=window),
               split_attention_ref(q, k, v, torch.full((4,), 2048,
                                                       device=dev),
                                   causal=True, window=window), "bfloat16")


def test_split_attention_writes_strided_out(dev):
    """The backend hands the kernel model-layout ([B, S, H, D]) views."""
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (_rand(g, dev, torch.float32, 2, 40, 4, 32) for _ in range(3))
    out = torch.empty_like(q)
    split_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), None, seg_boundary=8,
                          out=out.transpose(1, 2))
    want = split_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               torch.full((2,), 40, device=dev),
                               seg_boundary=8)
    _close(out.transpose(1, 2), want, "float32")


JOIN_SHAPES = [
    (2, 4, 2, 32, 8, 24, 32),    # GQA
    (3, 8, 4, 40, 32, 8, 16),    # long query segment, short docs
    (2, 12, 12, 512, 32, 480, 64),  # join layers at full width
    (4, 12, 12, 1, 32, 480, 64),    # CLS row at full width
    (1, 4, 1, 1, 16, 48, 32),    # CLS row, MQA
    (2, 8, 8, 1, 8, 100, 128),   # CLS row, D=128
    (2, 4, 4, 70, 40, 66, 128),  # D=128, two query-segment tiles
]
# the split-KV kernel's CLS rows only (the int8 forms take D <= 128)
JOIN_ROW_SHAPES = [
    (2, 8, 1, 1, 5, 70, 16),     # GQA 8/1, D=16
    (3, 4, 2, 1, 32, 200, 256),  # GQA 2, D=256
    (2, 12, 1, 1, 8, 40, 64),    # 12 heads a KV head: two row groups
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,lq,ld,d", JOIN_SHAPES + JOIN_ROW_SHAPES)
def test_join_attention_kernel(dev, b, hq, hkv, sq, lq, ld, d, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    dt = DTYPES[dtype]
    q = _rand(g, dev, dt, b, hq, sq, d)
    kq, vq = (_rand(g, dev, dt, b, hkv, lq, d) for _ in range(2))
    kd, vd = (_rand(g, dev, dt, b, hkv, ld, d) for _ in range(2))
    kqv = torch.arange(lq, device=dev)[None] < torch.randint(
        1, lq + 1, (b, 1), device=dev, generator=g)
    kdv = torch.arange(ld, device=dev)[None] < torch.randint(
        1, ld + 1, (b, 1), device=dev, generator=g)
    kdv[:, min(2, ld - 1)] = False            # non-prefix doc validity
    kdv[:, 0] = True
    before = (join_flash_attention.launches,
              join_flash_attention.row_launches)
    got = join_flash_attention(q, kq, vq, kd, vd, kqv, kdv)
    want = join_attention_ref(q, kq, vq, kd, vd, kqv, kdv)
    _close(got, want, dtype)
    row = int(sq == 1)
    assert (join_flash_attention.launches - before[0],
            join_flash_attention.row_launches - before[1]) == (1 - row, row)


# The compressor kernels' tensor-core tiles: compress 128 rows a block,
# decompress 32.  Row counts at the tile edges (1, tile - 1, tile + 1) and
# the main path's (64 docs x 480 tokens at index time, 32 pairs x 480 a
# micro-batch) at prettr_bert.full_config's d = 768, e = 256.
COMPRESS_EDGES = [(1, 768, 256), (127, 768, 256), (129, 768, 256),
                  (64 * 480, 768, 256)]
DECOMPRESS_EDGES = [(1, 256, 768), (31, 256, 768), (33, 256, 768),
                    (32 * 480, 256, 768)]


def _route(fn, before, tensor_core):
    """The call since ``before`` (``_routed``) went to the tensor-core
    kernel (or, with ``tensor_core`` False, the CUDA-core one)."""
    tc, cc = _routed(fn)
    assert (tc - before[0], cc - before[1]) == ((1, 0) if tensor_core
                                                else (0, 1))


def _compress_on_tc(d, e):
    """rt_compress's rule for these aligned operands: d % 32, e % 8."""
    return d % 32 == 0 and e % 8 == 0


def _decompress_on_tc(e, d):
    """rt_decompress's rule: e % 32, d % 8, d <= 768."""
    return e % 32 == 0 and d % 8 == 0 and d <= 768


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,e", [(37, 64, 16), (2 * 480, 768, 256),
                                      (33, 1024, 8), (5, 8, 1000),
                                      *COMPRESS_EDGES])
def test_compress_kernel(dev, rows, d, e, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    x = _rand(g, dev, DTYPES[dtype], rows, d)
    w = _rand(g, dev, torch.float32, d, e) / d ** 0.5
    b = _rand(g, dev, torch.float32, e)
    before = _routed(fused_compress)
    got = fused_compress(x, w, b)
    assert got.dtype == torch.float16 and got.shape == (rows, e)
    _route(fused_compress, before, _compress_on_tc(d, e))
    _close(got, compress_ref(x, w, b), "float16")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,e,d", [(37, 16, 64), (2 * 480, 256, 768),
                                      (33, 8, 1024), (5, 1000, 8),
                                      *DECOMPRESS_EDGES])
def test_decompress_kernel(dev, rows, e, d, dtype):
    g = torch.Generator(device=dev).manual_seed(4)
    r = _rand(g, dev, torch.float16, rows, e)
    w = _rand(g, dev, torch.float32, e, d) / e ** 0.5
    b, gamma, beta = (_rand(g, dev, torch.float32, d) for _ in range(3))
    dt = DTYPES[dtype]
    before = _routed(fused_decompress)
    got = fused_decompress(r, w, b, gamma, beta, out_dtype=dt)
    assert got.dtype == dt and got.shape == (rows, d)
    _route(fused_decompress, before, _decompress_on_tc(e, d))
    _close(got, decompress_ref(r, w, b, gamma, beta, out_dtype=dt), dtype)


def _int8_kv(g, dev, *shape):
    """Raw int8 K/V and per-token scales like the int8 codec's."""
    x = torch.randint(-127, 128, shape, generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    b, _, ld, _ = shape
    s = 1e-3 + 0.05 * torch.rand((b, ld), generator=g, device=dev)
    return x, s


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,lq,ld,d", JOIN_SHAPES)
def test_join_attention_int8_kernel(dev, b, hq, hkv, sq, lq, ld, d, dtype):
    """Raw int8 doc K/V with per-token scales against decode-then-attend;
    Sq = 1 goes to the tiled kernel too."""
    g = torch.Generator(device=dev).manual_seed(6)
    dt = DTYPES[dtype]
    q = _rand(g, dev, dt, b, hq, sq, d)
    kq, vq = (_rand(g, dev, dt, b, hkv, lq, d) for _ in range(2))
    (kd, ks), (vd, vs) = (_int8_kv(g, dev, b, hkv, ld, d) for _ in range(2))
    kqv = torch.arange(lq, device=dev)[None] < torch.randint(
        1, lq + 1, (b, 1), device=dev, generator=g)
    kdv = torch.arange(ld, device=dev)[None] < torch.randint(
        1, ld + 1, (b, 1), device=dev, generator=g)
    kdv[:, min(2, ld - 1)] = False            # non-prefix doc validity
    kdv[:, 0] = True
    before = join_flash_attention.int8_launches
    got = join_flash_attention(q, kq, vq, kd, vd, kqv, kdv, ks, vs)
    want = join_attention_ref_quant(q, kq, vq, kd, vd, ks, vs, kqv, kdv)
    _close(got, want, dtype)
    assert join_flash_attention.int8_launches == before + 1


POOL_DTYPES = {"int8": torch.int8, **DTYPES}


def _paged_world(g, dev, b, hkv, d, page, n_slots, pool_dtype):
    """Pools [P, page, Hkv, D] with page 0 all zero, a page table whose
    rows hold distinct real pages, zero-page tails and, in row 0, a stale
    page (real data, zero validity) behind the document's end; non-prefix
    validity inside the documents."""
    n_pool = 2 + b * n_slots
    if pool_dtype == torch.int8:
        k = torch.randint(-127, 128, (n_pool, page, hkv, d), generator=g,
                          device=dev, dtype=torch.int32).to(torch.int8)
        v = torch.randint(-127, 128, (n_pool, page, hkv, d), generator=g,
                          device=dev, dtype=torch.int32).to(torch.int8)
        scales = [1e-3 + 0.05 * torch.rand((n_pool, page, 1), generator=g,
                                           device=dev) for _ in range(2)]
    else:
        k, v = (_rand(g, dev, pool_dtype, n_pool, page, hkv, d)
                for _ in range(2))
        scales = [None, None]
    valid = torch.rand((n_pool, page), generator=g, device=dev) < 0.8
    valid[:, 0] = True
    table = (2 + torch.randperm(n_pool - 2, generator=g, device=dev)
             [: b * n_slots].reshape(b, n_slots)).to(torch.int32)
    for row in range(1, b):                   # short docs: zero-page tails
        table[row, 1 + row % n_slots:] = 0
    if n_slots > 1:                           # row 0: a stale last page
        valid[table[0, -1].long()] = False
    for t in (k, v, *(s for s in scales if s is not None)):
        t[0] = 0
    valid[0] = False
    return k, v, table, valid.to(torch.int8), scales


@pytest.mark.parametrize("pool", list(POOL_DTYPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page,n_slots,hq,hkv,d", [
    (8, 5, 4, 2, 32), (24, 3, 4, 1, 16), (64, 8, 12, 12, 64),
    (480, 2, 8, 4, 64)])
def test_join_attention_paged_kernel(dev, page, n_slots, hq, hkv, d, dtype,
                                     pool):
    g = torch.Generator(device=dev).manual_seed(7)
    dt, b, lq = DTYPES[dtype], 3, 16
    sq = lq + page * n_slots
    k, v, table, valid, (ks, vs) = _paged_world(g, dev, b, hkv, d, page,
                                                n_slots, POOL_DTYPES[pool])
    q = _rand(g, dev, dt, b, hq, sq, d)
    kq, vq = (_rand(g, dev, dt, b, hkv, lq, d) for _ in range(2))
    kqv = torch.arange(lq, device=dev)[None] < torch.randint(
        1, lq + 1, (b, 1), device=dev, generator=g)
    before = join_flash_attention_paged.launches
    got = join_flash_attention_paged(q, kq, vq, k, v, table, valid, kqv,
                                     kd_scale_pages=ks, vd_scale_pages=vs)
    want = join_attention_ref_paged(q, kq, vq, k, v, table, valid, kqv,
                                    kd_scale_pages=ks, vd_scale_pages=vs)
    _close(got, want, dtype)
    assert join_flash_attention_paged.launches == before + 1
    if n_slots > 1:                           # the stale page is masked
        fresh = table.clone()
        fresh[0, -1] = 0
        _close(got[:1], join_attention_ref_paged(
            q, kq, vq, k, v, fresh, valid, kqv, kd_scale_pages=ks,
            vd_scale_pages=vs)[:1], dtype)


def _routed(fn):
    return fn.tensor_core_launches, fn.cuda_core_launches


def _wide_scales(g, dev, b, n):
    """Per-token scales spread over four decades (1e-4 .. 1)."""
    return 10.0 ** (-4 * torch.rand((b, n), generator=g, device=dev))


# the tensor-core split kernel's tile edges: (Hq, Hkv, Sq, Skv, causal,
# window, seg_boundary, int8); Sq and Skv off the 64-row / 64-key tiles
TC_SPLIT_CASES = {
    "seg_boundary_mid_tile": (12, 12, 130, 130, False, -1, 37, False),
    "seg_boundary_at_32": (12, 12, 96, 96, False, -1, 32, False),
    "gqa_causal": (8, 4, 190, 190, True, -1, -1, False),
    "window_64": (8, 4, 200, 200, True, 64, -1, False),
    "window_65": (8, 4, 200, 200, True, 65, -1, False),
    "window_bidirectional": (4, 4, 70, 150, False, 100, -1, False),
    "int8_wide_scales": (8, 4, 77, 150, False, -1, -1, True),
    "int8_causal_window": (12, 12, 129, 129, True, 50, 40, True),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(TC_SPLIT_CASES))
def test_split_attention_tensor_core_edges(dev, case, d, dtype):
    """16-bit q at D = 64, 128, 256 takes the tensor-core kernel; ragged
    tiles, a seg_boundary inside a tile, window edges, GQA 8/4 and 12/12
    and int8 K/V with scales over four decades agree with the plain
    version on every row that sees a key."""
    hq, hkv, sq, skv, causal, window, boundary, int8 = TC_SPLIT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(16)
    dt, b = DTYPES[dtype], 2
    q = _rand(g, dev, dt, b, hq, sq, d)
    if int8:
        k, v = (torch.randint(-127, 128, (b, hkv, skv, d), generator=g,
                              device=dev, dtype=torch.int32).to(torch.int8)
                for _ in range(2))
        ks, vs = (_wide_scales(g, dev, b, skv) for _ in range(2))
    else:
        k, v = (_rand(g, dev, dt, b, hkv, skv, d) for _ in range(2))
        ks = vs = None
    lengths = torch.tensor([skv, skv - 29], device=dev, dtype=torch.int32)
    valid = torch.rand((b, skv), generator=g, device=dev) < 0.9
    valid[:, 0] = True
    kw = dict(causal=causal, window=window, seg_boundary=boundary)
    before = _routed(split_flash_attention)
    got = split_flash_attention(q, k, v, lengths, valid, ks, vs, **kw)
    assert _routed(split_flash_attention) == (before[0] + 1, before[1])
    want = split_attention_ref(q, k, v, lengths, valid, ks, vs, **kw)
    rows = _visible_rows(sq, skv, lengths, valid, causal, window, boundary)
    assert rows.float().mean() > 0.8
    _close(got.transpose(1, 2)[rows], want.transpose(1, 2)[rows], dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv,sq,lq,ld", [
    (12, 12, 512, 32, 480),      # PreTTR's join layers: half a query tile
    (8, 4, 100, 70, 130),        # GQA, two query tiles, ragged docs
    (4, 4, 65, 1, 64)])          # one query key, Sq one past a tile
@pytest.mark.parametrize("int8", [False, True])
def test_join_attention_tensor_core_edges(dev, hq, hkv, sq, lq, ld, d,
                                          dtype, int8):
    g = torch.Generator(device=dev).manual_seed(17)
    dt, b = DTYPES[dtype], 3
    q = _rand(g, dev, dt, b, hq, sq, d)
    kq, vq = (_rand(g, dev, dt, b, hkv, lq, d) for _ in range(2))
    if int8:
        kd, vd = (torch.randint(-127, 128, (b, hkv, ld, d), generator=g,
                                device=dev, dtype=torch.int32)
                  .to(torch.int8) for _ in range(2))
        ks, vs = (_wide_scales(g, dev, b, ld) for _ in range(2))
    else:
        kd, vd = (_rand(g, dev, dt, b, hkv, ld, d) for _ in range(2))
        ks = vs = None
    kqv = torch.arange(lq, device=dev)[None] < torch.randint(
        1, lq + 1, (b, 1), device=dev, generator=g)
    kdv = torch.rand((b, ld), generator=g, device=dev) < 0.85
    kdv[:, 0] = True
    kdv[1, ld // 2:] = False                  # a short document
    before = _routed(join_flash_attention)
    got = join_flash_attention(q, kq, vq, kd, vd, kqv, kdv, ks, vs)
    assert _routed(join_flash_attention) == (before[0] + 1, before[1])
    if int8:
        want = join_attention_ref_quant(q, kq, vq, kd, vd, ks, vs, kqv, kdv)
    else:
        want = join_attention_ref(q, kq, vq, kd, vd, kqv, kdv)
    _close(got, want, dtype)


@pytest.mark.parametrize("pool", ["int8", "bfloat16", "float16"])
@pytest.mark.parametrize("page,n_slots,hkv,d", [
    (24, 7, 12, 64), (40, 3, 4, 128), (100, 5, 2, 64)])
def test_join_attention_paged_tensor_core_edges(dev, page, n_slots, hkv, d,
                                                pool):
    """Pages that are no multiple of the 64-key tile, under a bf16 q
    (fp16 pools are rounded to bf16 as staged)."""
    g = torch.Generator(device=dev).manual_seed(18)
    b, hq, lq = 3, 12 if hkv == 12 else 8, 32
    sq = 96
    k, v, table, valid, (ks, vs) = _paged_world(g, dev, b, hkv, d, page,
                                                n_slots, POOL_DTYPES[pool])
    q = _rand(g, dev, torch.bfloat16, b, hq, sq, d)
    kq, vq = (_rand(g, dev, torch.bfloat16, b, hkv, lq, d)
              for _ in range(2))
    kqv = torch.arange(lq, device=dev)[None] < torch.randint(
        1, lq + 1, (b, 1), device=dev, generator=g)
    before = _routed(join_flash_attention_paged)
    got = join_flash_attention_paged(q, kq, vq, k, v, table, valid, kqv,
                                     kd_scale_pages=ks, vd_scale_pages=vs)
    assert _routed(join_flash_attention_paged) == (before[0] + 1, before[1])
    want = join_attention_ref_paged(q, kq, vq, k, v, table, valid, kqv,
                                    kd_scale_pages=ks, vd_scale_pages=vs)
    _close(got, want, "bfloat16")


def test_attention_routes_to_the_cuda_core_kernels(dev):
    """float32 q, a head dim outside {64, 128, 256}, one query row and an
    unaligned operand take the CUDA-core kernels, which the float32 paths
    hold to 2e-5."""
    g = torch.Generator(device=dev).manual_seed(19)
    f32 = _rand(g, dev, torch.float32, 2, 4, 40, 64)
    bf16 = f32.to(torch.bfloat16)
    narrow = _rand(g, dev, torch.bfloat16, 2, 4, 40, 32)
    one_row = bf16[:, :, :1]
    # a view 2 elements into its storage: 4-byte, not 16-byte, aligned
    shifted = torch.empty(2 * 4 * 40 * 64 + 2, device=dev,
                          dtype=torch.bfloat16)[2:].view(2, 4, 40, 64)
    shifted.copy_(bf16)
    for q, kv, name in ((f32, f32, "float32"), (narrow, narrow, "bfloat16"),
                        (one_row, bf16, "bfloat16"),
                        (shifted, bf16, "bfloat16")):
        before = _routed(split_flash_attention)
        got = split_flash_attention(q, kv, kv)
        assert _routed(split_flash_attention) == (before[0], before[1] + 1)
        _close(got, split_attention_ref(q, kv, kv, torch.full(
            (2,), kv.shape[2], device=dev)), name)
        before = _routed(join_flash_attention)
        join_flash_attention(q, kv, kv, kv, kv)
        assert _routed(join_flash_attention) == (
            before[0], before[1] + int(q.shape[2] > 1))
    before = _routed(split_flash_attention)
    split_flash_attention(bf16, bf16, bf16)
    assert _routed(split_flash_attention) == (before[0] + 1, before[1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows", [2 * 480, *(r for r, _, _ in COMPRESS_EDGES)])
def test_compress_kernel_f32_out(dev, rows, dtype):
    g = torch.Generator(device=dev).manual_seed(8)
    x = _rand(g, dev, DTYPES[dtype], rows, 768)
    w = _rand(g, dev, torch.float32, 768, 256) / 768 ** 0.5
    b = _rand(g, dev, torch.float32, 256)
    before, routed = fused_compress.f32_launches, _routed(fused_compress)
    got = fused_compress(x, w, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and fused_compress.f32_launches \
        == before + 1
    _route(fused_compress, routed, True)
    _close(got, compress_ref(x, w, b, out_dtype=torch.float32), "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,e,d", [(37, 16, 64), (2 * 480, 256, 768),
                                      *DECOMPRESS_EDGES])
def test_decompress_kernel_f32_in(dev, rows, e, d, dtype):
    g = torch.Generator(device=dev).manual_seed(9)
    r = _rand(g, dev, torch.float32, rows, e)
    w = _rand(g, dev, torch.float32, e, d) / e ** 0.5
    b, gamma, beta = (_rand(g, dev, torch.float32, d) for _ in range(3))
    dt = DTYPES[dtype]
    before, routed = fused_decompress.f32_launches, _routed(fused_decompress)
    got = fused_decompress(r, w, b, gamma, beta, out_dtype=dt)
    assert fused_decompress.f32_launches == before + 1
    _route(fused_decompress, routed, _decompress_on_tc(e, d))
    _close(got, decompress_ref(r, w, b, gamma, beta, out_dtype=dt), dtype)


@pytest.mark.parametrize("in_dtype", ["bfloat16", "float16", "float32"])
def test_compressor_kernels_repeat_bit_for_bit(dev, in_dtype):
    """Two calls on the same inputs give identical bits: each output is
    summed by one thread in a fixed order, no atomics."""
    g = torch.Generator(device=dev).manual_seed(10)
    x = _rand(g, dev, DTYPES[in_dtype], 64 * 480, 768)
    wc = _rand(g, dev, torch.float32, 768, 256) / 768 ** 0.5
    bc = _rand(g, dev, torch.float32, 256)
    for out_dtype in (torch.float16, torch.float32):
        assert torch.equal(fused_compress(x, wc, bc, out_dtype=out_dtype),
                           fused_compress(x, wc, bc, out_dtype=out_dtype))
    if in_dtype == "bfloat16":        # decompress reads fp16 or float32
        return
    r = _rand(g, dev, DTYPES[in_dtype], 32 * 480, 256)
    dargs = (_rand(g, dev, torch.float32, 256, 768) / 16,
             *(_rand(g, dev, torch.float32, 768) for _ in range(3)))
    assert torch.equal(fused_decompress(r, *dargs), fused_decompress(r, *dargs))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 2, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        split_flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        split_flash_attention(q, q.cpu(), q)
    q = torch.zeros((2, 2, 8, 32), device=dev)
    with pytest.raises(ValueError, match="do not match"):
        split_flash_attention(q, q, q, k_valid=torch.ones((2, 7), dtype=bool,
                                                          device=dev))
    with pytest.raises(ValueError, match="do not match"):
        join_flash_attention(q, q, q, q, q, kd_valid=torch.ones(
            (1, 8), dtype=bool, device=dev))
    x = torch.zeros((4, 6), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_compress(x, torch.zeros((6, 8), device=dev),
                       torch.zeros(8, device=dev))
    with pytest.raises(TypeError, match="float16"):
        fused_decompress(x.to(torch.bfloat16), torch.zeros((6, 8), device=dev),
                         *(torch.zeros(8, device=dev) for _ in range(3)))
    i8 = torch.zeros((2, 2, 8, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="scales"):
        join_flash_attention(q, q, q, i8, i8)
    with pytest.raises(TypeError, match="float16 or float32"):
        fused_compress(torch.zeros((4, 8), device=dev),
                       torch.zeros((8, 8), device=dev),
                       torch.zeros(8, device=dev), out_dtype=torch.bfloat16)


def test_smoke_service_kernels_match_plain(dev, tmp_path):
    """IndexBuilder + RankingService at smoke_config through the kernels
    against the plain impl, float32 on the card."""
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.index import IndexBuilder, TermRepIndex
    from repro_torch.serving import RankingService

    rng = np.random.default_rng(5)
    docs = [rng.integers(4, 512, rng.integers(3, 60)) for _ in range(24)]
    q = np.zeros(8, np.int64)
    q[:5] = [1, 17, 99, 250, 2]
    qv = q != 0
    scores = {}
    for impl in ("plain", "cuda"):
        cfg = smoke_config(attn_impl=impl, compress_impl=impl)
        params = init_prettr(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
        IndexBuilder(str(tmp_path / impl), cfg, params, batch_size=8).build(
            docs)
        svc = RankingService(params, cfg,
                             TermRepIndex.open(str(tmp_path / impl)),
                             micro_batch=8)
        resp = svc.rank(q, qv, list(range(24)))
        scores[impl] = dict(zip(resp.doc_ids, resp.scores))
    for doc, s in scores["plain"].items():
        assert abs(scores["cuda"][doc] - s) < 1e-4, doc


@pytest.mark.parametrize("cache_mb", [0, 8])
def test_smoke_int8_kv_service_kernels_match_plain(dev, tmp_path, cache_mb):
    """An int8 index with int8 layer-l K/V at smoke_config, served with
    stored K/V (and the paged doc cache) through the kernels against the
    plain impl, float32 on the card."""
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.index import IndexBuilder, TermRepIndex
    from repro_torch.serving import RankingService

    rng = np.random.default_rng(10)
    docs = [rng.integers(4, 512, rng.integers(3, 60)) for _ in range(24)]
    q = np.zeros(8, np.int64)
    q[:5] = [1, 17, 99, 250, 2]
    qv = q != 0
    cfg = smoke_config()
    params = init_prettr(cfg, torch.Generator().manual_seed(0),
                         device="cuda")
    IndexBuilder(str(tmp_path), cfg, params, codec="int8",
                 store_layer_kv=True, kv_codec="int8", batch_size=8).build(
        docs)
    scores = {}
    for impl in ("plain", "cuda"):
        cfg = smoke_config(attn_impl=impl, compress_impl=impl)
        svc = RankingService(params, cfg, TermRepIndex.open(str(tmp_path)),
                             micro_batch=8, use_layer_kv=True,
                             doc_cache_mb=cache_mb, page_tokens=16)
        counts = (join_flash_attention.int8_launches,
                  join_flash_attention_paged.launches)
        for _ in range(2):                    # cold, then warm
            resp = svc.rank(q, qv, list(range(24)))
        scores[impl] = dict(zip(resp.doc_ids, resp.scores))
        if impl == "cuda":
            launched = (join_flash_attention.int8_launches - counts[0],
                        join_flash_attention_paged.launches - counts[1])
            assert launched == ((0, 6) if cache_mb else (6, 0))
        assert svc.stats.n_decode_dispatch == 0
    for doc, s in scores["plain"].items():
        assert abs(scores["cuda"][doc] - s) < 1e-4, doc


def _decode_world(g, dev, dt, b, hq, hkv, s, d):
    """q/k/v, lengths >= 1 with every row's query key valid, and a
    non-prefix validity mask (about one key in five masked)."""
    q = _rand(g, dev, dt, b, hq, 1, d)
    k, v = (_rand(g, dev, dt, b, hkv, s, d) for _ in range(2))
    lengths = torch.tensor([s, max(1, s // 2 + 3), 7][:b], device=dev,
                           dtype=torch.int32)
    valid = torch.rand((b, s), generator=g, device=dev) < 0.8
    valid[torch.arange(b, device=dev), lengths.long() - 1] = True
    return q, k, v, lengths, valid


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [-1, 32, 1024])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_decode_attention_kernel(dev, d, group, window, dtype):
    """Every head dim, GQA group and window form against the plain
    version, at S = 1100 (not a multiple of the 32-key tile)."""
    g = torch.Generator(device=dev).manual_seed(11)
    hkv = 2
    q, k, v, lengths, valid = _decode_world(g, dev, DTYPES[dtype], 3,
                                            hkv * group, hkv, 1100, d)
    counter = "window_launches" if window > 0 else "launches"
    before = getattr(flash_decode_attention, counter)
    got = flash_decode_attention(q, k, v, lengths, valid, window=window)
    assert getattr(flash_decode_attention, counter) == before + 1
    _close(got, decode_attention_ref(q, k, v, lengths, valid,
                                     window=window), dtype)


@pytest.mark.parametrize("hq,hkv", [(3, 1), (10, 2), (16, 2), (12, 12)])
def test_decode_attention_groups_and_defaults(dev, hq, hkv):
    """Group sizes the kernel rounds up (3, 5), the largest (8) and MHA;
    lengths derived from k_valid; a model-layout output view."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, _, valid = _decode_world(g, dev, torch.float32, 3, hq, hkv,
                                      70, 64)
    out = torch.empty((3, 1, hq, 64), device=dev)
    flash_decode_attention(q, k, v, None, valid, out=out.transpose(1, 2))
    _close(out.transpose(1, 2), decode_attention_ref(
        q, k, v, last_valid_lengths(valid), valid), "float32")
    _close(flash_decode_attention(q, k, v),
           decode_attention_ref(q, k, v, torch.full((3,), 70, device=dev)),
           "float32")


def test_decode_attention_gemma3_window(dev):
    """The LM slice's shape: GQA 8/4 at D = 256 over 4096 keys with a
    1024-key window, bf16."""
    g = torch.Generator(device=dev).manual_seed(13)
    q = _rand(g, dev, torch.bfloat16, 4, 8, 1, 256)
    k, v = (_rand(g, dev, torch.bfloat16, 4, 4, 4096, 256)
            for _ in range(2))
    lengths = torch.tensor([4096, 2048, 4089, 1000], device=dev,
                           dtype=torch.int32)
    _close(flash_decode_attention(q, k, v, lengths, window=1024),
           decode_attention_ref(q, k, v, lengths, window=1024), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [-1, 1024])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("r", [3, 12, 16, 24])
def test_decode_attention_large_groups(dev, r, d, window, dtype):
    """GQA groups of 3 (padded to 4 rows), 12 (a row group of 8 and a
    partial one of 4), 16 and 24 query heads a KV head: the four LMs'
    decode groups.  Ragged lengths over a 2080-key cache, into a
    model-layout output that starts as NaN (every head must be written);
    the planner splits the keys, so the merge runs on the row groups."""
    g = torch.Generator(device=dev).manual_seed(20)
    dt, b, hkv, s = DTYPES[dtype], 4, 2, 2080
    q = _rand(g, dev, dt, b, hkv * r, 1, d)
    k, v = (_rand(g, dev, dt, b, hkv, s, d) for _ in range(2))
    lengths = torch.tensor([2080, 2064, 1000, 1], device=dev,
                           dtype=torch.int32)
    out = torch.full((b, 1, hkv * r, d), float("nan"), device=dev, dtype=dt)
    flash_decode_attention(q, k, v, lengths, window=window,
                           out=out.transpose(1, 2))
    assert flash_decode_attention.last_n_splits > 1
    _close(out.transpose(1, 2), decode_attention_ref(q, k, v, lengths,
                                                     window=window), dtype)


def test_moe_smoke_model_kernels_match_plain(dev):
    """qwen3-moe's smoke config on the card, float32: forward, logits
    and two decode steps through the kernels (split attention's causal
    form, flash decode at 2 query heads a KV head) against the plain
    impl; the MoE FFN is plain torch in both."""
    import dataclasses

    from repro_torch.configs.qwen3_moe_235b import smoke_config
    from repro_torch.models import transformer as T
    cfg = smoke_config()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(dev)
    out = {}
    for impl in ("cuda", "plain"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        before = split_flash_attention.causal_launches
        with torch.inference_mode():
            h, kv, aux = T.forward(params, c, toks[:, :38],
                                   collect_cache=True)
            cache = T.init_decode_cache(c, 2, 40, dtype=torch.float32,
                                        device=dev)
            cache[0][:, :, :38], cache[1][:, :, :38] = kv
            steps = [T.decode_step(params, c, toks[:, 38 + i:39 + i], cache,
                                   38 + i)[0] for i in range(2)]
        assert (split_flash_attention.causal_launches - before
                == (cfg.n_layers if impl == "cuda" else 0))
        out[impl] = [T.logits(params, c, h), *steps, aux]
    for got, want in zip(out["cuda"], out["plain"]):
        _close(got, want, "float32")


def _split_kv(monkeypatch, n_splits):
    """Force the split-KV planner of both Sq = 1 wrappers to ``n_splits``
    ("one": 1, "many": 7) instead of its choice for the card."""
    from repro_torch.kernels.decode_attention import plan
    n = {"one": 1, "many": 7}[n_splits]
    monkeypatch.setattr(plan, "plan_splits", lambda *a, **k: n)
    return n


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_splits", ["one", "many"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_decode_attention_split_kv_edges(dev, monkeypatch, d, group,
                                         n_splits, dtype):
    """The split-KV kernel's edges: lengths 0, 1 and a key tile (4096 / D
    keys) +- 1, global and with a 40-key window, into a model-layout
    (strided) output; one split, or seven with the merge (counted in
    ``merge_launches`` / ``window_merge_launches``).  A row without keys
    writes 0."""
    n = _split_kv(monkeypatch, n_splits)
    g = torch.Generator(device=dev).manual_seed(18)
    dt, hkv, tile = DTYPES[dtype], 2, 4096 // d
    b, hq, s = 4, 2 * group, tile + 40
    q = _rand(g, dev, dt, b, hq, 1, d)
    k, v = (_rand(g, dev, dt, b, hkv, s, d) for _ in range(2))
    lengths = torch.tensor([0, 1, tile - 1, tile + 1], device=dev,
                           dtype=torch.int32)
    for window in (-1, 40):
        out = torch.full((b, 1, hq, d), float("nan"), device=dev, dtype=dt)
        counter = "window_merge_launches" if window > 0 \
            else "merge_launches"
        before = getattr(flash_decode_attention, counter)
        flash_decode_attention(q, k, v, lengths, window=window,
                               out=out.transpose(1, 2))
        assert getattr(flash_decode_attention, counter) - before \
            == int(n > 1)
        got = out.transpose(1, 2)
        _close(got[1:], decode_attention_ref(q, k, v, lengths,
                                             window=window)[1:], dtype)
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("n_splits", ["one", "many"])
def test_sq1_kernels_repeat_bit_for_bit(dev, monkeypatch, n_splits):
    """Two calls on the same inputs give the same bits: the splits merge in
    a fixed order, with no atomics (the serving checks rely on it)."""
    _split_kv(monkeypatch, n_splits)
    g = torch.Generator(device=dev).manual_seed(19)
    q = _rand(g, dev, torch.bfloat16, 4, 8, 1, 256)
    k, v = (_rand(g, dev, torch.bfloat16, 4, 4, 2080, 256) for _ in range(2))
    lengths = torch.tensor([2064, 1, 700, 2080], device=dev,
                           dtype=torch.int32)
    for window in (-1, 1024):
        runs = [flash_decode_attention(q, k, v, lengths, window=window)
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
    q = _rand(g, dev, torch.bfloat16, 32, 12, 1, 64)
    kq, vq = (_rand(g, dev, torch.bfloat16, 32, 12, 32, 64) for _ in range(2))
    kd, vd = (_rand(g, dev, torch.bfloat16, 32, 12, 480, 64)
              for _ in range(2))
    kdv = torch.rand((32, 480), generator=g, device=dev) < 0.7
    runs = [join_flash_attention(q, kq, vq, kd, vd, None, kdv)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("n_splits", ["one", "many"])
def test_sq1_kernels_take_rows_not_16_byte_aligned(dev, monkeypatch,
                                                   n_splits):
    """K/V views that start one element into their rows (2-byte aligned):
    the split-KV kernel copies them with plain loads instead of cp.async,
    for flash decode and the CLS row alike."""
    _split_kv(monkeypatch, n_splits)
    g = torch.Generator(device=dev).manual_seed(21)
    dt = torch.bfloat16
    q = _rand(g, dev, dt, 3, 4, 1, 64)
    k, v = (_rand(g, dev, dt, 3, 2, 300, 65)[..., 1:] for _ in range(2))
    lengths = torch.tensor([300, 77, 1], device=dev, dtype=torch.int32)
    for window in (-1, 50):
        _close(flash_decode_attention(q, k, v, lengths, window=window),
               decode_attention_ref(q, k, v, lengths, window=window),
               "bfloat16")
    kq, vq = (_rand(g, dev, dt, 3, 2, 20, 65)[..., 1:] for _ in range(2))
    kdv = torch.rand((3, 300), generator=g, device=dev) < 0.8
    _close(join_flash_attention(q, kq, vq, k, v, None, kdv),
           join_attention_ref(q, kq, vq, k, v, None, kdv), "bfloat16")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_splits", ["one", "many"])
@pytest.mark.parametrize("d", [16, 64, 256])
def test_join_cls_row_split_kv_edges(dev, monkeypatch, d, n_splits, dtype):
    """The join's CLS row through the split-KV kernel: one or seven splits
    (``row_merge_launches`` counts the merges), a doc segment that is all
    masked in one row and masked past its first tile in another, absent
    query-segment masks, a strided output."""
    n = _split_kv(monkeypatch, n_splits)
    g = torch.Generator(device=dev).manual_seed(20)
    dt = DTYPES[dtype]
    b, hq, hkv, lq, ld = 3, 8, 2, 20, 300
    q = _rand(g, dev, dt, b, hq, 1, d)
    kq, vq = (_rand(g, dev, dt, b, hkv, lq, d) for _ in range(2))
    kd, vd = (_rand(g, dev, dt, b, hkv, ld, d) for _ in range(2))
    kdv = torch.rand((b, ld), generator=g, device=dev) < 0.8
    kdv[0] = False
    kdv[1, 4096 // d + 1:] = False
    out = torch.full((b, 1, hq, d), float("nan"), device=dev, dtype=dt)
    before = (join_flash_attention.row_launches,
              join_flash_attention.row_merge_launches)
    join_flash_attention(q, kq, vq, kd, vd, None, kdv,
                         out=out.transpose(1, 2))
    assert (join_flash_attention.row_launches - before[0],
            join_flash_attention.row_merge_launches - before[1]) \
        == (1, int(n > 1))
    _close(out.transpose(1, 2),
           join_attention_ref(q, kq, vq, kd, vd, None, kdv), dtype)


@pytest.mark.parametrize("drift", [0, 1, 2])
def test_sq1_kernels_refuse_a_planner_that_drifted(dev, monkeypatch, drift):
    """The planner's copies of the kernel's split alignment, split limit and
    block rows (``plan.LAYOUT``) go to the C entries with every call; one
    that differs from the kernel's constant makes both entries refuse to
    launch, and both wrappers still record each split count they launch
    with (``last_n_splits``, ``last_row_n_splits``)."""
    from repro_torch.kernels.decode_attention import plan
    q = torch.zeros((2, 4, 1, 64), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((2, 2, 300, 64), device=dev, dtype=torch.bfloat16)
    n = _split_kv(monkeypatch, "many")
    flash_decode_attention(q, k, k)
    join_flash_attention(q, k, k, k, k)
    assert (flash_decode_attention.last_n_splits,
            join_flash_attention.last_row_n_splits) == (n, n)
    layout = list(plan.LAYOUT)
    layout[drift] *= 2
    monkeypatch.setattr(plan, "LAYOUT", tuple(layout))
    with pytest.raises(RuntimeError, match="rt_decode_attention"):
        flash_decode_attention(q, k, k)
    with pytest.raises(RuntimeError, match="rt_join_attention_row"):
        join_flash_attention(q, k, k, k, k)


def test_decode_attention_rejects_what_it_does_not_take(dev):
    q = torch.zeros((2, 18, 1, 64), device=dev)
    k = torch.zeros((2, 4, 8, 64), device=dev)
    with pytest.raises(ValueError, match="not a multiple"):
        flash_decode_attention(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((2, 2, 8, 48), device=dev)
        flash_decode_attention(z[:, :, :1], z, z)
    with pytest.raises(ValueError, match="one query row"):
        flash_decode_attention(k, k, k)


def _smoke_world(tmp_path, codec="fp16", **build_kw):
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.index import IndexBuilder

    rng = np.random.default_rng(14)
    docs = [rng.integers(4, 512, rng.integers(3, 40)) for _ in range(24)]
    cfg = smoke_config()
    params = init_prettr(cfg, torch.Generator().manual_seed(0),
                         device="cuda")
    IndexBuilder(str(tmp_path), cfg, params, codec=codec, batch_size=8,
                 **build_kw).build(docs)
    reqs = []
    for i in range(5):
        q = np.zeros(8, np.int64)
        q[:5] = [1, 17 + i, 99, 250 - i, 2]
        reqs.append((q, q != 0, [int(d) for d in rng.choice(24, 10, False)]))
    return params, reqs


def _serve_all(svc, reqs):
    from repro_torch.serving import RankRequest
    for i, (q, qv, ids) in enumerate(reqs):
        svc.submit(RankRequest(q, qv, ids, request_id=f"r{i}"))
    return {r.request_id: r for r in svc.drain()}


def test_smoke_legacy_service_kernels_match_plain(dev, tmp_path):
    """The legacy concat join served through the kernels (split attention
    and flash decode, no join kernel) against the plain impl and against
    the fused join, float32 on the card."""
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.index import TermRepIndex
    from repro_torch.serving import RankingService

    params, reqs = _smoke_world(tmp_path)
    index = TermRepIndex.open(str(tmp_path))
    runs = {}
    for impl, fused in (("plain", False), ("cuda", False), ("cuda", True)):
        cfg = smoke_config(attn_impl=impl, compress_impl=impl)
        before = (flash_decode_attention.launches,
                  join_flash_attention.launches
                  + join_flash_attention.row_launches)
        got = _serve_all(RankingService(params, cfg, index, micro_batch=8,
                                        fused=fused), reqs)
        runs[impl, fused] = {(rid, d): s for rid, r in got.items()
                             for d, s in zip(r.doc_ids, r.scores)}
        if impl == "cuda":
            launched = (flash_decode_attention.launches - before[0],
                        join_flash_attention.launches
                        + join_flash_attention.row_launches - before[1])
            assert (launched[0] > 0, launched[1] > 0) == (not fused, fused)
    for key, s in runs["plain", False].items():
        assert abs(runs["cuda", False][key] - s) < 1e-4, key
        assert abs(runs["cuda", True][key] - s) < 1e-4, key


@pytest.mark.parametrize("cache_mb", [0, 8])
def test_prefetched_scores_equal_synchronous(dev, tmp_path, cache_mb):
    """The prefetch thread (side-stream copies) and the synchronous drain
    give the same bits, with and without the doc cache."""
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.index import TermRepIndex
    from repro_torch.serving import RankingService

    params, reqs = _smoke_world(tmp_path, codec="int8", store_layer_kv=True,
                                kv_codec="int8")
    index = TermRepIndex.open(str(tmp_path))
    runs = {}
    for depth in (0, 2):
        svc = RankingService(params, smoke_config(), index, micro_batch=4,
                             prefetch_depth=depth, doc_cache_mb=cache_mb,
                             page_tokens=16)
        runs[depth] = [_serve_all(svc, reqs) for _ in range(2)]
    for a, b in zip(runs[0], runs[2]):
        for rid in a:
            assert a[rid].doc_ids == b[rid].doc_ids
            np.testing.assert_array_equal(a[rid].scores, b[rid].scores)


def test_staging_fault_fails_only_its_micro_batch(dev, tmp_path):
    """An injected staging error on the prefetch thread fails one
    micro-batch's rows; every other score is bit-equal to a clean run."""
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.index import TermRepIndex
    from repro_torch.serving import FaultPlan, FaultSpec, RankingService

    params, reqs = _smoke_world(tmp_path)
    index = TermRepIndex.open(str(tmp_path))
    svc = lambda: RankingService(params, smoke_config(), index,
                                 micro_batch=4)
    clean = _serve_all(svc(), reqs)
    faulty = svc()
    with FaultPlan([FaultSpec("engine.stage", "error", after=3)]) as plan:
        got = _serve_all(faulty, reqs)
    assert plan.n_fired() == 1
    failed = [(rid, d) for rid, r in got.items() for d in r.failed_doc_ids]
    assert 0 < len(failed) <= 4 and faulty.stats.n_failed_rows == 4
    for rid, r in got.items():
        want = dict(zip(clean[rid].doc_ids, clean[rid].scores))
        assert r.degraded == bool(r.failed_doc_ids)
        for d, s in zip(r.doc_ids, r.scores):
            assert s == (-np.inf if d in r.failed_doc_ids else want[d])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_smoke_forward_and_decode_kernels_match_plain(dev, dtype):
    """gemma3's smoke_config (5 local : 1 global, window 8) on the card:
    the last prefill position after 16 tokens, 4 teacher-forced decode
    steps and a forward over all 20 tokens (the window bites), kernels
    against the plain impl.  The prefill launches the causal and window
    forms, the decode the flash-decode kernel's two window forms.  Logits
    within 2e-4 in float32 (tests/test_models.py); in bfloat16 within twice
    the plain impl's own bf16 distance from float32, the rule of
    chip_smoke.py (the kernels round at other places than the plain
    impl)."""
    import dataclasses

    from repro_torch.configs.gemma3_4b import smoke_config
    from repro_torch.models import transformer as T

    cfg = smoke_config()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(16),
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(17))

    def run(impl, dt):
        c = dataclasses.replace(cfg, attn_impl=impl, compute_dtype=dt)
        before = (split_flash_attention.causal_launches,
                  split_flash_attention.window_launches,
                  flash_decode_attention.launches,
                  flash_decode_attention.window_launches)
        h, kv, _ = T.forward(params, c, toks[:, :16], collect_cache=True)
        cache = T.init_decode_cache(c, 2, 24, device=dev)
        cache[0][:, :, :16] = kv[0]
        cache[1][:, :, :16] = kv[1]
        steps = [T.decode_step(params, c, toks[:, 16 + i:17 + i], cache,
                               16 + i)[0] for i in range(4)]
        after = (split_flash_attention.causal_launches,
                 split_flash_attention.window_launches,
                 flash_decode_attention.launches,
                 flash_decode_attention.window_launches)
        launched = tuple(a - b for a, b in zip(after, before))
        assert launched == ((1, 5, 4, 20) if impl == "cuda" else (0,) * 4)
        full, _, _ = T.forward(params, c, toks)
        torch.cuda.synchronize()
        return np.concatenate([t.float().cpu().numpy().ravel() for t in (
            T.logits(params, c, h[:, -1:]), *steps,
            T.logits(params, c, full))])

    dt = DTYPES[dtype]
    got, want = run("cuda", dt), run("plain", dt)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        limit = 2 * np.abs(want - run("plain", torch.float32)).max()
        assert np.abs(got - want).max() <= limit


# ---------------------------------------------------------------------------
# The embedding-bag kernel and the recsys models through it
# ---------------------------------------------------------------------------

# table dtype, output dtype, the counter the launch adds to
BAG_FORMS = {"float32": (torch.float32, torch.float32, "launches"),
             "bfloat16": (torch.bfloat16, torch.bfloat16, "launches"),
             "cast": (torch.float32, torch.bfloat16, "cast_launches")}


def _bag_case(dev, rows, dim, n_bags, nnz, table_dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = _rand(gen, dev, table_dtype, rows, dim)
    ids = torch.randint(0, rows, (n_bags, nnz), generator=gen, device=dev)
    w = (torch.rand((n_bags, nnz), generator=gen, device=dev) > 0.3).float()
    w = w * (0.5 + 1.5 * torch.rand((n_bags, nnz), generator=gen,
                                    device=dev))
    w[0] = 0.0                           # a bag of pads only
    return table, ids, w


@contextlib.contextmanager
def _bag_route(route):
    """Assert that the launch inside ran ``route``'s kernel ("wide",
    "narrow" or "generic"): the C entry's report, as the wrapper counted
    it."""
    names = ("wide", "narrow", "generic")
    before = [getattr(embedding_bag_op, f"{n}_launches") for n in names]
    yield
    ran = [n for n, b in zip(names, before)
           if getattr(embedding_bag_op, f"{n}_launches") != b]
    assert ran == [route]


def _bag_count(dev, n_bags, p):
    """The test's n_bags: 77, one bag, one less than a warp's tile (the
    generic kernel's block of 8 bags), or enough tiles that every warp of
    the largest grid the card can hold resident (8 blocks of 8 warps an
    SM) takes more than one (77 for the generic kernel, which has no
    loop)."""
    tb = p.tb or 8
    if n_bags == "one":
        return 1
    if n_bags == "tile-1":
        return max(1, tb - 1)
    if n_bags == "wrap" and p.tb:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return sms * 8 * 8 * tb + tb // 2 + 1
    return 77


@pytest.mark.parametrize("n_bags", [77, "one", "tile-1", "wrap"])
@pytest.mark.parametrize("form", list(BAG_FORMS))
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("nnz", [1, 13, 39])
@pytest.mark.parametrize("dim", [1, 10, 16, 64, 96, 128, 200, 256])
def test_embedding_bag_kernel(dev, dim, nnz, mode, form, n_bags):
    """Weighted sum / mean bags with weight-0 pads, int64 ids, against the
    plain version: float32 and bf16 tables in their own type and bf16 rows
    from a float32 table; 77 bags, one, one less than a warp's tile, and
    enough for the persistent loop to wrap.  Each call runs the kernel
    ``_embedding_bag_map.ROUTES`` writes out for an aligned table."""
    table_dtype, out_dtype, counter = BAG_FORMS[form]
    type_name = str(table_dtype).removeprefix("torch.")
    b = _bag_count(dev, n_bags, bag_map.plan(dim, nnz,
                                             table_dtype.itemsize))
    table, ids, w = _bag_case(dev, 1000, dim, b, nnz, table_dtype,
                              dim * 100 + nnz)
    route = bag_map.route(type_name, table.data_ptr(), dim)
    if mode == "mean" and counter == "launches":
        counter = "mean_launches"
    before = getattr(embedding_bag_op, counter)
    with _bag_route(route):
        got = embedding_bag_op(table, ids, w, mode=mode, out_dtype=out_dtype)
    assert getattr(embedding_bag_op, counter) == before + 1
    assert got.dtype == out_dtype and got.shape == (b, dim)
    _close(got, embedding_bag_ref(table, ids, w, mode=mode,
                                  out_dtype=out_dtype),
           "float32" if out_dtype == torch.float32 else "bfloat16")


@pytest.mark.parametrize("form", list(BAG_FORMS))
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("nnz", [1, 13])
@pytest.mark.parametrize("dim", [10, 128])
def test_embedding_bag_misaligned_table_takes_the_generic_kernel(
        dev, dim, nnz, mode, form):
    """A contiguous table view one element into its storage (the rows of
    ``flat[1:]``: 4 or 2 bytes past an aligned address) is not aligned as
    the routed kernels' loads need at these widths (16 bytes, or 8 for a
    40-byte row, 4 for a 20-byte one): the entry runs the generic kernel,
    still right."""
    table_dtype, out_dtype, _ = BAG_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(dim + nnz)
    flat = _rand(g, dev, table_dtype, 500 * dim + 1)
    table = flat[1:].view(500, dim)
    assert table.is_contiguous() and table.data_ptr() % 8
    ids = torch.randint(0, 500, (300, nnz), generator=g, device=dev)
    w = torch.rand((300, nnz), generator=g, device=dev)
    with _bag_route("generic"):
        got = embedding_bag_op(table, ids, w, mode=mode, out_dtype=out_dtype)
    _close(got, embedding_bag_ref(table, ids, w, mode=mode,
                                  out_dtype=out_dtype),
           "float32" if out_dtype == torch.float32 else "bfloat16")


@pytest.mark.parametrize("case", ["dlrm_sum", "dlrm_mean", "deepfm_sum",
                                  "deepfm_w1", "deepfm_cast"])
def test_embedding_bag_kernels_repeat_bit_for_bit(dev, case):
    """Two calls on the same inputs give identical bits, at the main
    paths' widths and bag sizes: each output column is one lane's fmaf
    chain over its bag's slots in slot order, no atomics, whatever the
    grid."""
    table_dtype, dim, nnz, mode, out_dtype, route = {
        "dlrm_sum": (torch.bfloat16, 128, 1, "sum", None, "wide"),
        "dlrm_mean": (torch.bfloat16, 128, 13, "mean", None, "wide"),
        "deepfm_sum": (torch.float32, 10, 19, "sum", None, "narrow"),
        "deepfm_w1": (torch.float32, 1, 39, "sum", None, "narrow"),
        "deepfm_cast": (torch.float32, 10, 1, "sum", torch.bfloat16,
                        "narrow")}[case]
    table, ids, w = _bag_case(dev, 100_000, dim, 50_000, nnz, table_dtype,
                              nnz)
    for weights in (None, w):
        first = embedding_bag_op(table, ids, weights, mode=mode,
                                 out_dtype=out_dtype)
        with _bag_route(route):
            again = embedding_bag_op(table, ids, weights, mode=mode,
                                     out_dtype=out_dtype)
        assert torch.equal(first, again)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_int32_ids_no_weights_and_bags_of_one(dev, mode):
    """int32 ids and no weights (weight 1); a bag of one in the cast form
    is bit-equal to the cast followed by the gather; an out-of-range id
    gives its bag NaN and no fault."""
    table, ids, _ = _bag_case(dev, 500, 10, 33, 5, torch.float32, 3)
    ids32 = ids.to(torch.int32)
    _close(embedding_bag_op(table, ids32, mode=mode),
           embedding_bag_ref(table, ids, mode=mode), "float32")
    one = embedding_bag_op(table, ids32[:, :1], out_dtype=torch.bfloat16)
    assert torch.equal(one, table.to(torch.bfloat16)[ids[:, 0]])
    bad = ids.clone()
    bad[4, 2] = 500
    out = embedding_bag_op(table, bad, mode=mode)
    torch.cuda.synchronize()
    assert torch.isnan(out[4]).all() and torch.isfinite(out[:4]).all()


def test_embedding_bag_reads_past_32_bit_offsets(dev):
    """A bf16 table of 2^24 + 8 rows of 128 (2.1e9 elements, past 2^31):
    its last rows come back exactly."""
    rows = (1 << 24) + 8
    table = torch.zeros((rows, 128), dtype=torch.bfloat16, device=dev)
    tail = torch.arange(8 * 128, device=dev).reshape(8, 128)
    table[-8:] = tail.to(torch.bfloat16)
    ids = torch.tensor([[rows - 1], [rows - 8], [0]], device=dev,
                       dtype=torch.int32)
    got = embedding_bag_op(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got[0], table[-1]) and torch.equal(got[1], table[-8])
    assert not got[2].any()


def test_embedding_bag_rejects_what_it_does_not_take(dev):
    table = torch.zeros((10, 8), device=dev)
    ids = torch.zeros((2, 3), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="CUDA device"):
        embedding_bag_op(table, ids.cpu())
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_op(table, ids, mode="max")
    with pytest.raises(TypeError, match="reads and writes"):
        embedding_bag_op(table.half(), ids)
    with pytest.raises(TypeError, match="reads and writes"):
        embedding_bag_op(table, ids, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="reads and writes"):
        embedding_bag_op(table.bfloat16(), ids, out_dtype=torch.float32)
    with pytest.raises(TypeError, match="int32 or int64"):
        embedding_bag_op(table, ids.float())
    with pytest.raises(ValueError, match="dim 300"):
        embedding_bag_op(torch.zeros((10, 300), device=dev), ids)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_op(torch.zeros((8, 10), device=dev).t(), ids)
    with pytest.raises(ValueError, match="match weights"):
        embedding_bag_op(table, ids, torch.ones((2, 4), device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["dlrm", "deepfm", "xdeepfm"])
def test_recsys_smoke_models_kernels_match_plain(dev, family, dtype):
    """The smoke configs on the card, ``bag_impl`` "cuda" against
    "plain" on the same weights and click-log ids: forward, the towers or
    item vectors, and retrieval scores.  Each kernel run launches the
    embedding-bag kernel, each plain run none."""
    import dataclasses

    from repro_torch.configs import deepfm, dlrm_mlperf, xdeepfm
    from repro_torch.data.recsys import click_batch
    from repro_torch.models.recsys import deepfm as TF
    from repro_torch.models.recsys import dlrm as TD

    mod = {"dlrm": dlrm_mlperf, "deepfm": deepfm, "xdeepfm": xdeepfm}[family]
    cfg = dataclasses.replace(mod.smoke_config(),
                              compute_dtype=DTYPES[dtype])
    gen = torch.Generator(device=dev).manual_seed(21)
    init = TD.init_dlrm if family == "dlrm" else TF.init_deepfm
    params = init(cfg, gen, device=dev)
    b = click_batch(np.random.default_rng(22), 64, n_dense=13 if family ==
                    "dlrm" else 0, vocab_sizes=cfg.vocab_sizes)
    dense = torch.from_numpy(b["dense"]).to(dev)
    sparse = torch.from_numpy(b["sparse"]).to(dev)
    items = sparse[:, list(cfg.item_fields)]
    users = sparse[:8, cfg.user_fields]

    def run(impl):
        c = dataclasses.replace(cfg, bag_impl=impl)
        before = (embedding_bag_op.launches, embedding_bag_op.mean_launches,
                  embedding_bag_op.cast_launches)
        if family == "dlrm":
            iv = TD.item_tower(params, c, items)
            out = [TD.dlrm_forward(params, c, dense, sparse), iv,
                   TD.retrieval_scores(params, c, dense[:8], users, iv)]
        else:
            iv, first = TF.item_vectors(params, c, items)
            out = [TF.deepfm_forward(params, c, sparse), iv, first,
                   TF.retrieval_scores(params, c, users, iv, first)]
        after = (embedding_bag_op.launches, embedding_bag_op.mean_launches,
                 embedding_bag_op.cast_launches)
        launched = tuple(a - b for a, b in zip(after, before))
        torch.cuda.synchronize()
        return [t.float().cpu().numpy() for t in out], launched

    got, launched = run("cuda")
    want, none = run("plain")
    cast = int(dtype == "bfloat16")
    # dlrm: the forward's gather (sum, or cast in bf16), item_tower and
    # user_tower (mean; user_tower's cast in bf16); deepfm: the forward's
    # gather (sum, or cast in bf16) and w1 bag, item_vectors' and
    # retrieval's two sum bags each
    assert launched == ((1 - cast, 2 - cast, 2 * cast) if family == "dlrm"
                        else (6 - cast, 0, cast))
    assert none == (0, 0, 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **_tol(dtype))


# ---------------------------------------------------------------------------
# PQ, pruned and checksummed indexes; the first stage and the cascade
# ---------------------------------------------------------------------------


def test_pq_decode_on_the_card_equals_numpy(dev):
    """The card's codebook gather gives the host decode's floats, and the
    codebook is copied to the card once."""
    from repro_torch.index.codecs import PQCodec

    rng = np.random.default_rng(0)
    codec = PQCodec()
    codec.fit(rng.standard_normal((900, 256)).astype(np.float32), seed=1)
    codes = codec.encode(rng.standard_normal((3, 40, 256))
                         .astype(np.float32))["reps"]
    want = codec.decode({"reps": codes})
    got = codec.decode({"reps": torch.from_numpy(codes).to(dev)})
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    flat = codec._flat_on(got.device)
    codec.decode({"reps": torch.from_numpy(codes).to(dev)})
    assert codec._flat_on(got.device) is flat


def _service(params, cfg, index, cache_mb):
    from repro_torch.serving import RankingService
    return RankingService(params, cfg, index, micro_batch=4,
                          doc_cache_mb=cache_mb, page_tokens=8)


@pytest.mark.parametrize("build", [dict(codec="pq"), dict(keep_frac=0.5),
                                   dict(codec="pq", keep_frac=0.5)])
@pytest.mark.parametrize("cache_mb", [0, 8])
def test_smoke_pq_and_pruned_services_kernels_match_plain(dev, tmp_path,
                                                          build, cache_mb):
    """PQ and pruned indexes built on the card (checksummed, verified by
    ``verify_index``) served through the kernels and the plain impl, with
    and without the doc cache; the PQ reps reach the float32-input
    decompress kernel."""
    import dataclasses

    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.index import TermRepIndex, verify_index

    params, reqs = _smoke_world(tmp_path, **build)
    index = TermRepIndex.open(str(tmp_path))
    assert index.verify_integrity() > 0
    rng = np.random.default_rng(14)
    docs = [rng.integers(4, 512, rng.integers(3, 40)) for _ in range(24)]
    assert verify_index(index, smoke_config(), params, docs, sample=24) \
        == 24
    runs = {}
    for impl in ("plain", "cuda"):
        cfg = smoke_config(attn_impl=impl, compress_impl=impl)
        cfg = dataclasses.replace(cfg, max_doc_len=index.max_doc_len)
        before = fused_decompress.f32_launches
        got = _serve_all(_service(params, cfg, index, cache_mb), reqs)
        launched = fused_decompress.f32_launches - before
        assert (launched > 0) == (impl == "cuda" and build.get("codec")
                                  == "pq")
        runs[impl] = {(rid, d): s for rid, r in got.items()
                      for d, s in zip(r.doc_ids, r.scores)}
    for key, s in runs["plain"].items():
        assert abs(runs["cuda"][key] - s) < 1e-4, key


def test_doc_salience_on_the_card_matches_the_cpu(dev):
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core import prettr as P

    cfg = smoke_config()
    gen = torch.Generator().manual_seed(3)
    params = P.init_prettr(cfg, gen, device="cpu")
    tokens = torch.randint(4, 512, (5, cfg.max_doc_len), generator=gen)
    valid = torch.arange(cfg.max_doc_len)[None] < torch.tensor(
        [[40], [17], [1], [0], [33]])
    store = P.precompute_docs(params, cfg, tokens, valid)
    want = P.doc_salience(params, cfg, store, valid)
    from repro_torch.device import to_device
    got = P.doc_salience(to_device(params, dev), cfg, store.to(dev),
                         valid.to(dev))
    _close(got, want, "float32")


def test_smoke_cascade_kernels_match_plain(dev):
    """``run_cascade`` over a PQ build through the kernels and through the
    plain backend on the card: the same first-stage candidates, the same
    metrics, scores within 1e-4 (float32 through every layer, as the
    served scores above)."""
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.data.synthetic_ir import SyntheticIRWorld
    from repro_torch.eval import run_cascade

    cfg = smoke_config()
    world = SyntheticIRWorld(n_docs=96, n_queries=8, vocab_size=512,
                             doc_len=cfg.max_doc_len - 1, seed=0)
    params = init_prettr(cfg, torch.Generator().manual_seed(0),
                         device="cuda")
    got = {b: run_cascade(params, cfg, world, codec="pq", k=16, k_metric=5,
                          micro_batch=8, backend=b)
           for b in ("cuda", "plain")}
    (ids, s), (pids, ps) = (got[b].stages["first_stage"]
                            for b in ("cuda", "plain"))
    np.testing.assert_array_equal(ids, pids)
    np.testing.assert_allclose(s, ps, atol=1e-4)
    (rid, rs), (prid, prs) = (got[b].stages["rerank"]
                              for b in ("cuda", "plain"))
    np.testing.assert_allclose(np.sort(rs, -1), np.sort(prs, -1),
                               atol=1e-4)
    assert got["cuda"].meta == got["plain"].meta
    for key, v in got["plain"].first_stage.items():
        assert got["cuda"].first_stage[key] == pytest.approx(v, abs=1e-6)


# ---------------------------------------------------------------------------
# Training (autograd runs through the plain backend only)
# ---------------------------------------------------------------------------

_WRAPPERS = (split_flash_attention, flash_decode_attention,
             join_flash_attention, join_flash_attention_paged,
             fused_compress, fused_decompress, embedding_bag_op)


def _all_launches():
    """Every launch counter of every kernel wrapper, summed."""
    return sum(getattr(fn, a) for fn in _WRAPPERS for a in dir(fn)
               if a.endswith("launches"))


def _smoke_trainer(dev):
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.data.synthetic_ir import SyntheticIRWorld
    from repro_torch.optim import OptimizerConfig, init_opt_state

    cfg = smoke_config()                       # the kernels' backend
    world = SyntheticIRWorld(n_docs=64, n_queries=8, vocab_size=512,
                             doc_len=cfg.max_doc_len - 2, seed=0)
    params = init_prettr(cfg, torch.Generator().manual_seed(0), device=dev)
    opt_cfg = OptimizerConfig(lr=3e-3)
    return cfg, world, params, opt_cfg, init_opt_state(params, opt_cfg)


def test_train_step_on_the_card_launches_no_kernel(dev):
    """``prettr_train_step`` with a config on the kernels' backend trains
    through the plain one: no kernel launches, and every parameter leaf
    with a gradient moves.  Two kinds of leaf have a gradient of 0 up to
    rounding, which the card can round to exactly 0 (and AdamW does not
    move a leaf whose gradient is exactly 0): the K biases (softmax is
    shift-invariant along the keys) and the final norm's bias (it adds
    the same score to both docs of a pair, and the loss reads their
    difference)."""
    from repro_torch.core.prettr import rank_pairs_loss
    from repro_torch.launch.train import batch_tensors, prettr_train_step
    from repro_torch.models.backend import apply_backend
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths

    cfg, world, params, opt_cfg, opt = _smoke_trainer(dev)
    pos, neg = (batch_tensors(b, dev) for b in world.pair_batch(
        np.random.default_rng(1), 8, cfg.max_query_len, cfg.max_doc_len))
    before = _all_launches()
    new, opt, loss, gn = prettr_train_step(params, opt, cfg, opt_cfg, pos,
                                           neg)
    torch.cuda.synchronize()
    assert _all_launches() == before
    assert torch.isfinite(loss) and float(gn) > 0
    assert new["score_head"].is_cuda and int(opt["step"]) == 1
    _, grads = value_and_grad(lambda p: rank_pairs_loss(
        p, apply_backend(cfg, "plain"), pos, neg), params)
    zero = {k for k, g in leaves_with_paths(grads) if not bool(g.any())}
    assert all(k.endswith(("attn/bk", "final_norm/bias")) for k in zero), \
        zero
    old = dict(leaves_with_paths(params))
    still = {k for k, p in leaves_with_paths(new) if torch.equal(p, old[k])}
    assert still <= zero, still - zero


def _card_wrapper_calls(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    b, h, s, d = 2, 2, 16, 16
    return {
        "split_flash_attention": lambda x: split_flash_attention(
            x, r(b, h, s, d), r(b, h, s, d)),
        "flash_decode_attention": lambda x: flash_decode_attention(
            x[:, :, :1], r(b, h, s, d), r(b, h, s, d)),
        "join_flash_attention": lambda x: join_flash_attention(
            r(b, h, s, d), r(b, h, 8, d), r(b, h, 8, d), x,
            r(b, h, s, d)),
        "join_flash_attention_paged": lambda x: join_flash_attention_paged(
            r(b, h, 8, d), r(b, h, 8, d), r(b, h, 8, d), x.reshape(
                4, 8, h, d), r(4, 8, h, d),
            torch.tensor([[1, 2], [3, 0]], dtype=torch.int32, device=dev),
            torch.ones((4, 8), dtype=torch.int8, device=dev)),
        "fused_compress": lambda x: fused_compress(
            r(b, s, d), x[0, 0, :, :8], torch.zeros(8, device=dev)),
        "fused_decompress": lambda x: fused_decompress(
            r(b, s, 8).half(), r(8, d), x[0, 0, 0], torch.ones(d, device=dev),
            torch.zeros(d, device=dev)),
        "embedding_bag_op": lambda x: embedding_bag_op(
            x.reshape(-1, d), torch.tensor([[1, 3], [4, 0]], device=dev)),
    }


@pytest.mark.parametrize("wrapper", [fn.__name__ for fn in _WRAPPERS])
def test_wrappers_refuse_a_gradient_on_the_card(dev, wrapper):
    """The refusal comes before any launch: the counters do not move."""
    x = torch.randn(2, 2, 16, 16, device=dev).requires_grad_(True)
    call = _card_wrapper_calls(dev)[wrapper]
    before = _all_launches()
    with pytest.raises(RuntimeError, match=f"{wrapper}.*plain backend"):
        call(x)
    assert _all_launches() == before
    with torch.no_grad():
        call(x)
    torch.cuda.synchronize()
    assert _all_launches() > before


def test_validation_through_the_kernels_matches_plain(dev):
    """After a few training steps, ``rank_forward`` on the validation pools
    through the kernels (split, compress / decompress, the Sq = 1 kernel)
    against the plain backend: float32, within 1e-4 (the served-score
    limit), and the same P@20."""
    from repro_torch.core.prettr import rank_forward
    from repro_torch.launch.train import (batch_tensors, prettr_train_step,
                                          validation_scores)
    from repro_torch.models.backend import apply_backend

    cfg, world, params, opt_cfg, opt = _smoke_trainer(dev)
    for i in range(4):
        pos, neg = world.pair_batch(np.random.default_rng(i), 8,
                                    cfg.max_query_len, cfg.max_doc_len)
        params, opt, _, _ = prettr_train_step(params, opt, cfg, opt_cfg,
                                              batch_tensors(pos, dev),
                                              batch_tensors(neg, dev))
    rows = [world.pack_pair(world.queries[0], world.docs[d],
                            cfg.max_query_len, cfg.max_doc_len)
            for d in world.candidates(0, k=32)]
    t, s, v = (np.stack(x) for x in zip(*rows))
    batch = batch_tensors({"tokens": t, "segs": s, "valid": v}, dev)
    counts = (split_flash_attention.launches, fused_compress.launches,
              fused_decompress.launches, flash_decode_attention.launches)
    with torch.inference_mode():
        got = rank_forward(params, cfg, batch["tokens"], batch["segs"],
                           batch["valid"])
        want = rank_forward(params, apply_backend(cfg, "plain"),
                            batch["tokens"], batch["segs"], batch["valid"])
    assert all(n > c for n, c in zip(
        (split_flash_attention.launches, fused_compress.launches,
         fused_decompress.launches, flash_decode_attention.launches),
        counts))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 1e-4
    got_scores, got_p20 = validation_scores(params, cfg, world, dev)
    want_scores, want_p20 = validation_scores(
        params, apply_backend(cfg, "plain"), world, dev)
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-4, rtol=0)
    assert got_p20 == want_p20


# ---------------------------------------------------------------------------
# Sharded serving and BERT4Rec's split on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("cache_mb", [0, 8])
def test_router_on_the_card_bit_equals_the_service(dev, tmp_path, n_shards,
                                                   cache_mb):
    """RankingRouter over workers sharing the card against the
    single-process RankingService, bf16 kernels over an int8 + int8 K/V
    index (the paged join with the cache): every score the same bits,
    the cache's warm pass too."""
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.index import IndexBuilder, TermRepIndex
    from repro_torch.serving import (RankingRouter, RankingService,
                                     RankRequest)

    cfg = smoke_config(compute_dtype=torch.bfloat16)
    params = init_prettr(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(5)
    docs = [rng.integers(4, 512, rng.integers(3, 60)) for _ in range(48)]
    IndexBuilder(str(tmp_path), cfg, params, batch_size=8, codec="int8",
                 store_layer_kv=True, kv_codec="int8", n_shards=2).build(docs)
    idx = TermRepIndex.open(str(tmp_path))
    reqs = []
    for i in range(6):
        q = np.zeros(8, np.int64)
        q[:5] = [1, *rng.integers(4, 512, 3), 2]
        reqs.append(RankRequest(q, q != 0, [int(d) for d in
                                            rng.integers(0, 48, 20)],
                                request_id=f"r{i}"))
    kw = dict(micro_batch=8, doc_cache_mb=cache_mb, page_tokens=16)

    def passes(svc):
        out = []
        for _ in range(2):
            for r in reqs:
                svc.submit(r)
            out.append({r.request_id: (r.doc_ids, r.scores)
                        for r in svc.drain()})
        return out

    want = passes(RankingService(params, cfg, idx, **kw))
    router = RankingRouter(params, cfg, idx, n_shards=n_shards, **kw)
    got = passes(router)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for rid in w:
            assert g[rid][0] == w[rid][0]
            np.testing.assert_array_equal(g[rid][1], w[rid][1])
    st = router.stats
    assert st.n_degraded == 0 and st.n_rows == 2 * 6 * 20
    if cache_mb:
        assert st.n_doc_cache_hit > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 200, 201])
def test_split_attention_bert4rec_head_dim_32(dev, s, dtype):
    """The split kernel at BERT4Rec's shapes (full_config at serve_p99:
    the [MASK] slot alone, the history [512, 2, 200, 32], the join
    [512, 2, 201, 32]) against its plain version; head dim 32 takes the
    CUDA-core kernel and counts in ``d32_launches``."""
    g = torch.Generator(device=dev).manual_seed(s)
    dt = DTYPES[dtype]
    q, k, v = (_rand(g, dev, dt, 512, 2, s, 32) for _ in range(3))
    valid = torch.arange(s, device=dev)[None] < torch.randint(
        (s + 1) // 2, s + 1, (512, 1), device=dev, generator=g)
    counts = (split_flash_attention.d32_launches,
              split_flash_attention.cuda_core_launches)
    got = split_flash_attention(q, k, v, None, k_valid=valid)
    assert (split_flash_attention.d32_launches - counts[0],
            split_flash_attention.cuda_core_launches - counts[1]) == (1, 1)
    want = split_attention_ref(q, k, v, last_valid_lengths(valid), valid)
    _close(got, want, dtype)


def test_bert4rec_split_kernels_match_plain(dev):
    """BERT4Rec's smoke_config (head dim 16) on the card:
    precompute_history and serve_scores_from_reps through the kernels
    (three split launches: the history's layer 0, the [MASK] slot's layer
    0, the join's layer 1) against the plain impl in float32 (2e-5), and
    forward_hidden refused on the kernel impl before any launch."""
    import dataclasses

    from repro_torch.configs.bert4rec import smoke_config
    from repro_torch.data.recsys import item_seq_batch
    from repro_torch.models.recsys import bert4rec as TB

    cfg = smoke_config()
    params = TB.init_bert4rec(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    batch = item_seq_batch(np.random.default_rng(0), 16,
                           n_items=cfg.n_items, seq_len=cfg.seq_len)
    seq = torch.from_numpy(batch["item_seq"].astype(np.int64)).to(dev)
    valid = torch.from_numpy(batch["valid"]).to(dev)
    out = {}
    for impl in ("cuda", "plain"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        before = split_flash_attention.launches
        with torch.inference_mode():
            reps = TB.precompute_history(params, c, seq, valid)
            out[impl] = TB.serve_scores_from_reps(params, c, reps, valid)
        assert split_flash_attention.launches - before == (
            3 if impl == "cuda" else 0)
    _close(out["cuda"], out["plain"], "float32")
    before = split_flash_attention.launches
    with pytest.raises(ValueError, match="uniform split-flag"):
        TB.forward_hidden(params, cfg, seq, valid)
    assert split_flash_attention.launches == before


def test_dimenet_cora_card_matches_cpu(dev):
    """DimeNet's full config at Cora's shape (the full_graph_sm cell:
    2708 nodes, 10556 edges, 1433 features) on the card against the port
    on the CPU, same inputs and weights, float32: the logits within 1e-4
    of max|cpu|, the loss within 1e-5 relative, each gradient leaf within
    1e-4 of its max (the card's index_add and gather backwards sum in
    another order); no kernel of the port is launched."""
    from repro_torch.configs import dimenet as DC
    from repro_torch.data import graphs as G
    from repro_torch.device import to_device
    from repro_torch.launch.steps import gnn_cell_config
    from repro_torch.models.gnn import dimenet as D
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths

    cfg = gnn_cell_config(DC.spec(), "full_graph_sm").cfg
    b_cpu = G.graph_batch_tensors(G.make_graph_batch(
        2708, 10556, d_feat=1433, fanout_cap=8, n_classes=16), device="cpu")
    p_cpu = D.init_dimenet(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    b, p = to_device(b_cpu, dev), to_device(p_cpu, dev)
    fwd = lambda params, batch: D.dimenet_forward(
        params, cfg, **{k: v for k, v in batch.items() if k != "labels"})
    counters = [(split_flash_attention, "launches"),
                (join_flash_attention, "launches"),
                (flash_decode_attention, "launches"),
                (fused_compress, "launches"), (fused_decompress, "launches"),
                (embedding_bag_op, "launches")]
    before = [getattr(w, a) for w, a in counters]
    with torch.no_grad():
        want, got = fwd(p_cpu, b_cpu), fwd(p, b).cpu()
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale
    loss_w, g_w = value_and_grad(lambda q: D.node_cls_loss(q, cfg, b_cpu),
                                 p_cpu)
    loss_g, g_g = value_and_grad(lambda q: D.node_cls_loss(q, cfg, b), p)
    assert abs(loss_g.item() - loss_w.item()) <= 1e-5 * abs(loss_w.item())
    g_w = dict(leaves_with_paths(g_w))
    for k, g in leaves_with_paths(g_g):
        assert (g.cpu() - g_w[k]).abs().max() <= 1e-4 * g_w[k].abs().max(), k
    assert [getattr(w, a) for w, a in counters] == before


# ---------------------------------------------------------------------------
# The mesh: SPMD ranks over NCCL, the data-parallel build, the router on a
# mesh of the cards
# ---------------------------------------------------------------------------

SPMD_SPEC = {"lookup": {"rows": 1 << 16, "dim": 128, "n_ids": 1 << 18},
             "moe": {"ep": {"n_experts": 8, "d_model": 64, "d_ff": 32,
                            "top_k": 2, "n_tokens": 512},
                     "no_ep": {"n_experts": 5, "d_model": 48, "d_ff": 32,
                               "top_k": 2, "n_tokens": 480}},
             "psum": {"axis": ("data", "model")}}


def _spmd_held(results, world):
    for r in results:
        assert r["world"] == world
        for case in ("uniform_cf4", "zipf_cf1"):
            assert r["lookup"][case]["equal"], (r["rank"], case)
        for key in ("moe_ep", "moe_no_ep"):
            m = r[key]
            assert m["max_abs_diff"] <= 1e-4 * m["max_abs"], (key, m)
            assert m["aux"] == pytest.approx(m["aux_one_process"],
                                             rel=1e-5)
        assert r["psum"]["finite"]
        assert r["psum"]["err_over_bound"] <= 1.0, r["psum"]


def test_spmd_checks_on_one_card_over_nccl(dev, tmp_path):
    """A world of 1 over NCCL: the row-sharded lookup (its gather on the
    embedding-bag kernel) equal to take * keep, the MoE FFN under rules
    within float32 of one process, compressed_psum finite and within its
    int8 bound of the float32 mean; the collectives are the identity."""
    from repro_torch.launch.mesh import run_spmd
    from repro_torch.tools.mesh_check import spmd_checks
    results = run_spmd(spmd_checks, (1, 1), ("data", "model"),
                       args=(SPMD_SPEC,), timeout_s=300,
                       store_dir=str(tmp_path))
    _spmd_held(results, 1)
    assert results[0]["psum"]["rel_err_vs_f32_mean"] < 0.01


def test_spmd_checks_over_every_card(dev, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 or more cards for a mesh of several ranks; "
                    f"{n} visible (the world of 1 runs in "
                    f"test_spmd_checks_on_one_card_over_nccl)")
    from repro_torch.launch.mesh import card_mesh_shape, run_spmd
    from repro_torch.tools.mesh_check import spmd_checks
    results = run_spmd(spmd_checks, card_mesh_shape(n), ("data", "model"),
                       args=(SPMD_SPEC,), timeout_s=300,
                       store_dir=str(tmp_path))
    _spmd_held(results, n)


def _chip_smoke():
    """``chip_smoke.py`` as a module, for the sizes and limits of the card
    checks it shares with these tests."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gnn_held(smoke, results, world):
    """Every rank's DimeNet check (chip_smoke.py's GNN_SPMD) inside the
    smoke's own gates (``gnn_line``, which prints the smoke's
    ``spmd_gnn`` line): the float32 loss and each gradient leaf within
    DIMENET_LOSS_REL / DIMENET_GRAD_REL of one process on the card, the
    bf16 steps' loss falling and its first within CELLS_BF16_FACTOR x one
    process's bf16 rounding of the float32 loss."""
    assert len(results) == world
    for r in results:
        g = r["gnn"]
        assert r["world"] == world and g["compute_dtype"] == "torch.bfloat16"
        assert g["edges_a_rank"] * world == g["edges_padded"] == 1288960
    assert smoke.gnn_line(torch.cuda.get_device_name(0), world, results,
                          {}) == []


@pytest.fixture(scope="module")
def blocked_grad_line():
    """chip_smoke.py's blocked-gradient check (``blocked_grad_check``,
    BLOCKED_GRAD at its sizes and limits), run once for this module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the split kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return _chip_smoke().blocked_grad_check(torch)


def test_blocked_gradient_within_the_bf16_limit(blocked_grad_line):
    """The "cuda" attention op at gemma3-4b's global layer (full width,
    2048 tokens, causal) launches the split kernel's causal form forward
    and takes the blocked gradient backward: bf16 dq / dk / dv within
    CELLS_BF16_FACTOR x the plain bf16 gradient's distance from the plain
    float32 gradient, the float32 op's within LM_SPMD_GRAD_LEAF_REL of
    each gradient's largest value."""
    smoke, line = _chip_smoke(), blocked_grad_line
    assert line["launches"]["split_attention_causal"] > 0
    assert line["launches_f32"]["split_attention_causal"] > 0
    for n, row in line["grads"].items():
        assert row["kernel_vs_f32"] <= smoke.CELLS_BF16_FACTOR \
            * row["plain_bf16_vs_f32"], (n, row)
        assert row["f32_rel"] <= smoke.LM_SPMD_GRAD_LEAF_REL, (n, row)


def test_blocked_gradient_peak_below_the_plain_gradient(blocked_grad_line):
    """At 8192 tokens one bf16 backward of the op through the blocked
    gradient peaks below the same op through the plain gradient, whose
    [2, 8, 8192, 8192] float32 scores take 4.3 GB a tensor."""
    peak = blocked_grad_line["backward_peak_bytes"]
    assert max(peak["blocked"]) < min(peak["plain"]), peak
    assert min(peak["plain"]) > 2 * 8 * 8192 ** 2 * 4, peak
    assert blocked_grad_line["ok"]


def test_dimenet_edge_sharded_cell_on_one_card_over_nccl(dev, tmp_path):
    """DimeNet's ogb_products cell cut by 48 through the edge-sharded route
    at a world of 1 over NCCL (every collective the identity)."""
    from repro_torch.launch.mesh import run_spmd
    from repro_torch.tools.mesh_check import spmd_checks
    smoke = _chip_smoke()
    results = run_spmd(spmd_checks, (1, 1), ("data", "model"),
                       args=({"gnn": smoke.GNN_SPMD},), timeout_s=300,
                       store_dir=str(tmp_path))
    _gnn_held(smoke, results, 1)


def test_dimenet_edge_sharded_cell_over_every_card(dev, tmp_path):
    """The same over every visible card: each rank a quarter (on four)
    of the edges and triplets, the messages all-gathered over NCCL."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 or more cards for a mesh of several ranks; "
                    f"{n} visible (the world of 1 runs in "
                    f"test_dimenet_edge_sharded_cell_on_one_card_over_nccl)")
    from repro_torch.launch.mesh import card_mesh_shape, run_spmd
    from repro_torch.tools.mesh_check import spmd_checks
    smoke = _chip_smoke()
    results = run_spmd(spmd_checks, card_mesh_shape(n), ("data", "model"),
                       args=({"gnn": smoke.GNN_SPMD},), timeout_s=300,
                       store_dir=str(tmp_path))
    _gnn_held(smoke, results, n)


def test_sharded_lm_loss_on_one_card_over_nccl(dev, tmp_path):
    """The sharded transformer at world 1 over NCCL (every collective the
    identity): gemma3's and granite-moe's smoke configs (granite's heads 16
    wide, a width the kernel takes), the float32 loss
    through the split kernel within 1e-5 of one process on the card, the
    kernel launched in it (causal and window forms for gemma3), gemma3's
    gradient through the plain impl within rtol = atol = 1e-5 element by
    element, the bf16 loss within 2e-2."""
    import dataclasses

    from repro_torch.configs import gemma3_4b, granite_moe_3b
    from repro_torch.launch.mesh import run_spmd
    from repro_torch.tools.mesh_check import spmd_checks, split_launches
    kw = dict(batch=2, seq=64)
    # granite's smoke heads are 12 wide; the kernel takes 16-256
    granite = dataclasses.replace(granite_moe_3b.smoke_config(), head_dim=16)
    spec = {"lm": {"gemma3": dict(config=gemma3_4b.smoke_config(),
                                  grad=True, bf16=True, **kw),
                   "granite": dict(config=granite, grad=False, bf16=False,
                                   **kw)}}
    (res,) = run_spmd(spmd_checks, (1, 1), ("data", "model"),
                      args=(spec, split_launches), timeout_s=300,
                      store_dir=str(tmp_path))
    for key in ("lm_gemma3", "lm_granite"):
        r = res[key]
        assert r["loss"]["rel"] <= r["loss_rtol"], r["loss"]
        assert r["loss"]["launches"]["split_attention_causal"] > 0, r["loss"]
    g = res["lm_gemma3"]
    assert g["loss"]["launches"]["split_attention_window"] > 0
    assert g["grad"]["loss_rel"] <= g["grad"]["rtol"]
    assert g["grad"]["leaves_apart"] == 0, g["grad"]
    assert g["bf16"]["rel"] <= 2e-2, g["bf16"]
    assert g["bf16"]["launches"]["split_attention_causal"] > 0


@pytest.mark.parametrize("hq,hkv,window", [(2, 1, -1), (2, 1, 1024),
                                           (1, 1, -1), (1, 1, 1024),
                                           (6, 2, -1), (3, 1, -1)])
def test_split_kernel_takes_a_ranks_local_heads(dev, hq, hkv, window):
    """The head counts a rank runs under tensor parallelism (gemma3's 8/4
    on ``model`` 4 -> 2/1, on 8 -> 1/1; granite's 24/8 on 4 -> 6/2;
    chatglm3's 32/2 -> 8/1 on 4), causal, at gemma3's head dim 256, float32
    and bf16, against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(hq * 10 + hkv)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q = torch.randn((2, hq, 512, 256), generator=gen, device=dev,
                        dtype=dtype)
        k, v = (torch.randn((2, hkv, 512, 256), generator=gen, device=dev,
                            dtype=dtype) for _ in range(2))
        got = split_flash_attention(q, k, v, causal=True, window=window)
        want = split_attention_ref(q, k, v, torch.full((2,), 512,
                                                       device=dev),
                                   causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _mesh_smoke(dev):
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr

    cfg = smoke_config(compute_dtype=torch.bfloat16)
    params = init_prettr(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(6)
    docs = [rng.integers(4, 512, rng.integers(3, 60)) for _ in range(40)]
    return cfg, params, docs, rng


def test_data_parallel_build_on_the_cards_matches_one_device(dev, tmp_path):
    """IndexBuilder(mesh=) over every card: the same stream bytes as the
    one-device build on one card (each card's rows are the one-device
    batch's on several), verified by verify_index's replay."""
    from repro_torch.index import IndexBuilder, TermRepIndex, verify_index
    from repro_torch.launch.mesh import make_device_mesh

    cfg, params, docs, _ = _mesh_smoke(dev)
    mesh = make_device_mesh("data")
    kw = dict(codec="int8", store_layer_kv=True, kv_codec="int8")
    IndexBuilder(str(tmp_path / "one"), cfg, params, batch_size=8,
                 **kw).build(docs)
    IndexBuilder(str(tmp_path / "dp"), cfg, params, batch_size=8,
                 mesh=mesh, **kw).build(docs)
    a, b = (TermRepIndex.open(str(tmp_path / k)) for k in ("one", "dp"))
    assert b.encode_batch == -(-8 // mesh.size)      # rows a card encodes
    assert verify_index(b, cfg, params, docs, sample=16) == 16
    if mesh.size == 1:
        pa, _ = a.gather_raw(list(range(len(docs))))
        pb, _ = b.gather_raw(list(range(len(docs))))
        for name in pa:
            np.testing.assert_array_equal(pb[name], pa[name])


def test_router_on_a_mesh_of_the_cards_bit_equals_the_service(dev,
                                                              tmp_path):
    from repro_torch.dist import serving_shard_devices
    from repro_torch.index import IndexBuilder, TermRepIndex
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.serving import (RankingRouter, RankingService,
                                     RankRequest)

    cfg, params, docs, rng = _mesh_smoke(dev)
    IndexBuilder(str(tmp_path), cfg, params, batch_size=8, codec="int8",
                 store_layer_kv=True, kv_codec="int8").build(docs)
    idx = TermRepIndex.open(str(tmp_path))
    reqs = []
    for i in range(4):
        q = np.zeros(8, np.int64)
        q[:5] = [1, *rng.integers(4, 512, 3), 2]
        reqs.append(RankRequest(q, q != 0, [int(d) for d in
                                            rng.integers(0, 40, 16)],
                                request_id=f"r{i}"))

    def drain(svc):
        for r in reqs:
            svc.submit(r)
        return {r.request_id: (r.doc_ids, r.scores) for r in svc.drain()}

    kw = dict(micro_batch=8, use_layer_kv=True)
    want = drain(RankingService(params, cfg, idx, **kw))
    mesh = make_device_mesh("shard")
    router = RankingRouter(params, cfg, idx, mesh=mesh, **kw)
    assert [w.device for w in router.workers] == \
        [torch.device("cuda", i) for i in range(mesh.size)]
    got = drain(router)
    by_devices = drain(RankingRouter(params, cfg, idx,
                                     devices=serving_shard_devices(mesh),
                                     **kw))
    for rid in want:
        for run in (got, by_devices):
            assert run[rid][0] == want[rid][0]
            np.testing.assert_array_equal(run[rid][1], want[rid][1])
    # every worker scored on its own card: a kernel that fails there is
    # failed over, bit-equal, and only these counts show it
    st = router.stats
    assert (st.n_retries, st.n_failovers, st.n_degraded) == (0, 0, 0)


@pytest.mark.parametrize("hq,hkv,d,window", [
    (4, 2, 256, -1), (4, 2, 256, 1024), (2, 1, 256, 1024), (1, 1, 256, -1),
    (8, 1, 128, -1), (6, 2, 64, -1), (16, 1, 128, -1)])
def test_decode_kernel_takes_a_ranks_local_heads(dev, hq, hkv, d, window):
    """Flash decode (row 6) at the head counts a rank runs in the sharded
    route's decode step (gemma3's 8/4 on ``model`` 2 -> 4/2, on 4 -> 2/1,
    on 8 -> 1/1; chatglm3's 32/2 on 4 -> 8/1, on 2 -> 16/1; granite's
    24/8 on 4 -> 6/2) against a 2080-key cache at position 2063, float32
    and bf16, against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(hq * 10 + hkv + d)
    lengths = torch.full((2,), 2064, device=dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q = _rand(gen, dev, dtype, 2, hq, 1, d)
        k, v = (_rand(gen, dev, dtype, 2, hkv, 2080, d) for _ in range(2))
        got = flash_decode_attention(q, k, v, lengths, window=window)
        want = decode_attention_ref(q, k, v, lengths, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_sharded_decode_cells_on_one_card_over_nccl(dev, tmp_path):
    """gemma3's smoke prefill and four decode steps through the cells at
    world 1 over NCCL (``launch.steps``, the sharded route's cache and
    local heads), the kernels in float32, within 1e-4 of the same cells
    through the plain impls in one process; flash decode launched on the
    mesh, never on the plain run."""
    import _spmd_cell_ranks as R
    from repro_torch.launch.mesh import run_spmd

    (res,) = run_spmd(R.card_decode, (1, 1), ("data", "model"),
                      timeout_s=300, store_dir=str(tmp_path))
    assert res["max_rel"] <= 1e-4, res
    assert res["launches"] > 0 and res["plain_launches"] == 0, res


def test_moe_train_cell_gradient_on_one_card_over_nccl(dev, tmp_path):
    """granite-moe's smoke train cell at world 1 over NCCL (the MoE FFN's
    gradient through its autograd collectives, two micro-batches) against
    the same cell in one process on the card: loss, ``grad_norm`` and
    every updated parameter within 1e-5."""
    import _spmd_cell_ranks as R
    from repro_torch.launch.mesh import run_spmd

    (res,) = run_spmd(R.card_moe_train, (1, 1), ("data", "model"),
                      timeout_s=300, store_dir=str(tmp_path))
    assert max(res.values()) <= 1e-5, res


@pytest.mark.parametrize("case", ["attention_split", "attention_causal",
                                  "attention_window", "decode_attention",
                                  "compress", "decompress", "embedding_bag"])
def test_cuda_backend_ops_train_through_the_kernels(dev, case):
    """Under autograd the "cuda" backend ops (and ``padded_bag``'s "cuda"
    impl) launch their kernel forward (its counter moves once) and take
    a reference op's gradient backward (attention: the blocked one's):
    float32 output within 1e-4 of the plain op's on the card (fp16 stores
    within one fp16 step), every input's gradient within 1e-4 of its
    largest value."""
    import _backend_ops as O

    got, got_g, launches = O.run(case, "cuda", dev)
    want, want_g, plain_launches = O.run(case, "plain", dev)
    assert (launches, plain_launches) == (1, 0)
    tol = 2 ** -10 if got.dtype == torch.float16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for g, w in zip(got_g, want_g):
        err = float((g.float() - w.float()).abs().max())
        assert err <= 1e-4 * float(w.float().abs().max()), (case, err)


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "xdeepfm"])
def test_recsys_train_cell_through_the_kernels(dev, arch):
    """A recsys train cell (smoke config, float32) with ``bag_impl``
    "cuda": its lookups launch the embedding-bag kernel forward and take
    the plain version's gradient backward (``embedding.padded_bag``),
    against the same cell with ``bag_impl`` "plain", which launches none,
    on the same seeded inputs on the card.  The train gates of the smoke's
    cells: loss and ``grad_norm`` within 1e-5, each gradient leaf (AdamW's
    first moment) within 1e-4 of its largest value, the updated
    parameters within rtol = atol = 1e-5."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import default_rules
    from repro_torch.dist.compat import AbstractMesh
    from repro_torch.launch import steps as ST
    from repro_torch.tree import leaves_with_paths

    one = default_rules(AbstractMesh((1, 1), ("data", "model")))
    res = {}
    for impl in ("cuda", "plain"):
        spec = get_arch(arch)
        spec = dataclasses.replace(spec, smoke=dataclasses.replace(
            spec.smoke, bag_impl=impl))
        cell = ST.build_spec_cell(spec, "train_batch", one, smoke=True,
                                  batch=64)
        args = ST.cell_inputs(cell, torch.Generator(device=dev).manual_seed(0),
                              dev, whole=True)
        before = _all_launches()
        new, out = cell.fn(*args)
        torch.cuda.synchronize()
        res[impl] = (new, out, _all_launches() - before)
    (new, out, launched), (want, wout, plain_launched) = res["cuda"], \
        res["plain"]
    assert launched > 0 and plain_launched == 0
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(out[k], wout[k], rtol=1e-5, atol=1e-5)
    g = dict(leaves_with_paths(new["opt"]["m"]))
    for k, w in leaves_with_paths(want["opt"]["m"]):
        err = float((g[k] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (k, err)
    p = dict(leaves_with_paths(new["params"]))
    for k, w in leaves_with_paths(want["params"]):
        torch.testing.assert_close(p[k], w, rtol=1e-5, atol=1e-5)
