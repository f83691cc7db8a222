"""The tensor-core compressor kernels' arithmetic, emulated in plain torch
on the CPU and held against the JAX package's float32 kernels (Pallas,
interpret mode) before any card runs them; the kernels themselves are
held against their plain versions on the card by tests/test_torch_cuda.py.

``compress_tc_kernel`` and ``decompress_tc_kernel`` (csrc/fused_compress.cu,
csrc/gemm_tf32.cuh) run x @ W (r @ W) as split TF32 on the tensor cores:
W splits into hi = tf32(W) (nearest, ties away from zero, 10 stored
mantissa bits, as ``cvt.rna.tf32.f32``) and lo = W - hi, which the MMA
truncates to TF32; a 16-bit input is exact in TF32 and takes two passes,
x.lo + x.hi; a float32 one splits too and takes three, x_lo.W_hi +
x_hi.W_lo + x_hi.W_hi; every product of two TF32 values is exact in
float32 and the passes sum in float32.
``tc_product`` repeats those steps.  Limits: rtol = atol = 2e-5 in float32
(the card tests' float32 limit); a 16-bit output within one unit in the
last place of the type, plus the float32 limit's 2e-5 absolute (GELU's
negative tail, 1 + tanh(z) near 0, loses most of its relative digits to
cancellation in either framework's float32).  A single TF32 pass misses
the float32 limit at these widths, so the limit has teeth.

The second half checks the kernels' fragment maps: the k and n
permutations and the XOR swizzles of their shared-memory tiles, as the
CUDA source computes them, reconstruct x @ W through the PTX fragment
layouts of mma.m16n8k8, and every fragment read they issue is free of
shared-memory bank conflicts."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.fused_compress import fused_compress as jax_compress
from repro.kernels.fused_compress import fused_decompress as jax_decompress

D, E = 768, 256                        # prettr_bert.full_config's d, e
ROWS = [2 * 480, 131]                  # two docs of 480 tokens; ragged
F32_TOL = dict(rtol=2e-5, atol=2e-5)
TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
         "float32": torch.float32}
JAX = {"bfloat16": jnp.bfloat16, "float16": jnp.float16,
       "float32": jnp.float32}
# one unit in the last place, relative
ULP = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}


def tf32(v):
    """``cvt.rna.tf32.f32`` with the 13 dropped bits cleared: round to 10
    stored mantissa bits, ties away from zero, by integer ops on the
    float32 bits (adding half a unit to the magnitude carries into the
    exponent where it must)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(v):
    """What the MMA reads of a float32 operand: its top 19 bits."""
    return (v.float().contiguous().view(torch.int32) & ~0x1FFF) \
        .view(torch.float32)


def split(v):
    hi = tf32(v)
    return hi, truncate(v - hi)


def tc_product(a, w, passes=None):
    """a [T, k] (bf16, fp16 or float32) @ w [k, n] float32 as the kernels
    compute it: 2 passes for a 16-bit a, 3 for a float32 one; ``passes=1``
    is a single TF32 pass, for the test that shows it is not enough."""
    w_hi, w_lo = split(w)
    if passes == 1:
        return tf32(a) @ w_hi
    if a.dtype != torch.float32:
        af = a.float()
        assert torch.equal(tf32(af), af)     # 16-bit values are exact in TF32
        return af @ w_lo + af @ w_hi
    a_hi, a_lo = split(a)
    return a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi


def compress_emulate(x, w, b, passes=None):
    """compress_tc_kernel before its output's rounding (float32)."""
    h = tc_product(x, w, passes) + b
    return torch.nn.functional.gelu(h, approximate="tanh")


def decompress_emulate(r, w, b, gamma, beta, eps=1e-6, passes=None):
    """decompress_tc_kernel before its output's rounding: bias, then the
    mean and the centred variance in two passes."""
    h = tc_product(r, w, passes) + b
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + eps) * gamma + beta


def _inputs(seed, rows, k, n, in_dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, k), np.float32)
    w = rng.standard_normal((k, n), np.float32) / np.sqrt(k)
    vecs = [rng.standard_normal((n,), np.float32) for _ in range(3)]
    a = torch.from_numpy(a).to(TORCH[in_dtype])
    return a, torch.from_numpy(w), [torch.from_numpy(v) for v in vecs]


def _jax(t, dtype=None):
    return jnp.asarray(t.float().numpy(), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jax_compress(rows, in_dtype, out_dtype):
    x, w, (b, _, _) = _inputs(1, rows, D, E, in_dtype)
    return np.asarray(jax_compress(_jax(x, JAX[in_dtype]), _jax(w), _jax(b),
                                   out_dtype=JAX[out_dtype], interpret=True)
                      .astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_decompress(rows, in_dtype, out_dtype):
    r, w, vecs = _inputs(2, rows, E, D, in_dtype)
    return np.asarray(jax_decompress(_jax(r, JAX[in_dtype]), _jax(w),
                                     *(_jax(v) for v in vecs),
                                     out_dtype=JAX[out_dtype], interpret=True)
                      .astype(jnp.float32))


def _hold(got_f32, want, out_dtype):
    """float32: within 2e-5; a 16-bit type: the emulation rounded to it is
    within one unit in its last place, plus 2e-5, of the JAX kernel's
    output."""
    if out_dtype == "float32":
        np.testing.assert_allclose(got_f32.numpy(), want, **F32_TOL)
        return
    got = got_f32.to(TORCH[out_dtype]).float().numpy()
    limit = ULP[out_dtype] * np.maximum(np.abs(got), np.abs(want)) \
        + F32_TOL["atol"]
    assert np.all(np.abs(got - want) <= limit), \
        np.abs(got - want).max()


@pytest.mark.parametrize("out_dtype", ["float16", "float32"])
@pytest.mark.parametrize("in_dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("rows", ROWS)
def test_compress_split_tf32_matches_jax(rows, in_dtype, out_dtype):
    x, w, (b, _, _) = _inputs(1, rows, D, E, in_dtype)
    _hold(compress_emulate(x, w, b), _jax_compress(rows, in_dtype, out_dtype),
          out_dtype)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("in_dtype", ["float16", "float32"])
@pytest.mark.parametrize("rows", ROWS)
def test_decompress_split_tf32_matches_jax(rows, in_dtype, out_dtype):
    r, w, vecs = _inputs(2, rows, E, D, in_dtype)
    _hold(decompress_emulate(r, w, *vecs),
          _jax_decompress(rows, in_dtype, out_dtype), out_dtype)


@pytest.mark.parametrize("kind,in_dtype", [
    ("compress", "bfloat16"), ("compress", "float32"),
    ("decompress", "float16"), ("decompress", "float32")])
def test_single_tf32_pass_misses_the_float32_limit(kind, in_dtype):
    rows = ROWS[0]
    if kind == "compress":
        x, w, (b, _, _) = _inputs(1, rows, D, E, in_dtype)
        one = compress_emulate(x, w, b, passes=1)
        want = _jax_compress(rows, in_dtype, "float32")
    else:
        r, w, vecs = _inputs(2, rows, E, D, in_dtype)
        one = decompress_emulate(r, w, *vecs, passes=1)
        want = _jax_decompress(rows, in_dtype, "float32")
    err = np.abs(one.numpy() - want)
    limit = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    assert (err > limit).any() and err.max() > 10 * F32_TOL["atol"], \
        err.max()


def test_tf32_rounding():
    one = 1.0 + 2.0 ** -10                   # the first TF32 step above 1
    half_up = np.float32(1.0 + 2.0 ** -11)   # a tie: away from zero
    below = np.nextafter(half_up, np.float32(0))
    v = torch.tensor([half_up, -half_up, below, -below, 3.0, 0.0])
    np.testing.assert_array_equal(
        tf32(v).numpy(), np.float32([one, -one, 1.0, -1.0, 3.0, 0.0]))
    x = torch.from_numpy((np.random.default_rng(3).standard_normal(4096)
                          * 10.0 ** np.arange(-4, 4).repeat(512))
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x - hi - lo).abs() <= 2.0 ** -20 * x.abs()).all()


# ---------------------------------------------------------------------------
# Fragment maps (csrc/gemm_tf32.cuh, csrc/fused_compress.cu)
# ---------------------------------------------------------------------------


def w_chunk(k, c):
    return c ^ (((k >> 1) & 3) << 1)


def a32_chunk(r, c):
    return c ^ ((r & 3) << 1)


def a16_chunk(r, c):
    return c ^ (r & 7)


def _mma(a, b):
    """mma.m16n8k8 over a warp's fragments (PTX ISA layouts; g = lane / 4,
    t = lane % 4): a [32, 4] (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
    (g + 8, t + 4)), b [32, 2] (b0 (t, g), b1 (t + 4, g)); returns c
    [32, 4] (c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
    2t + 1))."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
    C = A @ B
    return np.array([[C[l >> 2, 2 * (l & 3)], C[l >> 2, 2 * (l & 3) + 1],
                      C[(l >> 2) + 8, 2 * (l & 3)],
                      C[(l >> 2) + 8, 2 * (l & 3) + 1]] for l in range(32)])


def _no_conflicts(addresses, width, lanes_per_phase):
    """Byte addresses of one shared-memory read, ``width`` bytes each, in
    lane order: within each phase of ``lanes_per_phase`` lanes the
    accesses must cover distinct banks (128 bytes of 32 banks a cycle)."""
    for p in range(0, len(addresses), lanes_per_phase):
        units = [(a // width) % (128 // width)
                 for a in addresses[p:p + lanes_per_phase]]
        assert len(set(units)) == len(units), (p, units)


def _b_fragments(sw, cols, kr, wc):
    """The four n-tiles' (b0, b1) of one lane: float4 at rows kr, kr + 1
    of a swizzled W tile ``sw`` (flat, ``cols`` floats a row)."""
    rows = [sw[k * cols + 4 * w_chunk(k, wc):][:4] for k in (kr, kr + 1)]
    return [(rows[0][j], rows[1][j]) for j in range(4)]


def _stage_w(W, cols):
    k, n = W.shape
    sw = np.zeros(k * cols)
    for r in range(k):
        for c in range(n // 4):
            sw[r * cols + 4 * w_chunk(r, c):][:4] = W[r, 4 * c:4 * c + 4]
    return sw


@pytest.mark.parametrize("a_bytes", [2, 4])
def test_compress_fragment_maps(a_bytes):
    """One 128 x 128 block tile over one 64-deep stage, as
    compress_tc_kernel stages (cp.async to swizzled chunks) and reads it
    (ldmatrix for 16-bit x, float2 for float32 x, float4 for W)."""
    bm, bn, bk = 128, 128, 64
    rng = np.random.default_rng(4)
    X, W = rng.standard_normal((bm, bk)), rng.standard_normal((bk, bn))
    epc = 16 // a_bytes
    chunk = a16_chunk if a_bytes == 2 else a32_chunk
    sa = np.zeros(bm * bk)
    for r in range(bm):
        for c in range(bk // epc):
            sa[r * bk + epc * chunk(r, c):][:epc] = X[r, epc * c:epc * (c + 1)]
    sw = _stage_w(W, bn)
    out = np.full((bm, bn), np.nan)
    for warp in range(8):
        wm, wn = warp >> 2, warp & 3
        acc = np.zeros((4, 4, 32, 4))
        for s in range(bk // 8):
            b_addr = [4 * ((8 * s + 2 * (l & 3)) * bn
                           + 4 * w_chunk(8 * s + 2 * (l & 3), wn * 8 + (l >> 2)))
                      for l in range(32)]
            _no_conflicts(b_addr, 16, 8)
            b = [_b_fragments(sw, bn, 8 * s + 2 * (l & 3), wn * 8 + (l >> 2))
                 for l in range(32)]
            for m in range(4):
                if a_bytes == 2:
                    # ldmatrix.x4: lane l addresses row (l & 7) + 8 (q & 1)
                    # of matrix q = l / 8 at chunk s - s % 2 + q / 2
                    s0 = s - s % 2
                    row_addr = []
                    for l in range(32):
                        q = l >> 3
                        r = wm * 64 + 16 * m + (l & 7) + 8 * (q & 1)
                        row_addr.append(r * bk + 8 * chunk(r, s0 + (q >> 1)))
                    for q in range(4):
                        _no_conflicts([2 * x for x in row_addr[8 * q:8 * q + 8]],
                                      16, 8)
                    h = 2 * (s % 2)
                    a = []
                    for l in range(32):
                        g, t = l >> 2, l & 3
                        w0 = sa[row_addr[8 * h + g] + 2 * t:][:2]
                        w1 = sa[row_addr[8 * (h + 1) + g] + 2 * t:][:2]
                        a.append((w0[0], w1[0], w0[1], w1[1]))
                else:
                    a, addr = [], ([], [])
                    for l in range(32):
                        g, t = l >> 2, l & 3
                        r, c = wm * 64 + 16 * m + g, 2 * s + (t >> 1)
                        top = r * bk + 4 * chunk(r, c) + 2 * (t & 1)
                        bot = (r + 8) * bk + 4 * chunk(r + 8, c) + 2 * (t & 1)
                        addr[0].append(4 * top)
                        addr[1].append(4 * bot)
                        a.append((sa[top], sa[bot], sa[top + 1], sa[bot + 1]))
                    for rows in addr:
                        _no_conflicts(rows, 8, 16)
                for j in range(4):
                    acc[m, j] += _mma(np.array(a), np.array([bj[j] for bj in b]))
        for l in range(32):
            g, t = l >> 2, l & 3
            col = wn * 32 + 8 * t
            for m in range(4):
                for hr in range(2):
                    row = wm * 64 + 16 * m + g + 8 * hr
                    out[row, col:col + 4] = acc[m, :, l, 2 * hr]
                    out[row, col + 4:col + 8] = acc[m, :, l, 2 * hr + 1]
    np.testing.assert_allclose(out, X @ W, rtol=1e-12, atol=1e-12)


def test_decompress_fragment_maps():
    """One 32-row block of decompress_tc_kernel over K = 64 (two 32-deep
    stages) and d = 768 (8 warps of 3 groups of 32 columns): r widened
    into the swizzled sR, W through the swizzled ring."""
    bm, k, ng, bk = 32, 64, 3, 32
    cols = 8 * 32 * ng
    rng = np.random.default_rng(5)
    R, W = rng.standard_normal((bm, k)), rng.standard_normal((k, cols))
    sr = np.zeros(bm * k)
    for r in range(bm):
        for c in range(k // 4):
            sr[r * k + 4 * a32_chunk(r, c):][:4] = R[r, 4 * c:4 * c + 4]
    out = np.full((bm, cols), np.nan)
    for warp in range(8):
        for n in range(ng):
            acc = np.zeros((2, 4, 32, 4))
            wc = [(warp * ng + n) * 8 + (l >> 2) for l in range(32)]
            for kt in range(k // bk):
                sw = _stage_w(W[kt * bk:(kt + 1) * bk], cols)
                for s in range(bk // 8):
                    a, addr = [[], []], []
                    for l in range(32):
                        g, t = l >> 2, l & 3
                        c, o = (kt * bk + 8 * s) // 4 + (t >> 1), 2 * (t & 1)
                        for m in range(2):
                            r = 16 * m + g
                            top = r * k + 4 * a32_chunk(r, c) + o
                            bot = (r + 8) * k + 4 * a32_chunk(r + 8, c) + o
                            a[m].append((sr[top], sr[bot], sr[top + 1],
                                         sr[bot + 1]))
                            if m == 0:
                                addr.append(4 * top)
                    _no_conflicts(addr, 8, 16)
                    rows = [8 * s + 2 * (l & 3) for l in range(32)]
                    _no_conflicts([4 * (rows[l] * cols + 4 * w_chunk(
                        rows[l], wc[l])) for l in range(32)], 16, 8)
                    b = [_b_fragments(sw, cols, rows[l], wc[l])
                         for l in range(32)]
                    for m in range(2):
                        for j in range(4):
                            acc[m, j] += _mma(np.array(a[m]), np.array(
                                [bl[j] for bl in b]))
            for l in range(32):
                g, t = l >> 2, l & 3
                col = (warp * ng + n) * 32 + 8 * t
                for m in range(2):
                    for hr in range(2):
                        row = 16 * m + 8 * hr + g
                        out[row, col:col + 4] = acc[m, :, l, 2 * hr]
                        out[row, col + 4:col + 8] = acc[m, :, l, 2 * hr + 1]
    np.testing.assert_allclose(out, R @ W, rtol=1e-12, atol=1e-12)
