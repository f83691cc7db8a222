"""The tensor-core attention kernels' rounding points, emulated in plain
torch on the CPU and held against the JAX package's float32 references
before any card runs them (the kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py).

``split_attention_tc_kernel`` and ``join_tc_kernel`` (csrc/attention_tc.cuh)
compute S = Q.K^T from bf16 operands with float32 products and sums
(exact products), fold 64-key tiles into an online softmax in float32,
round P to bf16 before O += P.V, and for raw int8 K/V stage the integers
exactly, scale S's columns by the K scales, fold the V scales into P and
run P.V over P's two bf16 parts (hi = P rounded, lo = the rest rounded).
``tc_emulate`` repeats exactly those steps.

Limits, the card's for bf16: rtol = atol = 2e-2 (``chip_smoke.py``'s
``TOL``), and at most twice the distance of the plain version's bf16
output (a float32 computation rounded once) from the float32 reference.
Shapes: gemma3-4b's prefill cut to 2 heads (GQA 2/1) and 512 tokens,
causal and with a 128-key window; PreTTR's join layer (q [4, 12, 512, 64]
against 32 + 480 keys) over bf16 and int8 doc K/V; PreTTR's concat join
(split attention with ``seg_boundary`` 32)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.join_attention.ref import (
    join_attention_ref as jax_join_ref)
from repro.kernels.join_attention.ref import (
    join_attention_ref_quant as jax_join_ref_quant)
from repro.kernels.split_attention.ref import (
    split_attention_ref as jax_split_ref)

NEG_INF = -1e30
BLOCK_N = 64
TOL = dict(rtol=2e-2, atol=2e-2)


def tc_emulate(q, k, v, mask, k_scales=None, v_scales=None):
    """The tensor-core kernels' arithmetic: q, k, v bf16 (or k, v raw
    int8 with [B, Skv] scales), mask [B, Hq, Sq, Skv]; 64-key tiles in
    order.  Returns float32 [B, Hq, Sq, D] before the output's rounding."""
    b, hq, sq, d = q.shape
    rep = hq // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    o = torch.zeros((b, hq, sq, d))
    for k0 in range(0, k.shape[2], BLOCK_N):
        tile = slice(k0, k0 + BLOCK_N)
        s = q.float() @ k[:, :, tile].float().transpose(-1, -2)
        if k_scales is not None:
            s = s * k_scales[:, None, None, tile]
        s = torch.where(mask[..., tile], s * (1.0 / math.sqrt(d)),
                        torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * math.log2(math.e))
        p = torch.exp2((s - m_new) * math.log2(math.e))
        l = l * corr + p.sum(-1, keepdim=True)
        vt = v[:, :, tile].float()
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if v_scales is not None:
            p = p * v_scales[:, None, None, tile]
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vt + (p - hi).to(torch.bfloat16).float() @ vt
        o = o * corr + pv
        m = m_new
    return o / l.clamp_min(1e-30)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
        .to(torch.bfloat16)


def _jax(t):
    return jnp.asarray(t.float().numpy())


def _hold(emulated, want):
    """The emulation (rounded to bf16 as the kernel writes it) against the
    float32 reference: within the card's bf16 limits."""
    want = torch.from_numpy(np.array(want, np.float32))
    got = emulated.to(torch.bfloat16).float()
    err = (got - want).abs().max().item()
    plain = (want.to(torch.bfloat16).float() - want).abs().max().item()
    torch.testing.assert_close(got, want, **TOL)
    assert err <= 2 * plain, (err, plain)


@pytest.mark.parametrize("window", [-1, 128])
def test_gemma3_prefill_causal_forms(window):
    rng = np.random.default_rng(20)
    b, hq, hkv, s, d = 1, 2, 1, 512, 256
    q, k, v = _bf16(rng, b, hq, s, d), _bf16(rng, b, hkv, s, d), \
        _bf16(rng, b, hkv, s, d)
    pos = torch.arange(s)
    mask = pos[None] <= pos[:, None]
    if window > 0:
        mask = mask & (pos[:, None] - pos[None] < window)
    want = jax_split_ref(_jax(q), _jax(k), _jax(v), jnp.full((b,), s),
                         causal=True, window=window)
    _hold(tc_emulate(q, k, v, mask.expand(b, hq, s, s)), want)


def _join_world(rng, b=4, h=12, lq=32, ld=480, d=64):
    q = _bf16(rng, b, h, lq + ld, d)
    kq, vq = _bf16(rng, b, h, lq, d), _bf16(rng, b, h, lq, d)
    kqv = torch.from_numpy(np.arange(lq)[None] < rng.integers(3, lq + 1,
                                                              (b, 1)))
    kdv = torch.from_numpy(rng.random((b, ld)) < 0.85)
    kdv[:, 0] = True
    return q, kq, vq, kqv, kdv


def _join_mask(kqv, kdv, hq, sq):
    """The kernel's key order: the query segment padded to a 64-key tile
    (the pad masked), then the doc segment."""
    b, lq = kqv.shape
    pad = torch.zeros((b, -lq % BLOCK_N), dtype=torch.bool)
    keys = torch.cat([kqv, pad, kdv], 1)
    return keys[:, None, None, :].expand(b, hq, sq, keys.shape[1])


def _pad_q_segment(x):
    return torch.cat([x, torch.zeros_like(x[:, :, : -x.shape[2] % BLOCK_N])],
                     2)


def test_prettr_join_dense():
    rng = np.random.default_rng(21)
    q, kq, vq, kqv, kdv = _join_world(rng)
    kd, vd = _bf16(rng, *q.shape[:2], 480, 64), _bf16(rng, *q.shape[:2], 480,
                                                      64)
    k = torch.cat([_pad_q_segment(kq), kd], 2)
    v = torch.cat([_pad_q_segment(vq), vd], 2)
    want = jax_join_ref(_jax(q), _jax(kq), _jax(vq), _jax(kd), _jax(vd),
                        jnp.asarray(kqv.numpy()), jnp.asarray(kdv.numpy()))
    _hold(tc_emulate(q, k, v, _join_mask(kqv, kdv, 12, 512)), want)


@pytest.mark.parametrize("spread", ["codec", "decades"])
def test_prettr_join_int8_kv(spread):
    """Raw int8 doc K/V with per-token scales: the codec's (1e-3 .. 0.051,
    as chip_smoke.py draws them) or spread over four decades (1e-4 .. 1,
    where one bf16 rounding of the scaled P would miss the limit on
    outputs that cancel); the query segment's scales are 1."""
    rng = np.random.default_rng(22)
    q, kq, vq, kqv, kdv = _join_world(rng)
    b, h = q.shape[:2]
    kd8, vd8 = (torch.from_numpy(rng.integers(-127, 128, (b, h, 480, 64))
                                 .astype(np.int8)) for _ in range(2))
    draw = ((lambda: 1e-3 + 0.05 * rng.random((b, 480))) if spread ==
            "codec" else (lambda: 10.0 ** (-4 * rng.random((b, 480)))))
    ks, vs = (torch.from_numpy(draw()).float() for _ in range(2))
    k = torch.cat([_pad_q_segment(kq).float(), kd8.float()], 2)
    v = torch.cat([_pad_q_segment(vq).float(), vd8.float()], 2)
    ones = torch.ones((b, BLOCK_N))
    want = jax_join_ref_quant(
        _jax(q), _jax(kq), _jax(vq), jnp.asarray(kd8.numpy()),
        jnp.asarray(vd8.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vs.numpy()), jnp.asarray(kqv.numpy()),
        jnp.asarray(kdv.numpy()))
    _hold(tc_emulate(q, k, v, _join_mask(kqv, kdv, h, 512),
                     torch.cat([ones, ks], 1), torch.cat([ones, vs], 1)),
          want)


def test_prettr_concat_join_seg_boundary():
    """The legacy concat join: split attention over [B, 512] with the
    query / doc boundary at 32, inside the first 64-key tile."""
    rng = np.random.default_rng(23)
    b, h, s, d, sb = 2, 12, 512, 64, 32
    q, k, v = (_bf16(rng, b, h, s, d) for _ in range(3))
    valid = torch.from_numpy(rng.random((b, s)) < 0.85)
    valid[:, 0] = valid[:, sb] = True
    pos = torch.arange(s)
    same = (pos[:, None] >= sb) == (pos[None] >= sb)
    mask = same[None, None] & valid[:, None, None, :]
    want = jax_split_ref(_jax(q), _jax(k), _jax(v), jnp.full((b,), s),
                         jnp.asarray(valid.numpy()), seg_boundary=sb)
    _hold(tc_emulate(q, k, v, mask), want)
