"""The port's kernels: each plain PyTorch version against the JAX Pallas
kernel it replaces (interpret mode on the CPU), plus the package rules (no
JAX imports, the manifest msgpack).  The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances follow tests/test_kernels.py: rtol = atol = 2e-5 in float32,
2e-2 in bfloat16."""
import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import msgpack

from repro.kernels.fused_compress import fused_compress as jax_compress
from repro.kernels.fused_compress import fused_decompress as jax_decompress
from repro.kernels.join_attention import join_flash_attention as jax_join
from repro.kernels.masking import last_valid_lengths as jax_lengths
from repro.kernels.split_attention import split_flash_attention as jax_split
from repro_torch.index import _msgpack
from repro_torch.kernels.fused_compress import (fused_compress,
                                                fused_decompress)
from repro_torch.kernels.join_attention import join_flash_attention
from repro_torch.kernels.masking import last_valid_lengths
from repro_torch.kernels.split_attention import split_flash_attention

ROOT = os.path.join(os.path.dirname(__file__), "..")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a, name):
    """The same numpy values as a JAX array and a torch tensor of the
    named dtype (both round float32 -> bfloat16 to nearest even)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _split_inputs(rng, b, hq, hkv, sq, d, boundary):
    q = rng.standard_normal((b, hq, sq, d), np.float32)
    k = rng.standard_normal((b, hkv, sq, d), np.float32)
    v = rng.standard_normal((b, hkv, sq, d), np.float32)
    valid = np.arange(sq)[None] < rng.integers(sq // 2, sq + 1, (b, 1))
    valid[:, 1] = False                       # non-prefix validity
    valid[:, 0] = True                        # every row keeps a valid key
    if boundary >= 0:
        valid[:, boundary] = True
    return q, k, v, valid


SPLIT_SHAPES = [
    (2, 4, 2, 64, 32, -1),       # GQA, single segment
    (2, 2, 1, 80, 32, 24),       # PreTTR split, off-tile boundary, MQA
    (1, 4, 4, 40, 16, 8),        # split, D=16 (smoke_config heads)
    (2, 2, 2, 48, 64, 32),       # split, D=64 (full_config heads)
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,d,boundary", SPLIT_SHAPES)
def test_split_attention_plain_vs_pallas(b, hq, hkv, sq, d, boundary, dtype):
    rng = np.random.default_rng(0)
    q, k, v, valid = _split_inputs(rng, b, hq, hkv, sq, d, boundary)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jax_split(jq, jk, jv, None, k_valid=jnp.asarray(valid),
                     seg_boundary=boundary, interpret=True)
    got = split_flash_attention(tq, tk, tv, None,
                                k_valid=torch.from_numpy(valid),
                                seg_boundary=boundary)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def _join_inputs(rng, b, hq, hkv, sq, lq, ld, d):
    shape = lambda h, s: rng.standard_normal((b, h, s, d), np.float32)
    q, kq, vq, kd, vd = (shape(hq, sq), shape(hkv, lq), shape(hkv, lq),
                         shape(hkv, ld), shape(hkv, ld))
    kqv = np.arange(lq)[None] < rng.integers(1, lq + 1, (b, 1))
    kdv = np.arange(ld)[None] < rng.integers(1, ld + 1, (b, 1))
    kdv[:, min(2, ld - 1)] = False            # non-prefix doc validity
    kdv[:, 0] = True
    return q, kq, vq, kd, vd, kqv, kdv


JOIN_SHAPES = [
    (2, 4, 2, 32, 8, 24, 32),    # GQA, joint-shaped q
    (1, 4, 1, 1, 16, 48, 32),    # CLS row (Sq = 1), MQA
    (3, 8, 4, 40, 32, 8, 16),    # long query segment, short docs
    (2, 2, 2, 1, 8, 40, 64),     # CLS row, D=64
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,lq,ld,d", JOIN_SHAPES)
def test_join_attention_plain_vs_pallas(b, hq, hkv, sq, lq, ld, d, dtype):
    rng = np.random.default_rng(1)
    q, kq, vq, kd, vd, kqv, kdv = _join_inputs(rng, b, hq, hkv, sq, lq, ld, d)
    j, t = zip(*(_pair(a, dtype) for a in (q, kq, vq, kd, vd)))
    want = jax_join(*j, kq_valid=jnp.asarray(kqv), kd_valid=jnp.asarray(kdv),
                    interpret=True)
    got = join_flash_attention(*t, torch.from_numpy(kqv),
                               torch.from_numpy(kdv))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,d,e", [((37,), 64, 16), ((3, 13), 32, 8),
                                      ((2, 9), 128, 48)])
def test_compress_plain_vs_pallas(lead, d, e, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((*lead, d), np.float32)
    w = rng.standard_normal((d, e), np.float32) / np.sqrt(d)
    b = rng.standard_normal((e,), np.float32)
    jx, tx = _pair(x, dtype)
    want = jax_compress(jx, jnp.asarray(w), jnp.asarray(b), interpret=True)
    got = fused_compress(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float16 and got.shape == (*lead, e)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,e,d", [((37,), 16, 64), ((3, 13), 8, 32),
                                      ((2, 9), 48, 128)])
def test_decompress_plain_vs_pallas(lead, e, d, dtype):
    rng = np.random.default_rng(3)
    r = rng.standard_normal((*lead, e)).astype(np.float16)
    w = rng.standard_normal((e, d), np.float32) / np.sqrt(e)
    b, g, beta = (rng.standard_normal((d,), np.float32) for _ in range(3))
    jdt, tdt = DTYPES[dtype]
    want = jax_decompress(jnp.asarray(r), *(jnp.asarray(a)
                                            for a in (w, b, g, beta)),
                          out_dtype=jdt, interpret=True)
    got = fused_decompress(torch.from_numpy(r),
                           *(torch.from_numpy(a) for a in (w, b, g, beta)),
                           out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (*lead, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_compressor_wrappers_pass_float32_weights_as_they_are():
    """A contiguous float32 weight, bias, gamma or beta reaches the kernel
    without a copy a call; any other is converted."""
    from repro_torch.kernels.fused_compress.ops import _f32
    w = torch.randn(8, 4)
    assert _f32(w, w.device) is w
    assert _f32(w.t(), w.device).is_contiguous()
    assert _f32(w.half(), w.device).dtype == torch.float32


def test_last_valid_lengths_matches_jax():
    rng = np.random.default_rng(4)
    valid = rng.random((6, 11)) < 0.4
    valid[0] = False                          # all-pad row -> 0
    valid[1, -1] = True                       # last index valid -> S
    np.testing.assert_array_equal(
        last_valid_lengths(torch.from_numpy(valid)).numpy(),
        np.asarray(jax_lengths(jnp.asarray(valid), 11)))


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


@pytest.mark.parametrize("path", _port_files())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """No module of the port, nor chip_smoke.py, imports jax, the JAX
    package ``repro`` (numpy-only modules included) or msgpack."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    banned = [n for n in names
              if n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")]
    assert not banned, f"{path} imports {banned}"


MSGPACK_CASES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63,
    1.5, -0.0, 1e300, "", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é",
    b"", b"x" * 300, b"y" * 70000, list(range(20)), [None] * 70000,
    {"k": [1, {"z": None}], "n": 2.5}, {str(i): i for i in range(20)},
    {"version": 2, "codec": "fp16", "shards": [{"dir": "shard-00000",
                                                "lengths": [480, 17, 3]}]},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES,
                         ids=lambda o: type(o).__name__)
def test_msgpack_matches_the_package(obj):
    ours = _msgpack.packb(obj)
    assert ours == msgpack.packb(obj)
    assert _msgpack.unpackb(ours) == msgpack.unpackb(ours)


def test_msgpack_reads_float32_and_rejects_garbage():
    packed = msgpack.packb([1.25, -3], use_single_float=True)
    assert _msgpack.unpackb(packed) == [1.25, -3]
    with pytest.raises(ValueError):
        _msgpack.unpackb(packed[:-1])
    with pytest.raises(ValueError):
        _msgpack.unpackb(packed + b"\x00")
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
