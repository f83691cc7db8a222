"""Public wrappers of the compressor kernels (``csrc/fused_compress.cu``).

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch a
kernel or raise.  An input that requires grad while grad is
enabled raises first, on either device (``_build.refuse_grad``): the
kernels' outputs carry no gradient.
Launch counters: ``fused_compress.launches`` (float16
output) and ``.f32_launches`` (float32 output, for a quantising index
codec); ``fused_decompress.launches`` (float16 input) and
``.f32_launches`` (float32 input, the decoded int8 payload).  Each call
also counts in one of two route counters, by the kernel the C entry ran:
``.tensor_core_launches`` (``compress_tc_kernel`` /
``decompress_tc_kernel``, split TF32 on the tensor cores) or
``.cuda_core_launches`` (``compress_kernel`` / ``decompress_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_compress.ref import compress_ref, decompress_ref

MAX_COLS = 1024


def fused_compress(x, w, b, *, out_dtype=torch.float16):
    """x: [..., d] -> [..., e] in ``out_dtype`` (float16, or float32 for a
    quantising codec): GELU_tanh(x @ w + b), float32 inside.  ``w``
    [d, e] and ``b`` [e] are used in float32."""
    _build.refuse_grad("fused_compress", x, w, b)
    if x.device.type == "cpu":
        return compress_ref(x, w, b, out_dtype=out_dtype)
    if out_dtype not in (torch.float16, torch.float32):
        raise TypeError(f"the compress kernel stores float16 or float32, "
                        f"not {out_dtype}")
    d, e = w.shape
    if x.shape[-1] != d or b.shape != (e,):
        raise ValueError(f"compress shapes do not match: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    _check_gemm(d, e)
    xf = _rows(x, d)
    w, b = _f32(w, x.device), _f32(b, x.device)
    out = torch.empty((xf.shape[0], e), dtype=out_dtype, device=x.device)
    kernel = _build.launch_reporting(
        "rt_compress", xf.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), _build.dtype_code(xf.dtype),
        _build.dtype_code(out_dtype), xf.shape[0], d, e,
        _build.stream_ptr(x.device))
    _count_route(fused_compress, kernel)
    if out_dtype == torch.float32:
        fused_compress.f32_launches += 1
    else:
        fused_compress.launches += 1
    return out.reshape(*x.shape[:-1], e)


def fused_decompress(r, w, b, gamma, beta, *, out_dtype=torch.bfloat16,
                     eps: float = 1e-6):
    """r: [..., e] float16 (or float32, decoded from int8) -> [..., d] in
    ``out_dtype``: widen, expand, add the bias and LayerNorm (gamma, beta,
    eps) in one pass, float32 inside."""
    _build.refuse_grad("fused_decompress", r, w, b, gamma, beta)
    if r.device.type == "cpu":
        return decompress_ref(r, w, b, gamma, beta, out_dtype=out_dtype,
                              eps=eps)
    if r.dtype not in (torch.float16, torch.float32):
        raise TypeError(f"the decompress kernel reads float16 or float32 "
                        f"reps, not {r.dtype}")
    e, d = w.shape
    if r.shape[-1] != e or b.shape != (d,) or gamma.shape != (d,) \
            or beta.shape != (d,):
        raise ValueError(f"decompress shapes do not match: r "
                         f"{tuple(r.shape)}, w {tuple(w.shape)}")
    _check_gemm(e, d)
    rf = _rows(r, e)
    w, b = _f32(w, r.device), _f32(b, r.device)
    gamma, beta = _f32(gamma, r.device), _f32(beta, r.device)
    out = torch.empty((rf.shape[0], d), dtype=out_dtype, device=r.device)
    kernel = _build.launch_reporting(
        "rt_decompress", rf.data_ptr(), w.data_ptr(), b.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        _build.dtype_code(rf.dtype), _build.dtype_code(out_dtype),
        rf.shape[0], e, d, float(eps), _build.stream_ptr(r.device))
    _count_route(fused_decompress, kernel)
    if rf.dtype == torch.float32:
        fused_decompress.f32_launches += 1
    else:
        fused_decompress.launches += 1
    return out.reshape(*r.shape[:-1], d)


for _fn in (fused_compress, fused_decompress):
    _fn.launches = 0
    _fn.f32_launches = 0
    _fn.tensor_core_launches = 0
    _fn.cuda_core_launches = 0


def _count_route(fn, kernel):
    if kernel == _build.TENSOR_CORE:
        fn.tensor_core_launches += 1
    else:
        fn.cuda_core_launches += 1


def _check_gemm(k_dim, n_cols):
    """The kernels step the reduction 4 wide and give each of their 256
    threads at most 4 output columns."""
    if k_dim % 4:
        raise ValueError(f"reduction width {k_dim} is not a multiple of 4")
    if n_cols > MAX_COLS:
        raise ValueError(f"{n_cols} output columns exceed the kernel's "
                         f"{MAX_COLS}")


def _rows(x, width):
    if x.device.type != "cuda":
        raise ValueError(f"kernel input must lie on a CUDA device, got "
                         f"{x.device}")
    if x.numel() == 0:
        raise ValueError("empty kernel input")
    return x.reshape(-1, width).contiguous()


def _f32(t, device):
    """``t`` as a contiguous float32 tensor: one that is already so is
    returned as it is (``to`` and ``contiguous`` copy nothing then)."""
    if t.device != device:
        raise ValueError(f"weight on {t.device}, input on {device}")
    return t.to(torch.float32).contiguous()
