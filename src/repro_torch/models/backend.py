"""Pluggable compute backends for the hot paths, as in
``repro.models.backend``: one string knob per ``TransformerConfig``
(``attn_impl``, ``compress_impl``) picks the implementation of each kind.

Kinds and call contracts (model layout ``[B, S, H, D]``, boolean masks):

* ``attention(q, k, v, *, cfg, scale, split_flag, segs, valid,
  seg_boundary, window=-1, positions=None)`` -- q [B, Sq, Hq, D], k/v
  [B, Skv, Hkv, D]; masks by ``valid`` keys, ``cfg.causal``, the layer's
  ``window`` (> 0) and, with ``split_flag``, the PreTTR segments.
* ``decode_attention(q, k, v, *, cfg, scale, q_pos, k_pos, window,
  k_valid=None, lengths=None, static_window=None)`` -- one query row, q
  [B, 1, Hq, D], against k/v [B, S, Hkv, D]: keys with ``k_pos <= q_pos``,
  inside ``window`` and ``k_valid`` (the CLS-only final layer of the
  concat join and of ``rank_forward``).
* ``join_attention(q, kq, vq, kd, vd, *, cfg, scale, q_valid, kq_valid,
  kd_valid, kd_scale, vd_scale, paged)`` -- attention over the union of
  the query-segment and doc-segment K/V, never concatenated by the kernel.
* ``compress(params, x, *, store_dtype)`` / ``decompress(params, r, *,
  compute_dtype)`` -- the d -> e -> d bottleneck.

The doc segment of ``join_attention`` comes as float ``kd``/``vd``
([B, Ld, Hkv, D]), as raw int8 ``kd``/``vd`` with per-token scales
``kd_scale``/``vd_scale`` ([B, Ld]), or as ``paged``: a
:class:`~repro_torch.core.prettr.PagedDocKV` view of the device doc
cache's page pools (``kd``/``vd`` None).

Implementations: ``"plain"`` runs the plain PyTorch versions with the JAX
package's "plain" semantics (int8 K/V are dequantised and rounded to the
compute dtype, paged pools densified and sliced to ``kd_valid``'s
length); ``"blocked"``, the JAX package's default, runs
:func:`~repro_torch.models.layers.blocked_attention` (KV blocks of
``cfg.block_kv``, an online softmax, each block step recomputed in the
backward: no ``[Sq, Skv]`` scores) for ``attention`` and the join's
Sq > 1 rows over the concatenated, densified and dequantised K/V, and
the plain versions for ``decode_attention`` and the join's Sq = 1 row,
as the JAX impls do; ``"cuda"`` runs the kernel wrappers, which launch the
hand-written Hopper kernels on CUDA tensors (and their plain versions on
CPU tensors): int8 K/V go to the kernel's int8 form, paged pools to its
paged form; ``decode_attention`` goes to the flash-decode kernel, which
derives its scale (``1/sqrt(D)``) and its query position
(``lengths - 1``) itself and needs ``static_window``, as the Pallas impl
does.  ``attention`` under ``"cuda"`` runs the split-attention kernel
with ``cfg.causal`` and the layer's window as runtime arguments; the
model's layer loop is Python, so every layer passes its own static
window and a gemma3 ``forward`` mixes local and global layers in one
call.  That computes what the JAX ``plain``/``blocked`` impls compute
(the JAX ``pallas`` impl takes uniform layer ranges only); it adds no
feature.

Training through ``"cuda"``: where autograd records through a float
input of ``attention``, ``decode_attention``, ``compress`` or
``decompress``, the op runs :class:`_ReferenceGradient`: its forward
launches the kernel (the wrappers themselves refuse inputs that require
grad), its backward recomputes a reference version on the saved inputs
and differentiates that: ``attention`` the ``"blocked"`` one at
``cfg.block_kv`` (the backward holds ``[Sq, block_kv]`` scores a block,
never ``[Sq, Skv]``), the other three their plain versions (none forms
``[S, S]`` scores).  ``join_attention`` runs at inference only and keeps
the wrappers' refusal.

A backend family (:func:`impls_for`, :func:`apply_backend`) sets both
knobs of a config at once, as the entry points' ``backend=`` argument
does: ``"cuda"``, ``"plain"`` or ``"blocked"`` (whose compressor is the
plain one: there is no blocked compressor, as in the JAX package).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.decode_attention import flash_decode_attention
from repro_torch.kernels.fused_compress import fused_compress, fused_decompress
from repro_torch.kernels.join_attention import (join_flash_attention,
                                                join_flash_attention_paged)
from repro_torch.kernels.split_attention import split_flash_attention
from repro_torch.models import layers as L

KINDS = ("attention", "decode_attention", "join_attention", "compress",
         "decompress")

_REGISTRY: dict[str, dict[str, Callable]] = {k: {} for k in KINDS}


def register(kind: str, name: str):
    def deco(fn):
        _REGISTRY[kind][name] = fn
        return fn
    return deco


def available(kind: str) -> list[str]:
    return sorted(_REGISTRY[kind])


def get_impl(kind: str, name: str) -> Callable:
    if kind not in _REGISTRY:
        raise ValueError(f"unknown backend kind {kind!r}; kinds: {KINDS}")
    fn = _REGISTRY[kind].get(name)
    if fn is None:
        raise ValueError(f"unknown {kind} implementation {name!r}; "
                         f"available: {available(kind)}")
    return fn


#: the port's backend families: the kernels, the plain versions, or the
#: JAX package's default blocked attention
BACKENDS = ("cuda", "plain", "blocked")


def impls_for(backend: str) -> tuple[str, str]:
    """A backend family name -> ``(attn_impl, compress_impl)``: the
    compressor has no ``"blocked"`` flavour and runs ``"plain"`` under it.
    The JAX package's ``"pallas"`` family is the port's ``"cuda"``: it
    raises, naming the port's families."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port's backends "
                         f"are {list(BACKENDS)}")
    return backend, "plain" if backend == "blocked" else backend


def transformer_config_of(cfg):
    """The TransformerConfig carrying the backend knobs (``attn_impl`` and
    ``compress_impl``): ``cfg`` itself, its ``backbone`` *field* (a
    PreTTRConfig; a ``backbone()`` method, as on Bert4RecConfig, whose
    own ``attn_impl`` feeds it, is not this case), or None."""
    import dataclasses

    knobs = lambda c: hasattr(c, "attn_impl") and hasattr(c, "compress_impl")
    bb = getattr(cfg, "backbone", None)
    if dataclasses.is_dataclass(bb) and knobs(bb):
        return bb
    return cfg if knobs(cfg) else None


def apply_backend(cfg, backend: str):
    """Copy of ``cfg`` (a TransformerConfig, or a PreTTRConfig carrying
    one as its ``backbone``) rerouted through the ``backend`` family."""
    import dataclasses

    attn_impl, compress_impl = impls_for(backend)
    tcfg = transformer_config_of(cfg)
    if tcfg is not None and tcfg is not cfg:
        return dataclasses.replace(cfg, backbone=dataclasses.replace(
            tcfg, attn_impl=attn_impl, compress_impl=compress_impl))
    return dataclasses.replace(cfg, attn_impl=attn_impl,
                               compress_impl=compress_impl)


def validate_config(attn_impl: str, compress_impl: str) -> None:
    """Raise ValueError for an impl name some kind does not know."""
    for kind, name, knob in (("attention", attn_impl, "attn_impl"),
                             ("decode_attention", attn_impl, "attn_impl"),
                             ("join_attention", attn_impl, "attn_impl"),
                             ("compress", compress_impl, "compress_impl"),
                             ("decompress", compress_impl, "compress_impl")):
        if name not in _REGISTRY[kind]:
            raise ValueError(f"unknown {knob} {name!r} (no {kind} "
                             f"registration); available: {available(kind)}")


def _check_doc_operands(kd, kd_scale, vd_scale, paged):
    if (kd_scale is None) != (vd_scale is None):
        raise ValueError("pass both kd_scale and vd_scale or neither")
    if paged is not None and (kd is not None or kd_scale is not None):
        raise ValueError("a paged doc segment replaces kd/vd and their "
                         "scales; pass them as None")


def _pages_to_rows(pool, page_table):
    """[P, page, ...] pool + [B, nP] table -> [B, nP * page, ...] rows."""
    g = pool[page_table.long()]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _densify_paged(paged, kd_valid):
    """The paged doc segment as dense [B, Ld, Hkv, D] rows, sliced to the
    caller's dense doc length."""
    ld = kd_valid.shape[1] if kd_valid is not None else None
    kd = _pages_to_rows(paged.k, paged.page_table)[:, :ld]
    vd = _pages_to_rows(paged.v, paged.page_table)[:, :ld]
    kd_scale = vd_scale = None
    if paged.k_scale is not None:
        kd_scale = _pages_to_rows(paged.k_scale, paged.page_table)[:, :ld, 0]
        vd_scale = _pages_to_rows(paged.v_scale, paged.page_table)[:, :ld, 0]
    return kd, vd, kd_scale, vd_scale


def _dequant_kv(kd, vd, kd_scale, vd_scale, cfg):
    """Widen raw-int8 doc K/V with per-token float32 scales, then round to
    the compute dtype: decode-then-attend."""
    kd = (kd.float() * kd_scale.float()[..., None, None]).to(cfg.compute_dtype)
    vd = (vd.float() * vd_scale.float()[..., None, None]).to(cfg.compute_dtype)
    return kd, vd


def _model_layout_out(q):
    """[B, Sq, H, D] buffer and its [B, H, Sq, D] view for the kernels."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return out, out.transpose(1, 2)


class _ReferenceGradient(torch.autograd.Function):
    """``kernel(*xs)`` with the gradient of ``reference(*xs)``: the
    forward runs with grad off, so the kernel wrapper takes the call; the
    backward recomputes ``reference`` on the saved inputs and
    differentiates it, so nothing of the reference's forward is held
    between the passes."""

    @staticmethod
    def forward(ctx, kernel, reference, *xs):
        ctx.reference = reference
        ctx.save_for_backward(*xs)
        return kernel(*xs)

    @staticmethod
    def backward(ctx, grad):
        xs = [x.detach().requires_grad_(need) for x, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = ctx.reference(*xs)
        grads = iter(torch.autograd.grad(
            out, [x for x in xs if x.requires_grad], grad))
        return (None, None,
                *(next(grads) if x.requires_grad else None for x in xs))


def _trainable(kernel, reference, *xs):
    """``kernel(*xs)``; where autograd records through one of the float
    tensors ``xs``, with ``reference``'s gradient
    (:class:`_ReferenceGradient`)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _ReferenceGradient.apply(kernel, reference, *xs)
    return kernel(*xs)


# -- attention -------------------------------------------------------------


@register("attention", "plain")
def _attention_plain(q, k, v, *, cfg, scale, split_flag, segs, valid,
                     seg_boundary=-1, window=-1, positions=None):
    del seg_boundary
    positions = _positions_of(q) if positions is None else positions
    # key validity, causality, the window and (below l) same-segment: the
    # masks the kernel applies
    mask = L.attention_mask(positions, positions, causal=cfg.causal,
                            window=window, q_seg=segs, k_seg=segs,
                            split_segments=split_flag, k_valid=valid)
    return L.plain_attention(q, k, v, mask[:, None], scale=scale)


def _positions_of(x):
    """``[B, S]`` positions 0..S-1 of a ``[B, S, ...]`` operand."""
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


@register("attention", "blocked")
def _attention_blocked(q, k, v, *, cfg, scale, split_flag, segs, valid,
                       seg_boundary=-1, window=-1, positions=None):
    del seg_boundary
    positions = _positions_of(q) if positions is None else positions
    return L.blocked_attention(
        q, k, v, scale=scale, block_kv=cfg.block_kv, q_pos=positions,
        k_pos=positions, causal=cfg.causal, window=window, q_seg=segs,
        k_seg=segs, split_segments=split_flag, k_valid=valid)


@register("attention", "cuda")
def _attention_cuda(q, k, v, *, cfg, scale, split_flag, segs, valid,
                    seg_boundary=-1, window=-1, positions=None):
    def kernel(q, k, v):             # it derives scale, segs, positions
        out, out_t = _model_layout_out(q)
        split_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), None, k_valid=valid,
                              causal=cfg.causal, window=int(window),
                              seg_boundary=seg_boundary if split_flag
                              else -1, out=out_t)
        return out

    # the gradient: the blocked version's, [Sq, block_kv] scores a block
    blocked = lambda q, k, v: _attention_blocked(
        q, k, v, cfg=cfg, scale=scale, split_flag=split_flag, segs=segs,
        valid=valid, window=window, positions=positions)
    return _trainable(kernel, blocked, q, k, v)


# -- decode_attention --------------------------------------------------------


@register("decode_attention", "plain")
@register("decode_attention", "blocked")    # no blocked flavour: the plain
def _decode_plain(q, k, v, *, cfg, scale, q_pos, k_pos, window,
                  k_valid=None, lengths=None, static_window=None):
    del cfg, lengths, static_window
    return L.decode_attention(q, k, v, scale=scale, k_pos=k_pos, q_pos=q_pos,
                              window=window, k_valid=k_valid)


@register("decode_attention", "cuda")
def _decode_cuda(q, k, v, *, cfg, scale, q_pos, k_pos, window, k_valid=None,
                 lengths=None, static_window=None):
    if static_window is None:
        raise ValueError(
            "attn_impl='cuda' decode needs a static window; this layer "
            "range mixes window sizes -- use 'plain'")

    def kernel(q, k, v):             # scale, q_pos: the static contract
        out, out_t = _model_layout_out(q)
        flash_decode_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), lengths, k_valid=k_valid,
                               window=int(static_window), out=out_t)
        return out

    plain = lambda q, k, v: L.decode_attention(
        q, k, v, scale=scale, k_pos=k_pos, q_pos=q_pos, window=window,
        k_valid=k_valid)
    return _trainable(kernel, plain, q, k, v)


# -- join_attention ----------------------------------------------------------


def _concat_join_operands(q, kq, vq, kd, vd, *, cfg, kq_valid, kd_valid,
                          kd_scale, vd_scale, paged):
    """The reference impls' join operands: the paged pools densified, int8
    doc K/V dequantised, then the query and doc segments concatenated
    into ``(k, v, k_valid)``."""
    _check_doc_operands(kd, kd_scale, vd_scale, paged)
    b = q.shape[0]
    if paged is not None:
        kd, vd, kd_scale, vd_scale = _densify_paged(paged, kd_valid)
        if kd_scale is None:
            kd, vd = kd.to(cfg.compute_dtype), vd.to(cfg.compute_dtype)
    if kd_scale is not None:
        kd, vd = _dequant_kv(kd, vd, kd_scale, vd_scale, cfg)
    k = torch.cat([kq, kd], dim=1)
    v = torch.cat([vq, vd], dim=1)
    ones = lambda n: torch.ones((b, n), dtype=torch.bool, device=q.device)
    k_valid = torch.cat([ones(kq.shape[1]) if kq_valid is None else kq_valid,
                         ones(kd.shape[1]) if kd_valid is None else kd_valid],
                        dim=1).bool()
    return k, v, k_valid


@register("join_attention", "plain")
def _join_plain(q, kq, vq, kd, vd, *, cfg, scale, q_valid=None,
                kq_valid=None, kd_valid=None, kd_scale=None, vd_scale=None,
                paged=None):
    k, v, k_valid = _concat_join_operands(
        q, kq, vq, kd, vd, cfg=cfg, kq_valid=kq_valid, kd_valid=kd_valid,
        kd_scale=kd_scale, vd_scale=vd_scale, paged=paged)
    mask = k_valid[:, None, None, :]
    if q.shape[1] > 1 and q_valid is not None:
        mask = mask & q_valid.bool()[:, None, :, None]
    return L.plain_attention(q, k, v, mask, scale=scale)


@register("join_attention", "blocked")
def _join_blocked(q, kq, vq, kd, vd, *, cfg, scale, q_valid=None,
                  kq_valid=None, kd_valid=None, kd_scale=None, vd_scale=None,
                  paged=None):
    del q_valid                      # keys mask only, as the JAX impl
    k, v, k_valid = _concat_join_operands(
        q, kq, vq, kd, vd, cfg=cfg, kq_valid=kq_valid, kd_valid=kd_valid,
        kd_scale=kd_scale, vd_scale=vd_scale, paged=paged)
    k_pos = _positions_of(k)
    if q.shape[1] == 1:              # the CLS row: the decode reference
        q_pos = torch.full((q.shape[0], 1),
                           torch.iinfo(torch.int32).max // 2, device=q.device)
        return L.decode_attention(q, k, v, scale=scale, k_pos=k_pos,
                                  q_pos=q_pos, window=-1, k_valid=k_valid)
    # positions feed only the (disabled) causal and window terms
    return L.blocked_attention(
        q, k, v, scale=scale, block_kv=cfg.block_kv,
        q_pos=_positions_of(q), k_pos=k_pos, causal=False, window=-1,
        k_valid=k_valid)


@register("join_attention", "cuda")
def _join_cuda(q, kq, vq, kd, vd, *, cfg, scale, q_valid=None,
               kq_valid=None, kd_valid=None, kd_scale=None, vd_scale=None,
               paged=None):
    del cfg, scale, q_valid          # kernel derives scale; keys mask only
    _check_doc_operands(kd, kd_scale, vd_scale, paged)
    out, out_t = _model_layout_out(q)
    qt, kqt, vqt = (t.transpose(1, 2) for t in (q, kq, vq))
    if paged is not None:            # the kernel walks the page table
        join_flash_attention_paged(
            qt, kqt, vqt, paged.k, paged.v, paged.page_table, paged.valid,
            kq_valid, kd_scale_pages=paged.k_scale,
            vd_scale_pages=paged.v_scale, out=out_t)
    else:
        join_flash_attention(qt, kqt, vqt, kd.transpose(1, 2),
                             vd.transpose(1, 2), kq_valid, kd_valid,
                             kd_scale, vd_scale, out=out_t)
    return out


# -- compress / decompress ---------------------------------------------------


@register("compress", "plain")
def _compress_plain(params, x, *, store_dtype=torch.float16):
    from repro_torch.core.compression import compress_plain
    return compress_plain(params, x, store_dtype=store_dtype)


@register("compress", "cuda")
def _compress_cuda(params, x, *, store_dtype=torch.float16):
    return _trainable(
        lambda x, w, b: fused_compress(x, w, b, out_dtype=store_dtype),
        lambda x, w, b: _compress_plain({"w_comp": w, "b_comp": b}, x,
                                        store_dtype=store_dtype),
        x, params["w_comp"], params["b_comp"])


@register("decompress", "plain")
def _decompress_plain(params, r, *, compute_dtype=torch.bfloat16):
    from repro_torch.core.compression import decompress_plain
    return decompress_plain(params, r, compute_dtype=compute_dtype)


@register("decompress", "cuda")
def _decompress_cuda(params, r, *, compute_dtype=torch.bfloat16):
    return _trainable(
        lambda r, w, b, g, be: fused_decompress(r, w, b, g, be,
                                                out_dtype=compute_dtype),
        lambda r, w, b, g, be: _decompress_plain(
            {"w_decomp": w, "b_decomp": b, "ln": {"scale": g, "bias": be}},
            r, compute_dtype=compute_dtype),
        r, params["w_decomp"], params["b_decomp"], params["ln"]["scale"],
        params["ln"]["bias"])
