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
length); ``"cuda"`` runs the kernel wrappers, which launch the
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

A backend family (:func:`impls_for`, :func:`apply_backend`) sets both
knobs of a config at once, as the entry points' ``backend=`` argument
does: ``"cuda"`` or ``"plain"``.
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


#: the port's backend families: the kernels or the plain versions
BACKENDS = ("cuda", "plain")


def impls_for(backend: str) -> tuple[str, str]:
    """A backend family name -> ``(attn_impl, compress_impl)``.  The JAX
    package's ``"blocked"`` and ``"pallas"`` families have no counterpart
    here: they raise, naming the port's two."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port's backends "
                         f"are {list(BACKENDS)}")
    return backend, backend


def apply_backend(cfg, backend: str):
    """Copy of ``cfg`` (a TransformerConfig, or a PreTTRConfig carrying
    one as its ``backbone``) rerouted through the ``backend`` family."""
    import dataclasses

    attn_impl, compress_impl = impls_for(backend)
    bb = getattr(cfg, "backbone", None)
    if dataclasses.is_dataclass(bb) and hasattr(bb, "attn_impl"):
        return dataclasses.replace(cfg, backbone=dataclasses.replace(
            bb, attn_impl=attn_impl, compress_impl=compress_impl))
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


# -- attention -------------------------------------------------------------


@register("attention", "plain")
def _attention_plain(q, k, v, *, cfg, scale, split_flag, segs, valid,
                     seg_boundary=-1, window=-1, positions=None):
    del seg_boundary
    if positions is None:
        b, s = q.shape[:2]
        positions = torch.arange(s, device=q.device).expand(b, s)
    # key validity, causality, the window and (below l) same-segment: the
    # masks the kernel applies
    mask = L.attention_mask(positions, positions, causal=cfg.causal,
                            window=window, q_seg=segs, k_seg=segs,
                            split_segments=split_flag, k_valid=valid)
    return L.plain_attention(q, k, v, mask[:, None], scale=scale)


@register("attention", "cuda")
def _attention_cuda(q, k, v, *, cfg, scale, split_flag, segs, valid,
                    seg_boundary=-1, window=-1, positions=None):
    del scale, segs, positions       # the kernel derives all three
    out, out_t = _model_layout_out(q)
    split_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), None, k_valid=valid,
                          causal=cfg.causal, window=int(window),
                          seg_boundary=seg_boundary if split_flag else -1,
                          out=out_t)
    return out


# -- decode_attention --------------------------------------------------------


@register("decode_attention", "plain")
def _decode_plain(q, k, v, *, cfg, scale, q_pos, k_pos, window,
                  k_valid=None, lengths=None, static_window=None):
    del cfg, lengths, static_window
    return L.decode_attention(q, k, v, scale=scale, k_pos=k_pos, q_pos=q_pos,
                              window=window, k_valid=k_valid)


@register("decode_attention", "cuda")
def _decode_cuda(q, k, v, *, cfg, scale, q_pos, k_pos, window, k_valid=None,
                 lengths=None, static_window=None):
    del cfg, scale, q_pos, k_pos, window   # the kernel's static contract
    if static_window is None:
        raise ValueError(
            "attn_impl='cuda' decode needs a static window; this layer "
            "range mixes window sizes -- use 'plain'")
    out, out_t = _model_layout_out(q)
    flash_decode_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), lengths, k_valid=k_valid,
                           window=int(static_window), out=out_t)
    return out


# -- join_attention ----------------------------------------------------------


@register("join_attention", "plain")
def _join_plain(q, kq, vq, kd, vd, *, cfg, scale, q_valid=None,
                kq_valid=None, kd_valid=None, kd_scale=None, vd_scale=None,
                paged=None):
    _check_doc_operands(kd, kd_scale, vd_scale, paged)
    b, sq = q.shape[0], q.shape[1]
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
    mask = k_valid[:, None, None, :]
    if sq > 1 and q_valid is not None:
        mask = mask & q_valid.bool()[:, None, :, None]
    return L.plain_attention(q, k, v, mask, scale=scale)


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
    return fused_compress(x, params["w_comp"], params["b_comp"],
                          out_dtype=store_dtype)


@register("decompress", "plain")
def _decompress_plain(params, r, *, compute_dtype=torch.bfloat16):
    from repro_torch.core.compression import decompress_plain
    return decompress_plain(params, r, compute_dtype=compute_dtype)


@register("decompress", "cuda")
def _decompress_cuda(params, r, *, compute_dtype=torch.bfloat16):
    return fused_decompress(r, params["w_decomp"], params["b_decomp"],
                            params["ln"]["scale"], params["ln"]["bias"],
                            out_dtype=compute_dtype)
