"""Gradient compression for the slowest all-reduce hop, the port of
``repro.optim.compression``.

Across pods (on the H100: across clusters, the ``pod`` axis of
``launch/mesh.py``) the gradient all-reduce is the slowest link, so that
hop is compressed: int8 with one scale a leaf and *error feedback* (the
quantisation residual is carried into the next step; Karimireddy et al.,
2019).  The arithmetic is the JAX package's: ``scale = max(max|x|,
1e-12) / 127`` (as XLA computes it: times float32(1 / 127)), round
half to even, clip to +-127, the residual kept
locally, the int8 payload summed as int32 and the scales summed, then
``mean = summed * (scale_sum / n) / n`` in the gradient's dtype.

The collectives run over the named axis's process group of an SPMD mesh
(``repro_torch.dist.compat.SpmdMesh``): one all-reduce of every leaf's
int32 payload in one flat buffer, one of the scales.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves_with_paths, map_with_paths, tree_map


_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def init_error_feedback(params):
    """A float32 zero residual for each leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_int8(x):
    # XLA compiles JAX's `/ 127.0` as a product with float32(1 / 127);
    # so does this, which keeps the scales (and residuals) bit-equal
    scale = torch.clamp(x.abs().max(), min=1e-12) * _INV_127.to(x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads, error_fb, axis):
    """int8 + error-feedback mean over the mesh axis (or tuple of axes)
    ``axis`` of the installed rules' SPMD mesh
    (``repro_torch.dist.install_rules``) -> ``(mean_grads,
    new_error_fb)``."""
    import torch.distributed as dist

    from repro_torch.dist.compat import SpmdMesh
    from repro_torch.dist.context import current_rules

    rules = current_rules()
    if rules is None or not isinstance(rules.mesh, SpmdMesh):
        raise ValueError("compressed_psum runs under rules installed over "
                         "an SPMD mesh (repro_torch.dist.install_rules)")
    mesh = rules.mesh
    group = mesh.group(axis)
    n = mesh.axis_size(axis)
    keys, flat_g = zip(*leaves_with_paths(grads))
    fb = dict(leaves_with_paths(error_fb))
    g32 = [g.float() + fb[k] for k, g in zip(keys, flat_g)]
    qs, scales = zip(*map(_quantize_int8, g32))
    # the residual stays local; x - q * scale rounded once, as XLA's
    # fused multiply-subtract gives it (the float64 product and difference
    # are exact: q has 8 bits, x and the product lie within a scale)
    new_e = {k: (x.double() - q.double() * s.double()).float()
             for k, x, q, s in zip(keys, g32, qs, scales)}
    # int8 payload summed in int32 against overflow across ranks
    summed = torch.cat([q.reshape(-1).to(torch.int32) for q in qs])
    scale_sum = torch.stack(scales)
    dist.all_reduce(summed, group=group)
    dist.all_reduce(scale_sum, group=group)
    means, lo = {}, 0
    for i, (k, g) in enumerate(zip(keys, flat_g)):
        part = summed[lo:lo + g.numel()].reshape(g.shape)
        lo += g.numel()
        means[k] = (part.float() * (scale_sum[i] / n) / n).to(g.dtype)
    return (map_with_paths(lambda k, _: means[k], grads),
            map_with_paths(lambda k, _: new_e[k], grads))
