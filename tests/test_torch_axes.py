"""The port's logical-axes trees and sharded specs against the JAX
package's, in one process on the CPU: for every registry arch at its
full config, the axes tree beside each ``init_*`` (``param_axes``,
``moe_axes``, ``dlrm_axes``, ``deepfm_axes``, ``bert4rec_axes``,
``dimenet_axes``, ``prettr_axes``) equals the JAX ``init_*``'s second
return, layer by layer (the port keeps a list of layer dicts: each
layer's axes are JAX's stacked ones without the leading ``"layers"``),
and ``launch.steps.state_specs`` (params and AdamW state, through
``eval_params``, ``attach_shardings`` and ``opt_state_axes``) gives
JAX's shapes, dtypes and partition specs under ``default_rules`` on the
production 16 x 16 mesh and a (2, 2) mesh.  The port's PreTTR tree has
no ``lm_head`` (``init_prettr`` drops it), so JAX's is compared without
it.  JAX's ``AbstractMesh`` is built as ``(axis_sizes, axis_names)``,
as jax 0.9 wants."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ALL_ARCHS, get_arch as jax_arch
from repro.dist import sharding as JS
from repro.launch.steps import eval_params as jax_eval_params
from repro.launch.steps import state_specs as jax_state_specs
from repro.optim.adam import OptimizerConfig as JaxOptimizerConfig
from repro_torch.configs import get_arch
from repro_torch.dist import default_rules
from repro_torch.dist.compat import AbstractMesh
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TT
from repro_torch.optim import OptimizerConfig, opt_state_axes

MESHES = {"production_16x16": ((16, 16), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _jax_init_fn(spec):
    cfg = spec.config
    if spec.name == "prettr-bert":
        from repro.core.prettr import init_prettr
        return lambda k: init_prettr(k, cfg)
    if spec.family == "lm":
        from repro.models.transformer import init_params
        return lambda k: init_params(k, cfg)
    if spec.family == "gnn":
        from repro.models.gnn.dimenet import init_dimenet
        return lambda k: init_dimenet(k, cfg)
    if spec.name == "dlrm-mlperf":
        from repro.models.recsys.dlrm import init_dlrm
        return lambda k: init_dlrm(k, cfg)
    if spec.name == "bert4rec":
        from repro.models.recsys.bert4rec import init_bert4rec
        return lambda k: init_bert4rec(k, cfg)
    from repro.models.recsys.deepfm import init_deepfm
    return lambda k: init_deepfm(k, cfg)


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists whose leaves are tuples
    (axes) or anything else that is not a dict or a list."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _unstack(tree, n_layers, strip):
    """The JAX tree in the port's layout: every stacked ``layers`` dict
    as ``n_layers`` layer trees, each leaf through ``strip`` (its leading
    layer entry dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "layers" and isinstance(v, dict):
                layer = jax.tree.map(strip, v, is_leaf=_is_leaf)
                out[k] = [layer for _ in range(n_layers)]
            else:
                out[k] = _unstack(v, n_layers, strip)
        return out
    if isinstance(tree, list):
        return [_unstack(v, n_layers, strip) for v in tree]
    return tree


def _is_leaf(x):
    return isinstance(x, tuple) or isinstance(x, jax.ShapeDtypeStruct)


def _n_layers(spec):
    """Layers of an arch's transformer (0 for a model without one)."""
    cfg = spec.config
    bb = getattr(cfg, "backbone", None)
    bb = bb() if callable(bb) else bb
    return getattr(cfg, "n_layers", 0) or getattr(bb, "n_layers", 0)


def _drop_prettr_head(arch, tree):
    if arch == "prettr-bert":
        tree["backbone"].pop("lm_head", None)
    return tree


@pytest.fixture(scope="module")
def jax_axes():
    out = {}
    for arch in ALL_ARCHS:
        spec = jax_arch(arch)
        _, axes = jax_eval_params(_jax_init_fn(spec))
        out[arch] = _drop_prettr_head(arch, _unstack(
            axes, _n_layers(get_arch(arch)), lambda a: tuple(a[1:])))
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axes_tree_equals_jax_init_layer_by_layer(jax_axes, arch):
    want, got = _flat(jax_axes[arch]), _flat(_axes_of(get_arch(arch)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == tuple(want[k]), k


def _axes_of(spec):
    """The port's axes tree of ``spec``'s full config, from the init
    function ``param_init`` pairs it with (no params are made)."""
    _, axes = ST.eval_params(ST.param_init(spec))
    return axes


def test_decode_cache_and_opt_state_axes_match_jax():
    from repro.models.transformer import DECODE_CACHE_AXES
    from repro.optim.adam import opt_state_axes as jax_opt_state_axes

    assert TT.DECODE_CACHE_AXES == DECODE_CACHE_AXES
    p_axes = {"w": ("embed", "mlp"), "b": ("mlp",)}
    for keep in (True, False):
        want = jax_opt_state_axes(p_axes, JaxOptimizerConfig(
            keep_master=keep))
        got = opt_state_axes(p_axes, OptimizerConfig(keep_master=keep))
        assert got == want


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_state_specs_equal_jax(arch, mesh_key):
    """Params and AdamW state: every leaf's shape, dtype and partition
    spec under ``default_rules``."""
    sizes, names = MESHES[mesh_key]
    spec = get_arch(arch)
    want = jax_state_specs(_jax_init_fn(jax_arch(arch)),
                           JaxOptimizerConfig(),
                           JS.default_rules(JaxAbstractMesh(sizes, names)))
    n = _n_layers(spec)
    strip = lambda s: (tuple(s.shape[1:]), _dtype_name(s.dtype),
                       tuple(s.sharding.spec)[1:])
    want = {k: _unstack(v, n, strip) for k, v in want.items()}
    want["params"] = _drop_prettr_head(arch, want["params"])
    for key in ("m", "v", "master"):
        want["opt"][key] = _drop_prettr_head(arch, want["opt"][key])
    got = ST.state_specs(ST.param_init(spec), OptimizerConfig(),
                         default_rules(AbstractMesh(sizes, names)))
    w, g = _flat(want), _flat(got)
    assert sorted(g) == sorted(w)
    for k, s in w.items():
        if not isinstance(s, tuple):       # a leaf outside the layers
            s = (tuple(s.shape), _dtype_name(s.dtype),
                 tuple(s.sharding.spec))
        ours = g[k]
        assert (ours.shape, _dtype_name(ours.dtype), tuple(ours.spec)) \
            == (s[0], s[1], tuple(s[2]) + (None,) * (len(s[0])
                                                     - len(s[2]))), k
