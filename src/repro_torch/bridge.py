"""Weight bridge: the JAX package's PreTTR params pytree -> the port's
params.

The JAX tree comes in as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``); this module needs neither JAX nor
the JAX package.  Layer leaves are stacked on a leading ``[L]`` axis there
and become one dict per layer here; ``lm_head`` is unused by PreTTR and
skipped.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prettr import PreTTRConfig
from repro_torch.device import resolve_device


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(t, device):
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    return _tensor(t, device)


def params_from_jax(tree: dict, cfg: PreTTRConfig, device=None) -> dict:
    """JAX ``init_prettr`` params (numpy leaves) -> port params on
    ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    bb = tree["backbone"]
    stacked = bb["layers"]
    n = cfg.backbone.n_layers
    lead = {np.asarray(a).shape[0] for a in _leaves(stacked)}
    if lead != {n}:
        raise ValueError(f"stacked layer leaves have leading sizes {lead}, "
                         f"config has n_layers={n}")

    def layer(i):
        return _map(stacked, lambda a: _tensor(np.asarray(a)[i], dev))

    out = {"backbone": {"embed": _tree(bb["embed"], dev),
                        "layers": [layer(i) for i in range(n)],
                        "final_norm": _tree(bb["final_norm"], dev)},
           "score_head": _tensor(tree["score_head"], dev)}
    if cfg.compress_dim:
        out["compressor"] = _tree(tree["compressor"], dev)
    return out


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


def _map(t, fn):
    if isinstance(t, dict):
        return {k: _map(v, fn) for k, v in t.items()}
    return fn(t)
