"""Weight bridge: the JAX package's params pytrees (PreTTR's, the
transformer LM's, BERT4Rec's, the recsys models' and DimeNet's) -> the
port's params.

The JAX tree comes in as nested dicts and lists of numpy arrays (for example
``jax.tree.map(np.asarray, params)``, or :func:`read_jax_checkpoint` of a
checkpoint the JAX store wrote); this module needs neither JAX nor the
JAX package.  Layer leaves are stacked on a leading ``[L]`` axis there
and become one dict per layer here; PreTTR's ``lm_head`` is unused and
skipped.  :func:`train_state_from_jax` bridges a whole ``{"params",
"opt"}`` train state, moments and master included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core.prettr import PreTTRConfig
from repro_torch.device import resolve_device
from repro_torch.models.gnn.dimenet import (DimeNetConfig, map_shapes,
                                           param_shapes)
from repro_torch.models.recsys.bert4rec import Bert4RecConfig
from repro_torch.models.recsys.deepfm import DeepFMConfig
from repro_torch.models.recsys.dlrm import DLRMConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.tree import leaves, leaves_with_paths, tree_map


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(t, device):
    """Nested dicts and lists of arrays -> the same structure of tensors
    (a tuple becomes a list)."""
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree(v, device) for v in t]
    return _tensor(t, device)


def params_from_jax(tree: dict, cfg: PreTTRConfig, device=None) -> dict:
    """JAX ``init_prettr`` params (numpy leaves) -> port params on
    ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    bb = tree["backbone"]
    out = {"backbone": {"embed": _tree(bb["embed"], dev),
                        "layers": _unstack_layers(
                            bb["layers"], cfg.backbone.n_layers, dev),
                        "final_norm": _tree(bb["final_norm"], dev)},
           "score_head": _tensor(tree["score_head"], dev)}
    if cfg.compress_dim:
        out["compressor"] = _tree(tree["compressor"], dev)
    return out


def lm_params_from_jax(tree: dict, cfg: TransformerConfig,
                       device=None) -> dict:
    """JAX ``transformer.init_params`` params (numpy leaves) -> the port's
    ``transformer`` params on ``device`` (``None`` means the card): layer
    leaves unstacked into a list; ``lm_head`` kept when the head is not
    tied."""
    dev = resolve_device(device)
    out = {"embed": _tree(tree["embed"], dev),
           "layers": _unstack_layers(tree["layers"], cfg.n_layers, dev),
           "final_norm": _tree(tree["final_norm"], dev)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    return out


def bert4rec_params_from_jax(tree: dict, cfg, device=None) -> dict:
    """JAX ``init_bert4rec`` params (numpy leaves) -> the port's on
    ``device`` (``None`` means the card): its backbone's transformer
    params (tied head, so no ``lm_head``)."""
    return lm_params_from_jax(tree, cfg.backbone(), device)


def recsys_params_from_jax(tree: dict, cfg, device=None,
                           table_dtype=None) -> dict:
    """JAX ``init_dlrm`` / ``init_deepfm`` params (numpy leaves) -> the
    port's on ``device`` (``None`` means the card): ``table``, ``w1``,
    ``b0`` and ``cin_out`` as tensors, the ``bot`` / ``top`` / ``dnn`` /
    ``cin`` layer lists as lists of dicts.  ``table_dtype`` converts the
    embedding table (say to bf16, so a full DLRM table fits the card)."""
    dev = resolve_device(device)
    if isinstance(cfg, DLRMConfig):
        keys = {"table", "bot", "top"}
    elif isinstance(cfg, DeepFMConfig):
        keys = {"table", "w1", "b0", "dnn"}
        if cfg.interaction == "cin":
            keys |= {"cin", "cin_out"}
    else:
        raise TypeError(f"not a recsys config: {type(cfg).__name__}")
    if set(tree) != keys:
        raise ValueError(f"params keys {sorted(tree)} do not match "
                         f"{cfg.name}'s {sorted(keys)}")
    out = {k: [_tree(lyr, dev) for lyr in v] if isinstance(v, (list, tuple))
           else _tensor(v, dev) for k, v in tree.items()}
    if out["table"].shape[1] != cfg.embed_dim:
        raise ValueError(f"table width {out['table'].shape[1]} is not "
                         f"embed_dim={cfg.embed_dim}")
    if table_dtype is not None:
        out["table"] = out["table"].to(table_dtype)
    return out


def dimenet_params_from_jax(tree: dict, cfg: DimeNetConfig,
                            device=None) -> dict:
    """JAX ``init_dimenet`` params (numpy leaves; ``msg_init``, ``blocks``,
    ``head`` and each block's ``update`` are lists) -> the port's on
    ``device`` (``None`` means the card).  A tree whose structure, block
    count or leaf shapes differ from ``cfg``'s raises, naming the
    leaf."""
    dev = resolve_device(device)
    n_blocks = len(tree.get("blocks", ()))
    if n_blocks != cfg.n_blocks:
        raise ValueError(f"params hold {n_blocks} blocks, {cfg.name} has "
                         f"n_blocks={cfg.n_blocks}")
    want = {}
    map_shapes(want.setdefault, param_shapes(cfg))
    got = {k: np.shape(a) for k, a in leaves_with_paths(tree)}
    for key in sorted(set(want) | set(got)):
        if got.get(key) != want.get(key):
            raise ValueError(f"params leaf {key!r}: shape {got.get(key)}, "
                             f"{cfg.name} wants {want.get(key)}")
    return _tree(tree, dev)


def read_jax_checkpoint(ckpt_dir: str):
    """The newest valid step of a checkpoint the JAX store wrote (or the
    port's, in the same format) as nested dicts of numpy arrays, the
    keys split on "/"; walks back past corrupt or torn steps as
    ``restore_checkpoint`` does.  A bf16 leaf comes back widened to
    float32 (exact).  Returns ``(tree, step)``, or ``(None, None)`` when
    no step is readable."""
    def load(step):
        manifest = store.read_manifest(ckpt_dir, step)
        tree = {}
        for meta in manifest["leaves"]:
            arr = store.leaf_array(store.read_leaf(ckpt_dir, step, meta),
                                   meta)
            if meta["dtype"] in (store.BF16_STR, "|V2"):
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            *path, last = meta["key"].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[last] = arr
        return tree, manifest["step"]

    return store.load_newest(ckpt_dir, load) or (None, None)


def train_state_from_jax(tree: dict, cfg, device=None) -> dict:
    """A JAX ``{"params", "opt"}`` train state (numpy leaves, as
    :func:`read_jax_checkpoint` gives it) -> the port's, on ``device``
    (``None`` means the card): ``params`` and the optimizer's ``m``,
    ``v`` and ``master`` trees bridged as params are (layers unstacked,
    PreTTR's ``lm_head`` dropped), ``step`` an int32 scalar.  ``cfg`` is a
    PreTTRConfig, a TransformerConfig or a recsys config (DLRM, DeepFM,
    BERT4Rec)."""
    dev = resolve_device(device)
    if isinstance(cfg, PreTTRConfig):
        bridge = params_from_jax
    elif isinstance(cfg, (DLRMConfig, DeepFMConfig)):
        bridge = recsys_params_from_jax
    elif isinstance(cfg, Bert4RecConfig):
        bridge = bert4rec_params_from_jax
    else:
        bridge = lm_params_from_jax
    opt = tree["opt"]
    out = {"step": torch.as_tensor(np.asarray(opt["step"]),
                                   dtype=torch.int32).to(dev)}
    for k in ("m", "v", "master"):
        if k in opt:
            out[k] = bridge(opt[k], cfg, dev)
    return {"params": bridge(tree["params"], cfg, dev), "opt": out}


def _unstack_layers(stacked: dict, n: int, device) -> list[dict]:
    """Leaves stacked on a leading ``[n]`` axis -> ``n`` layer dicts."""
    lead = {np.asarray(a).shape[0] for a in leaves(stacked)}
    if lead != {n}:
        raise ValueError(f"stacked layer leaves have leading sizes {lead}, "
                         f"config has n_layers={n}")
    return [tree_map(lambda a: _tensor(np.asarray(a)[i], device), stacked)
            for i in range(n)]
