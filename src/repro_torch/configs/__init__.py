"""Architecture registry of the port, the twin of ``repro.configs``: the
ten assigned architectures and the paper's own model.

``get_arch(name)`` -> :class:`ArchSpec` with the published full config, a
reduced smoke config of the same family and the architecture's shape-cell
table, for every name the JAX registry knows: ``prettr-bert``, the five
LMs, ``dimenet``, ``dlrm-mlperf``, ``deepfm``, ``xdeepfm`` and
``bert4rec``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

# ---------------------------------------------------------------------------
# Shape cells (assigned per family), as the JAX registry's
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k":    {"kind": "train",   "seq_len": 4096,   "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768,  "global_batch": 32},
    "decode_32k":  {"kind": "decode",  "seq_len": 32768,  "global_batch": 128},
    "long_500k":   {"kind": "decode",  "seq_len": 524288, "global_batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "graph_train", "n_nodes": 2708,
                      "n_edges": 10556, "d_feat": 1433},
    "minibatch_lg":  {"kind": "graph_sampled", "n_nodes": 232965,
                      "n_edges": 114615892, "batch_nodes": 1024,
                      "fanout": (15, 10)},
    "ogb_products":  {"kind": "graph_train", "n_nodes": 2449029,
                      "n_edges": 61859140, "d_feat": 100},
    "molecule":      {"kind": "graph_energy", "n_nodes": 30, "n_edges": 64,
                      "batch": 128},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "rec_train", "batch": 65536},
    "serve_p99":      {"kind": "rec_serve", "batch": 512},
    "serve_bulk":     {"kind": "rec_serve", "batch": 262144},
    "retrieval_cand": {"kind": "rec_retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                    # "prettr" | "lm" | "gnn" | "recsys"
    config: Any                    # full published config
    smoke: Any                     # reduced same-family config
    shapes: dict
    skip_shapes: tuple = ()        # cells the JAX package's dry-run skips
    notes: str = ""


_ARCH_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "chatglm3-6b": "chatglm3_6b",
    "gemma3-4b": "gemma3_4b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "dimenet": "dimenet",
    "dlrm-mlperf": "dlrm_mlperf",
    "deepfm": "deepfm",
    "xdeepfm": "xdeepfm",
    "bert4rec": "bert4rec",
    "prettr-bert": "prettr_bert",
}

ALL_ARCHS = tuple(_ARCH_MODULES)
ASSIGNED_ARCHS = tuple(a for a in ALL_ARCHS if a != "prettr-bert")


def get_arch(name: str) -> ArchSpec:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.spec()


def arch_cells(name: str) -> list[str]:
    """Shape cells this arch runs (skips removed)."""
    spec = get_arch(name)
    return [s for s in spec.shapes if s not in spec.skip_shapes]
