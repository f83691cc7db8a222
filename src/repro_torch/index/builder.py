"""Offline index builder (the paper's indexing phase), the port's minimal
copy of ``repro.index.builder``: fixed-shape encode batches through the
port's :func:`~repro_torch.core.prettr.precompute_docs`, one append-only
writer per shard, and a v2 manifest (without a checksum block; the JAX
reader opens such manifests unverified).  The writer thread, trained
codecs, pruning and stored layer-K/V streams wait for later slices."""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prettr as P
from repro_torch.device import resolve_device, to_device
from repro_torch.index import _msgpack
from repro_torch.index.codecs import get_codec
from repro_torch.index.store import FORMAT_VERSION

PAD, SEP = 0, 2          # token ids of repro.data.tokenizer


def pack_doc_batch(doc_token_lists, max_doc_len: int):
    """``d [SEP]`` (truncated, [SEP]-terminated) padded to ``max_doc_len``
    -> (tokens [N, Ld] int64, lengths [N] int64, valid [N, Ld] bool)."""
    n = len(doc_token_lists)
    tokens = np.full((n, max_doc_len), PAD, np.int64)
    lengths = np.zeros(n, np.int64)
    for i, d in enumerate(doc_token_lists):
        packed = np.concatenate([np.asarray(d)[: max_doc_len - 1], [SEP]])
        tokens[i, : len(packed)] = packed
        lengths[i] = len(packed)
    valid = np.arange(max_doc_len)[None] < lengths[:, None]
    return tokens, lengths, valid


def shard_ranges(n_docs: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [lo, hi) doc ranges, balanced like ``np.array_split``."""
    bounds = np.linspace(0, n_docs, n_shards + 1).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_shards)]


@dataclasses.dataclass
class BuildReport:
    n_docs: int
    n_tokens: int
    n_shards: int
    codec: str
    storage_bytes: int                 # bytes on disk
    encode_s: float                    # device encode, synchronised
    write_s: float                     # device->host copy + file writes
    wall_s: float


class _ShardWriter:
    """Append-only ``reps.bin`` of one shard directory plus its per-doc
    token counts."""

    def __init__(self, root: str, shard_id: int):
        self.dir_name = f"shard-{shard_id:05d}"
        self.path = os.path.join(root, self.dir_name)
        os.makedirs(self.path, exist_ok=True)
        self._fh = open(os.path.join(self.path, "reps.bin"), "wb")
        self.lengths: list[int] = []

    def append(self, reps: np.ndarray, n_tokens: int):
        self._fh.write(np.ascontiguousarray(reps).tobytes())
        self.lengths.append(int(n_tokens))

    def close(self):
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()

    def manifest_row(self) -> dict:
        return {"dir": self.dir_name, "n_docs": len(self.lengths),
                "lengths": self.lengths}


class IndexBuilder:
    """Encode raw documents and write a sharded v2 index::

        report = IndexBuilder(out_dir, cfg, params).build(doc_token_lists)
        index = TermRepIndex.open(out_dir)

    ``device`` (``None`` means the card) is where the encode runs; params
    are moved there once."""

    def __init__(self, out_dir: str, cfg: P.PreTTRConfig, params, *,
                 codec: str = "fp16", n_shards: int = 1,
                 batch_size: int = 64, device=None):
        self.device = resolve_device(device)
        self.codec = get_codec(codec)
        store_dtype = torch.float16 if self.codec.name == "fp16" \
            else torch.float32
        self.cfg = dataclasses.replace(cfg, store_dtype=store_dtype)
        self.params = to_device(params, self.device)
        self.out_dir = out_dir
        self.n_shards = max(1, int(n_shards))
        self.batch_size = max(1, int(batch_size))
        self.rep_dim = cfg.compress_dim or cfg.backbone.d_model

    def _encode(self, tokens: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """One fixed-shape batch (padded with empty rows) -> host reps."""
        pad = self.batch_size - len(tokens)
        if pad:
            tokens = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]),
                                                      tokens.dtype)])
            valid = np.concatenate([valid, np.zeros((pad, valid.shape[1]),
                                                    bool)])
        with torch.inference_mode():
            reps = P.precompute_docs(
                self.params, self.cfg,
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(valid).to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return reps

    def build(self, docs: Sequence[np.ndarray]) -> BuildReport:
        t_wall = time.perf_counter()
        n_docs = len(docs)
        writers = [_ShardWriter(self.out_dir, s)
                   for s in range(self.n_shards)]
        boundaries = np.asarray([lo for lo, _ in
                                 shard_ranges(n_docs, self.n_shards)])
        encode_s = write_s = 0.0
        try:
            for lo in range(0, n_docs, self.batch_size):
                tokens, lengths, valid = pack_doc_batch(
                    docs[lo: lo + self.batch_size], self.cfg.max_doc_len)
                t0 = time.perf_counter()
                reps_dev = self._encode(tokens, valid)
                t1 = time.perf_counter()
                reps = reps_dev.cpu().numpy()
                for i, n in enumerate(lengths):
                    shard = int(np.searchsorted(boundaries, lo + i,
                                                side="right") - 1)
                    parts = self.codec.encode(reps[i, : int(n)])
                    writers[shard].append(parts["reps"], int(n))
                encode_s += t1 - t0
                write_s += time.perf_counter() - t1
        finally:
            for w in writers:
                w.close()
        manifest = {"version": FORMAT_VERSION, "codec": self.codec.name,
                    "rep_dim": self.rep_dim, "l": self.cfg.l,
                    "compressed": bool(self.cfg.compress_dim),
                    "max_doc_len": self.cfg.max_doc_len, "n_docs": n_docs,
                    "encode_batch": self.batch_size,
                    "shards": [w.manifest_row() for w in writers]}
        with open(os.path.join(self.out_dir, "manifest.msgpack"), "wb") as f:
            f.write(_msgpack.packb(manifest))
        n_tokens = sum(sum(w.lengths) for w in writers)
        return BuildReport(
            n_docs=n_docs, n_tokens=n_tokens, n_shards=self.n_shards,
            codec=self.codec.name,
            storage_bytes=n_tokens * self.codec.bytes_per_token(self.rep_dim),
            encode_s=encode_s, write_s=write_s,
            wall_s=time.perf_counter() - t_wall)
