"""Offline index builder (the paper's indexing phase), the port of
``repro.index.builder``: fixed-shape encode batches through the port's
:func:`~repro_torch.core.prettr.precompute_docs`, one append-only writer
per shard with one file per stream, and a v2 manifest (without a
checksum block; the JAX reader opens such manifests unverified).

``codec`` picks the storage codec (``fp16``, ``fp32`` or ``int8``; a
quantising codec encodes from float32 reps on the host).
``store_layer_kv=True`` also writes the join layer's doc-side K/V
(:func:`~repro_torch.core.prettr.precompute_doc_kv`) as the ``layer_k`` /
``layer_v`` streams, computed from the codec-round-tripped reps (the
bytes serving will read: an int8 build encodes on the host and decodes on
the device before the K/V pass), in the config's storage dtype or, with
``kv_codec``, encoded by that codec (int8 payload plus per-token scale
streams).  The writer thread, trained codecs and pruning wait for later
slices."""
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
    """Append-only stream files (``<stream>.bin``) of one shard directory
    plus its per-doc token counts."""

    def __init__(self, root: str, shard_id: int, stream_names):
        self.dir_name = f"shard-{shard_id:05d}"
        self.path = os.path.join(root, self.dir_name)
        os.makedirs(self.path, exist_ok=True)
        self._handles = {}
        try:
            for name in stream_names:
                self._handles[name] = open(
                    os.path.join(self.path, f"{name}.bin"), "wb")
        except OSError:
            self.close()
            raise
        self.lengths: list[int] = []

    def append(self, parts: dict, n_tokens: int):
        for name, fh in self._handles.items():
            fh.write(np.ascontiguousarray(parts[name]).tobytes())
        self.lengths.append(int(n_tokens))

    def close(self):
        for fh in self._handles.values():
            if fh.closed:
                continue
            fh.flush()
            os.fsync(fh.fileno())
            fh.close()

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
                 batch_size: int = 64, store_layer_kv: bool = False,
                 kv_codec: str | None = None, device=None):
        self.device = resolve_device(device)
        self.codec = get_codec(codec)
        self.store_layer_kv = bool(store_layer_kv)
        self.kv_codec = get_codec(kv_codec) if kv_codec is not None else None
        if self.kv_codec is not None and not self.store_layer_kv:
            raise ValueError("kv_codec requires store_layer_kv=True")
        # K/V stream dtype: the codec's encode dtype with a kv_codec (its
        # payload dtype goes to the manifest), else the model's storage
        # dtype
        if self.kv_codec is not None:
            self._kv_dtype = np.dtype(self.kv_codec.encode_dtype)
            self._kv_payload_dtype = self.kv_codec.stream_group(
                "layer_k", 1)["layer_k"][0]
        else:
            self._kv_dtype = torch.empty(0, dtype=cfg.store_dtype).numpy() \
                .dtype
            self._kv_payload_dtype = self._kv_dtype
        # float codecs store the model's own storage dtype; quantising
        # codecs encode from float32
        store_dtype = {np.dtype(np.float16): torch.float16,
                       np.dtype(np.float32): torch.float32}.get(
            np.dtype(self.codec.encode_dtype), torch.float32)
        self.cfg = dataclasses.replace(cfg, store_dtype=store_dtype)
        self.params = to_device(params, self.device)
        self.out_dir = out_dir
        self.n_shards = max(1, int(n_shards))
        self.batch_size = max(1, int(batch_size))
        self.rep_dim = cfg.compress_dim or cfg.backbone.d_model
        self.kv_dim = cfg.backbone.n_kv_heads * cfg.backbone.dh

    def _stream_names(self) -> list[str]:
        names = list(self.codec.streams(self.rep_dim))
        if self.kv_codec is not None:
            names += [*self.kv_codec.stream_group("layer_k", self.kv_dim),
                      *self.kv_codec.stream_group("layer_v", self.kv_dim)]
        elif self.store_layer_kv:
            names += ["layer_k", "layer_v"]
        return names

    def _encode(self, tokens: np.ndarray, valid: np.ndarray):
        """One fixed-shape batch (padded with empty rows) -> device reps
        and, with ``store_layer_kv``, the device ``(k, v)`` pair."""
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
            kv = self._batch_kv(reps) if self.store_layer_kv else None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return reps, kv

    def _batch_kv(self, reps):
        """Layer-l K/V of one batch from the codec-round-tripped reps: a
        quantising codec encodes on the host, then decodes on the device
        (what the query-time join reads)."""
        if not self.codec.decode_is_identity:
            parts = self.codec.encode(reps.cpu().numpy())
            reps = self.codec.decode({k: torch.from_numpy(v).to(self.device)
                                      for k, v in parts.items()})
        return P.precompute_doc_kv(self.params, self.cfg, reps)

    def build(self, docs: Sequence[np.ndarray]) -> BuildReport:
        t_wall = time.perf_counter()
        n_docs = len(docs)
        writers = []
        try:
            for s in range(self.n_shards):
                writers.append(_ShardWriter(self.out_dir, s,
                                            self._stream_names()))
        except OSError:
            for w in writers:
                w.close()
            raise
        boundaries = np.asarray([lo for lo, _ in
                                 shard_ranges(n_docs, self.n_shards)])
        encode_s = write_s = 0.0
        try:
            for lo in range(0, n_docs, self.batch_size):
                tokens, lengths, valid = pack_doc_batch(
                    docs[lo: lo + self.batch_size], self.cfg.max_doc_len)
                t0 = time.perf_counter()
                reps_dev, kv_dev = self._encode(tokens, valid)
                t1 = time.perf_counter()
                reps = reps_dev.cpu().numpy()
                kv = None if kv_dev is None else [
                    t.cpu().numpy().astype(self._kv_dtype) for t in kv_dev]
                for i, n in enumerate(lengths):
                    shard = int(np.searchsorted(boundaries, lo + i,
                                                side="right") - 1)
                    n = int(n)
                    parts = self.codec.encode(reps[i, :n])
                    if kv is not None:
                        for name, x in zip(("layer_k", "layer_v"), kv):
                            parts.update(
                                self.kv_codec.encode_group(name, x[i, :n])
                                if self.kv_codec is not None
                                else {name: x[i, :n]})
                    writers[shard].append(parts, n)
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
        if self.store_layer_kv:
            manifest["layer_kv"] = {"dtype": self._kv_payload_dtype.str,
                                    "d_kv": self.kv_dim}
            if self.kv_codec is not None:
                manifest["layer_kv"]["codec"] = self.kv_codec.name
        with open(os.path.join(self.out_dir, "manifest.msgpack"), "wb") as f:
            f.write(_msgpack.packb(manifest))
        n_tokens = sum(sum(w.lengths) for w in writers)
        on_disk = sum(os.path.getsize(os.path.join(w.path, f"{name}.bin"))
                      for w in writers for name in self._stream_names())
        return BuildReport(
            n_docs=n_docs, n_tokens=n_tokens, n_shards=self.n_shards,
            codec=self.codec.name, storage_bytes=on_disk,
            encode_s=encode_s, write_s=write_s,
            wall_s=time.perf_counter() - t_wall)
