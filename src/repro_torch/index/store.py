"""Term-representation index reader, the port's copy of the v2 reader of
``repro.index.store`` (``manifest.msgpack`` + ``shard-NNNNN/`` stream
files, one flat file per stream, memmapped so serving touches only the
candidates' bytes).

Streams: the codec's (``reps``, plus ``scales`` for int8) and, for an
index built with stored layer-``l`` K/V, the manifest's ``layer_kv``
group: raw ``layer_k`` / ``layer_v`` rows of ``d_kv`` values in the
recorded dtype, or, with ``layer_kv["codec"]``, that codec's payload and
scale streams (``layer_k_scales`` / ``layer_v_scales`` for int8).

The manifest's ``checksum`` block is read and kept but not verified yet.
Indexes written by either package open in both.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index import _msgpack
from repro_torch.index.codecs import get_codec

FORMAT_VERSION = 2


class IndexFormatError(Exception):
    """The on-disk index is missing, unreadable, or a format this reader
    does not understand."""


def read_manifest(path: str) -> dict:
    manifest_p = os.path.join(path, "manifest.msgpack")
    if not os.path.exists(manifest_p):
        raise IndexFormatError(f"no manifest.msgpack at {path!r}: not a "
                               f"format-v{FORMAT_VERSION} term-rep index")
    try:
        with open(manifest_p, "rb") as f:
            mani = _msgpack.unpackb(f.read())
    except (ValueError, UnicodeDecodeError) as e:
        raise IndexFormatError(f"corrupt manifest at {manifest_p!r}: "
                               f"{e}") from e
    if not isinstance(mani, dict):
        raise IndexFormatError(f"corrupt manifest at {manifest_p!r}: "
                               f"expected a map")
    if mani.get("version") != FORMAT_VERSION:
        raise IndexFormatError(
            f"index at {path!r} has format version {mani.get('version')!r}; "
            f"this reader expects {FORMAT_VERSION}")
    return mani


def _open_stream(path: str, dtype: np.dtype, row_shape: tuple, n_rows: int):
    if n_rows == 0:                       # np.memmap rejects empty files
        return np.zeros((0, *row_shape), dtype)
    try:
        return np.memmap(path, dtype=dtype, mode="r",
                         shape=(n_rows, *row_shape))
    except (OSError, ValueError) as e:
        raise IndexFormatError(f"corrupt index stream {path!r}: expected "
                               f"{n_rows} rows of {dtype.str} x "
                               f"{row_shape}: {e}") from e


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, dt)).dtype


class TermRepIndex:
    """A v2 term-rep index opened for reading (:meth:`open`)."""

    def __init__(self, path: str, manifest: dict):
        try:
            if manifest.get("codec_state"):
                raise IndexFormatError(
                    f"index at {path!r} uses a trained codec; not ported")
            self.codec = get_codec(manifest["codec"])
            self.rep_dim = int(manifest["rep_dim"])
            self.l = int(manifest["l"])
            self.compressed = bool(manifest["compressed"])
            self.max_doc_len = int(manifest["max_doc_len"])
            layer_kv = manifest.get("layer_kv") or None
            if layer_kv is not None:
                norm = {"dtype": np.dtype(layer_kv["dtype"]).str,
                        "d_kv": int(layer_kv["d_kv"])}
                if layer_kv.get("codec"):
                    norm["codec"] = str(layer_kv["codec"])
                layer_kv = norm
            self.layer_kv = layer_kv
            shards = manifest["shards"]
        except (KeyError, TypeError, ValueError) as e:
            raise IndexFormatError(f"malformed manifest at {path!r}: "
                                   f"{e!r}") from e
        self.path = path
        self.checksum = manifest.get("checksum")   # read, not verified yet
        spec = self.streams_spec()
        self._streams: list[dict[str, np.ndarray]] = []
        # per shard, stream name -> file (the fault injector's corrupt
        # kind flips bytes there)
        self._stream_paths: list[dict[str, str]] = []
        rows = []
        for si, sh in enumerate(shards):
            try:
                lengths = np.asarray(sh["lengths"], np.int64).reshape(-1)
                sdir = os.path.join(path, sh["dir"])
            except (KeyError, TypeError, ValueError) as e:
                raise IndexFormatError(f"malformed manifest at {path!r}: "
                                       f"shard {si}: {e!r}") from e
            n_tok = int(lengths.sum())
            opened, paths = {}, {}
            for name, (dt, row_shape) in spec.items():
                fp = paths[name] = os.path.join(sdir, f"{name}.bin")
                if n_tok and not os.path.exists(fp):
                    raise IndexFormatError(
                        f"index at {path!r}: shard stream {fp!r} is "
                        f"missing (manifest lists {n_tok} tokens for this "
                        f"shard)")
                opened[name] = _open_stream(fp, dt, row_shape, n_tok)
            self._streams.append(opened)
            self._stream_paths.append(paths)
            starts = np.cumsum(lengths) - lengths
            rows.append(np.stack([np.full(len(lengths), si), starts,
                                  lengths], axis=1).astype(np.int64))
        self._doc_table = (np.concatenate(rows) if rows
                           else np.zeros((0, 3), np.int64))
        if len(self._doc_table) != manifest.get("n_docs",
                                                len(self._doc_table)):
            raise IndexFormatError(
                f"index at {path!r}: manifest n_docs={manifest['n_docs']} "
                f"but shards list {len(self._doc_table)} documents")

    @classmethod
    def open(cls, path: str) -> "TermRepIndex":
        return cls(path, read_manifest(path))

    def __len__(self) -> int:
        return len(self._doc_table)

    @property
    def doc_lengths(self) -> np.ndarray:
        """Per-doc stored token counts ([N] int64)."""
        return self._doc_table[:, 2]

    @property
    def n_shards(self) -> int:
        return len(self._streams)

    # -- stream layout ---------------------------------------------------------
    @property
    def has_layer_kv(self) -> bool:
        """True when the index stores layer-``l`` doc K/V streams."""
        return self.layer_kv is not None

    @property
    def kv_dim(self) -> int:
        """Per-token width of each stored K/V stream (0 when absent)."""
        return int(self.layer_kv["d_kv"]) if self.layer_kv else 0

    @property
    def kv_codec(self):
        """Codec of the K/V streams, or None for raw-dtype (or absent)
        K/V streams."""
        if self.layer_kv and self.layer_kv.get("codec"):
            return get_codec(self.layer_kv["codec"])
        return None

    def kv_streams_spec(self) -> dict:
        """Streams of the layer-``l`` K/V pair only (empty without it)."""
        if not self.layer_kv:
            return {}
        d_kv = self.kv_dim
        kvc = self.kv_codec
        if kvc is not None:
            return {**kvc.stream_group("layer_k", d_kv),
                    **kvc.stream_group("layer_v", d_kv)}
        dt = np.dtype(self.layer_kv["dtype"])
        return {"layer_k": (dt, (d_kv,)), "layer_v": (dt, (d_kv,))}

    def streams_spec(self) -> dict:
        """Every per-token stream -> ``{name: (dtype, row_shape)}``."""
        return {**self.codec.streams(self.rep_dim), **self.kv_streams_spec()}

    def bytes_per_token(self) -> int:
        """Stored bytes per token over all streams (paper section 6.2)."""
        return sum(dt.itemsize * int(np.prod(shape, dtype=np.int64))
                   for dt, shape in self.streams_spec().values())

    def _spec(self, streams):
        spec = self.streams_spec()
        if streams is None:
            return spec
        unknown = set(streams) - set(spec)
        if unknown:
            raise ValueError(f"unknown stream(s) {sorted(unknown)}; index "
                             f"has {sorted(spec)}")
        return {name: spec[name] for name in streams}

    # -- reads -----------------------------------------------------------------
    def gather_raw(self, doc_ids: Sequence[int], pad_to: int | None = None,
                   streams: Sequence[str] | None = None, out=None):
        """Batched read of the stored streams: one fancy-index gather per
        (shard, stream) over the memmaps -> (``{stream: [N, Ld, ...]}``,
        valid ``[N, Ld]`` bool).  ``streams`` restricts the read to a
        subset of :meth:`streams_spec`.  ``out``: optional zeroed
        ``(parts, valid)`` numpy arrays to gather into (for example views
        of pinned buffers)."""
        ids = np.asarray(list(doc_ids), np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self)):
            raise IndexError(f"doc id out of range [0, {len(self)})")
        pad_to = pad_to or self.max_doc_len or (
            int(self._doc_table[ids, 2].max()) if ids.size else 1)
        spec = self._spec(streams)
        if out is None:
            parts = {name: np.zeros((ids.size, pad_to, *row_shape), dt)
                     for name, (dt, row_shape) in spec.items()}
            valid = np.zeros((ids.size, pad_to), bool)
        else:
            parts, valid = out
        shard_of = self._doc_table[ids, 0]
        starts = self._doc_table[ids, 1]
        lens = np.minimum(self._doc_table[ids, 2], pad_to)
        for si in np.unique(shard_of):
            rsel = np.flatnonzero(shard_of == si)
            rl = lens[rsel]
            total = int(rl.sum())
            if total == 0:
                continue
            rows = np.repeat(rsel, rl)
            cols = np.arange(total) - np.repeat(np.cumsum(rl) - rl, rl)
            src = np.repeat(starts[rsel], rl) + cols
            for name in spec:
                parts[name][rows, cols] = self._streams[si][name][src]
            valid[rows, cols] = True
        return parts, valid

    def stage(self, doc_ids: Sequence[int], pad_to: int | None = None,
              streams: Sequence[str] | None = None, device=None):
        """Gather on the host into pinned buffers and copy to ``device``
        (``None`` means the card) -> (``{stream: [N, Ld, ...]}``, valid
        ``[N, Ld]``).  The copies are asynchronous on the current
        stream."""
        dev = resolve_device(device)
        n = len(doc_ids)
        pad_to = pad_to or self.max_doc_len
        spec = self._spec(streams)
        pin = dev.type == "cuda"
        host = {name: torch.zeros((n, pad_to, *row_shape),
                                  dtype=torch_dtype(dt), pin_memory=pin)
                for name, (dt, row_shape) in spec.items()}
        valid = torch.zeros((n, pad_to), dtype=torch.bool, pin_memory=pin)
        self.gather_raw(doc_ids, pad_to, streams=list(spec),
                        out=({k: t.numpy() for k, t in host.items()},
                             valid.numpy()))
        return ({k: t.to(dev, non_blocking=True) for k, t in host.items()},
                valid.to(dev, non_blocking=True))
