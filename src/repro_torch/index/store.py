"""Term-representation index reader, the port's copy of the v2 reader of
``repro.index.store`` (``manifest.msgpack`` + ``shard-NNNNN/`` stream
files, one flat file per codec stream, memmapped so serving touches only
the candidates' bytes).

Reads the fp32/fp16 codecs.  The manifest's ``checksum`` block is read
and kept but not verified yet; stored layer-``l`` K/V streams, when an
index has them, are not opened (the port's join recomputes them).
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
            shards = manifest["shards"]
        except (KeyError, TypeError, ValueError) as e:
            raise IndexFormatError(f"malformed manifest at {path!r}: "
                                   f"{e!r}") from e
        self.path = path
        self.checksum = manifest.get("checksum")   # read, not verified yet
        (dt, row_shape), = self.codec.streams(self.rep_dim).values()
        self._reps: list[np.ndarray] = []
        rows = []
        for si, sh in enumerate(shards):
            try:
                lengths = np.asarray(sh["lengths"], np.int64).reshape(-1)
                sdir = os.path.join(path, sh["dir"])
            except (KeyError, TypeError, ValueError) as e:
                raise IndexFormatError(f"malformed manifest at {path!r}: "
                                       f"shard {si}: {e!r}") from e
            self._reps.append(_open_stream(os.path.join(sdir, "reps.bin"),
                                           dt, row_shape,
                                           int(lengths.sum())))
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
        return len(self._reps)

    def gather_raw(self, doc_ids: Sequence[int], pad_to: int | None = None,
                   out=None):
        """Batched read of the stored reps: one fancy-index gather per
        shard over the memmaps -> (``{"reps": [N, Ld, e]}``, valid
        ``[N, Ld]`` bool).  ``out``: optional zeroed ``(reps, valid)``
        numpy arrays to gather into (e.g. views of pinned buffers)."""
        ids = np.asarray(list(doc_ids), np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self)):
            raise IndexError(f"doc id out of range [0, {len(self)})")
        pad_to = pad_to or self.max_doc_len
        (dt, row_shape), = self.codec.streams(self.rep_dim).values()
        if out is None:
            reps = np.zeros((ids.size, pad_to, *row_shape), dt)
            valid = np.zeros((ids.size, pad_to), bool)
        else:
            reps, valid = out
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
            reps[rows, cols] = self._reps[si][np.repeat(starts[rsel], rl)
                                              + cols]
            valid[rows, cols] = True
        return {"reps": reps}, valid

    def stage(self, doc_ids: Sequence[int], pad_to: int | None = None,
              device=None):
        """Gather on the host into pinned buffers and copy to ``device``
        (``None`` means the card) -> (reps [N, Ld, e], valid [N, Ld]).
        The copy is asynchronous on the current stream."""
        dev = resolve_device(device)
        n = len(doc_ids)
        pad_to = pad_to or self.max_doc_len
        (dt, row_shape), = self.codec.streams(self.rep_dim).values()
        pin = dev.type == "cuda"
        reps = torch.zeros((n, pad_to, *row_shape),
                           dtype=torch.from_numpy(np.zeros(0, dt)).dtype,
                           pin_memory=pin)
        valid = torch.zeros((n, pad_to), dtype=torch.bool, pin_memory=pin)
        self.gather_raw(doc_ids, pad_to, out=(reps.numpy(), valid.numpy()))
        return (reps.to(dev, non_blocking=True),
                valid.to(dev, non_blocking=True))
