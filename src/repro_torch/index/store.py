"""Term-representation index reader, the port of ``repro.index.store``.

Two on-disk formats, one reader:

* **v2** -- ``manifest.msgpack`` + ``shard-NNNNN/`` stream files, one flat
  file per stream, memmapped so serving touches only the candidates'
  bytes.  Streams: the codec's (``reps``, plus ``scales`` for int8; uint8
  codes for pq) and, for an index built with stored layer-``l`` K/V, the
  manifest's ``layer_kv`` group: raw ``layer_k`` / ``layer_v`` rows of
  ``d_kv`` values in the recorded dtype, or, with ``layer_kv["codec"]``,
  that codec's payload and scale streams.
* **v1** (legacy) -- ``meta.msgpack`` + one ``reps.bin`` of contiguous raw
  float16 / float32 blocks, one a doc; it opens as a one-shard index with
  the matching float codec.

A trained codec's state (``codec_state``: the pq codebooks) is loaded
into the codec before the stream spec is read.  A pruned index records
its policy (``prune``, :attr:`TermRepIndex.prune_policy`) and each
shard's token counts before pruning (``orig_lengths``,
:attr:`TermRepIndex.orig_doc_lengths`); its ``max_doc_len`` is the
pruned cap.

The manifest's optional ``checksum`` block (``{"algo": "crc32c",
"chunk_bytes"}`` plus per-shard ``checksums``: one CRC-32C per chunk of
each stream file) is verified as the JAX reader does it: :meth:`open`
runs the full-file pass by default and ``verify_reads=True`` re-checks
the chunks each read touches (``repro_torch.index.integrity``).  A
manifest without the block (v1, or a build with
``checksum_chunk_bytes=0``) opens unverified.  Indexes written by either
package open in both.

For sharded serving, :meth:`TermRepIndex.serving_assignment` maps each
doc to a serving shard along the physical shard files and
:meth:`TermRepIndex.shard_view` gives one shard's
:class:`ShardIndexView`, which refuses ids it does not own.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index import _msgpack
from repro_torch.index.codecs import codec_for_v1_dtype, get_codec
from repro_torch.index.integrity import chunk_checksums, crc32c

FORMAT_VERSION = 2


class IndexFormatError(Exception):
    """The on-disk index is missing, unreadable, or a format this reader
    does not understand."""


class IndexIntegrityError(IndexFormatError):
    """Stored stream bytes fail their manifest CRC-32C chunk checksums:
    the index was corrupted after build time.  Raised by
    :meth:`TermRepIndex.open` (full-file pass) or, with
    ``verify_reads=True``, by the read that touched the bad chunk."""


def _read_msgpack(path: str, kind: str) -> dict:
    try:
        with open(path, "rb") as f:
            obj = _msgpack.unpackb(f.read())
    except (ValueError, UnicodeDecodeError) as e:
        raise IndexFormatError(f"corrupt {kind} at {path!r}: {e}") from e
    if not isinstance(obj, dict):
        raise IndexFormatError(f"corrupt {kind} at {path!r}: expected a map")
    return obj


def read_manifest(path: str) -> dict:
    """The v2 manifest of the index at ``path``."""
    manifest_p = os.path.join(path, "manifest.msgpack")
    if not os.path.exists(manifest_p):
        raise IndexFormatError(f"no manifest.msgpack at {path!r}: not a "
                               f"format-v{FORMAT_VERSION} term-rep index")
    mani = _read_msgpack(manifest_p, "manifest")
    if mani.get("version") != FORMAT_VERSION:
        raise IndexFormatError(
            f"index at {path!r} has format version {mani.get('version')!r}; "
            f"this reader expects {FORMAT_VERSION}")
    return mani


def _v1_manifest(path: str) -> dict:
    """A legacy v1 index's ``meta.msgpack`` as a one-shard v2 manifest
    whose shard directory is the index directory itself."""
    meta_p = os.path.join(path, "meta.msgpack")
    if not os.path.exists(meta_p):
        raise IndexFormatError(
            f"no manifest.msgpack or meta.msgpack at {path!r}: not a "
            f"term-rep index (format v{FORMAT_VERSION} or legacy v1)")
    meta = _read_msgpack(meta_p, "v1 meta.msgpack")
    try:
        offsets = [(int(off), int(n)) for off, n in meta["offsets"]]
        if any(off != sum(n for _, n in offsets[:i])
               for i, (off, _) in enumerate(offsets)):
            raise ValueError("v1 offsets are not contiguous")
        return {"version": 1,
                "codec": codec_for_v1_dtype(meta["dtype"]).name,
                "rep_dim": int(meta["rep_dim"]), "l": int(meta["l"]),
                "compressed": bool(meta["compressed"]),
                "max_doc_len": int(meta["max_doc_len"]),
                "n_docs": len(offsets),
                "shards": [{"dir": ".", "lengths": [n for _, n in offsets]}]}
    except (KeyError, TypeError, ValueError) as e:
        raise IndexFormatError(f"malformed v1 meta.msgpack at {meta_p!r}: "
                               f"{e!r}") from e


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
            self.version = int(manifest["version"])
            self.codec = get_codec(manifest["codec"])
            if manifest.get("codec_state"):
                self.codec.load_state_dict(manifest["codec_state"])
            self.rep_dim = int(manifest["rep_dim"])
            self.l = int(manifest["l"])
            self.compressed = bool(manifest["compressed"])
            self.max_doc_len = int(manifest["max_doc_len"])
            self.encode_batch = int(manifest.get("encode_batch", 0))
            prune = manifest.get("prune") or None
            if prune is not None:
                prune = {"keep_frac": float(prune["keep_frac"]),
                         "max_kept_tokens": int(prune["max_kept_tokens"]),
                         "layer": int(prune["layer"])}
            # the token-pruning policy (None when every token is stored)
            self.prune_policy = prune
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
        cksum = manifest.get("checksum") or None
        if cksum is not None and str(cksum.get("algo", "crc32c")) != "crc32c":
            raise IndexFormatError(
                f"index at {path!r} uses checksum algo "
                f"{cksum.get('algo')!r}; this reader knows crc32c")
        # per shard, stream name -> chunk CRCs; None when the manifest
        # records none (then nothing is verified)
        self._checksums: list[dict[str, list[int]]] | None = None
        self.checksum_chunk_bytes = 0
        self.verify_reads = False
        checksums = []
        spec = self.streams_spec()
        self._streams: list[dict[str, np.ndarray]] = []
        # per shard, stream name -> file (the fault injector's corrupt
        # kind flips bytes there)
        self._stream_paths: list[dict[str, str]] = []
        rows, orig_rows = [], []
        for si, sh in enumerate(shards):
            try:
                lengths = np.asarray(sh["lengths"], np.int64).reshape(-1)
                orig = np.asarray(sh.get("orig_lengths", sh["lengths"]),
                                  np.int64).reshape(-1)
                if len(orig) != len(lengths):
                    raise ValueError(
                        f"orig_lengths lists {len(orig)} docs but lengths "
                        f"lists {len(lengths)}")
                sdir = os.path.join(path, sh["dir"])
            except (KeyError, TypeError, ValueError) as e:
                raise IndexFormatError(f"malformed manifest at {path!r}: "
                                       f"shard {si}: {e!r}") from e
            orig_rows.append(orig)
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
            sh_ck = sh.get("checksums")
            if sh_ck is not None:
                checksums.append({str(k): [int(c) for c in v]
                                  for k, v in sh_ck.items()})
            starts = np.cumsum(lengths) - lengths
            rows.append(np.stack([np.full(len(lengths), si), starts,
                                  lengths], axis=1).astype(np.int64))
        self._doc_table = (np.concatenate(rows) if rows
                           else np.zeros((0, 3), np.int64))
        self._orig_lengths = (np.concatenate(orig_rows) if orig_rows
                              else np.zeros((0,), np.int64))
        if len(self._doc_table) != manifest.get("n_docs",
                                                len(self._doc_table)):
            raise IndexFormatError(
                f"index at {path!r}: manifest n_docs={manifest['n_docs']} "
                f"but shards list {len(self._doc_table)} documents")
        if cksum is not None and len(checksums) == len(shards):
            self.checksum_chunk_bytes = int(cksum.get("chunk_bytes", 1 << 16))
            self._checksums = checksums

    @classmethod
    def open(cls, path: str, *, verify: bool = True,
             verify_reads: bool = False) -> "TermRepIndex":
        """Open the v2 or v1 index at ``path``.  ``verify`` (default on)
        runs the full-file CRC-32C pass over every stream whose manifest
        records chunk checksums and raises :class:`IndexIntegrityError` on a
        mismatch; a manifest without checksums opens unverified.
        ``verify_reads=True`` re-checks the chunks each :meth:`gather_raw`
        (and so :meth:`stage`) touches; it raises ValueError on a
        manifest without checksums."""
        v2 = os.path.exists(os.path.join(path, "manifest.msgpack"))
        idx = cls(path, read_manifest(path) if v2 else _v1_manifest(path))
        if verify and idx._checksums is not None:
            idx.verify_integrity()
        if verify_reads:
            if idx._checksums is None:
                raise ValueError(
                    f"verify_reads=True but the index at {path!r} records "
                    f"no chunk checksums; build it with a checksumming "
                    f"builder to add them")
            idx.verify_reads = True
        return idx

    # -- integrity -----------------------------------------------------------
    def verify_integrity(self) -> int:
        """Recompute every stream chunk's CRC-32C against the manifest and
        raise :class:`IndexIntegrityError` on the first mismatch, naming
        the shard's stream file and the chunk.  Returns the number of
        chunks checked (0 for a manifest without checksums)."""
        if self._checksums is None:
            return 0
        cb = self.checksum_chunk_bytes
        checked = 0
        for si, per_stream in enumerate(self._checksums):
            for name, want in per_stream.items():
                arr = self._streams[si].get(name)
                arr8 = (np.asarray(arr).reshape(-1).view(np.uint8)
                        if arr is not None and arr.size
                        else np.zeros((0,), np.uint8))
                got = chunk_checksums(arr8, cb)
                fp = self._stream_paths[si].get(name, f"shard{si}/{name}")
                if len(got) != len(want):
                    raise IndexIntegrityError(
                        f"{fp}: stream has {len(got)} chunks but manifest "
                        f"lists {len(want)}: file truncated or extended "
                        f"after build")
                for ci, (w, g) in enumerate(zip(want, got)):
                    if int(w) != int(g):
                        raise IndexIntegrityError(
                            f"{fp}: chunk {ci} CRC-32C mismatch (manifest "
                            f"{int(w):#010x}, stored bytes {int(g):#010x}): "
                            f"stream bytes corrupted after build")
                checked += len(got)
        return checked

    def _verify_gather(self, si: int, starts: np.ndarray, lens: np.ndarray,
                       stream_names) -> None:
        """Re-check the CRC of every chunk that a read of rows
        ``[starts, starts + lens)`` from shard ``si`` touches."""
        per_stream = self._checksums[si]
        cb = self.checksum_chunk_bytes
        spec = self.streams_spec()
        for name in stream_names:
            want = per_stream.get(name)
            if want is None:
                continue
            dt, row_shape = spec[name]
            rowbytes = dt.itemsize * int(np.prod(row_shape, dtype=np.int64))
            lo = starts * rowbytes
            hi = (starts + lens) * rowbytes
            touched = np.unique(np.concatenate(
                [np.arange(a // cb, (b - 1) // cb + 1)
                 for a, b in zip(lo, hi) if b > a] or
                [np.zeros((0,), np.int64)]))
            arr8 = np.asarray(self._streams[si][name]).reshape(-1) \
                .view(np.uint8)
            fp = self._stream_paths[si].get(name, f"shard{si}/{name}")
            for ci in touched:
                ci = int(ci)
                if ci >= len(want):
                    raise IndexIntegrityError(
                        f"{fp}: read touches chunk {ci} but manifest lists "
                        f"only {len(want)} chunks")
                got = crc32c(arr8[ci * cb:(ci + 1) * cb])
                if got != int(want[ci]):
                    raise IndexIntegrityError(
                        f"{fp}: chunk {ci} CRC-32C mismatch on read "
                        f"(manifest {int(want[ci]):#010x}, stored bytes "
                        f"{got:#010x}): stream bytes corrupted after build")

    def __len__(self) -> int:
        return len(self._doc_table)

    @property
    def doc_lengths(self) -> np.ndarray:
        """Per-doc stored token counts ([N] int64)."""
        return self._doc_table[:, 2]

    @property
    def orig_doc_lengths(self) -> np.ndarray:
        """Per-doc token counts before index-time pruning ([N] int64);
        :attr:`doc_lengths` for an unpruned or v1 index."""
        return self._orig_lengths

    def storage_bytes(self) -> int:
        """Stored bytes over every stream (paper section 6.2)."""
        return int(self.doc_lengths.sum()) * self.bytes_per_token()

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
        of pinned buffers).  With ``verify_reads`` every chunk the read
        touches is re-checked first."""
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
            if self.verify_reads:
                self._verify_gather(int(si), starts[rsel], rl, spec)
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

    def gather(self, doc_ids: Sequence[int], pad_to: int | None = None):
        """Decoded float batch on the host -> (reps ``[N, Ld, e]``, valid
        ``[N, Ld]``): the stored bytes as they are for a float codec, the
        codec's decode for the others.  Reads the codec's streams only,
        never the layer-``l`` K/V pair."""
        parts, valid = self.gather_raw(
            doc_ids, pad_to=pad_to,
            streams=list(self.codec.streams(self.rep_dim)))
        return self.codec.decode(parts), valid

    def load_docs(self, doc_ids: Sequence[int], pad_to: int | None = None):
        """Alias of :meth:`gather` (the original per-doc API's name)."""
        return self.gather(doc_ids, pad_to=pad_to)

    # -- scale-out serving ---------------------------------------------------
    def serving_assignment(self, n_serving: int) -> np.ndarray:
        """Each doc id's serving shard (``[N]`` int64), aligned with the
        physical shard files so that a doc's bytes stay with the worker
        that stores them: with ``n_serving <= n_shards`` physical shard
        ``s`` goes whole to ``s % n_serving``; with more serving shards,
        each physical shard's docs are split contiguously among serving
        shards ``s, s + n_shards, ...``.  Deterministic, so the router and
        its workers compute it alike."""
        if n_serving < 1:
            raise ValueError(f"n_serving must be >= 1, got {n_serving}")
        phys = self._doc_table[:, 0]
        n_phys = max(1, self.n_shards)
        out = np.empty(len(phys), np.int64)
        if n_serving <= n_phys:
            out[:] = phys % n_serving
            return out
        for si in range(n_phys):
            sel = np.flatnonzero(phys == si)
            if sel.size == 0:
                continue
            targets = np.arange(si, n_serving, n_phys, dtype=np.int64)
            out[sel] = targets[(np.arange(sel.size) * targets.size)
                               // sel.size]
        return out

    def shard_view(self, assignment: np.ndarray,
                   shard_id: int) -> "ShardIndexView":
        """The ownership-checking view of the docs ``assignment`` (see
        :meth:`serving_assignment`) routes to ``shard_id``."""
        return ShardIndexView(self, assignment, shard_id)

    @staticmethod
    def projected_storage_bytes(n_docs: int, avg_tokens: float, rep_dim: int,
                                bytes_per_val: float,
                                keep_frac: float = 1.0) -> int:
        """The paper's section 6.2 projection (ClueWeb09-B: 112 TB raw ->
        2.8 TB at e = 128 fp16).  ``bytes_per_val`` may be fractional (pq's
        sub-byte codes) and ``keep_frac`` scales the tokens for index-time
        pruning."""
        return int(n_docs * avg_tokens * keep_frac * rep_dim * bytes_per_val)


class ShardIndexView:
    """One serving shard's window onto a :class:`TermRepIndex`.

    The view keeps the global doc-id space (``len(view) == len(base)``)
    but owns only the docs its ``assignment`` maps to ``shard_id``.  Every
    method that takes doc ids (:meth:`gather_raw`, :meth:`stage`,
    :meth:`gather`, :meth:`load_docs`) checks them first and raises
    IndexError on an out-of-range id or one another shard stores, naming
    that shard, instead of reading its bytes.  Everything else (codec,
    streams, ``rep_dim``, ``l``, K/V metadata, the doc table the fault
    injector reads) comes from the base index, so a view drops into
    ``BatchEngine``, ``DeviceDocCache`` and ``validate_index_compat``."""

    def __init__(self, base: TermRepIndex, assignment: np.ndarray,
                 shard_id: int):
        assignment = np.asarray(assignment, np.int64).reshape(-1)
        if len(assignment) != len(base):
            raise ValueError(
                f"assignment maps {len(assignment)} docs but the index "
                f"has {len(base)}")
        if not (0 <= shard_id < max(1, assignment.max(initial=0) + 1)):
            raise ValueError(
                f"shard_id {shard_id} outside the assignment's range "
                f"[0, {assignment.max(initial=0) + 1})")
        self.base = base
        self.assignment = assignment
        self.shard_id = int(shard_id)
        self._owned_mask = assignment == self.shard_id

    def __getattr__(self, name):
        # the id-independent surface; "base" itself never delegates (a
        # half-built or unpickled view would recurse)
        if name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)

    def __len__(self):
        return len(self.base)

    @property
    def n_owned(self) -> int:
        return int(self._owned_mask.sum())

    @property
    def owned_ids(self) -> np.ndarray:
        """Global ids of the docs this shard stores (``[n_owned]``)."""
        return np.flatnonzero(self._owned_mask)

    def owns(self, doc_ids) -> np.ndarray:
        """Per-id residency (``[n]`` bool); out-of-range ids are False."""
        ids = np.asarray(list(doc_ids), np.int64).reshape(-1)
        ok = (ids >= 0) & (ids < len(self.base))
        out = np.zeros(ids.size, bool)
        out[ok] = self._owned_mask[ids[ok]]
        return out

    def describe_misroute(self, doc_ids) -> str | None:
        """The first few in-range ids this shard does not store, with the
        shard that does (None when it stores them all); the hook
        ``validate_doc_routing`` reads at admission."""
        ids = np.asarray(list(doc_ids), np.int64).reshape(-1)
        in_range = ids[(ids >= 0) & (ids < len(self.base))]
        bad = in_range[~self._owned_mask[in_range]]
        if bad.size == 0:
            return None
        shown = bad[:4]
        pairs = ", ".join(f"{d}->shard {h}"
                          for d, h in zip(shown, self.assignment[shown]))
        more = f" (+{bad.size - shown.size} more)" if bad.size > 4 else ""
        return (f"doc id(s) routed to serving shard {self.shard_id} but "
                f"resident elsewhere: {pairs}{more} — shard-affinity "
                f"routing must send each candidate to the shard that "
                f"stores its bytes (TermRepIndex.serving_assignment)")

    def _check(self, doc_ids) -> np.ndarray:
        ids = np.asarray(list(doc_ids), np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self.base)):
            raise IndexError(
                f"doc id out of range [0, {len(self.base)}) in gather()")
        msg = self.describe_misroute(ids)
        if msg:
            raise IndexError(msg)
        return ids

    def gather_raw(self, doc_ids, pad_to=None, streams=None, out=None):
        return self.base.gather_raw(self._check(doc_ids), pad_to=pad_to,
                                    streams=streams, out=out)

    def stage(self, doc_ids, pad_to=None, streams=None, device=None):
        # the base's stage reads through the base's gather_raw, past this
        # view's check: check here first
        return self.base.stage(self._check(doc_ids), pad_to=pad_to,
                               streams=streams, device=device)

    def gather(self, doc_ids, pad_to=None):
        return self.base.gather(self._check(doc_ids), pad_to=pad_to)

    def load_docs(self, doc_ids, pad_to=None):
        return self.gather(doc_ids, pad_to=pad_to)
