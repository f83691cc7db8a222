"""Offline index builder (the paper's indexing phase), the port of
``repro.index.builder``: fixed-shape encode batches through the port's
:func:`~repro_torch.core.prettr.precompute_docs`, one append-only writer
per shard with one file per stream, and a v2 manifest.

* **Fixed-shape batches** -- documents are packed to ``[batch_size,
  max_doc_len]``; the last batch is padded with empty rows, as
  :func:`verify_index` replays it.
* **Overlapped host writes** -- a writer thread copies each encoded batch
  to the host, codec-encodes it and appends it to its shard while the
  card encodes the next batch; ``writer_depth`` bounds the batches in
  flight (0 writes on the calling thread).
* **Codecs** -- ``fp16`` / ``fp32`` store the model's own storage dtype;
  quantising codecs (``int8``, ``pq``) encode float32 reps on the host.
  A trained codec (``pq``) is fitted first on the valid-token reps of
  the first ``fit_sample`` docs (``fit_seed`` seeds the k-means); its
  state goes to the manifest's ``codec_state``.
* **Stored layer-l K/V** -- ``store_layer_kv=True`` also writes the join
  layer's doc-side K/V (:func:`~repro_torch.core.prettr.precompute_doc_kv`)
  as the ``layer_k`` / ``layer_v`` streams, computed from the
  codec-round-tripped reps (the bytes serving will read), in the config's
  storage dtype or, with ``kv_codec``, encoded by that codec.
* **Index-time token pruning** -- ``keep_frac`` / ``max_kept_tokens``
  score every token with :func:`~repro_torch.core.prettr.doc_salience`
  and write only each doc's survivors of :func:`prune_selection`; the
  manifest records the policy (``prune``), each shard's token counts
  before pruning (``orig_lengths``) and the pruned cap as
  ``max_doc_len``.  Refused on RoPE backbones: dropping rows would shift
  every survivor's rotary phase.
* **Data-parallel encode** -- ``mesh`` (a placement mesh with a
  ``"data"`` axis, ``repro_torch.dist.compat.Mesh``) rounds the batch up
  to a multiple of its devices; each device encodes its rows with its
  own copy of the params (made once), and the parts are gathered in row
  order on the host before the codec and the writer thread.
* **Checksums** -- each stream file gets one CRC-32C per
  ``checksum_chunk_bytes`` chunk (0 writes none), computed after the
  fsync, which both packages' readers verify on open.

:func:`verify_index` re-encodes a sample of documents in the build's
batch shape and compares the stored streams byte for byte.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prettr as P
from repro_torch.device import device_scope, resolve_device, to_device
from repro_torch.index import _msgpack
from repro_torch.index.codecs import StorageCodec, get_codec
from repro_torch.index.integrity import file_chunk_checksums
from repro_torch.index.store import FORMAT_VERSION

PAD, SEP = 0, 2          # token ids of repro_torch.data.tokenizer
_STOP = object()


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


def prune_selection(salience: np.ndarray, n_tokens: int, keep_frac: float,
                    max_kept_tokens: int) -> np.ndarray:
    """Token indices a prune policy keeps for one doc, in ascending order:
    the ``max(1, ceil(keep_frac * n))`` most salient tokens, capped by
    ``max_kept_tokens`` when > 0.  A stable argsort takes the first of
    ties, so the selection is fixed by the salience floats."""
    n = int(n_tokens)
    keep = max(1, int(np.ceil(keep_frac * n)))
    if max_kept_tokens > 0:
        keep = min(keep, int(max_kept_tokens))
    keep = max(1, min(keep, n))
    order = np.argsort(-np.asarray(salience[:n], np.float32), kind="stable")
    return np.sort(order[:keep])


@dataclasses.dataclass
class BuildReport:
    n_docs: int
    n_tokens: int
    n_shards: int
    codec: str
    storage_bytes: int                 # bytes on disk
    encode_s: float                    # device encode, synchronised
    write_s: float                     # device->host copy, codec, files
    wall_s: float
    fit_s: float = 0.0                 # trained codec's fit pass

    @property
    def bytes_per_doc(self) -> float:
        return self.storage_bytes / max(1, self.n_docs)


class _ShardWriter:
    """Append-only stream files (``<stream>.bin``) of one shard directory,
    its per-doc token counts (kept and before pruning) and, at close, the
    chunk checksums of each file."""

    def __init__(self, root: str, shard_id: int, stream_names,
                 checksum_chunk_bytes: int = 0):
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
        self.orig_lengths: list[int] = []
        self.checksum_chunk_bytes = int(checksum_chunk_bytes)
        self.checksums: dict[str, list[int]] | None = None

    def append(self, parts: dict, n_tokens: int, orig_tokens: int):
        for name, fh in self._handles.items():
            fh.write(np.ascontiguousarray(parts[name]).tobytes())
        self.lengths.append(int(n_tokens))
        self.orig_lengths.append(int(orig_tokens))

    def close(self):
        open_handles = [fh for fh in self._handles.values() if not fh.closed]
        for fh in open_handles:
            fh.flush()
            os.fsync(fh.fileno())
            fh.close()
        # the CRCs cover exactly the bytes that reached the disk
        if open_handles and self.checksum_chunk_bytes > 0:
            self.checksums = {
                name: file_chunk_checksums(
                    os.path.join(self.path, f"{name}.bin"),
                    self.checksum_chunk_bytes)
                for name in self._handles}

    def manifest_row(self, with_orig: bool) -> dict:
        row = {"dir": self.dir_name, "n_docs": len(self.lengths),
               "lengths": self.lengths}
        if with_orig:
            row["orig_lengths"] = self.orig_lengths
        if self.checksums is not None:
            row["checksums"] = self.checksums
        return row


class IndexBuilder:
    """Encode raw documents and write a sharded v2 index::

        report = IndexBuilder(out_dir, cfg, params).build(doc_token_lists)
        index = TermRepIndex.open(out_dir)

    ``device`` (``None`` means the card) is where the encode runs; params
    are moved there once.  ``mesh`` spreads each batch over the mesh's
    devices instead (module docstring).  ``codec`` / ``kv_codec`` take a
    name or a codec instance (a fitted ``pq`` codec is not fitted
    again)."""

    def __init__(self, out_dir: str | None, cfg: P.PreTTRConfig, params, *,
                 codec: str | StorageCodec = "fp16", n_shards: int = 1,
                 batch_size: int = 64, writer_depth: int = 2,
                 store_layer_kv: bool = False,
                 kv_codec: str | StorageCodec | None = None,
                 keep_frac: float = 1.0, max_kept_tokens: int = 0,
                 fit_sample: int = 256, fit_seed: int = 0,
                 checksum_chunk_bytes: int = 1 << 16, device=None,
                 mesh=None):
        if mesh is not None and "data" not in mesh.axis_names:
            raise ValueError(f"a data-parallel build needs a mesh with a "
                             f"'data' axis; got axes {mesh.axis_names}")
        # the devices a batch is split over, in row order
        self.devices = [resolve_device(d) for d in mesh.devices.reshape(-1)] \
            if mesh is not None else [resolve_device(device)]
        self.device = self.devices[0]
        self.codec = get_codec(codec) if isinstance(codec, str) else codec
        if not 0.0 < keep_frac <= 1.0:
            raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")
        if max_kept_tokens < 0:
            raise ValueError(
                f"max_kept_tokens must be >= 0, got {max_kept_tokens}")
        self.keep_frac = float(keep_frac)
        self.max_kept_tokens = int(max_kept_tokens)
        self.prune = keep_frac < 1.0 or max_kept_tokens > 0
        if self.prune and cfg.backbone.rope:
            raise ValueError(
                "token pruning requires a learned-position backbone: the "
                "join layers rope surviving rows by their *pruned* index, "
                "which would shift every survivor's phase (rope=False for "
                "PreTTR's BERT config)")
        self._fit_sample = max(1, int(fit_sample))
        self._fit_seed = int(fit_seed)
        if checksum_chunk_bytes < 0:
            raise ValueError(
                f"checksum_chunk_bytes must be >= 0 (0 disables integrity "
                f"checksums), got {checksum_chunk_bytes}")
        self.checksum_chunk_bytes = int(checksum_chunk_bytes)
        self.store_layer_kv = bool(store_layer_kv)
        self.kv_codec = (get_codec(kv_codec) if isinstance(kv_codec, str)
                         else kv_codec)
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
        # one copy of the params a device (a device may repeat)
        self._device_params = {self.device: self.params}
        for dev in self.devices:
            if dev not in self._device_params:
                self._device_params[dev] = to_device(params, dev)
        self.out_dir = out_dir
        self.n_shards = max(1, int(n_shards))
        ndev = len(self.devices)
        # fixed batch shape, divisible by the data-parallel mesh
        self.batch_size = -(-max(1, int(batch_size)) // ndev) * ndev
        self.writer_depth = max(0, int(writer_depth))
        self.rep_dim = cfg.compress_dim or cfg.backbone.d_model
        self.kv_dim = cfg.backbone.n_kv_heads * cfg.backbone.dh
        # the pruned cap the manifest records as max_doc_len: derived from
        # the policy, so it is known before the build
        cap = int(cfg.max_doc_len)
        if self.prune:
            cap = min(cap, int(np.ceil(self.keep_frac * cap)))
            if self.max_kept_tokens > 0:
                cap = min(cap, self.max_kept_tokens)
        self.pruned_max_doc_len = max(1, cap)

    def _stream_names(self) -> list[str]:
        names = list(self.codec.streams(self.rep_dim))
        if self.kv_codec is not None:
            names += [*self.kv_codec.stream_group("layer_k", self.kv_dim),
                      *self.kv_codec.stream_group("layer_v", self.kv_dim)]
        elif self.store_layer_kv:
            names += ["layer_k", "layer_v"]
        return names

    # -- device side -----------------------------------------------------------
    def _device_batch(self, tokens: np.ndarray, valid: np.ndarray):
        """One batch, padded with empty rows to the fixed shape -> one
        ``(reps, kv, salience)`` a device, in row order (one without a
        mesh): ``kv`` the ``(k, v)`` pair with ``store_layer_kv`` and
        ``salience`` [rows, Ld] when pruning, else None.  Synchronises the
        cards, so the caller's clock holds the encode."""
        pad = self.batch_size - len(tokens)
        if pad:
            tokens = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]),
                                                      tokens.dtype)])
            valid = np.concatenate([valid, np.zeros((pad, valid.shape[1]),
                                                    bool)])
        per = self.batch_size // len(self.devices)
        parts = []
        # each device's encode is queued before the cards are waited for
        # (a quantising codec's stored K/V waits for its reps on the host)
        for i, dev in enumerate(self.devices):
            rows = slice(i * per, (i + 1) * per)
            parts.append(self._encode_rows(dev, tokens[rows], valid[rows]))
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return parts

    def _encode_rows(self, dev, tokens, valid):
        params = self._device_params[dev]
        with torch.inference_mode(), device_scope(dev):
            valid_dev = torch.from_numpy(valid).to(dev)
            reps = P.precompute_docs(
                params, self.cfg,
                torch.from_numpy(tokens.astype(np.int64)).to(dev), valid_dev)
            sal = (P.doc_salience(params, self.cfg, reps, valid_dev)
                   if self.prune else None)
            kv = self._batch_kv(params, reps) if self.store_layer_kv \
                else None
        return reps, kv, sal

    def _batch_kv(self, params, reps):
        """Layer-l K/V of one batch from the codec-round-tripped reps: a
        quantising codec encodes on the host, then decodes on the device
        (what the query-time join reads)."""
        if not self.codec.decode_is_identity:
            parts = self.codec.encode(reps.cpu().numpy())
            reps = self.codec.decode({k: torch.from_numpy(v).to(reps.device)
                                      for k, v in parts.items()})
        return P.precompute_doc_kv(params, self.cfg, reps)

    def _host_batch(self, parts):
        """The devices' parts -> numpy ``(reps, kv, salience)`` in row
        order; one device's part as it is, with no copy."""
        def cat(xs):
            if len(xs) == 1:
                return xs[0].cpu().numpy()
            return np.concatenate([x.cpu().numpy() for x in xs])

        reps, kv, sal = zip(*parts)
        kv = None if kv[0] is None else [
            cat(t).astype(self._kv_dtype) for t in zip(*kv)]
        return cat(reps), kv, None if sal[0] is None else cat(sal)

    def _doc_parts(self, reps, kv, sal, i: int, n: int):
        """The stored streams of row ``i`` (``n`` packed tokens) -> (parts,
        kept token count).  Pruning slices the kept rows: encode and the
        K/V projections are per token, so slicing before or after them
        gives the same bytes."""
        rows = (prune_selection(sal[i], n, self.keep_frac,
                                self.max_kept_tokens)
                if sal is not None else slice(None, n))
        parts = self.codec.encode(reps[i, rows])
        if kv is not None:
            for name, x in zip(("layer_k", "layer_v"), kv):
                parts.update(self.kv_codec.encode_group(name, x[i, rows])
                             if self.kv_codec is not None
                             else {name: x[i, rows]})
        return parts, (len(rows) if sal is not None else n)

    def _fit_codec(self, docs: Sequence[np.ndarray]):
        """Fit pass of a trained codec (pq): encode the batches that hold
        the first ``fit_sample`` docs through the build's fixed batch
        shape and train on their valid-token reps."""
        buf = []
        for lo in range(0, min(len(docs), self._fit_sample),
                        self.batch_size):
            tokens, lengths, valid = pack_doc_batch(
                docs[lo: lo + self.batch_size], self.cfg.max_doc_len)
            reps = self._host_batch(self._device_batch(tokens, valid))[0]
            buf += [np.asarray(reps[i, : int(n)], np.float32)
                    for i, n in enumerate(lengths)]
        if not buf:
            raise ValueError(f"codec {self.codec.name!r} needs a fit sample "
                             f"but the corpus is empty")
        self.codec.fit(np.concatenate(buf), seed=self._fit_seed)

    # -- host side -------------------------------------------------------------
    def _write_batch(self, parts, lengths, doc_lo, writers, boundaries,
                     write_s):
        """Copy one device batch to the host and append its docs to their
        shards (the writer thread's work, overlapping the next encode)."""
        t0 = time.perf_counter()
        reps, kv, sal = self._host_batch(parts)
        for i, n in enumerate(lengths):
            shard = int(np.searchsorted(boundaries, doc_lo + i,
                                        side="right") - 1)
            parts, kept = self._doc_parts(reps, kv, sal, i, int(n))
            writers[shard].append(parts, kept, int(n))
        write_s[0] += time.perf_counter() - t0

    def _write_loop(self, work_q: queue.Queue, writers, boundaries,
                    err: list, write_s: list):
        while True:
            item = work_q.get()
            if item is _STOP:
                return
            try:
                self._write_batch(*item, writers, boundaries, write_s)
            except Exception as e:                    # noqa: BLE001
                err.append(e)
                return

    # -- the pipeline ----------------------------------------------------------
    def build(self, docs: Sequence[np.ndarray]) -> BuildReport:
        """Encode ``docs`` (raw token arrays; packed to ``[SEP]``-terminated
        fixed shapes here) and write the sharded v2 index."""
        if self.out_dir is None:
            raise ValueError("IndexBuilder.build needs an out_dir")
        t_wall = time.perf_counter()
        n_docs = len(docs)
        fit_s = 0.0
        if self.codec.needs_fit:
            t0 = time.perf_counter()
            self._fit_codec(docs)
            fit_s = time.perf_counter() - t0
        writers = []
        try:
            for s in range(self.n_shards):
                writers.append(_ShardWriter(self.out_dir, s,
                                            self._stream_names(),
                                            self.checksum_chunk_bytes))
        except OSError:
            for w in writers:
                w.close()
            raise
        boundaries = np.asarray([lo for lo, _ in
                                 shard_ranges(n_docs, self.n_shards)])
        err: list = []
        write_s = [0.0]
        work_q: queue.Queue = queue.Queue(maxsize=max(1, self.writer_depth))
        worker = None
        if self.writer_depth > 0:
            worker = threading.Thread(
                target=self._write_loop,
                args=(work_q, writers, boundaries, err, write_s), daemon=True)
            worker.start()
        encode_s = 0.0
        try:
            for lo in range(0, n_docs, self.batch_size):
                tokens, lengths, valid = pack_doc_batch(
                    docs[lo: lo + self.batch_size], self.cfg.max_doc_len)
                t0 = time.perf_counter()
                item = (self._device_batch(tokens, valid), lengths, lo)
                encode_s += time.perf_counter() - t0
                if worker is None:
                    self._write_batch(*item, writers, boundaries, write_s)
                    continue
                # a bounded put that never deadlocks on a dead writer
                while not err:
                    try:
                        work_q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if err:
                    break
        finally:
            if worker is not None:
                while worker.is_alive():
                    try:
                        work_q.put(_STOP, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                worker.join()
            for w in writers:
                w.close()
        if err:
            raise err[0]
        self._write_manifest(n_docs, writers)
        n_tokens = sum(sum(w.lengths) for w in writers)
        on_disk = sum(os.path.getsize(os.path.join(w.path, f"{name}.bin"))
                      for w in writers for name in self._stream_names())
        return BuildReport(
            n_docs=n_docs, n_tokens=n_tokens, n_shards=self.n_shards,
            codec=self.codec.name, storage_bytes=on_disk,
            encode_s=encode_s, write_s=write_s[0],
            wall_s=time.perf_counter() - t_wall, fit_s=fit_s)

    def _write_manifest(self, n_docs: int, writers) -> None:
        manifest = {"version": FORMAT_VERSION, "codec": self.codec.name,
                    "rep_dim": self.rep_dim, "l": self.cfg.l,
                    "compressed": bool(self.cfg.compress_dim),
                    "max_doc_len": self.pruned_max_doc_len if self.prune
                    else self.cfg.max_doc_len,
                    "n_docs": n_docs,
                    # results differ at the ulp across batch shapes, so a
                    # byte-exact re-verification replays the one a device
                    # encoded
                    "encode_batch": self.batch_size // len(self.devices),
                    "shards": [w.manifest_row(with_orig=self.prune)
                               for w in writers]}
        if self.checksum_chunk_bytes > 0:
            manifest["checksum"] = {"algo": "crc32c",
                                    "chunk_bytes": self.checksum_chunk_bytes}
        state = self.codec.state_dict()
        if state is not None:
            manifest["codec_state"] = state
        if self.prune:
            manifest["prune"] = {"keep_frac": self.keep_frac,
                                 "max_kept_tokens": self.max_kept_tokens,
                                 "layer": self.cfg.l}
        if self.store_layer_kv:
            manifest["layer_kv"] = {"dtype": self._kv_payload_dtype.str,
                                    "d_kv": self.kv_dim}
            if self.kv_codec is not None:
                manifest["layer_kv"]["codec"] = self.kv_codec.name
        with open(os.path.join(self.out_dir, "manifest.msgpack"), "wb") as f:
            f.write(_msgpack.packb(manifest))


def verify_index(index, cfg: P.PreTTRConfig, params,
                 docs: Sequence[np.ndarray], sample: int = 16,
                 seed: int = 0, device=None) -> int:
    """Re-encode a seeded sample of ``docs`` and compare the stored streams
    byte for byte (the codecs are deterministic, so this is exact for
    every codec, int8 and pq included, and replays a prune selection).
    ``cfg`` is the build's config (its unpruned ``max_doc_len``).  The
    sample is encoded in the build's batch shape
    (``manifest["encode_batch"]``), the last partial batch padded as the
    build padded it: the card's results differ at the ulp across batch
    shapes.  Returns the number of docs checked; raises AssertionError on
    any mismatch."""
    n = len(index)
    if not n:
        return 0
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    prune = index.prune_policy or {"keep_frac": 1.0, "max_kept_tokens": 0}
    kv_codec = index.kv_codec
    if index.has_layer_kv and kv_codec is None:
        cfg = dataclasses.replace(cfg, store_dtype=torch.from_numpy(
            np.zeros(0, np.dtype(index.layer_kv["dtype"]))).dtype)
    enc = IndexBuilder(
        None, cfg, params, codec=index.codec,
        batch_size=index.encode_batch or len(ids),
        store_layer_kv=index.has_layer_kv, kv_codec=kv_codec,
        keep_frac=prune["keep_frac"],
        max_kept_tokens=prune["max_kept_tokens"], device=device)
    orig_lens = np.asarray(index.orig_doc_lengths)
    parts, got_valid = index.gather_raw([int(i) for i in ids],
                                        pad_to=cfg.max_doc_len)
    for lo in range(0, len(ids), enc.batch_size):
        chunk = ids[lo: lo + enc.batch_size]
        tokens, lengths, valid = pack_doc_batch([docs[i] for i in chunk],
                                                cfg.max_doc_len)
        reps, kv, sal = enc._host_batch(enc._device_batch(tokens, valid))
        for i, n_tok in enumerate(lengths):
            row, doc = lo + i, int(chunk[i])
            assert orig_lens[doc] == n_tok, (
                f"doc {doc} orig_lengths={orig_lens[doc]} but the doc "
                f"packs to {n_tok} tokens")
            want, stored = enc._doc_parts(reps, kv, sal, i, int(n_tok))
            for name, arr in want.items():
                np.testing.assert_array_equal(
                    parts[name][row, :stored], arr,
                    err_msg=f"doc {doc} stream {name!r} mismatch")
            assert int(got_valid[row].sum()) == stored, \
                f"doc {doc} stored length mismatch"
    return len(ids)
