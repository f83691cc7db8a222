"""CRC32C chunk checksums for term-rep index streams, the port's copy of
``repro.index.integrity`` (numpy only; the port imports nothing of the
JAX package).

The format-v2 manifest records, per shard and per stream file, one
CRC-32C (Castagnoli) checksum per fixed-size chunk of the file (the
manifest's ``checksum["chunk_bytes"]``).  The JAX package's builder
writes them at finalize; :meth:`~repro_torch.index.store.TermRepIndex.
open` re-verifies every chunk (fast full-file pass, ``verify=True``
default) and ``verify_reads=True`` additionally re-checks the chunks a
``gather_raw`` touches on every read, turning silent bit-rot in the
memmapped stored bytes into a named
:class:`~repro_torch.index.store.IndexIntegrityError` instead of
silently wrong scores.

Pure-python/numpy implementation (no compiled crc32c dependency): a
slice-by-8 table scalar path for single chunks (the per-gather check)
and a numpy path vectorized *across chunks* for whole files (every chunk
advances one byte position per iteration, so a full file costs
``chunk_bytes`` small vector ops regardless of file size).
"""
from __future__ import annotations

import numpy as np

#: CRC-32C: the Castagnoli polynomial, reflected.
_POLY = np.uint32(0x82F63B78)


def _make_tables() -> np.ndarray:
    t0 = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t0 = np.where(t0 & 1, (t0 >> np.uint32(1)) ^ _POLY,
                      t0 >> np.uint32(1))
    tables = np.empty((8, 256), np.uint32)
    tables[0] = t0
    for k in range(1, 8):
        prev = tables[k - 1]
        tables[k] = t0[prev & 0xFF] ^ (prev >> np.uint32(8))
    return tables


_TABLES = _make_tables()
#: python-int lookup rows for the scalar slice-by-8 loop (list indexing
#: beats ndarray item access ~3x in pure-python loops)
_T = [t.tolist() for t in _TABLES]


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    arr = np.ascontiguousarray(data)
    return arr.view(np.uint8).reshape(-1).tobytes()


def crc32c(data, value: int = 0) -> int:
    """CRC-32C of ``data`` (bytes-like or ndarray).  ``value`` chains
    calls like ``zlib.crc32``: ``crc32c(b, crc32c(a)) == crc32c(a + b)``.
    Scalar slice-by-8; use :func:`chunk_checksums` for whole files."""
    b = _as_bytes(data)
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    crc = (~value) & 0xFFFFFFFF
    n8 = len(b) & ~7
    i = 0
    while i < n8:
        crc ^= int.from_bytes(b[i:i + 4], "little")
        hi = int.from_bytes(b[i + 4:i + 8], "little")
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[crc >> 24]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF]
               ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24])
        i += 8
    for byte in b[n8:]:
        crc = t0[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _crc_many(mat: np.ndarray) -> np.ndarray:
    """CRC-32C of each row of a ``[n_chunks, chunk_bytes]`` uint8 matrix,
    vectorized across rows (one table step per byte *position*)."""
    cols = np.ascontiguousarray(mat.T)      # contiguous per-position rows
    t0 = _TABLES[0]
    crcs = np.full(mat.shape[0], 0xFFFFFFFF, np.uint32)
    for j in range(cols.shape[0]):
        crcs = t0[(crcs ^ cols[j]) & np.uint32(0xFF)] ^ (crcs >> np.uint32(8))
    return crcs ^ np.uint32(0xFFFFFFFF)


def chunk_checksums(data, chunk_bytes: int) -> list[int]:
    """Per-chunk CRC-32C list for a whole stream: chunks of exactly
    ``chunk_bytes`` plus one shorter tail chunk (if the size doesn't
    divide).  Empty data -> empty list."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    buf = (np.frombuffer(data, np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.ascontiguousarray(data).view(np.uint8).reshape(-1))
    n_full = len(buf) // chunk_bytes
    out: list[int] = []
    if n_full >= 2:
        out = [int(c) for c in _crc_many(
            buf[:n_full * chunk_bytes].reshape(n_full, chunk_bytes))]
    else:
        for i in range(n_full):
            out.append(crc32c(buf[i * chunk_bytes:(i + 1) * chunk_bytes]))
    tail = buf[n_full * chunk_bytes:]
    if len(tail):
        out.append(crc32c(tail))
    return out


def file_chunk_checksums(path: str, chunk_bytes: int) -> list[int]:
    """Per-chunk CRC-32C list of a file's bytes (empty file -> [])."""
    return chunk_checksums(np.fromfile(path, np.uint8), chunk_bytes)
