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

Numpy only (no compiled crc32c dependency), one path for every size:
each chunk is split into sub-blocks of ``SUB_BLOCK`` bytes, the CRC of
every sub-block of a whole file is taken at once (slice-by-8 over
little-endian 64-bit words, through tables of 16-bit pieces, so a file
costs ``SUB_BLOCK / 8`` vector steps whatever its size), and the
sub-block CRCs are folded into chunk CRCs by the CRC's linear combine:
``crc(a + b) = Z_len(b)(crc(a)) ^ crc(b)`` for CRCs started at 0, where
``Z_n`` (appending ``n`` zero bytes) is a linear map on 32 bits, applied
through two 65,536-entry tables built once per length.  Leading zero
bytes leave a CRC started at 0 unchanged, so a chunk whose length the
sub-block does not divide is zero-padded in front.  The whole-file
pass, the per-read check and ``IndexBuilder``'s checksums share it; inputs
below ``SUB_BLOCK`` bytes take the scalar table loop.
"""
from __future__ import annotations

import functools

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
#: python-int lookup rows for the scalar loop (list indexing beats
#: ndarray item access ~3x in pure-python loops)
_T = [t.tolist() for t in _TABLES]
#: bytes of one sub-block (a multiple of 8)
SUB_BLOCK = 64
#: sub-blocks a vector step takes at once (1 MiB of data: the step's
#: arrays stay in cache)
_ROWS_A_STEP = (1 << 20) // SUB_BLOCK


def _pieces16(lo8, hi8) -> np.ndarray:
    """A 65,536-entry table of a 16-bit piece: ``lo8[i & 0xFF] ^
    hi8[i >> 8]``."""
    i = np.arange(1 << 16)
    return lo8[i & 0xFF] ^ hi8[i >> 8]


# slice-by-8 in 16-bit pieces: bytes 0-1 and 2-3 of a word (after the
# running CRC is XORed in), then bytes 4-5 and 6-7
_P0, _P1, _P2, _P3 = (_pieces16(_TABLES[7 - 2 * k], _TABLES[6 - 2 * k])
                      for k in range(4))


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    arr = np.ascontiguousarray(data)
    return arr.view(np.uint8).reshape(-1).tobytes()


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def _crc_scalar(b: bytes, crc: int) -> int:
    """The register after ``b``, from register ``crc`` (no final XOR)."""
    t0 = _T[0]
    for byte in b:
        crc = t0[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc


# -- linear maps on the 32-bit register ---------------------------------------
# A map is its 32 column images (uint32): the image of bit i is column i.

def _apply(cols: np.ndarray, v: int) -> int:
    out = 0
    for i in range(32):
        if (v >> i) & 1:
            out ^= int(cols[i])
    return out


def _compose(f: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Columns of ``f after g``."""
    return np.array([_apply(f, int(c)) for c in g], np.uint32)


@functools.lru_cache(maxsize=None)
def _zeros_map(n: int) -> np.ndarray:
    """Columns of ``Z_n``: the register after ``n`` zero bytes."""
    if n == 0:
        return np.array([1 << i for i in range(32)], np.uint32)
    if n == 1:
        return np.array([_crc_scalar(b"\0", 1 << i) for i in range(32)],
                        np.uint32)
    half = _zeros_map(n // 2)
    out = _compose(half, half)
    return _compose(_zeros_map(1), out) if n % 2 else out


@functools.lru_cache(maxsize=None)
def _zeros_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``Z_n`` as two 65,536-entry tables, of a register's low and high
    16 bits."""
    cols = _zeros_map(n)
    i = np.arange(1 << 16, dtype=np.uint32)
    lo = np.zeros(1 << 16, np.uint32)
    hi = np.zeros(1 << 16, np.uint32)
    for b in range(16):
        bit = ((i >> np.uint32(b)) & np.uint32(1)).astype(bool)
        lo[bit] ^= cols[b]
        hi[bit] ^= cols[16 + b]
    return lo, hi


def _shift(crc: np.ndarray, n: int) -> np.ndarray:
    """``Z_n`` applied to each register of ``crc`` (uint32)."""
    lo, hi = _zeros_tables(n)
    c = crc.astype(np.intp)
    return lo.take(c & 0xFFFF, mode="wrap") ^ hi.take(c >> 16, mode="wrap")


# -- the vector path ----------------------------------------------------------

def _sub_block_crcs(buf: np.ndarray) -> np.ndarray:
    """CRC, started at 0, of each ``SUB_BLOCK`` bytes of ``buf`` (a
    multiple of ``SUB_BLOCK`` bytes) -> uint32 ``[len / SUB_BLOCK]``."""
    rows = buf.reshape(-1, SUB_BLOCK)
    n, steps = rows.shape[0], SUB_BLOCK // 8
    out = np.empty(n, np.uint32)
    for lo in range(0, n, _ROWS_A_STEP):
        m = rows[lo:lo + _ROWS_A_STEP]
        # [SUB_BLOCK / 4, rows] little-endian 32-bit words: the low word of
        # each 64-bit step meets the running register, the high word's
        # table terms do not depend on it
        w = m.view("<u4").T.astype(np.intp, order="C")
        high = w[1::2]
        # take(mode="wrap") skips fancy indexing's bounds checks (every
        # index is a 16-bit piece)
        high = _P2.take(high & 0xFFFF, mode="wrap") \
            ^ _P3.take(high >> 16, mode="wrap")
        x = w[0]                                   # the register starts at 0
        for j in range(steps):
            if j:
                x = crc ^ w[2 * j]
            crc = _P0.take(x & 0xFFFF, mode="wrap")
            crc ^= _P1.take(x >> 16, mode="wrap")
            crc ^= high[j]
        out[lo:lo + m.shape[0]] = crc
    return out


def _fold(crcs: np.ndarray, sub_len: int) -> np.ndarray:
    """``[n, m]`` CRCs (started at 0) of consecutive ``sub_len``-byte
    pieces -> ``[n]`` CRCs of each row's concatenation: a tree of
    pairwise combines, zero pieces prepended to a power of two."""
    n, m = crcs.shape
    width = 1 << max(0, (m - 1).bit_length())
    if width > m:
        crcs = np.concatenate(
            [np.zeros((n, width - m), np.uint32), crcs], axis=1)
    while crcs.shape[1] > 1:
        crcs = _shift(crcs[:, 0::2], sub_len) ^ crcs[:, 1::2]
        sub_len *= 2
    return crcs[:, 0]


def _crc_rows(mat: np.ndarray, init: int) -> np.ndarray:
    """CRC-32C of each row of a ``[n, L]`` uint8 matrix, each started at
    register ``init`` (``~value``), final XOR applied -> uint32 ``[n]``."""
    n, length = mat.shape
    pad = -length % SUB_BLOCK
    if pad:
        padded = np.zeros((n, length + pad), np.uint8)
        padded[:, pad:] = mat
        mat = padded
    raw = _fold(_sub_block_crcs(mat.reshape(-1)).reshape(n, -1), SUB_BLOCK)
    start = _apply(_zeros_map(length), init & 0xFFFFFFFF)
    return raw ^ np.uint32(start ^ 0xFFFFFFFF)


def crc32c(data, value: int = 0) -> int:
    """CRC-32C of ``data`` (bytes-like or ndarray).  ``value`` chains
    calls like ``zlib.crc32``: ``crc32c(b, crc32c(a)) == crc32c(a + b)``."""
    buf = _as_u8(data)
    init = (~value) & 0xFFFFFFFF
    if len(buf) < SUB_BLOCK:
        return _crc_scalar(_as_bytes(buf), init) ^ 0xFFFFFFFF
    return int(_crc_rows(buf[None], init)[0])


def chunk_checksums(data, chunk_bytes: int) -> list[int]:
    """Per-chunk CRC-32C list for a whole stream: chunks of exactly
    ``chunk_bytes`` plus one shorter tail chunk (if the size doesn't
    divide).  Empty data -> empty list."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    buf = _as_u8(data)
    n_full = len(buf) // chunk_bytes
    out: list[int] = []
    if n_full:
        out = _crc_rows(buf[:n_full * chunk_bytes].reshape(
            n_full, chunk_bytes), 0xFFFFFFFF).tolist()
    tail = buf[n_full * chunk_bytes:]
    if len(tail):
        out.append(crc32c(tail))
    return out


def file_chunk_checksums(path: str, chunk_bytes: int) -> list[int]:
    """Per-chunk CRC-32C list of a file's bytes (empty file -> [])."""
    return chunk_checksums(np.fromfile(path, np.uint8), chunk_bytes)
