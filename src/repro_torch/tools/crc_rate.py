"""Time the port's CRC-32C (``index.integrity.chunk_checksums``) against
the per-byte-position loop it replaced, on the host CPU::

    PYTHONPATH=src python -m repro_torch.tools.crc_rate

over MB megabytes of seeded bytes in CHUNKS chunks.  Prints one JSON
line: both times (best of REPEATS), their ratio, the new path's MB/s,
and whether the two agree on every chunk.
"""
from __future__ import annotations

import json
import time

import numpy as np

from repro_torch.index import integrity

MB, CHUNKS, REPEATS = 64, 1024, 3


def per_position_crcs(mat: np.ndarray) -> np.ndarray:
    """The replaced form: CRC-32C of each row of a ``[n_chunks,
    chunk_bytes]`` uint8 matrix, one table step per byte position."""
    cols = np.ascontiguousarray(mat.T)
    t0 = integrity._TABLES[0]
    crcs = np.full(mat.shape[0], 0xFFFFFFFF, np.uint32)
    for j in range(cols.shape[0]):
        crcs = t0[(crcs ^ cols[j]) & np.uint32(0xFF)] ^ (crcs >> np.uint32(8))
    return crcs ^ np.uint32(0xFFFFFFFF)


def best_s(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    data = np.random.default_rng(0).integers(0, 256, MB << 20,
                                             dtype=np.uint8)
    chunk = len(data) // CHUNKS
    mat = data[:chunk * CHUNKS].reshape(CHUNKS, chunk)
    integrity.chunk_checksums(data[:4 * chunk], chunk)      # tables built
    new = integrity.chunk_checksums(data, chunk)
    old = per_position_crcs(mat).tolist()
    new_s = best_s(lambda: integrity.chunk_checksums(data, chunk),
                   REPEATS)
    old_s = best_s(lambda: per_position_crcs(mat), REPEATS)
    print(json.dumps({"mb": MB, "chunks": CHUNKS,
                      "chunk_bytes": chunk, "new_s": new_s, "old_s": old_s,
                      "speedup": old_s / new_s,
                      "new_mb_per_s": MB / new_s,
                      "equal": new == old}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
