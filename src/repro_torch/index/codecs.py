"""Storage codecs of the term-rep index, host side: the port's copy of the
identity codecs of ``repro.index.codecs`` (``fp32``, ``fp16``).  A codec
names the per-token streams of an index (``{name: (dtype, row_shape)}``);
the identity codecs store one ``reps`` stream of raw floats, so decode is
the stored bytes themselves.  ``int8`` and ``pq`` arrive with a later
slice of the port."""
from __future__ import annotations

import numpy as np


class IdentityCodec:
    name: str = ""
    dtype = np.float32

    def streams(self, rep_dim: int) -> dict:
        return {"reps": (np.dtype(self.dtype), (rep_dim,))}

    def bytes_per_token(self, rep_dim: int) -> int:
        return np.dtype(self.dtype).itemsize * rep_dim

    def encode(self, x: np.ndarray) -> dict:
        return {"reps": np.asarray(x, self.dtype)}


class Fp32Codec(IdentityCodec):
    name = "fp32"
    dtype = np.float32


class Fp16Codec(IdentityCodec):
    """The paper's 16-bit storage (section 6.2)."""
    name = "fp16"
    dtype = np.float16


_CODECS = {c.name: c for c in (Fp32Codec, Fp16Codec)}


def get_codec(name: str) -> IdentityCodec:
    cls = _CODECS.get(name)
    if cls is None:
        raise ValueError(
            f"storage codec {name!r} is not ported (the port reads "
            f"{sorted(_CODECS)}; int8 and pq arrive with a later slice)")
    return cls()
