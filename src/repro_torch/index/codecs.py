"""Storage codecs of the term-rep index: the port's copy of
``repro.index.codecs`` for ``fp32``, ``fp16`` and ``int8``.

A codec names the per-token streams of an index (``{name: (dtype,
row_shape)}``) and the transforms between the model's float reps and
those streams.  Any named group of per-token rows goes through the group
API (``stream_group`` / ``encode_group`` / ``decode_group``): the index
stores its reps as the ``"reps"`` group and, with ``kv_codec``, the
layer-``l`` K/V pair as the ``"layer_k"`` / ``"layer_v"`` groups.  The
classic ``streams`` / ``encode`` / ``decode`` trio is the ``"reps"``
specialisation.

Encoding runs on the host (numpy).  Decoding takes numpy arrays or torch
tensors, so serving ships the narrow stored payload to the card and
decodes it there.  ``pq`` is not ported yet (the port's roadmap, "PQ,
pruning and CRC verification").
"""
from __future__ import annotations

import numpy as np
import torch


def _widen(x):
    """float32 copy of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return np.asarray(x).astype(np.float32)


class StorageCodec:
    """Raw-float passthrough parameterised by ``_dtype``.

    The scale stream of a quantising codec's ``"reps"`` group is named
    ``"scales"`` (the on-disk name of the JAX package's int8 indexes); any
    other group's is ``"<group>_scales"``."""

    name: str = ""
    _dtype = np.float32
    #: decode returns the stored stream unchanged: serving may feed the
    #: stored bytes straight to the join
    decode_is_identity = True

    @property
    def encode_dtype(self):
        """dtype the builder materialises model outputs in before
        :meth:`encode` (quantising codecs want full precision)."""
        return self._dtype

    def scale_stream(self, group: str) -> str | None:
        """Name of ``group``'s side-channel scale stream (None for codecs
        without scales)."""
        return None

    def stream_group(self, group: str, dim: int) -> dict:
        return {group: (np.dtype(self._dtype), (dim,))}

    def encode_group(self, group: str, x: np.ndarray) -> dict:
        return {group: np.asarray(x, self._dtype)}

    def decode_group(self, group: str, parts):
        return parts[group]

    def streams(self, rep_dim: int) -> dict:
        return self.stream_group("reps", rep_dim)

    def bytes_per_token(self, rep_dim: int) -> int:
        return sum(dt.itemsize * int(np.prod(shape, dtype=np.int64))
                   for dt, shape in self.streams(rep_dim).values())

    def encode(self, x: np.ndarray) -> dict:
        return self.encode_group("reps", x)

    def decode(self, parts):
        return self.decode_group("reps", parts)


class Fp32Codec(StorageCodec):
    name = "fp32"
    _dtype = np.float32


class Fp16Codec(StorageCodec):
    """The paper's 16-bit storage (section 6.2)."""
    name = "fp16"
    _dtype = np.float16


class Int8Codec(StorageCodec):
    """Symmetric per-token int8: each token keeps a float32 scale
    ``max(|x|) / 127`` over its row, and ``q = clip(rint(x / scale))``.
    Decode is ``q * scale`` in float32."""
    name = "int8"
    _dtype = np.int8
    decode_is_identity = False

    @property
    def encode_dtype(self):
        return np.float32

    def scale_stream(self, group: str) -> str:
        return "scales" if group == "reps" else f"{group}_scales"

    def stream_group(self, group: str, dim: int) -> dict:
        return {group: (np.dtype(np.int8), (dim,)),
                self.scale_stream(group): (np.dtype(np.float32), ())}

    def encode_group(self, group: str, x: np.ndarray) -> dict:
        x = np.asarray(x, np.float32)
        scales = np.maximum(np.max(np.abs(x), axis=-1), 1e-12) / 127.0
        q = np.clip(np.rint(x / scales[..., None]), -127, 127).astype(np.int8)
        return {group: q, self.scale_stream(group): scales.astype(np.float32)}

    def decode_group(self, group: str, parts):
        return _widen(parts[group]) * parts[self.scale_stream(group)][..., None]


_CODECS = {c.name: c for c in (Fp32Codec, Fp16Codec, Int8Codec)}


def get_codec(name: str) -> StorageCodec:
    cls = _CODECS.get(name)
    if cls is None:
        raise ValueError(
            f"storage codec {name!r} is not ported (the port reads "
            f"{sorted(_CODECS)}; pq arrives with the port's roadmap item "
            f"3, 'PQ, pruning and CRC verification')")
    return cls()
