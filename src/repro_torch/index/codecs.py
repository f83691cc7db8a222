"""Storage codecs of the term-rep index: the port's copy of
``repro.index.codecs`` (``fp32``, ``fp16``, ``int8`` and the trained
product quantiser ``pq``).

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
decodes it there.

A trained codec (``pq``) carries state that travels with its index:
``needs_fit`` holds until :meth:`StorageCodec.fit` has seen a
``[T, rep_dim]`` float sample (the builder's fit pass), ``state_dict()``
goes into the manifest's ``codec_state`` and the reader feeds it back
through ``load_state_dict`` before it consults the stream spec.  The
numpy fit and encode are copies of the JAX package's, so the same
float32 sample gives the same codebooks and codes, bit for bit.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

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
    #: True until fit() has trained the codec's state (trained codecs)
    needs_fit = False

    def fit(self, sample: np.ndarray, *, seed: int = 0) -> None:
        """Train codec state on a ``[T, rep_dim]`` sample (stateless
        codecs: nothing to do)."""

    def state_dict(self) -> dict | None:
        """The manifest's ``codec_state`` (None for stateless codecs)."""
        return None

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(f"codec {self.name!r} is stateless but the "
                             f"manifest carries codec_state")

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


_CODECS: dict[str, type] = {}


def register_codec(cls):
    """Class decorator: register under ``cls.name`` (a second class of one
    name replaces the first)."""
    _CODECS[cls.name] = cls
    return cls


def available_codecs() -> list[str]:
    return sorted(_CODECS)


def get_codec(name: str) -> StorageCodec:
    cls = _CODECS.get(name)
    if cls is None:
        raise ValueError(f"unknown storage codec {name!r}; available: "
                         f"{available_codecs()}")
    return cls()


def codec_for_v1_dtype(dtype) -> StorageCodec:
    """The float codec of a v1 index's ``meta.msgpack`` dtype (v1 stored
    raw float16 or float32 blocks only)."""
    dt = np.dtype(dtype)
    if dt == np.float16:
        return get_codec("fp16")
    if dt == np.float32:
        return get_codec("fp32")
    raise ValueError(f"v1 indexes store raw float16/float32 blocks; dtype "
                     f"{dt.str!r} has no v1 codec")


@register_codec
class Fp32Codec(StorageCodec):
    name = "fp32"
    _dtype = np.float32


@register_codec
class Fp16Codec(StorageCodec):
    """The paper's 16-bit storage (section 6.2)."""
    name = "fp16"
    _dtype = np.float16


@register_codec
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


def _only_reps(group: str) -> None:
    if group != "reps":
        raise ValueError("pq codec encodes only the 'reps' stream group; "
                         "pick a different kv_codec for layer K/V streams")


@register_codec
class PQCodec(StorageCodec):
    """Product quantisation: a token's ``e`` dims split into ``e /
    sub_dim`` subvectors, each stored as the uint8 id of its nearest
    centroid in that subspace's codebook of ``n_centroids`` (``sub_dim=4``
    stores 0.25 byte a dim).  The codebooks are k-means-trained on a
    sample of reps at build time and live in the manifest.

    Decode is a codebook gather: numpy on the host, and on the card one
    gather from the flat ``[m * k, sub_dim]`` codebook, which is copied to
    each device once and kept there.  Only the ``"reps"`` group: layer K/V
    streams keep their own ``kv_codec``."""
    name = "pq"
    decode_is_identity = False

    def __init__(self, sub_dim: int = 4, n_centroids: int = 256,
                 codebooks: np.ndarray | None = None):
        if not 0 < n_centroids <= 256:
            raise ValueError(f"n_centroids must fit a uint8 code (1..256), "
                             f"got {n_centroids}")
        self.sub_dim = int(sub_dim)
        self.n_centroids = int(n_centroids)
        self.codebooks = None
        self._on_device: dict = {}        # device -> flat codebook tensor
        if codebooks is not None:
            self._set_codebooks(np.asarray(codebooks, np.float32))

    @property
    def needs_fit(self):
        return self.codebooks is None

    @property
    def encode_dtype(self):
        return np.float32

    def _set_codebooks(self, cb: np.ndarray) -> None:
        if cb.ndim != 3 or cb.shape[1] != self.n_centroids \
                or cb.shape[2] != self.sub_dim:
            raise ValueError(f"codebooks must be [n_sub, {self.n_centroids}, "
                             f"{self.sub_dim}], got {cb.shape}")
        self.codebooks = np.ascontiguousarray(cb, np.float32)
        self._on_device = {}
        # per subspace: the encode's -2 cent.T [sub_dim, k] and c^2 [1, k]
        self._operands = [self._scaled(c) for c in self.codebooks]

    def _n_sub(self, rep_dim: int) -> int:
        if rep_dim % self.sub_dim:
            raise ValueError(f"pq codec needs rep_dim divisible by sub_dim="
                             f"{self.sub_dim}, got rep_dim={rep_dim}")
        return rep_dim // self.sub_dim

    def _require_fit(self) -> np.ndarray:
        if self.codebooks is None:
            raise ValueError(
                "pq codec has no codebooks: call fit() on a term-rep sample "
                "(IndexBuilder does) or open an index whose manifest "
                "carries codec_state")
        return self.codebooks

    # -- training ------------------------------------------------------------
    def fit(self, sample: np.ndarray, *, seed: int = 0,
            iters: int = 8) -> None:
        """Lloyd k-means per subspace on ``[T, rep_dim]`` floats, seeded by
        ``seed``: first-index tie-breaks, an empty cluster keeps its
        centroid, a centroid moves to the mean of its members in token
        order.  The JAX package selects each cluster's members by a mask
        (k passes over T); here one stable sort by cluster lays them out
        in the same order, so each mean sums the same floats in the same
        order.  The subspaces are independent once their initial
        centroids are drawn (in subspace order, from one generator), so
        they train on a thread each.  The codebooks equal the JAX
        package's bit for bit."""
        sample = np.asarray(sample, np.float32)
        if sample.ndim != 2 or not sample.size:
            raise ValueError(f"fit() wants a non-empty [T, rep_dim] sample, "
                             f"got shape {sample.shape}")
        m = self._n_sub(sample.shape[1])
        t, k = sample.shape[0], self.n_centroids
        rng = np.random.default_rng(seed)
        init = [rng.choice(t, size=k, replace=t < k) for _ in range(m)]

        def train(s):
            x = np.ascontiguousarray(
                sample[:, s * self.sub_dim:(s + 1) * self.sub_dim])
            cent = x[init[s]].copy()
            for _ in range(max(1, int(iters))):
                assign = self._nearest(x, *self._scaled(cent))
                # k <= 256: a stable sort of uint8 keys is a radix sort
                order = np.argsort(assign.astype(np.uint8), kind="stable")
                members = x[order]
                bounds = np.searchsorted(assign[order], np.arange(k + 1))
                for c in range(k):
                    lo, hi = bounds[c], bounds[c + 1]
                    if hi > lo:
                        cent[c] = members[lo:hi].mean(axis=0)
            return cent

        with ThreadPoolExecutor(min(m, os.cpu_count() or 1)) as pool:
            self._set_codebooks(np.stack(list(pool.map(train, range(m)))))

    @staticmethod
    def _scaled(cent: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(-2 cent.T, c^2)`` of a codebook, :meth:`_nearest`'s
        operands."""
        return np.ascontiguousarray(-2.0 * cent.T), \
            (cent * cent).sum(-1)[None, :]

    @staticmethod
    def _nearest(x: np.ndarray, neg2_t: np.ndarray,
                 c2: np.ndarray) -> np.ndarray:
        # ||x - c||^2 up to the x^2 term; argmin takes the first of ties.
        # x @ (-2 c).T is -2 (x @ c.T) to the bit (a power of two scales
        # every product and sum exactly), and c^2 + (-2 x.c) is
        # c^2 - 2 x.c to the bit
        d = x @ neg2_t
        d += c2
        return np.argmin(d, axis=1)

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        cb = self._require_fit()
        return {"kind": "pq", "sub_dim": self.sub_dim,
                "n_centroids": self.n_centroids, "shape": list(cb.shape),
                "codebooks": cb.tobytes()}

    def load_state_dict(self, state: dict) -> None:
        if not state or state.get("kind") != "pq":
            raise ValueError(f"pq codec expects codec_state kind 'pq', got "
                             f"{state!r}")
        self.sub_dim = int(state["sub_dim"])
        self.n_centroids = int(state["n_centroids"])
        self._set_codebooks(np.frombuffer(state["codebooks"], np.float32)
                            .reshape(tuple(state["shape"])))

    # -- codec API -----------------------------------------------------------
    def stream_group(self, group: str, dim: int) -> dict:
        _only_reps(group)
        return {group: (np.dtype(np.uint8), (self._n_sub(dim),))}

    def encode_group(self, group: str, x: np.ndarray) -> dict:
        _only_reps(group)
        cb = self._require_fit()
        x = np.asarray(x, np.float32)
        m = self._n_sub(x.shape[-1])
        if m != cb.shape[0]:
            raise ValueError(f"pq codec fitted for rep_dim="
                             f"{cb.shape[0] * self.sub_dim} but encode got "
                             f"rep_dim={x.shape[-1]}")
        sub = x.reshape(-1, m, self.sub_dim)
        codes = np.empty((sub.shape[0], m), np.uint8)
        for s in range(m):
            codes[:, s] = self._nearest(sub[:, s], *self._operands[s])
        return {group: codes.reshape(*x.shape[:-1], m)}

    def _flat_on(self, device) -> torch.Tensor:
        """The ``[m * k, sub_dim]`` codebook on ``device``, copied once."""
        flat = self._on_device.get(device)
        if flat is None:
            cb = self._require_fit()
            flat = torch.tensor(cb.reshape(-1, cb.shape[2]), device=device)
            self._on_device[device] = flat
        return flat

    def decode_group(self, group: str, parts):
        codes = parts[group]
        m, k, sub = self._require_fit().shape
        if isinstance(codes, torch.Tensor):
            flat = self._flat_on(codes.device)
            idx = codes.long() + torch.arange(m, device=codes.device) * k
            out = flat[idx]
        else:
            idx = codes.astype(np.int64) + np.arange(m, dtype=np.int64) * k
            out = self.codebooks.reshape(m * k, sub)[idx]
        return out.reshape(*codes.shape[:-1], m * sub)
