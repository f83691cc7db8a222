"""Checkpoint store, the port of ``repro.checkpoint.store`` in its on-disk
format, byte for byte.

Layout: ``<dir>/step_<NNNNNNNN>/`` holds one raw buffer a leaf
(``leaf_<NNNNN>.bin``, leaves in pytree order: dict keys sorted, list
items in order) and ``MANIFEST.msgpack``: ``{"step", "leaves": [{"key",
"file", "shape", "dtype", "crc32"}]}`` with ``key`` the "/"-joined path,
``dtype`` numpy's ``dtype.str`` and ``crc32`` zlib's over the buffer.  A
bf16 leaf is stored as the JAX store stores one: raw 2-byte words with
``dtype.str`` ``'<V2'``; the reader takes them back as bf16 when the
target leaf is bf16.

* **Atomicity** -- a step is written to ``step_<N>.tmp``, each file
  fsynced, then renamed: a crash mid-write never leaves a readable torn
  step.
* **Corruption detection** -- every leaf's crc32 is checked on restore,
  which walks back past a corrupt or torn step to the previous one.
* **Async** -- :class:`AsyncCheckpointer` copies the tree to host memory
  before ``save`` returns and writes on a background thread.

The manifest is written and read with the port's own msgpack
(``repro_torch/index/_msgpack.py``).
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.index import _msgpack
from repro_torch.tree import leaves_with_paths, map_with_paths, tree_map

_SENTINEL = "MANIFEST.msgpack"
#: the JAX store's ``dtype.str`` of a bf16 leaf (ml_dtypes' bfloat16)
BF16_STR = "<V2"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _host_bytes(leaf) -> tuple[bytes, list[int], str]:
    """A leaf's raw buffer, shape and ``dtype.str``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    BF16_STR)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), arr.dtype.str


def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Blocking save of ``tree`` (nested dicts / lists of tensors or
    arrays) as step ``step``.  Returns the step's directory."""
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(leaves_with_paths(tree)):
        data, shape, dtype = _host_bytes(leaf)
        fname = f"leaf_{i:05d}.bin"
        _fsync_write(os.path.join(tmp, fname), data)
        manifest["leaves"].append({"key": key, "file": fname, "shape": shape,
                                   "dtype": dtype,
                                   "crc32": zlib.crc32(data)})
    _fsync_write(os.path.join(tmp, _SENTINEL), _msgpack.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    """Every ``step_<N>`` directory's step, complete or not, ascending."""
    return sorted({int(m.group(1)) for m in
                   (re.fullmatch(r"step_(\d+)", n)
                    for n in os.listdir(ckpt_dir)) if m})


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step whose manifest exists, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in list_steps(ckpt_dir)
             if os.path.exists(os.path.join(_step_dir(ckpt_dir, s),
                                            _SENTINEL))]
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(_step_dir(ckpt_dir, step), _SENTINEL), "rb") as f:
        return _msgpack.unpackb(f.read())


def read_leaf(ckpt_dir: str, step: int, meta: dict) -> bytes:
    """One leaf's buffer, its crc32 checked (``OSError`` on a mismatch)."""
    with open(os.path.join(_step_dir(ckpt_dir, step), meta["file"]),
              "rb") as f:
        data = f.read()
    if zlib.crc32(data) != meta["crc32"]:
        raise OSError(f"checksum mismatch for {meta['key']} at step {step}")
    return data


def leaf_array(data: bytes, meta: dict) -> np.ndarray:
    """A leaf's buffer as a writable numpy array of its shape; a bf16
    leaf (``'<V2'``) as its raw 2-byte words (uint16)."""
    dtype = np.uint16 if meta["dtype"] in (BF16_STR, "|V2") \
        else np.dtype(meta["dtype"])
    return np.frombuffer(data, dtype=dtype).reshape(meta["shape"]).copy()


def _to_tensor(data: bytes, meta: dict, target):
    arr = leaf_array(data, meta)
    device = target.device if isinstance(target, torch.Tensor) else "cpu"
    if meta["dtype"] in (BF16_STR, "|V2"):
        if not (isinstance(target, torch.Tensor)
                and target.dtype == torch.bfloat16):
            raise ValueError(f"{meta['key']}: a 2-byte void leaf restores "
                             f"only into a bf16 target")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(arr).to(device)


def _load_step(ckpt_dir: str, step: int, target):
    manifest = read_manifest(ckpt_dir, step)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    # every leaf is read and checked before any is used
    loaded = {key: _to_tensor(read_leaf(ckpt_dir, step, by_key[key]),
                              by_key[key], leaf)
              for key, leaf in leaves_with_paths(target)}
    return map_with_paths(lambda key, _: loaded[key], target), \
        manifest["step"]


def load_newest(ckpt_dir: str, load):
    """``load(step)`` of the newest step it reads without error, walking
    back past corrupt or torn steps; None when no step is readable."""
    if not os.path.isdir(ckpt_dir):
        return None
    for step in reversed(list_steps(ckpt_dir)):
        try:
            return load(step)
        except (OSError, KeyError, ValueError) as e:  # corrupt / torn step
            print(f"[ckpt] step {step} unusable ({e}); trying previous")
    return None


def restore_checkpoint(ckpt_dir: str, target):
    """Restore the latest *valid* checkpoint into ``target``'s structure
    (each leaf on its target leaf's device, in its stored dtype); walks
    back past corrupt or torn steps.  Returns ``(tree, step)``, or
    ``(target, None)`` when there is none."""
    got = load_newest(ckpt_dir,
                      lambda step: _load_step(ckpt_dir, step, target))
    return (target, None) if got is None else got


def _host_snapshot(tree):
    """A copy of ``tree`` on the host: every tensor copied to the CPU
    (waiting for the device), so later in-place updates cannot reach
    it."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else np.array(x), tree)


class AsyncCheckpointer:
    """Snapshot to host, write on a daemon thread; at most one write in
    flight, and the newest ``keep`` steps kept."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self):
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree):
        """Copy ``tree`` to the host now, then write it as step ``step``
        in the background."""
        self.wait()
        host_tree = _host_snapshot(tree)

        def _write():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree)
                self._gc()
            except Exception as e:       # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in list_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(_step_dir(self.ckpt_dir, s), ignore_errors=True)
