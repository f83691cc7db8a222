"""Per-rank counts of one traced step, the port's counterpart of
``repro.launch.hlo_analysis``.  The JAX package walks the compiled HLO of
a cell; the port has no HLO, so :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten and c10d op of a step as it
runs (on fake tensors in ``launch.dryrun``) and counts, for this rank:

* ``op_bytes``: the operand and result bytes of every aten op, views
  (which move no data) left out.  The ops are counted one by one, as
  eager PyTorch runs them, so this is an upper bound on the HBM traffic
  (the JAX package counts at fusion boundaries);
* ``collective_bytes``: the operand bytes of every c10d collective, by
  op (``allreduce_``, ``_allgather_base_``, ``allgather_``,
  ``_reduce_scatter_base_``, ``alltoall_base_``, ...): the tensor an
  all-reduce reduces, the block an all-gather sends, the whole input of a
  reduce-scatter or an all-to-all.  On a backend other than NCCL the
  sharded route's reduce-scatter is an all-reduce of the same operand;
* ``peak_live_bytes``: the peak of the bytes held by the storages the
  step's ops made, each counted from the op that made it until the last
  tensor on it is freed (the step's arguments are not among them).

The ops of a shape-only init that the step runs itself (the sharded
transformer's spec tree comes from an init of the whole model under a
fake mode of its own, which returns ``meta`` tensors) allocate nothing
on a device: given the ``FakeTensorMode`` of the trace, it leaves out the
ops of any other fake mode, and every op whose result is on ``meta``.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` beside it.
JAX's ``f32_upcast_artifact_bytes`` measures a rewrite that XLA makes on
the CPU; nothing here corresponds to it."""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the c10d ops whose operand is their second argument (the first is the
#: output)
_SECOND_OPERAND = ("allgather", "reduce_scatter", "alltoall")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _key(t) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched under it (module docstring)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.op_bytes = 0
        self.op_count = 0
        self.collective_bytes: dict[str, int] = {}
        self.collective_count = 0
        self.live = 0
        self.peak_live_bytes = 0
        self._refs: dict[int, list] = {}        # storage -> [bytes, tensors]

    def _release(self, key):
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _track(self, t, fresh: bool):
        key = _key(t)
        ref = self._refs.get(key)
        if ref is None:
            if not fresh:
                return                # a view or write of an argument
            ref = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ref[0]
            self.peak_live_bytes = max(self.peak_live_bytes, self.live)
        ref[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name()
        if name.startswith("c10d::"):
            op = name.split("::", 1)[1]
            operand = args[1] if any(s in op for s in _SECOND_OPERAND) \
                else args[0]
            n = sum(_nbytes(t) for t in _tensors(operand))
            self.collective_bytes[op] = self.collective_bytes.get(op, 0) + n
            self.collective_count += 1
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(t.device.type == "meta" or (
                self.fake_mode is not None and getattr(
                    t, "fake_mode", self.fake_mode) is not self.fake_mode)
               for t in outs):
            return out
        view = getattr(func, "is_view", False)
        if not view:
            self.op_count += 1
            self.op_bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        in_keys = {_key(t) for t in ins}
        for t in outs:
            self._track(t, not view and _key(t) not in in_keys)
        return out

    def summary(self) -> dict:
        coll = dict(self.collective_bytes)
        return {"op_bytes": self.op_bytes, "op_count": self.op_count,
                "collective_bytes": {**coll, "total": sum(coll.values()),
                                     "count": self.collective_count},
                "peak_live_bytes": self.peak_live_bytes}
