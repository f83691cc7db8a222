"""Ambient sharding rules, the port of ``repro.dist.context``.

Code runs under ``install_rules(rules)``; model code deep in the call
stack asks :func:`current_rules` instead of threading a mesh through
every signature.  Outside any installed rules every hook is a no-op, so
the same model code runs unchanged on one device.
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.dist.sharding import ShardingRules

_STATE = threading.local()


def _stack() -> list:
    st = getattr(_STATE, "stack", None)
    if st is None:
        st = _STATE.stack = []
    return st


def current_rules() -> ShardingRules | None:
    """The innermost installed :class:`ShardingRules` of this thread, or
    None."""
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def install_rules(rules: ShardingRules):
    """Install ``rules`` as the ambient sharding rules (re-entrant; the
    previous rules come back on exit, on error too)."""
    st = _stack()
    st.append(rules)
    try:
        yield rules
    finally:
        st.pop()


def maybe_shard(x, logical_axes):
    """``x`` unchanged.  In JAX this is a sharding constraint that GSPMD
    honours; under the port's explicit SPMD a rank already holds its own
    rows, so there is nothing to constrain."""
    del logical_axes
    return x
