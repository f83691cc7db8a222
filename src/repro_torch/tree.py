"""Nested dicts and lists of tensors (the port's params, optimizer state
and checkpoints), walked in the JAX package's pytree order: dict keys
sorted, list items in order, ``None`` an empty subtree.

Keys are JAX's ``tree_flatten_with_path`` keys joined with "/": a dict
entry by its key, a list item by its index, as
``repro.checkpoint.store._flatten`` writes them.
"""
from __future__ import annotations


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(key, leaf), ...]`` in pytree order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves_with_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def leaves(tree) -> list:
    """The leaves in pytree order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_paths(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` over the leaves; the result has ``tree``'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, f"{prefix}/{i}" if prefix
                                         else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
