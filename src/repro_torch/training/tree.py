"""Parameter and state trees: the port's stand-in for ``jax.tree``.

A tree is a dict, NamedTuple, tuple or list whose items are trees or
leaves (tensors, arrays, None).  Every function walks dicts in insertion
order and the others by position, so the leaves of trees with one
structure line up.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    """(key, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuild(like, values: List):
    """An inner node of ``like``'s type holding ``values``."""
    if isinstance(like, dict):
        return dict(zip(like.keys(), values))
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def leaves_with_path(tree, path: Tuple[str, ...] = ()) -> List[Tuple]:
    """(path, leaf) for every leaf of ``tree``, in order; a path is the
    tuple of keys (field names, positions) from the root."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, v in kids:
        out.extend(leaves_with_path(v, path + (k,)))
    return out


def leaves(tree) -> List:
    """The leaves of ``tree``, in order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [[v for _, v in _children(r)] for r in rest]
    return _rebuild(tree, [map_tree(fn, v, *(o[i] for o in others))
                           for i, (_, v) in enumerate(kids)])


def unflatten(like, flat: List):
    """The leaves ``flat`` (in ``leaves(like)`` order) nested as ``like``."""
    it = iter(flat)
    return map_tree(lambda _: next(it), like)
