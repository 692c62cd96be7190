"""The port's state trees: nested dicts, lists and tuples (a NamedTuple
such as ``optim.OptState`` too) of tensors, with None for an empty
subtree (adafactor's first moment).

Leaves are visited in the JAX package's order: dict keys sorted, list,
tuple and NamedTuple entries in order, None skipped.  A leaf's path joins
its keys, indices and NamedTuple field names with '/'.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves_with_paths", "leaves", "tree_map", "unflatten"]


def _children(node) -> list:
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuild(node, values: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


def leaves_with_paths(tree: Any, path: str = "") -> Iterator[tuple]:
    """``(path, leaf)`` for every leaf of ``tree``."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from leaves_with_paths(v, f"{path}/{k}" if path else k)


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` over ``tree``'s leaves; each tree in ``rest``
    has ``tree``'s structure down to its leaves, where it may hold a
    subtree (adafactor's ``(row, col)`` second moment), passed whole."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, v, *(o[i][1] for o in others))
        for i, (_, v) in enumerate(kids)])


def unflatten(template: Any, values: list) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``values``."""
    n = len(leaves(template))
    if n != len(values):
        raise ValueError(f"{len(values)} values for a template of {n} "
                         "leaves")
    it = iter(values)
    return tree_map(lambda _: next(it), template)
