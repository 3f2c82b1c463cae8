"""Nested dict/tuple trees of tensors: the port's stand-in for jax's pytree
calls.  Dict keys are visited in sorted order and sequences in order, as
``jax.tree.leaves`` visits them, so a leaf order (a global norm's sum) and
a leaf path (``"0/blocks/attn/wq"``, a checkpoint key) are the reference's.
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple

__all__ = ["items", "leaves", "tree_map", "path_key"]


def items(tree, path: Tuple = ()) -> Iterator[Tuple[tuple, object]]:
    """``(path, leaf)`` pairs in the reference's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from items(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the congruent ``rest``, called
    in ``items``' order; the result has ``tree``'s structure (dicts, tuples,
    lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)
