"""Nested dict/tuple trees of tensors: the port's stand-in for jax's pytree
calls.  Dict keys are visited in sorted order, NamedTuples (``KVCache``,
``SSMState``) by field name and other sequences in order, as
``jax.tree.leaves`` visits them, so a leaf order (a global norm's sum) and
a leaf path (``"0/blocks/attn/wq"``, a checkpoint key, ``"shared_kv/k"``)
are the reference's.  ``is_leaf`` stops a walk at a node, as jax's does
(a partition spec is a tuple).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

__all__ = ["items", "leaves", "tree_map", "tree_map_with_path", "path_key"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def items(tree, path: Tuple = (), is_leaf: Optional[Callable] = None
          ) -> Iterator[Tuple[tuple, object]]:
    """``(path, leaf)`` pairs in the reference's leaf order."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (k,), is_leaf)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from items(getattr(tree, name), path + (name,), is_leaf)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from items(v, path + (i,), is_leaf)
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map_with_path(fn: Callable, tree, *rest,
                       is_leaf: Optional[Callable] = None, path: Tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree`` and the
    congruent ``rest``, called in ``items``' order; the result has
    ``tree``'s structure (dicts, NamedTuples, tuples, lists)."""
    def sub(node, others, key):
        return tree_map_with_path(fn, node, *others, is_leaf=is_leaf,
                                  path=path + (key,))

    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: sub(tree[k], [r[k] for r in rest], k) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(sub(getattr(tree, n), [getattr(r, n) for r in rest],
                                n) for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(v, [r[i] for r in rest], i)
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the congruent ``rest``, called
    in ``items``' order; the result has ``tree``'s structure."""
    return tree_map_with_path(lambda _, *leaf: fn(*leaf), tree, *rest,
                              is_leaf=is_leaf)


def path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)
