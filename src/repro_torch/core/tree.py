"""Nested dict / list / tuple trees of tensors: the port's parameter,
gradient and optimizer-state containers (the reference's pytrees)."""

from __future__ import annotations


def leaves(tree) -> list:
    """Every leaf in traversal order (dicts in insertion order); None is an
    empty subtree, as in a JAX pytree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def map_(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a tree of the results, lists
    for lists and tuples (a named tuple keeps its type)."""
    return _walk(lambda x, _key, *r: fn(x, *r), tree, rest, None)


def map_keyed(fn, tree):
    """:func:`map_` with ``fn(leaf, key)``: ``key`` is the dict key
    nearest above the leaf (None at the root), which picks a leaf's
    dtype or layout by its name."""
    return _walk(fn, tree, (), None)


def _walk(fn, tree, rest, key):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, [r[k] for r in rest], k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_walk(fn, v, [r[i] for r in rest], key)
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else out
    return None if tree is None else fn(tree, key, *rest)


def unflatten(tree, flat):
    """``tree``'s structure with its leaves replaced, in :func:`leaves`
    order, by the entries of ``flat``."""
    it = iter(flat)
    return map_(lambda _leaf: next(it), tree)
