"""Nested containers of tensors ("trees"), the port's counterpart of
``jax.tree``.

A tree is a dict, list, tuple or NamedTuple of trees, or a leaf (anything
else: a tensor, a numpy array, a number). Leaves are visited in the order
that JAX flattens: dict keys sorted, sequences and NamedTuple fields in
order. ``named_leaves`` names each leaf as ``jax.tree_util.keystr`` does
(``.params['w']``, ``.opt_state['w'].m``, ``[0]``), so a checkpoint index
written by one package names the same arrays in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _walk(tree, name: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{name}[{k!r}]")
    elif _is_namedtuple(tree):
        for field, x in zip(tree._fields, tree):
            yield from _walk(x, f"{name}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, f"{name}[{i}]")
    else:
        yield name, tree


def named_leaves(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flattening order, named as
    ``jax.tree_util.keystr`` names them."""
    return list(_walk(tree, ""))


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in _walk(tree, "")]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure whose leaves are ``leaves``, in
    ``tree_leaves(like)`` order."""
    it = iter(leaves)

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(tree[k]) for k in sorted(tree)}
        if _is_namedtuple(tree):
            return type(tree)(*(take(x) for x in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(take(x) for x in tree)
        return next(it)

    return take(like)
