"""Nested-container trees of tensors (the part of ``jax.tree`` the port
uses).

A tree is a tensor (or any other leaf), a dict, a list or a tuple of
trees. Leaves are ordered as ``jax.tree.flatten`` orders them: dict keys
sorted, lists and tuples in order, depth first. That order decides the
exchange plan's leaf ids and bucket membership, so the port's buckets and
drop masks fall on the same elements as the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

TreeDef = Any


def _flatten(x: Any, out: List[Any]) -> TreeDef:
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(x[k], out)) for k in sorted(x)))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(v, out) for v in x))
    out.append(x)
    return None


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """(leaves in jax order, treedef). Module-level recursion, not a
    nested closure: a self-referencing closure would hold the leaves in a
    reference cycle until the garbage collector runs, and with them a
    whole stack of model replicas."""
    out: List[Any] = []
    return out, _flatten(tree, out)


def _unflatten(d: TreeDef, it) -> Any:
    if d is None:
        return next(it)
    kind, kids = d
    if kind is dict:
        return {k: _unflatten(c, it) for k, c in kids}
    return kind(_unflatten(c, it) for c in kids)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """Inverse of :func:`flatten`."""
    return _unflatten(treedef, iter(leaves))


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` over corresponding leaves of trees of one structure."""
    lv, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(lv, *others)])
