"""Parameter trees: nested dicts, lists and (named) tuples of tensors.

The JAX package's parameters are pytrees, and the simulator's flat (m, D)
rows concatenate their leaves in ``jax.tree.leaves`` order.  These helpers
walk a tree in that order: a dict's keys sorted at each level, a list's or
tuple's items by index, and an empty dict contributing nothing.  Sorting
joined path strings would not do: ``stages/10`` sorts before ``stages/2``.
"""
from __future__ import annotations


def _named(node) -> bool:
    return hasattr(node, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and (named) tuples;
    the result keeps ``tree``'s structure (and its dicts' key order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if _named(tree) else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves``, taken in
    ``tree_leaves`` order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [build(item) for item in node]
            return type(node)(*items) if _named(node) else type(node)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def first_leaf(tree):
    return tree_leaves(tree)[0]
