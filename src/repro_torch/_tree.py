"""Parameter trees: nested dicts (and lists) of tensors, the port's
stand-in for JAX pytrees.  Leaves are visited in sorted-key order, as
``jax.tree`` visits a dict.  A tuple is a leaf, so trees of logical axes
(tuples of names) map like trees of tensors."""

from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in flattening order; paths join keys with "/"."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, flat: list):
    """A tree of ``tree``'s structure with the leaves of ``flat``, in
    flattening order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)
