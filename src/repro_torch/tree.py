"""Trees of tensors: nested dicts, lists and tuples, as the port keeps its
parameters and train state (the port's stand-in for ``jax.tree``)."""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map"]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure (dicts keep
    their key order, tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out
