"""Nested containers of tensors (the port's pytrees).

Parameters and caches are nested ``dict``s and ``list``s with tensors at
the leaves, laid out exactly as the reference's pytrees, so a reference
tree converts leaf for leaf (``repro_torch.convert``)."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` (and same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_items(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's flatten order: dict keys sorted,
    lists and tuples by index; a path holds the keys and indices from the
    root. Sums over leaves follow this order to round as the reference's
    do, and checkpoints name leaves by it."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]
