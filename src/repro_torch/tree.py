"""Nested containers of tensors ("trees"), flattened in the reference's order.

The reference walks parameter, optimizer and checkpoint trees with
``jax.tree``: a dict's children in sorted key order, a list's or a tuple's in
order, ``None`` an empty node, anything else a leaf.  Checkpoint leaves
(``a0``, ``a1``, ...) and the treedef string in a checkpoint's manifest follow
that order, so the port flattens the same way and renders the same string.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_flatten", "tree_unflatten", "tree_map", "tree_leaves", "treedef_str"]


def _children(node: Any) -> list[Any] | None:
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def tree_leaves(tree: Any) -> list[Any]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_flatten(tree: Any) -> tuple[list[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` is the tree with each leaf replaced
    by ``...`` (``Ellipsis``)."""

    def skeleton(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: skeleton(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(skeleton(x) for x in node)
        return ...

    return tree_leaves(tree), skeleton(tree)


def tree_unflatten(treedef: Any, leaves: list[Any]) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        if node is None:
            return None
        if node is ...:
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(x) for x in node)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def treedef_str(tree: Any) -> str:
    """``str(jax.tree.flatten(tree)[1])`` for ``tree``: ``PyTreeDef({'a': *,
    'b': [*, (*,)], 'n': None})``."""

    def render(node: Any) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {render(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(render(x) for x in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(render(x) for x in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({render(tree)})"
