"""Pytrees of nested dicts, lists and tuples, flattened in
``jax.tree_util``'s order, in pure Python.

The optimizer walks params, gradients and moments leaf by leaf in one
order, and the checkpoint manager stores leaves as ``leaf_{i}`` in the
order the JAX manager uses (``repro/checkpoint/manager.py``): dict keys
sorted, lists and tuples in order, ``None`` no leaf (an empty subtree),
anything else one leaf. A treedef here is a nested tuple that
``unflatten`` reads back.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "flatten_with_path", "leaves", "unflatten",
           "tree_map", "describe"]

Path = Tuple[Any, ...]


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[Path, Any]], Any]:
    """([(path, leaf), ...], treedef): a path holds the dict keys and the
    list or tuple indices from the root to the leaf."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys),
                    tuple(walk(node[k], path + (k,)) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node),
                    tuple(walk(v, path + (i,)) for i, v in enumerate(node)))
        if node is None:
            return ("none",)
        out.append((path, node))
        return ("leaf",)

    treedef = walk(tree, ())
    return out, treedef


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in ``jax.tree_util.tree_flatten``'s order."""
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: Any, new_leaves: List[Any]) -> Any:
    """The tree of ``treedef`` with ``new_leaves`` in flatten order."""
    it = iter(new_leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        children = [build(c) for c in node[2]]
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same structure."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def describe(treedef: Any) -> str:
    """A compact string of a treedef (kept in a checkpoint's meta)."""
    kind = treedef[0]
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {describe(c)}"
                               for k, c in zip(treedef[1], treedef[2])) + "}"
    inner = ", ".join(describe(c) for c in treedef[2])
    return f"[{inner}]" if kind == "list" else f"({inner})"
