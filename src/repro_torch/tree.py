"""Key-sorted flatten/unflatten of nested dict/list/tuple param trees.

JAX flattens a dict in SORTED key order; ``torch.utils._pytree`` keeps
insertion order.  The bucket layout's segment order, every segment's
offset and every leaf-path salt follow the flatten order, so the port
flattens exactly like JAX: dict keys sorted, sequences in order, ``None``
an empty subtree.  A path is the tuple of dict keys / sequence indices
from the root; :func:`path_name` joins it with ``/`` like
``repro.dist.layout.leaf_path_name``.
"""
from __future__ import annotations

from typing import Any, List, Tuple


class TreeDef:
    """Structure of a tree: nested ``("dict", keys, children)`` /
    ``("list"|"tuple", n, children)`` / ``("leaf",)`` / ``("none",)``."""

    def __init__(self, node):
        self.node = node

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self.node == other.node

    def __repr__(self) -> str:
        return f"TreeDef({self.node!r})"


def _flatten(tree, path, out):
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], path + (k,), out) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, len(tree),
                tuple(_flatten(c, path + (i,), out)
                      for i, c in enumerate(tree)))
    out.append((path, tree))
    return ("leaf",)


def flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in JAX's flatten order."""
    out: list = []
    node = _flatten(tree, (), out)
    return out, TreeDef(node)


def flatten(tree) -> Tuple[list, TreeDef]:
    pairs, td = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], td


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(treedef: TreeDef, leaves_in) -> Any:
    it = iter(leaves_in)

    def build(node):
        if node[0] == "leaf":
            return next(it)
        if node[0] == "none":
            return None
        if node[0] == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        kids = [build(c) for c in node[2]]
        return kids if node[0] == "list" else tuple(kids)

    out = build(treedef.node)
    rest = list(it)
    if rest:
        raise ValueError(f"unflatten got {len(rest)} leaves too many")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), same structure back."""
    lv, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(lv, *others)])


def path_name(path) -> str:
    """'/'-joined leaf path: the name scheme of the layout segments and
    of the JAX package's checkpoint keys."""
    return "/".join(str(p) for p in path)
