"""Nested parameter trees: dicts, lists, tuples and registered
dataclasses (``register_node``) whose leaves are anything else (tensors,
specs, arrays).

Leaves come out in the reference's pytree order: dict keys sorted, lists
and tuples by index, a registered dataclass by its fields in order (the
order of a registered pytree class's children). ``named_leaves`` names
each leaf by its path, keys and indices joined with "/", as the
reference's checkpoint store names its files.
"""
from __future__ import annotations

import dataclasses

_NODES: set = set()


def register_node(cls):
    """Make the dataclass ``cls`` a container whose fields, in order, are
    its children (the reference's registered pytree classes)."""
    _NODES.add(cls)
    return cls


def _children(node):
    """[(key, child)] of a container in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if type(node) in _NODES:
        return [(i, getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, list):
        return list(children)
    if isinstance(node, tuple):
        return tuple(children)
    return type(node)(*children)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def named_leaves(tree, prefix: str = "") -> list:
    """[(path name, leaf)] in leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += named_leaves(child, f"{prefix}/{key}" if prefix else str(key))
    return out


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for _, c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which have its structure."""
    flat = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])
