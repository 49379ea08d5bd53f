"""Pytree helpers for the port's parameter and optimizer-state trees:
nested dicts, lists, tuples and NamedTuples of tensors.  Leaves are
visited in ``jax.tree_util`` order (dict keys sorted), so sums over
leaves add in the reference's order."""

from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(key, child)] of an inner node in traversal order, else None."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, children: dict):
    if isinstance(node, dict):
        return {k: children[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(children[f] for f in node._fields))
    return type(node)(children[i] for i in range(len(node)))


def tree_leaves_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] with ``path`` a tuple of dict keys, field names and
    sequence indices."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, child in kids:
        out.extend(tree_leaves_with_path(child, path + (k,)))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` in traversal order."""
    it = iter(leaves)

    def go(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, {k: go(child) for k, child in kids})

    out = go(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure); ``is_leaf`` stops the descent at matching nodes."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    return _rebuild(tree, {
        k: tree_map(fn, child, *(r[k] if isinstance(r, dict) else
                                 getattr(r, k) if _is_namedtuple(r) else
                                 r[k] for r in rest), is_leaf=is_leaf)
        for k, child in kids})
