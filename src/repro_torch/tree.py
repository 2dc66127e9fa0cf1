"""Parameter trees: nested dicts, lists and tuples of tensors, walked in the
order JAX flattens the reference's pytrees.

A dict's keys go in sorted order, a list's or plain tuple's items by index,
a named tuple's fields by declaration (``AdamWState``: step, mu, nu).  A
leaf's path joins those keys with ``/``, a named tuple's field as
``.name``, as ``jax.tree_util.tree_flatten_with_path`` spells them in the
reference's checkpoints (``opt/.mu/tables/0``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's flattening order."""
    def join(key):
        return f"{prefix}{SEP}{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in leaves_with_paths(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields
                for pair in leaves_with_paths(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in leaves_with_paths(v, join(i))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(like, values: List[Any]):
    """``like``'s structure filled with ``values`` in flattening order."""
    it = iter(values)
    return tree_map(lambda _: next(it), _ordered(like))


def _ordered(tree):
    # a copy of the structure whose dicts iterate in sorted key order, so
    # tree_map visits leaves in flattening order
    if isinstance(tree, dict):
        return {k: _ordered(tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_ordered(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ordered(v) for v in tree)
    return tree
