"""Pytrees of tensors in ``jax.tree``'s leaf order.

The port keeps parameters, gradients and optimizer states as the JAX
package does: nested dicts, lists, tuples and NamedTuples with tensors at
the leaves.  ``flatten`` visits them in ``jax.tree.flatten``'s order
(dict keys sorted, sequences and NamedTuple fields in order, ``None`` an
empty subtree), so a leaf's index means the same leaf in both packages:
checkpoints (``leaf_<i>``) and optimizer updates depend on it.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(t, leaves: List[Any]):
    if t is None:
        return None
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, keys, [_walk(t[k], leaves) for k in keys])
    if _is_namedtuple(t) or isinstance(t, (list, tuple)):
        return (type(t), None, [_walk(c, leaves) for c in t])
    leaves.append(t)
    return "leaf"


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; ``unflatten(spec, leaves)`` rebuilds the tree.

    The recursion is a module-level function, not a closure: a recursive
    closure is a reference cycle, which would keep the leaves alive until
    the garbage collector runs."""
    leaves: List[Any] = []
    spec = _walk(tree, leaves)
    return leaves, spec


def _build(s, it):
    if s is None:
        return None
    if s == "leaf":
        return next(it)
    kind, keys, children = s
    built = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(keys, built))
    if kind in (list, tuple):
        return kind(built)
    return kind(*built)                          # NamedTuple


def unflatten(spec, leaves) -> Any:
    it = iter(leaves)
    out = _build(spec, it)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree of {len(o)} leaves against {len(flat)}")
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])


def tree_map_with_path(fn: Callable, tree, path: Tuple[Any, ...] = ()) -> Any:
    """``fn(path, leaf)`` over the leaves, ``path`` the tuple of dict keys
    and sequence indices (NamedTuple field names) from the root, as
    ``jax.tree_util.tree_map_with_path`` gives them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
