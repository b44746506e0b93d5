"""Trees: nested dicts, lists and tuples of tensors, the port's pytrees.

The JAX package keeps params, optimizer state and batches as pytrees and
walks them with ``jax.tree_util``. The port keeps the same nested dicts
of tensors. These helpers walk them in JAX's order: a dict's keys
sorted, a sequence's items in turn. A leaf is anything that is not a
dict, list or tuple (or what ``is_leaf`` accepts), so a sharding spec,
a tuple, is a leaf only where ``is_leaf`` says so.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Path = Tuple[Any, ...]


def _children(tree) -> Optional[list]:
    """``(key, child)`` pairs of a container in JAX's order, else None."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_leaves_with_path(tree, is_leaf: Optional[Callable] = None
                          ) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs; a path is the tuple of dict keys and
    sequence indices from the root."""
    out = []

    def walk(node, path):
        kids = None if is_leaf is not None and is_leaf(node) \
            else _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(tree, ())
    return out


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def tree_map_with_path(fn: Callable, tree, *rest,
                       is_leaf: Optional[Callable] = None):
    """``fn(path, leaf, *leaves of rest)`` over ``tree``'s leaves; the
    other trees must have ``tree``'s structure. Dicts keep their key
    order."""

    def walk(node, others, path):
        if (is_leaf is not None and is_leaf(node)) or \
                _children(node) is None:
            return fn(path, node, *others)
        if isinstance(node, dict):
            return {k: walk(v, [o[k] for o in others], path + (k,))
                    for k, v in node.items()}
        return type(node)(walk(v, [o[i] for o in others], path + (i,))
                          for i, v in enumerate(node))

    return walk(tree, list(rest), ())


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn(leaf, *leaves of rest)`` over ``tree``'s leaves."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest,
                              is_leaf=is_leaf)


def path_key(path: Path, sep: str = "/") -> str:
    """A path as the JAX package's checkpoint key (``"layers/attn/wq"``)."""
    return sep.join(str(k) for k in path)
