"""Nested trees of tensors (dicts, lists and tuples, as the port's
parameter, gradient and optimizer-state trees are): what the training and
checkpoint code need of ``jax.tree_util``. A dict's entries are visited in
sorted key order, as JAX flattens dicts; a list's or tuple's in order.
Anything else is a leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """The leaves in order, each with its path (``"layers/0/attn/wq"``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in leaves_with_paths(sub, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, new: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in order, by ``new``."""
    it = iter(new)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(s) for s in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    if any(len(o) != len(mine) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(mine, *others)])
