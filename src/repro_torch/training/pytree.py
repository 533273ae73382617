"""The parameter trees' leaves in JAX's flatten order, and back: dicts by
sorted key, lists and tuples in order, anything else a leaf (a tuple
subclass too: a partition spec ``P`` is a leaf of a spec tree).  The
optimizer updates and the checkpoint stores leaves in this order, as the
reference does with ``jax.tree.flatten``."""
from __future__ import annotations

from typing import Any, Iterator, List


def leaves(tree) -> List[Any]:
    return list(_walk(tree))


def _walk(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif type(tree) in (list, tuple):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def unflatten(like, flat) -> Any:
    """A tree of ``like``'s structure holding ``flat`` (in flatten order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}      # keep like's key order
        if type(t) in (list, tuple):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out

