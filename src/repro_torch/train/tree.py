"""Pytrees of the port: nested dicts whose leaves are tensors (or numpy
arrays, Python numbers). Traversal is in sorted key order, as JAX
flattens a dict, so a sum over the leaves adds them in the reference's
order, and a leaf's key is its "/"-joined path, as the reference's
checkpoints name it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

SEP = "/"


def items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in sorted key order; a non-dict tree is one leaf
    under the key ``prefix``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}{SEP}{k}" if prefix
                             else str(k))
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def unflatten(keys: Sequence[str], values: Sequence[Any]) -> Dict:
    """The nested dict whose ``items`` are ``zip(keys, values)``."""
    out: Dict = {}
    for key, value in zip(keys, values):
        *path, last = key.split(SEP)
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the nodes at the same paths of
    ``rest`` (whatever they hold there: a leaf, or a subtree such as
    Adafactor's {"vr", "vc"})."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
