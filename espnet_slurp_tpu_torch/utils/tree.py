"""``tree_map`` over the nested dicts, lists and tuples of tensors that the
decode hooks carry as state (a Transformer LM's cache, an LSTM's carry, the
word-level fusions' states), in place of jax.tree.map."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)
