"""Tree helpers shared by the optimizers, the trainer and checkpointing
(port of :mod:`repro.utils.tree`).

A tree is a tensor, a dict, list or tuple of trees, or an ``nn.Module``,
which stands for the dict of its parameters by qualified name
(``layers.0.attn.wq``).  Other leaves (ints, None) are not arrays and are
skipped, as the reference's helpers skip leaves without a shape.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch


def _node(tree: Any) -> Any:
    """A module as the dict of its parameters; anything else unchanged."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return tree


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(qualified name, tensor) for every tensor leaf, in the tree's order;
    dict keys and sequence positions are joined with ``.``."""
    tree = _node(tree)
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}.{i}" if prefix else str(i))


def tree_leaves(tree: Any) -> list:
    return [t for _, t in named_leaves(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of ``tree`` and the matching leaves of
    ``rest``; a module maps to a dict keyed by parameter name."""
    tree = _node(tree)
    rest = tuple(_node(r) for r in rest)
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return tree


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves (``meta`` tensors too)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_params(tree: Any) -> int:
    """Total element count of all tensor leaves."""
    return sum(t.numel() for t in tree_leaves(tree))


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def tree_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every leaf is finite.  On the leaves' device, with
    no read on the host."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()
