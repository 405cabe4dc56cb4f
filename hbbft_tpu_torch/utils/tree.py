"""Nested-tuple helpers: the port's stand-in for ``jax.tree_util``.

Field elements are tensors; tower elements and curve points are nested
tuples of them (fq2 = (c0, c1), fq6 = three fq2, a Jacobian point =
(X, Y, Z, inf)).  These helpers map a function over such trees and run
JAX's parallel prefix scan over a leading axis with the same pairing
order, so a scan here combines exactly the operands JAX's would.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf-wise over identically shaped nested tuples/lists."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_stack(trees, dim: int = 0) -> Any:
    """Stack identical-structure trees along a new axis ``dim``."""
    return tree_map(lambda *cs: torch.stack(cs, dim=dim), *trees)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a at even and b at odd positions of axis 0 (len(a) - len(b) ∈ {0, 1})."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]))
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn: Callable, elems: Any, reverse: bool = False) -> Any:
    """Inclusive scan of ``fn`` along axis 0 of every leaf — the same
    odd/even recursion as ``jax.lax.associative_scan``, so each output is
    built from the same operand pairs in the same order."""
    if reverse:
        elems = tree_map(lambda c: torch.flip(c, dims=(0,)), elems)

    def scan(el):
        n = tree_leaves(el)[0].shape[0]
        if n < 2:
            return el
        reduced = fn(
            tree_map(lambda c: c[0:-1:2], el), tree_map(lambda c: c[1::2], el)
        )
        odd = scan(reduced)
        tail = tree_map(lambda c: c[2::2], el)
        if n % 2 == 0:
            even = fn(tree_map(lambda c: c[:-1], odd), tail)
        else:
            even = fn(odd, tail)
        even = tree_map(lambda c, e: torch.cat([c[:1], e], dim=0), el, even)
        return tree_map(_interleave, even, odd)

    out = scan(elems)
    if reverse:
        out = tree_map(lambda c: torch.flip(c, dims=(0,)), out)
    return out
