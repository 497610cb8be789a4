"""Log-depth inclusive scan over one axis (stands in for
``jax.lax.associative_scan``, which PyTorch lacks).

Hillis-Steele doubling: after the pass with offset d, element i holds the
combination of elements (i - 2d, i]; ceil(log2 n) passes cover the axis.
Each pass is a few whole-tensor ops, so a scan over the ~4.2k anchor slots of
an utterance is ~13 passes, not 4.2k Python steps.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

Elems = Tuple[torch.Tensor, ...]


def associative_scan(fn: Callable[[Elems, Elems], Elems], elems: Elems,
                     dim: int = 0, reverse: bool = False) -> Elems:
    """Inclusive scan of ``fn`` over ``dim`` for a tuple of same-shape
    tensors.

    ``fn(l, r)`` combines an earlier block ``l`` with a later block ``r``
    and must be associative.  ``reverse=True`` flips, scans, and flips back
    with the same ``fn`` (as jax.lax.associative_scan does), so ``l`` then
    holds the block of higher original index.
    """
    if reverse:
        out = associative_scan(fn, tuple(e.flip(dim) for e in elems), dim)
        return tuple(o.flip(dim) for o in out)
    elems = tuple(elems)
    n = elems[0].shape[dim]
    d = 1
    while d < n:
        left = tuple(e.narrow(dim, 0, n - d) for e in elems)
        right = tuple(e.narrow(dim, d, n - d) for e in elems)
        comb = fn(left, right)
        elems = tuple(torch.cat([e.narrow(dim, 0, d), c], dim=dim)
                      for e, c in zip(elems, comb))
        d *= 2
    return elems


def _add(l: Elems, r: Elems) -> Elems:
    return (l[0] + r[0],)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.cumsum, except on a floating CUDA tensor while deterministic
    algorithms are on (``torch.use_deterministic_algorithms``), where
    PyTorch's CUDA cumsum raises: there the log-depth ``associative_scan``
    of additions, which sums in a fixed order (another order than
    torch.cumsum's, so its roundings differ)."""
    if x.is_cuda and (x.is_floating_point() or x.is_complex()) and \
            torch.are_deterministic_algorithms_enabled():
        return associative_scan(_add, (x,), dim)[0]
    return torch.cumsum(x, dim=dim)
