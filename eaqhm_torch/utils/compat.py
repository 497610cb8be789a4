"""MATLAB-compatibility helpers mirroring the reference `misc` module.

The engine itself never needs these (its state is dense arrays + masks,
SURVEY.md §7), but users porting code written against the reference
(reference misc.py:13-165) should find the same surface here: the
`normalize` / `min_interp_size` constants, 1-D transposition helpers,
MATLAB-style `end`, scatter-by-index, container simplification, and the
recursive type predicates.  `ellip_filter` / `medfilt` re-export the
port's device implementations (`eaqhm_torch.ops.filters`,
`eaqhm_torch.ops.medfilt`), which return tensors and, like every entry
point of the port, run on CUDA unless given ``device="cpu"`` or a CPU
tensor.

CamelCase aliases match the reference names one-for-one so a
`from eaqhm_torch.utils.compat import *` is a drop-in for
`from misc import *`.
"""
from __future__ import annotations

import numbers
from typing import Any, Callable

import numpy as np

from eaqhm_torch.ops.filters import ellip_filter
from eaqhm_torch.ops.medfilt import medfilt

#: int16 full-scale divisor used for wav normalization (reference misc.py:13).
normalize = 32768

#: minimum anchors for kind=3 interpolation (reference misc.py:14).
min_interp_size = 4

__all__ = [
    "normalize", "min_interp_size",
    "transpose1d_array", "mytranspose", "end", "array_by_index",
    "singlelize", "apply_fn", "is_complex", "is_num", "is_container",
    "is_empty", "ellip_filter", "medfilt",
    # reference-name aliases
    "transpose1dArray", "arrayByIndex", "apply", "isComplex", "isNum",
    "isContainer", "isEmpty", "ellipFilter",
]


def transpose1d_array(x) -> np.ndarray:
    """[n] -> [n, 1] column vector (reference misc.py:16-29)."""
    return np.asarray(x).reshape(-1, 1)


def mytranspose(x):
    """Transpose that treats length-1 inputs as 1-D columns
    (reference misc.py:31-45): a single-element container becomes a
    column vector; anything else is `np.transpose`, simplified if the
    result has a single element."""
    if len(x) == 1:
        return transpose1d_array(x)
    return singlelize(np.transpose(x))


def end(a):
    """MATLAB ``end``: the last scalar of a (possibly nested) array/list
    (reference misc.py:47-63).  ``end([[1, 2], [3, 4]]) == 4``."""
    while isinstance(a, (np.ndarray, list)):
        a = a[len(a) - 1]
    return a


def array_by_index(idxs, values) -> np.ndarray:
    """Scatter `values` to positions `idxs` of a zero-filled array of
    length ``max(idxs) + 1`` (reference misc.py:65-93).

    The i-th index receives the i-th value; unmapped slots stay 0.  A
    scalar value broadcasts to every index.  (The reference's int branch
    crashes — SURVEY.md §2.5 #12 — so the broadcast here is the intended,
    fixed behavior.)
    """
    idxs = np.asarray(idxs)
    out_len = int(end(idxs)) + 1
    if np.isscalar(values) or isinstance(values, numbers.Number):
        out = np.zeros(out_len, dtype=np.asarray(values).dtype)
        out[idxs.astype(int)] = values
        return out
    values = np.asarray(values)
    out = np.zeros(out_len, dtype=values.dtype)
    out[idxs.astype(int).ravel()] = values.ravel()
    return out


def singlelize(a):
    """Strip singleton nesting: ``[x] -> x`` recursively
    (reference misc.py:95-114).  Non-containers pass through."""
    while isinstance(a, (np.ndarray, list)) and len(a) == 1:
        a = a[0]
    return a


def apply_fn(v, fn: Callable[[Any], Any]):
    """Apply `fn` elementwise through arbitrarily nested containers
    (reference misc.py:116-134)."""
    if is_num(v):
        return fn(v)
    if is_container(v):
        return np.asarray([apply_fn(x, fn) for x in v])
    raise TypeError(type(v))


def is_complex(a) -> bool:
    """True for Python/NumPy complex scalars (reference misc.py:136-140)."""
    return isinstance(a, (complex, np.complexfloating))


def is_num(a) -> bool:
    """True for real/complex scalars incl. NumPy scalar types
    (reference misc.py:142-153)."""
    return isinstance(a, (numbers.Number, np.number)) and not isinstance(
        a, (bool, np.bool_))


def is_container(a) -> bool:
    """True for ndarray/list (reference misc.py:155-160)."""
    return isinstance(a, (np.ndarray, list))


def is_empty(a) -> bool:
    """True for an empty container; False for scalars
    (reference misc.py:162-165)."""
    return is_container(a) and len(a) == 0


# ---- reference-name aliases (drop-in import surface) ----
transpose1dArray = transpose1d_array
arrayByIndex = array_by_index
apply = apply_fn
isComplex = is_complex
isNum = is_num
isContainer = is_container
isEmpty = is_empty
ellipFilter = ellip_filter
