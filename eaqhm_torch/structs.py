"""Record types mirroring the reference data model (reference structs.py).

The engine's state is dense arrays and masks; these records are a
compatibility view for code written against the reference's per-instant
objects (`Deterministic(ti, isSpeech, isVoiced, a0, ak, frange, pk)`,
reference structs.py:7-22; `Frame(ti, isSpeech, isVoiced)`,
structs.py:24-33).  `from_result` / `frames_from_result` build them from an
`EaqhmResult`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Frame:
    """One analysis instant's flags (reference structs.py:24-33)."""
    ti: int
    isSpeech: bool
    isVoiced: bool


@dataclass
class Deterministic(Frame):
    """Deterministic components at one analysis instant (structs.py:7-22).

    a0: DC amplitude; ak: harmonic amplitudes; frange: harmonic frequencies
    [Hz]; pk: harmonic phases [rad]; nonzero entries only, like the
    reference's per-frame variable-length arrays.
    """
    a0: float = 0.0
    ak: np.ndarray = None
    frange: np.ndarray = None
    pk: np.ndarray = None


def from_result(result) -> List[Deterministic]:
    """Per-instant `Deterministic` records of an EaqhmResult, as the
    reference packages them (functions.py:404-411): one record per analysis
    instant, harmonic arrays trimmed to the accepted (nonzero) entries."""
    out = []
    ak = result.det_ak
    fr = result.det_frange
    pk = result.det_pk
    for i, ti in enumerate(result.det_ti):
        nz = ak[i] != 0
        out.append(Deterministic(
            ti=int(ti),
            isSpeech=bool(result.det_is_speech[i]),
            isVoiced=bool(result.det_is_voiced[i]),
            a0=float(result.det_a0[i]),
            ak=ak[i][nz].copy(),
            frange=fr[i][nz].copy(),
            pk=pk[i][nz].copy(),
        ))
    return out


def frames_from_result(result) -> List[Frame]:
    """Per-instant `Frame` flag records (reference structs.py:24-33)."""
    return [Frame(ti=int(t), isSpeech=bool(s), isVoiced=bool(v))
            for t, s, v in zip(result.det_ti, result.det_is_speech,
                               result.det_is_voiced)]
