"""Configuration for the eaQHM PyTorch pipeline.

The parameter surface of the reference entry point (functions.py:35-37) as a
frozen dataclass, field for field the same as the JAX package's
``EaqhmConfig`` so that a configuration carries across unchanged
(``config_from_dict``).  Gender presets map to SWIPE' pitch limits
(reference functions.py:95-109; the code, not the docstring, is
authoritative: female is [160, 300]).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Gender presets, reference functions.py:95-109.
_GENDER_LIMITS = {
    "male": (70.0, 180.0),
    "female": (160.0, 300.0),
    "child": (300.0, 600.0),
    "other": (70.0, 500.0),
}


def gender_pitch_limits(gender) -> Tuple[float, float]:
    """Pitch search limits [Hz] for a gender preset or explicit tuple.

    Unknown strings fall back to the 'other' preset [70, 500]; tuples pass
    through (reference functions.py:95-109).
    """
    if isinstance(gender, (tuple, list)):
        return float(gender[0]), float(gender[1])
    return _GENDER_LIMITS.get(gender, _GENDER_LIMITS["other"])


@dataclasses.dataclass(frozen=True)
class EaqhmConfig:
    """Full parameter surface (reference functions.py:35-37) + device knobs."""

    # ---- reference-parity parameters ----
    gender: object = "other"        # preset name or (f0min, f0max) tuple
    step: int = 15                  # analysis grid step in samples
    max_adaptations: int = 10       # `maxAdpt`
    pitch_periods: int = 3          # window half-length factor (functions.py:191)
    analysis_window: int = 32       # edge margin = analysis_window*step samples
    full_waveform: bool = True      # model the entire signal (functions.py:140-146)
    fc: float = 0.0                 # optional elliptic high-pass cutoff [Hz]
    partials: int = 0               # manual Kmax override (<=0: derived)

    # ---- numerics / device knobs ----
    # "auto": float32 on CUDA, float64 on the CPU (parity tests)
    dtype: str = "auto"             # "auto" | "float32" | "float64"
    # LS solve, as the JAX package picks it: "auto" -> "cholesky" for
    # float64, "block_inverse" for float32.  "block_inverse" is the
    # recursive Schur-complement inverse plus two refinements (float32: a
    # ridged rerun on the Cholesky kernel when the batch is non-finite or
    # the returned solution's residual exceeds 1e-3 of the right-hand
    # side); "cholesky" is one hand-kernel
    # solve, NaN on a failed pivot (float32: ridged rerun on a non-finite
    # batch); "pallas" is a complex64 solve with the Pallas pivot guard plus
    # one refinement step (one factorization, two substitutions).  The
    # Cholesky kernel (ops.chol) is CUDA C++ on the card.
    solve_method: str = "auto"      # "auto"|"block_inverse"|"cholesky"|"pallas"
    # replicate reference quirks needed for bit-comparable SRER
    replicate_quirks: bool = True
    # keep-previous-on-decline convergence rule (functions.py:394-402)
    stop_on_decline: bool = True
    # per-adaptation accepted-harmonic counts
    collect_metrics: bool = False
    # every eaQHM adaptation as one CUDA graph replay (with stop_on_decline
    # and without collect_metrics, as in the JAX package)
    fused_adapt_loop: bool = False
    # quantize the signal length to 4096-sample pages and the harmonic
    # tiers to a fixed lattice; exact (zero window weight and identity
    # columns absorb the padding)
    quantize_geometry: bool = True
    # frames per batched fit (bounds the Gram/basis working set)
    chunk: int = 128
    # progress bar over the adaptation loop
    loading_screen: bool = False

    @property
    def pitch_limits(self) -> Tuple[float, float]:
        return gender_pitch_limits(self.gender)

    @property
    def is_male(self) -> bool:
        # VAD low-pass branch (functions.py:606-609) keys on the literal
        # string 'male'; tuple genders use the non-male branch
        return self.gender == "male"

    @property
    def margin_samples(self) -> int:
        return self.analysis_window * self.step


def config_from_dict(d: dict) -> EaqhmConfig:
    """Build a config from ``dataclasses.asdict`` of either package's
    ``EaqhmConfig``.  Unknown keys raise, so a field added on one side and
    not the other is caught."""
    d = dict(d)
    if isinstance(d.get("gender"), list):
        d["gender"] = tuple(d["gender"])
    names = {f.name for f in dataclasses.fields(EaqhmConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown EaqhmConfig fields: {sorted(extra)}")
    return EaqhmConfig(**d)
