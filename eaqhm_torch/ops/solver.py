"""Batched windowed complex least-squares fits: the hot path.

Per voiced frame the reference fits a quasi-harmonic model by windowed
normal equations ``R = (WE)^H (WE)``, ``x = R^{-1} (WE)^H (W s)`` with basis
``E = [e^{j phi_k(t)}, t e^{j phi_k(t)}]`` (reference functions.py:420-535).
All frames of a batch solve at once: windows are padded to a half-width W
(rows outside a frame's +-wl get window weight 0, which reproduces the
reference R exactly), harmonic columns are padded to Kc with masked columns
replaced by identity rows (block-diagonal: the live solution is unchanged),
the normal equations come from the fit kernels of ``ops.fit`` (re-exported
here), and the solve is the batched Cholesky kernel of ``ops.chol`` or the
recursive block inverse (float32's default, as in the JAX package).

Shapes: B frames, N = 2W+1 window rows, Kc max harmonic, M = 2(2Kc+1) columns.
Column slot j: j < Kc -> harmonic -(Kc-j); j == Kc -> DC; j > Kc -> +(j-Kc);
slots Kc2..2Kc2 are the slope (t*E) block, same order (Kc2 = 2Kc+1).

Only the JAX package's production numerics are ported: the split Gram, the
integer phase split, the complex block inverse with Gauss-Jordan leaves of 16
(no planar embedding, no ``EAQHM_GJ_BASE``: a leaf below 16 breaks SA19,
docs/NUMERICS.md:99-102).
"""
from __future__ import annotations

import math

import torch

from eaqhm_torch.ops.block_inverse import (  # noqa: F401  (re-exported)
    block_inverse_solve, gj_inverse, hpd_block_inverse)
from eaqhm_torch.ops.chol import chol_solve, chol_subst
from eaqhm_torch.ops.fit import (  # noqa: F401  (re-exported)
    _mv, blackman_window, build_gram_split, complex_dtype, eaqhm_gram,
    eaqhm_gram_tables, hamming_window, iqhm_gram, iqhm_gram_tables,
    repair_tracks)

_RIDGE = 1e-5


def default_solve_method(rdtype: torch.dtype) -> str:
    """The JAX package's rule (eaqhm_tpu/ops/solver.py:185-209): float64 ->
    "cholesky" (one solve, the f64 oracle's function); float32 ->
    "block_inverse" at every size."""
    return "cholesky" if rdtype == torch.float64 else "block_inverse"


def _refined_solve(R, Rf, rhs, mode):
    """Solve Rf x = rhs, then one refinement against R: one factorization
    of Rf (kept), the residual rhs - R x in R's type, and one substitution
    with the kept factor.  Rf may be a complex64 copy of R (float64
    "pallas"): the correction is cast back and added in R's type."""
    x, f = chol_solve(Rf, rhs.to(Rf.dtype), mode=mode, keep_factor=True)
    x = x.to(R.dtype)
    r = (rhs - _mv(R, x)).to(Rf.dtype).contiguous()
    return x + chol_subst(f, r).to(R.dtype)


def _ridge_rerun(R, rhs):
    """Cholesky of R + 1e-5 I plus one refinement against R (the float32
    fallback of solver.py:379-387, jnp.linalg.cholesky there: the "nan"
    pivot rule)."""
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    return _refined_solve(R, (R + _RIDGE * eye).contiguous(), rhs, "nan")


def _finite_or_ridged(R, rhs, x, good):
    """The float32 fallback: x when ``good`` (a 0-d bool tensor: every entry
    finite, and for the block inverse every residual within the gate)
    holds, else the whole batch rerun ridged (solver.py:351-352,379-390).
    Under CUDA graph capture the host cannot branch, so the rerun is always
    computed and the batch selected on the device with torch.where on the
    flag: the function JAX's lax.cond computes."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return torch.where(good, x, _ridge_rerun(R, rhs))
    return x if bool(good) else _ridge_rerun(R, rhs)


def solve_gram(R, rhs, rdtype, method=None):
    """Solve equilibrated HPD normal equations R x' = rhs (batched).

    R: [B, M, M]; rhs: [B, M]; the caller de-equilibrates (x = x' * dinv).
    method: None/"auto" (dtype default: float64 "cholesky", float32
    "block_inverse") | "block_inverse" | "cholesky" | "pallas".
      "block_inverse": the recursive Schur-complement inverse, x = Ri rhs
        and two residual refinements (solver.py:316-352), full float32
        products (TF32 off); for float32 the ridged rerun (the CUDA kernel,
        "nan" rule) when any entry is non-finite, as in JAX, or when the
        returned solution's residual exceeds block_inverse.RESID_GATE of
        the right-hand side: off the TPU the float32 recursion diverges at
        M = 194 on SA19 while staying finite (JAX on the CPU and the port
        on the H100 alike), which JAX's finite-only gate lets through;
      "cholesky", float64: one kernel solve, NaN on a failed pivot
        (solver.py:356-362);
      "cholesky", float32: the same, and when any entry is non-finite a
        ridged rerun plus one refinement (solver.py:363-390);
      "pallas": a complex64 solve with the Pallas kernel's pivot guard plus
        one refinement step, the residual taken in the caller's type
        (solver.py:302-315); one factorization, two substitutions.
    "cholesky" and "pallas" launch the CUDA kernel on the card (ops.chol)
    with the pivot rule of the JAX branch they stand for; "block_inverse"
    launches the block-inverse kernel (ops.block_inverse), whose outputs
    carry the gate's inputs.
    """
    if method in (None, "auto"):
        method = default_solve_method(rdtype)
    R = R.contiguous()
    rhs = rhs.contiguous()
    if method == "pallas":
        return _refined_solve(R, R.to(torch.complex64).contiguous(), rhs,
                              "guard")
    if method == "block_inverse":
        sol = block_inverse_solve(R, rhs)
        if rdtype == torch.float64:
            return sol.x
        return _finite_or_ridged(R, rhs, sol.x, sol.ok)
    if method != "cholesky":
        raise ValueError(f"unknown solve_method {method!r}")
    x = chol_solve(R, rhs, mode="nan")
    if rdtype != torch.float64:
        x = _finite_or_ridged(R, rhs, x,
                              torch.isfinite(torch.view_as_real(x)).all())
    return x


def split_amps(x, Kc: int):
    """Split a solution row [.., 2(2Kc+1)] into (amps, slopes)."""
    Kc2 = 2 * Kc + 1
    return x[..., :Kc2], x[..., Kc2:]


def iqhm_batch(s_win, o, wl, f0, K, fs, Kc, dtype=torch.float64,
               method=None):
    """Batched stationary fit: returns (amps, slopes), [B, 2Kc+1] complex."""
    R, rhs, dinv = iqhm_gram(s_win, o, wl, f0, K, fs, Kc, dtype=dtype)
    x = solve_gram(R, rhs, dtype, method=method) * dinv
    return split_amps(x, Kc)


def eaqhm_extract(x, colmask_k, Kc: int, fs):
    """Split a solved row into (amps, slopes, fmismatch): the frequency-
    mismatch corrector fs/(2pi) (Re a Im b - Im a Re b)/|a|^2
    (reference functions.py:297)."""
    amps, slopes = split_amps(x, Kc)
    a_pos = amps[..., Kc + 1:]
    b_pos = slopes[..., Kc + 1:]
    denom = a_pos.abs() ** 2
    fmis = (fs / (2 * math.pi)) * (a_pos.real * b_pos.imag
                                   - a_pos.imag * b_pos.real)
    fmis = torch.where(denom > 0, fmis / torch.where(denom > 0, denom, 1.0),
                       torch.zeros_like(fmis))
    return amps, slopes, fmis * colmask_k


def eaqhm_batch(s_win, fm_win, am_win, o, wl, colmask_k, fs,
                dtype=torch.float64, eps=1e-4, method=None):
    """Batched non-stationary fit: returns (amps, slopes, fmismatch)."""
    Kc = fm_win.shape[-1]
    R, rhs, dinv = eaqhm_gram(s_win, fm_win, am_win, o, wl, colmask_k, fs,
                              dtype=dtype, eps=eps)
    x = solve_gram(R, rhs, dtype, method=method) * dinv
    return eaqhm_extract(x, colmask_k, Kc, fs)
