"""Batched windowed complex least-squares fits: the hot path.

Per voiced frame the reference fits a quasi-harmonic model by windowed
normal equations ``R = (WE)^H (WE)``, ``x = R^{-1} (WE)^H (W s)`` with basis
``E = [e^{j phi_k(t)}, t e^{j phi_k(t)}]`` (reference functions.py:420-535).
All frames of a batch solve at once: windows are padded to a half-width W
(rows outside a frame's +-wl get window weight 0, which reproduces the
reference R exactly), harmonic columns are padded to Kc with masked columns
replaced by identity rows (block-diagonal: the live solution is unchanged),
and the solve is the batched Cholesky kernel of ``ops.chol`` or the
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

from eaqhm_torch.ops import scan
from eaqhm_torch.ops.block_inverse import (  # noqa: F401  (re-exported)
    block_inverse_solve, gj_inverse, hpd_block_inverse)
from eaqhm_torch.ops.chol import chol_solve, chol_subst

_RIDGE = 1e-5


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def blackman_window(o, wl):
    """np.blackman(2*wl+1) sampled at centered offsets o, 0 outside +-wl."""
    r = o / wl
    w = 0.42 + 0.5 * torch.cos(math.pi * r) + 0.08 * torch.cos(2 * math.pi * r)
    return torch.where(o.abs() <= wl, w, torch.zeros_like(w))


def hamming_window(o, wl):
    """np.hamming(2*wl+1) sampled at centered offsets o, 0 outside +-wl."""
    w = 0.54 + 0.46 * torch.cos(math.pi * o / wl)
    return torch.where(o.abs() <= wl, w, torch.zeros_like(w))


def default_solve_method(rdtype: torch.dtype) -> str:
    """The JAX package's rule (eaqhm_tpu/ops/solver.py:185-209): float64 ->
    "cholesky" (one solve, the f64 oracle's function); float32 ->
    "block_inverse" at every size."""
    return "cholesky" if rdtype == torch.float64 else "block_inverse"


def _mv(R, x):
    return torch.matmul(R, x[..., None])[..., 0]


def build_gram_split(E1, w, o, s_win, colmask1):
    """Windowed normal equations via the basis' block structure
    (equilibrated): E = [E1, t*E1], so

        R = [[G0, G1], [G1^H, G2]],  Gk = E1^H W^2 t^k E1

    computed as three half-size Grams of A = w*E1 and B = (w*t)*E1.
    Masked columns are identity-padded, then Jacobi equilibration scales R
    to a unit diagonal.  Returns (R, rhs, dinv); the caller de-equilibrates
    x = solve(R, rhs) * dinv.
    """
    A = E1 * w[..., None].to(E1.dtype)
    B = A * o[None, :, None].to(E1.dtype)
    Ah = A.mH
    Bh = B.mH
    G0 = torch.matmul(Ah, A)
    G1 = torch.matmul(Ah, B)
    G2 = torch.matmul(Bh, B)
    R = torch.cat([torch.cat([G0, G1], dim=-1),
                   torch.cat([G1.mH, G2], dim=-1)], dim=-2)
    ws = (w * s_win).to(E1.dtype)
    rhs = torch.cat([_mv(Ah, ws), _mv(Bh, ws)], dim=-1)
    colmask = torch.cat([colmask1, colmask1], dim=-1)
    Mdim = R.shape[-1]
    eye = torch.eye(Mdim, dtype=R.dtype, device=R.device)
    R = R + eye * (~colmask[:, None, :])
    diag = torch.diagonal(R, dim1=-2, dim2=-1).real
    dinv = torch.rsqrt(torch.clamp(diag, min=1e-30))
    R = R * (dinv[:, None, :] * dinv[:, :, None]).to(R.dtype)
    rhs = rhs * dinv
    return R.contiguous(), rhs.contiguous(), dinv


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


def iqhm_gram(s_win, o, wl, f0, K, fs, Kc, dtype=torch.float64):
    """Stationary-fit normal equations (reference functions.py:420-470).

    s_win: [B, N] signal windows centered on each frame; o: [N] centered
    offsets (-W..W); wl: [B] half-widths; f0: [B]; K: [B] per-frame harmonic
    count; Kc: static max harmonic.  Returns (R, rhs, dinv).
    """
    cdtype = complex_dtype(dtype)
    dev = s_win.device
    k = torch.arange(-Kc, Kc + 1, device=dev)                       # [Kc2]
    colmask1 = k.abs()[None, :] <= K[:, None]                        # [B, Kc2]
    phase = ((2 * math.pi / fs) * o[None, :, None].to(dtype)
             * (k[None, None, :].to(dtype) * f0[:, None, None]))
    E1 = torch.polar(torch.ones_like(phase), phase).to(cdtype)
    E1 = E1 * colmask1[:, None, :]
    w = blackman_window(o[None, :].to(dtype), wl[:, None].to(dtype))
    return build_gram_split(E1, w, o, s_win.to(dtype), colmask1)


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


def repair_tracks(fm_win, am_win, o, wl):
    """Zero-gap repair of gathered track windows (functions.py:217-278).

    For each (frame, harmonic): inside the frame's window (+-wl), zeros of
    fm are filled by linear interpolation between the surrounding nonzeros
    (constant extension at the edges); am is repaired at fm's zero
    positions.  Outside +-wl both are set to 0.  The previous and next
    nonzero come exactly from a cummax (and a flipped cummin) of indices.

    fm_win, am_win: [B, N, K]; o: [N]; wl: [B].
    """
    B, N, K = fm_win.shape
    dtype = fm_win.dtype
    zero = torch.zeros((), dtype=dtype, device=fm_win.device)
    inwin = o.abs()[None, :, None] <= wl[:, None, None]             # [B, N, 1]
    nz = inwin & (fm_win != 0)
    idx = torch.arange(N, device=fm_win.device)[None, :, None].expand(B, N, K)
    prev_i = torch.where(nz, idx, -1).cummax(dim=1).values
    nxt_i = torch.where(nz, idx, N).flip(1).cummin(dim=1).values.flip(1)
    has_prev = prev_i >= 0
    has_next = nxt_i < N
    pc = prev_i.clamp(0, N - 1)
    nc = nxt_i.clamp(0, N - 1)
    nxt_i = torch.where(has_next, nxt_i, -1)      # the scan's "none" value
    denom = (nxt_i - prev_i).to(dtype)
    ok = denom != 0
    g = torch.where(ok, (idx - prev_i) / torch.where(ok, denom, 1.0), zero)

    def fill(x):
        xp = torch.gather(x, 1, pc)
        xn = torch.gather(x, 1, nc)
        interp = xp + (xn - xp) * g
        out = torch.where(nz, x,
                          torch.where(has_prev & has_next, interp,
                                      torch.where(has_prev, xp,
                                                  torch.where(has_next, xn,
                                                              zero))))
        return torch.where(inwin, out, zero)

    return fill(fm_win), fill(am_win)


def eaqhm_gram(s_win, fm_win, am_win, o, wl, colmask_k, fs,
               dtype=torch.float64, eps=1e-4):
    """Non-stationary-fit normal equations (reference functions.py:472-535).

    fm_win/am_win: [B, N, Kc] track windows (positive harmonics 1..Kc at
    slots 0..Kc-1), already overlay-corrected; zeros are repaired here.
    colmask_k: [B, Kc] selected harmonics.  Returns (R, rhs, dinv).
    """
    cdtype = complex_dtype(dtype)
    B, N = s_win.shape
    W = (N - 1) // 2
    fm_r, am_r = repair_tracks(fm_win.to(dtype), am_win.to(dtype), o, wl)
    cm = colmask_k[:, None, :]
    fm_r = fm_r * cm
    am_r = am_r * cm

    # centered cumulative phase psi(t) = C(t) - C(mid) with the exact
    # integer split fm = q + r, q = round(fm) (round half to even): integer
    # partial sums are exact in float32 and reduce mod fs exactly
    fm_q = torch.round(fm_r)
    fm_res = fm_r - fm_q
    cq = scan.cumsum(fm_q, dim=1)
    cr = scan.cumsum(fm_res, dim=1)
    psi_q = cq - cq[:, W:W + 1, :]
    psi_r = cr - cr[:, W:W + 1, :]

    def mk_phase(pq, pr):
        return (2 * math.pi / fs) * (torch.remainder(pq, fs) + pr)

    phase = mk_phase(psi_q, psi_r)
    am_mid = am_r[:, W:W + 1, :]
    rho = (eps + am_r) / (am_mid + eps)
    pos = (rho * torch.polar(torch.ones_like(phase), phase)).to(cdtype) * cm

    # negative block: the reference feeds -flipud(fm) through the same
    # inclusive cumsum, which recenters to
    #   phase_neg(t) = (2pi/fs) * (psi(N-2-t) + fm(mid))
    def ext_flip(p, c_mid):
        return torch.cat([-c_mid, p[:, :-1, :]], dim=1).flip(1)

    neg_phase = mk_phase(
        ext_flip(psi_q, cq[:, W:W + 1, :]) + fm_q[:, W:W + 1, :],
        ext_flip(psi_r, cr[:, W:W + 1, :]) + fm_res[:, W:W + 1, :])
    neg = (rho.flip(1) * torch.polar(torch.ones_like(neg_phase),
                                     neg_phase)).to(cdtype) * cm
    neg = neg.flip(2)          # slots -Kc..-1 ascending = harmonics Kc..1
    dc = torch.ones((B, N, 1), dtype=cdtype, device=s_win.device)
    E1 = torch.cat([neg, dc, pos], dim=-1)                         # [B,N,Kc2]
    w = hamming_window(o[None, :].to(dtype), wl[:, None].to(dtype))
    colmask1 = torch.cat([colmask_k.flip(-1),
                          torch.ones((B, 1), dtype=torch.bool,
                                     device=s_win.device), colmask_k], dim=-1)
    return build_gram_split(E1, w, o, s_win.to(dtype), colmask1)


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
