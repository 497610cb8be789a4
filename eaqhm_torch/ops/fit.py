"""The fit's normal equations: the hand-written CUDA kernels and their plain
PyTorch versions.

Per voiced frame the reference fits a quasi-harmonic model by windowed
normal equations (reference functions.py:420-535).  ``iqhm_gram`` (the
stationary fit of adaptation 0) and ``eaqhm_gram`` (every eaQHM
adaptation, with the zero-gap repair of the tracks) build the basis
E1 [B, N, Kc2], A = w E1 and B = o A, and ``build_gram_split`` the
equilibrated R = [[G0, G1], [G1^H, G2]] (Gk = E1^H W^2 t^k E1), the
right-hand side and dinv: the JAX package's eaqhm_tpu/ops/solver.py
``build_gram_split`` (:212-247), ``iqhm_gram`` (:402-422) and
``eaqhm_gram`` (:508-587), which XLA fuses on the TPU, with the window
gathers of eaqhm_tpu/models/engine.py before them (``dead_overlay_windows``
:149-164, ``_iqhm_stage`` :188, ``_eaqhm_bucket`` :244).

The engines call ``iqhm_gram_tables`` / ``eaqhm_gram_tables``: per frame an
utterance ``utt``, a centre row ``ctr`` and the tables themselves (the
signal, and for eaQHM the track tables fm, am read through their strides,
the dead centres and the frame's dead flag); no window is gathered.  On a
CUDA tensor they launch two kernels of ``kernels/csrc/fit.cu`` (no torch op
between them):
  ``fit_basis``  one frame and 8 harmonics a block, a warp a harmonic and
                 its lanes on 32 rows at a time: the window rows read from
                 the tables, the dead-track overlay, the windowed basis A
                 [B, N, Kc2] written once, the right-hand side, dinv (from
                 the columns' sums of |A|^2 and |B|^2, the Gram's diagonal),
                 the column mask and R's entries against the DC column; in
                 iQHM or eaQHM mode (the repair, the integer phase split and
                 the cumsums as warp scans, rho, the time-reversed negative
                 block), rounding where the torch ops round;
  ``fit_gram``   one frame and one 32 x 32 tile of the Grams' columns but
                 the DC a block, a warp a 16 x 16 piece of all three Grams,
                 each Gram as its own upper triangle at every Kc (a piece
                 wholly below the diagonal is skipped), each entry below the
                 diagonal the conjugate of its mirror, the identity at masked
                 slots and the scaling in the epilogue: with fit_basis's DC
                 entries, R is written once.  complex64 on FP32 FFMA (no
                 TF32), complex128 on the FP64 tensor cores (m16n8k4).
On CPU tensors they run the plain version: the torch-op gather and overlay
(``gather_windows``), then ``iqhm_gram_reference`` / ``eaqhm_gram_reference``
(the torch ops the port had before the kernels).  ``iqhm_gram`` and
``eaqhm_gram`` take gathered windows (JAX's signature, o = -W..W): on a CPU
tensor the plain fit, on a CUDA tensor the kernels with the windows as
tables of one frame each.  ``fit_basis`` and ``fit_gram`` take CUDA tensors
only.

``fit_basis.launches`` / ``fit_gram.launches`` count kernel launches and
``.shapes`` record (B, N, Kc, mode, type) and (B, N, Kc, type) per launch;
a launch recorded into a CUDA graph counts at each replay
(``take_captured``, ``count_replay``, ``.replayed``), as in ``ops.chol``.
The four entry points' ``.plain_calls`` count the fits served by the plain
version (``plain_fits()`` sums them).
"""
from __future__ import annotations

import math
import threading

import torch

from eaqhm_torch.kernels import build
from eaqhm_torch.ops import scan

MODES = ("iqhm", "eaqhm")
DEAD_TRACK_F0 = 140.0    # reference functions.py:209
DEAD_TRACK_AM = 1e-3     # reference functions.py:210 (10e-4)
# fit_gram's grain (kernels/csrc/fit.cu): a warp's piece of the Grams and a
# block's tile of their columns but the DC
PIECE, TILE_R, TILE_C = 16, 32, 32
_lock = threading.Lock()
_tls = threading.local()
_prepared = set()


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


def _iqhm_basis(o, wl, f0, K, fs, Kc, dtype):
    """(E1, w, colmask1) of the stationary fit."""
    cdtype = complex_dtype(dtype)
    dev = o.device
    k = torch.arange(-Kc, Kc + 1, device=dev)                       # [Kc2]
    colmask1 = k.abs()[None, :] <= K[:, None]                        # [B, Kc2]
    phase = ((2 * math.pi / fs) * o[None, :, None].to(dtype)
             * (k[None, None, :].to(dtype) * f0[:, None, None]))
    E1 = torch.polar(torch.ones_like(phase), phase).to(cdtype)
    E1 = E1 * colmask1[:, None, :]
    w = blackman_window(o[None, :].to(dtype), wl[:, None].to(dtype))
    return E1, w, colmask1


def iqhm_gram_reference(s_win, o, wl, f0, K, fs, Kc, dtype=torch.float64):
    """The plain version of ``iqhm_gram``."""
    E1, w, colmask1 = _iqhm_basis(o, wl, f0, K, fs, Kc, dtype)
    return build_gram_split(E1, w, o, s_win.to(dtype), colmask1)


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


def _eaqhm_basis(fm_win, am_win, o, wl, colmask_k, fs, dtype, eps):
    """(E1, w, colmask1) of the non-stationary fit."""
    cdtype = complex_dtype(dtype)
    B, N, _ = fm_win.shape
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
    dc = torch.ones((B, N, 1), dtype=cdtype, device=fm_win.device)
    E1 = torch.cat([neg, dc, pos], dim=-1)                         # [B,N,Kc2]
    w = hamming_window(o[None, :].to(dtype), wl[:, None].to(dtype))
    colmask1 = torch.cat([colmask_k.flip(-1),
                          torch.ones((B, 1), dtype=torch.bool,
                                     device=fm_win.device), colmask_k], dim=-1)
    return E1, w, colmask1


def eaqhm_gram_reference(s_win, fm_win, am_win, o, wl, colmask_k, fs,
                         dtype=torch.float64, eps=1e-4):
    """The plain version of ``eaqhm_gram``."""
    E1, w, colmask1 = _eaqhm_basis(fm_win, am_win, o, wl, colmask_k, fs,
                                   dtype, eps)
    return build_gram_split(E1, w, o, s_win.to(dtype), colmask1)


def dead_overlay(fm_win, am_win, dead_win, dd, o):
    """The dead-track bootstrap (fm=140 Hz, am=1e-3 on harmonic 1,
    functions.py:204-210) on gathered windows, with the reference's
    left-visibility: a frame's window sees it at dead centers strictly left
    of its own center, plus its own center when the frame itself is dead.
    fm_win/am_win: [B, N, K]; dead_win: [B, N] dead centers under the
    window; dd: [B] this frame dead; o: [N] offsets."""
    use = dead_win & ((o[None, :] < 0) | ((o[None, :] == 0) & dd[:, None]))
    first = (torch.arange(fm_win.shape[-1], device=fm_win.device)
             == 0)[None, None, :]
    ovl = use[..., None] & first
    return (torch.where(ovl, DEAD_TRACK_F0, fm_win),
            torch.where(ovl, DEAD_TRACK_AM, am_win))


def _per_utt(x, nd):
    """A table of one utterance ([L, ...]) as one of U = 1 ([1, L, ...])."""
    return x[None] if x.dim() == nd else x


def gather_windows(s, utt, ctr, W: int, fm=None, am=None, dead=None,
                   dd=None, Kc=None):
    """The plain gather of the table fits: per frame the rows
    clamp(ctr + o, 0, L - 1) of utterance utt (o = -W..W) of s [U, L] (or
    [L]), and, with the track tables fm, am [U, L, >= Kc] (or [L, >= Kc]),
    their first Kc columns with the dead-track overlay (dead [U, L] dead
    centres, dd [B] the frame dead).  Returns s_win [B, N] or (s_win,
    fm_win, am_win)."""
    s = _per_utt(s, 1)
    L = s.shape[-1]
    o = torch.arange(-W, W + 1, device=s.device)
    u = utt[:, None]
    rows = (ctr[:, None] + o[None, :]).clamp(0, L - 1)
    s_win = s[u, rows]
    if fm is None:
        return s_win
    fm_win = _per_utt(fm, 2)[u, rows, :Kc]
    am_win = _per_utt(am, 2)[u, rows, :Kc]
    fm_win, am_win = dead_overlay(fm_win, am_win, _per_utt(dead, 1)[u, rows],
                                  dd, o)
    return s_win, fm_win, am_win


def library(device=None):
    """The kernel library; with a CUDA device, the kernels' dynamic shared-
    memory attribute is set on that device first (once per device, outside
    any capture)."""
    lib = build.load("fit")
    if device is None:
        return lib
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _prepared:
        with _lock, torch.cuda.device(idx):
            err = lib.fit_prepare()
            if err != 0:
                raise RuntimeError(f"fit: setting the kernels' shared memory "
                                   f"on cuda:{idx} failed: cudaError {err}")
            _prepared.add(idx)
    return lib


def _need_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"the fit kernels take CUDA tensors, not {x.device}"
                         f" (the fit entry points run the plain version on"
                         f" the CPU)")


def _real(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fit takes float32/float64, got {dtype}")
    return "f64" if dtype == torch.float64 else "f32"


def _launch(counter, sym: str, dev: torch.device, *args) -> None:
    lib = library(dev)
    with torch.cuda.device(dev):
        err = getattr(lib, sym)(*args,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{sym} kernel launch failed: cudaError {err}")
    _count(counter, 1)


def _vec(x, dtype, dev):
    return torch.as_tensor(x, device=dev).to(dtype).contiguous()


def gram_plan(Kc: int):
    """fit_gram's plan at Kc, as kernels/csrc/fit.cu's Plan computes it:
    (tiles a frame, live 16 x 16 pieces a frame, piece slots of the
    launched tiles).  Pure Python."""
    n = 2 * Kc
    RT, CT = -(-n // TILE_R), -(-n // TILE_C)
    ntiles = sum(min(RT, (J * TILE_C + TILE_C - 1) // TILE_R + 1)
                 for J in range(CT))
    live = sum(1 for r0 in range(0, n, PIECE) for c0 in range(0, n, PIECE)
               if c0 + PIECE - 1 >= r0)
    return ntiles, live, ntiles * (TILE_R // PIECE) * (TILE_C // PIECE)


def gram_work_ratio(Kc: int) -> float:
    """fit_gram's executed work (its live pieces: 16 x 16 entries of three
    Grams, 8 real flops an entry and a row) over the least (one triangle of
    each Gram, 3 M^2 N real flops a frame)."""
    Kc2 = 2 * Kc + 1
    return gram_plan(Kc)[1] * PIECE * PIECE * 24 / (12 * Kc2 * Kc2)


def basis_call(mode, s, utt, ctr, W: int, wl, dtype, *, fs, Kc=None,
               f0=None, K=None, fm=None, am=None, dead=None, dd=None,
               colmask_k=None, eps=1e-4):
    """One fit_basis launch without the launch: (outputs (A, R, rhs, dinv,
    mask) allocated, the symbol, its arguments but the stream, the operand
    tensors to keep alive).  s: [U, L] (or [L]); iQHM takes f0, K and Kc;
    eaQHM fm, am [U, L, >= Kc] (or [L, >= Kc]; read through their strides,
    the last 1), dead [U, L] (or [L]), dd [B] and colmask_k [B, Kc].
    Tensor work only (the CPU tests check the arguments against the
    library's argtypes)."""
    s = _per_utt(s, 1)
    dev = s.device
    L = s.shape[1]
    B, N = len(ctr), 2 * W + 1
    if mode == "eaqhm":
        Kc = colmask_k.shape[-1]
    Kc2 = 2 * Kc + 1
    cdtype = complex_dtype(dtype)
    out = (torch.empty((B, N, Kc2), dtype=cdtype, device=dev),
           torch.empty((B, 2 * Kc2, 2 * Kc2), dtype=cdtype, device=dev),
           torch.empty((B, 2 * Kc2), dtype=cdtype, device=dev),
           torch.empty((B, 2 * Kc2), dtype=dtype, device=dev),
           torch.empty((B, Kc2), dtype=torch.uint8, device=dev))
    frame = [_vec(utt, torch.int64, dev), _vec(ctr, torch.int64, dev)]
    c = 2 * math.pi / fs
    if mode == "iqhm":
        keep = [s.to(dtype).contiguous(), *frame, _vec(wl, dtype, dev),
                _vec(f0, dtype, dev), _vec(K, torch.int64, dev)]
        scalars = (B, N, Kc, L, c)
    else:
        fm, am = _per_utt(fm, 2).to(dtype), _per_utt(am, 2).to(dtype)
        if fm.stride() != am.stride() or fm.stride(-1) != 1:
            fm, am = fm.contiguous(), am.contiguous()
        keep = [s.to(dtype).contiguous(), fm, am,
                _per_utt(dead, 1).to(torch.bool).contiguous(), *frame,
                _vec(dd, torch.bool, dev), _vec(wl, dtype, dev),
                colmask_k.to(torch.bool).contiguous()]
        scalars = (B, N, Kc, L, fm.stride(0), fm.stride(1), float(fs), c,
                   float(eps))
    args = (*(t.data_ptr() for t in keep), *(t.data_ptr() for t in out),
            *scalars)
    return out, f"fit_basis_{mode}_{_real(dtype)}", args, keep


def gram_call(A, R, dinv, mask):
    """One fit_gram launch without the launch: (R, the symbol, its
    arguments but the stream, the operand tensors to keep alive)."""
    B, N, Kc2 = A.shape
    keep = [A, dinv.to(A.real.dtype).contiguous(), mask]
    sym = "fit_gram_c128" if A.dtype == torch.complex128 else "fit_gram_c64"
    args = (*(t.data_ptr() for t in keep), R.data_ptr(), B, N,
            (Kc2 - 1) // 2)
    return R, sym, args, keep


def fit_basis(mode, s, utt, ctr, W: int, wl, dtype, *, fs, Kc=None,
              f0=None, K=None, fm=None, am=None, dead=None, dd=None,
              colmask_k=None, eps=1e-4):
    """The windowed basis read from the tables and what the Gram needs:
    (A [B, N, Kc2] complex, R [B, M, M] with its entries against the DC
    slots written (fit_gram writes the rest), rhs [B, M] (scaled), dinv
    [B, M], mask [B, Kc2] uint8); frame b's rows are clamp(ctr[b] + o, 0,
    L - 1) of utterance utt[b] (o = -W..W).  Arguments as ``basis_call``.
    Launches the kernel (CUDA tensors only)."""
    if mode not in MODES:
        raise ValueError(f"fit_basis mode {mode!r} not in {MODES}")
    _real(dtype)
    _need_cuda(s)
    B = len(ctr)
    if tuple(wl.shape) != (B,) or tuple(utt.shape) != (B,):
        raise ValueError(f"fit_basis: utt {tuple(utt.shape)}, wl "
                         f"{tuple(wl.shape)} for {B} frames")
    if mode == "eaqhm":
        Kc = colmask_k.shape[-1]
        if fm.shape[-1] < Kc or am.shape != fm.shape or \
                tuple(colmask_k.shape) != (B, Kc) or tuple(dd.shape) != (B,):
            raise ValueError(f"eaqhm fit_basis: fm {tuple(fm.shape)}, am "
                             f"{tuple(am.shape)}, colmask_k "
                             f"{tuple(colmask_k.shape)}, dd "
                             f"{tuple(dd.shape)} for {B} frames")
    out, sym, args, _keep = basis_call(
        mode, s, utt, ctr, W, wl, dtype, fs=fs, Kc=Kc, f0=f0, K=K, fm=fm,
        am=am, dead=dead, dd=dd, colmask_k=colmask_k, eps=eps)
    if B > 0:
        _launch(fit_basis, sym, s.device, *args)
        _record(fit_basis, (B, 2 * W + 1, Kc, mode,
                            str(dtype).split(".")[-1]))
    return out


def fit_gram(A, R, dinv, mask):
    """R [B, M, M] from fit_basis's A, R (its entries against the DC slots
    written), dinv and mask: R = E^H E over E = [A, o A] (o = -W..W), each
    Gram as its own upper triangle and every entry below the diagonal the
    conjugate of its mirror, the identity added at masked slots, scaled by
    dinv_i dinv_j; written into R.  Launches the kernel (CUDA tensors
    only)."""
    if A.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"fit_gram takes complex64/complex128, got {A.dtype}")
    _need_cuda(A)
    B, N, Kc2 = A.shape
    M = 2 * Kc2
    if tuple(dinv.shape) != (B, M) or tuple(mask.shape) != (B, Kc2) \
            or tuple(R.shape) != (B, M, M) or N % 2 == 0:
        raise ValueError(f"fit_gram: R {tuple(R.shape)}, dinv "
                         f"{tuple(dinv.shape)}, mask {tuple(mask.shape)} for "
                         f"A {(B, N, Kc2)} (N odd)")
    if not (A.is_contiguous() and R.is_contiguous() and R.dtype == A.dtype
            and mask.is_contiguous() and mask.dtype == torch.uint8):
        raise ValueError("fit_gram needs contiguous A and R of one type and "
                         "a uint8 mask")
    R, sym, args, _keep = gram_call(A, R, dinv, mask)
    if B > 0:
        _launch(fit_gram, sym, A.device, *args)
        _record(fit_gram, (B, N, (Kc2 - 1) // 2,
                           str(A.dtype).split(".")[-1]))
    return R


def iqhm_gram_tables(s, utt, ctr, W: int, wl, f0, K, fs, Kc,
                     dtype=torch.float64):
    """Stationary-fit normal equations of the frames (utt, ctr) of s [U, L]
    (or [L]): rows clamp(ctr + o, 0, L - 1), o = -W..W; wl, f0: [B]; K: [B]
    per-frame harmonic count; Kc: static max harmonic.  Returns (R, rhs,
    dinv): on a CUDA tensor from the kernels, on a CPU tensor from the
    plain version (the gather, then ``iqhm_gram_reference``)."""
    if s.device.type == "cpu":
        _count_plain(iqhm_gram_tables)
        s_win = gather_windows(s, utt, ctr, W)
        o = torch.arange(-W, W + 1, device=s.device)
        return iqhm_gram_reference(s_win, o, wl, f0, K, fs, Kc, dtype=dtype)
    A, R, rhs, dinv, mask = fit_basis("iqhm", s, utt, ctr, W, wl, dtype,
                                      fs=fs, Kc=Kc, f0=f0, K=K)
    return fit_gram(A, R, dinv, mask), rhs, dinv


def eaqhm_gram_tables(s, fm, am, dead, utt, ctr, dd, W: int, wl, colmask_k,
                      fs, dtype=torch.float64, eps=1e-4):
    """Non-stationary-fit normal equations of the frames (utt, ctr): s [U,
    L], the track tables fm, am [U, L, >= Kc] (positive harmonics 1..Kc in
    their first Kc columns, read through the strides), dead [U, L] dead
    centres (or [L], [L, >= Kc], [L] for one utterance); dd: [B] the frame
    dead; colmask_k: [B, Kc] selected harmonics.  The dead-track overlay
    and the zero-gap repair are applied here.  Returns (R, rhs, dinv): on a
    CUDA tensor from the kernels, on a CPU tensor from the plain version
    (``gather_windows``, then ``eaqhm_gram_reference``)."""
    if s.device.type == "cpu":
        _count_plain(eaqhm_gram_tables)
        s_win, fm_win, am_win = gather_windows(
            s, utt, ctr, W, fm, am, dead, dd, colmask_k.shape[-1])
        o = torch.arange(-W, W + 1, device=s.device)
        return eaqhm_gram_reference(s_win, fm_win, am_win, o, wl, colmask_k,
                                    fs, dtype=dtype, eps=eps)
    A, R, rhs, dinv, mask = fit_basis(
        "eaqhm", s, utt, ctr, W, wl, dtype, fs=fs, fm=fm, am=am, dead=dead,
        dd=dd, colmask_k=colmask_k, eps=eps)
    return fit_gram(A, R, dinv, mask), rhs, dinv


def _as_tables(s_win):
    """Gathered windows [B, N] as tables of one frame each: (utt, ctr, W)."""
    B, N = s_win.shape
    dev = s_win.device
    return (torch.arange(B, device=dev),
            torch.full((B,), (N - 1) // 2, device=dev), (N - 1) // 2)


def iqhm_gram(s_win, o, wl, f0, K, fs, Kc, dtype=torch.float64):
    """Stationary-fit normal equations (reference functions.py:420-470).

    s_win: [B, N] signal windows centered on each frame; o: [N] centered
    offsets (-W..W); wl: [B] half-widths; f0: [B]; K: [B] per-frame harmonic
    count; Kc: static max harmonic.  Returns (R, rhs, dinv): on a CUDA
    tensor from the kernels (the windows as tables), on a CPU tensor from
    the plain version.
    """
    if s_win.device.type == "cpu":
        _count_plain(iqhm_gram)
        return iqhm_gram_reference(s_win, o, wl, f0, K, fs, Kc, dtype=dtype)
    utt, ctr, W = _as_tables(s_win)
    A, R, rhs, dinv, mask = fit_basis("iqhm", s_win, utt, ctr, W, wl, dtype,
                                      fs=fs, Kc=Kc, f0=f0, K=K)
    return fit_gram(A, R, dinv, mask), rhs, dinv


def eaqhm_gram(s_win, fm_win, am_win, o, wl, colmask_k, fs,
               dtype=torch.float64, eps=1e-4):
    """Non-stationary-fit normal equations (reference functions.py:472-535).

    fm_win/am_win: [B, N, Kc] track windows (positive harmonics 1..Kc at
    slots 0..Kc-1), already overlay-corrected; zeros are repaired here.
    colmask_k: [B, Kc] selected harmonics.  Returns (R, rhs, dinv): on a
    CUDA tensor from the kernels (the windows as tables, no dead centre),
    on a CPU tensor from the plain version.
    """
    if s_win.device.type == "cpu":
        _count_plain(eaqhm_gram)
        return eaqhm_gram_reference(s_win, fm_win, am_win, o, wl, colmask_k,
                                    fs, dtype=dtype, eps=eps)
    utt, ctr, W = _as_tables(s_win)
    dead = torch.zeros(s_win.shape, dtype=torch.bool, device=s_win.device)
    A, R, rhs, dinv, mask = fit_basis(
        "eaqhm", s_win, utt, ctr, W, wl, dtype, fs=fs, fm=fm_win, am=am_win,
        dead=dead, dd=dead[:, 0], colmask_k=colmask_k, eps=eps)
    return fit_gram(A, R, dinv, mask), rhs, dinv


ENTRIES = (iqhm_gram_tables, eaqhm_gram_tables, iqhm_gram, eaqhm_gram)


def plain_fits() -> int:
    """Fits the plain version served since the counts were set to 0."""
    with _lock:
        return sum(entry.plain_calls for entry in ENTRIES)


def _captured() -> dict:
    rec = getattr(_tls, "captured", None)
    if rec is None:
        rec = _tls.captured = {"basis": 0, "gram": 0, "basis_shapes": [],
                               "gram_shapes": []}
    return rec


def _key(counter) -> str:
    return "basis" if counter is fit_basis else "gram"


def _count(counter, n: int) -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured()[_key(counter)] += n
    else:
        with _lock:
            counter.launches += n


def _count_plain(entry) -> None:
    with _lock:
        entry.plain_calls += 1


def _record(counter, shape) -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured()[_key(counter) + "_shapes"].append(shape)
    else:
        with _lock:
            counter.shapes.append(shape)


def take_captured() -> dict:
    """The kernel launches and shapes this thread recorded into the CUDA
    graph it just captured, and a fresh record for its next capture."""
    out = _captured()
    _tls.captured = None
    return out


def count_replay(captured: dict) -> None:
    """Count the launches of one replay of a graph (``take_captured``)."""
    with _lock:
        for counter in (fit_basis, fit_gram):
            k = _key(counter)
            counter.launches += captured[k]
            counter.replayed += captured[k]
            counter.shapes.extend(captured[k + "_shapes"])


def reset_counts() -> None:
    """Set every count of this module to 0, and this thread's capture
    record."""
    with _lock:
        for counter in (fit_basis, fit_gram):
            counter.launches = 0
            counter.shapes = []
            counter.replayed = 0
        for entry in ENTRIES:
            entry.plain_calls = 0
    _tls.captured = None


reset_counts()
