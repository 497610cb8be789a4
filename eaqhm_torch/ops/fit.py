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
``eaqhm_gram`` (:508-587), which XLA fuses on the TPU.

On a CUDA tensor ``iqhm_gram`` and ``eaqhm_gram`` launch two kernels of
``kernels/csrc/fit.cu`` (no torch op between them):
  ``fit_basis``  one frame and 64 column units a block, each thread walking
                 the window's rows in order: the windowed basis A [B, N,
                 Kc2] written once, the right-hand side, dinv (from the
                 columns' sums of |A|^2 and |B|^2, the Gram's diagonal) and
                 the column mask; in iQHM or eaQHM mode (the repair, the
                 integer phase split, the cumsums, rho, the time-reversed
                 negative block), rounding where the torch ops round;
  ``fit_gram``   one frame and one 64 x 64 tile of R's upper triangle a
                 block (over the columns but the two DC ones; strip blocks
                 take those): R = E^H E over E = [A, o A] (B formed on load),
                 each entry below the diagonal the conjugate of its mirror
                 (G1 too taken as one triangle where Kc is a multiple of 32),
                 the identity at masked slots and the scaling in the
                 epilogue; R written once.  complex64 on FP32 FFMA (no
                 TF32), complex128 on the FP64 tensor cores.
On a CPU tensor they run the plain version, the torch ops the port had
before the kernels (``iqhm_gram_reference``, ``eaqhm_gram_reference``).
``fit_basis`` and ``fit_gram`` take CUDA tensors only.

``fit_basis.launches`` / ``fit_gram.launches`` count kernel launches and
``.shapes`` record (B, N, Kc, mode, type) and (B, N, Kc, type) per launch;
a launch recorded into a CUDA graph counts at each replay
(``take_captured``, ``count_replay``, ``.replayed``), as in ``ops.chol``.
``iqhm_gram.plain_calls`` / ``eaqhm_gram.plain_calls`` count the fits
served by the plain version.
"""
from __future__ import annotations

import math
import threading

import torch

from eaqhm_torch.kernels import build
from eaqhm_torch.ops import scan

MODES = ("iqhm", "eaqhm")
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
                         f" (iqhm_gram / eaqhm_gram run the plain version on"
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


def basis_call(mode, s_win, o, wl, dtype, *, f0=None, K=None, Kc=None,
               fm_win=None, am_win=None, colmask_k=None, fs, eps=1e-4):
    """One fit_basis launch without the launch: (outputs (A, rhs, dinv,
    mask) allocated, the symbol, its arguments but the stream, the operand
    tensors to keep alive).  Tensor work only (the CPU tests check the
    arguments against the library's argtypes)."""
    dev = s_win.device
    B, N = s_win.shape
    if mode == "eaqhm":
        Kc = fm_win.shape[-1]
    Kc2 = 2 * Kc + 1
    cdtype = complex_dtype(dtype)
    out = (torch.empty((B, N, Kc2), dtype=cdtype, device=dev),
           torch.empty((B, 2 * Kc2), dtype=cdtype, device=dev),
           torch.empty((B, 2 * Kc2), dtype=dtype, device=dev),
           torch.empty((B, Kc2), dtype=torch.uint8, device=dev))
    keep = [s_win.to(dtype).contiguous(), _vec(o, dtype, dev),
            _vec(wl, dtype, dev)]
    c = 2 * math.pi / fs
    if mode == "iqhm":
        keep += [_vec(f0, dtype, dev), _vec(K, torch.int64, dev)]
        scalars = (B, N, Kc, c)
    else:
        keep = [fm_win.to(dtype).contiguous(), am_win.to(dtype).contiguous(),
                *keep, colmask_k.to(torch.bool).contiguous()]
        scalars = (B, N, Kc, float(fs), c, float(eps))
    args = (*(t.data_ptr() for t in keep), *(t.data_ptr() for t in out),
            *scalars)
    return out, f"fit_basis_{mode}_{_real(dtype)}", args, keep


def gram_call(A, o, dinv, mask):
    """One fit_gram launch without the launch: (R allocated, the symbol,
    its arguments but the stream, the operand tensors to keep alive)."""
    B, N, Kc2 = A.shape
    M = 2 * Kc2
    R = torch.empty((B, M, M), dtype=A.dtype, device=A.device)
    real = A.real.dtype
    keep = [A, _vec(o, real, A.device), dinv.to(real).contiguous(), mask]
    sym = "fit_gram_c128" if A.dtype == torch.complex128 else "fit_gram_c64"
    args = (*(t.data_ptr() for t in keep), R.data_ptr(), B, N,
            (Kc2 - 1) // 2)
    return R, sym, args, keep


def fit_basis(mode, s_win, o, wl, dtype, *, f0=None, K=None, Kc=None,
              fm_win=None, am_win=None, colmask_k=None, fs, eps=1e-4):
    """The windowed basis and what the Gram's epilogue needs: (A [B, N,
    Kc2] complex, rhs [B, M] (scaled), dinv [B, M], mask [B, Kc2] uint8).
    mode "iqhm" takes f0, K, Kc; "eaqhm" fm_win, am_win [B, N, Kc] and
    colmask_k [B, Kc].  Launches the kernel (CUDA tensors only)."""
    if mode not in MODES:
        raise ValueError(f"fit_basis mode {mode!r} not in {MODES}")
    _real(dtype)
    _need_cuda(s_win)
    kw = dict(f0=f0, K=K, Kc=Kc, fm_win=fm_win, am_win=am_win,
              colmask_k=colmask_k, fs=fs, eps=eps)
    B, N = s_win.shape
    if mode == "eaqhm":
        Kc = fm_win.shape[-1]
        if tuple(fm_win.shape) != (B, N, Kc) or \
                tuple(am_win.shape) != (B, N, Kc) or \
                tuple(colmask_k.shape) != (B, Kc):
            raise ValueError(f"eaqhm fit_basis: fm_win {tuple(fm_win.shape)}"
                             f", am_win {tuple(am_win.shape)}, colmask_k "
                             f"{tuple(colmask_k.shape)} for s_win {(B, N)}")
    if tuple(o.shape) != (N,) or tuple(wl.shape) != (B,):
        raise ValueError(f"fit_basis: o {tuple(o.shape)}, wl "
                         f"{tuple(wl.shape)} for s_win {(B, N)}")
    out, sym, args, _keep = basis_call(mode, s_win, o, wl, dtype, **kw)
    if B > 0:
        _launch(fit_basis, sym, s_win.device, *args)
        _record(fit_basis, (B, N, Kc, mode, str(dtype).split(".")[-1]))
    return out


def fit_gram(A, o, dinv, mask):
    """R [B, M, M] from fit_basis's A, dinv and mask (o: [N] offsets): R =
    E^H E over E = [A, o A], each entry below the diagonal the conjugate of
    its mirror, the identity added at masked slots, scaled by dinv_i dinv_j.
    Launches the kernel (CUDA tensors only)."""
    if A.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"fit_gram takes complex64/complex128, got {A.dtype}")
    _need_cuda(A)
    B, N, Kc2 = A.shape
    if tuple(dinv.shape) != (B, 2 * Kc2) or tuple(mask.shape) != (B, Kc2) \
            or tuple(o.shape) != (N,):
        raise ValueError(f"fit_gram: dinv {tuple(dinv.shape)}, mask "
                         f"{tuple(mask.shape)}, o {tuple(o.shape)} for A "
                         f"{(B, N, Kc2)}")
    if not (A.is_contiguous() and mask.is_contiguous()
            and mask.dtype == torch.uint8):
        raise ValueError("fit_gram needs a contiguous A and uint8 mask")
    R, sym, args, _keep = gram_call(A, o, dinv, mask)
    if B > 0:
        _launch(fit_gram, sym, A.device, *args)
        _record(fit_gram, (B, N, (Kc2 - 1) // 2,
                           str(A.dtype).split(".")[-1]))
    return R


def iqhm_gram(s_win, o, wl, f0, K, fs, Kc, dtype=torch.float64):
    """Stationary-fit normal equations (reference functions.py:420-470).

    s_win: [B, N] signal windows centered on each frame; o: [N] centered
    offsets (-W..W); wl: [B] half-widths; f0: [B]; K: [B] per-frame harmonic
    count; Kc: static max harmonic.  Returns (R, rhs, dinv): on a CUDA
    tensor from the kernels, on a CPU tensor from the plain version.
    """
    if s_win.device.type == "cpu":
        _count_plain(iqhm_gram)
        return iqhm_gram_reference(s_win, o, wl, f0, K, fs, Kc, dtype=dtype)
    A, rhs, dinv, mask = fit_basis("iqhm", s_win, o, wl, dtype, f0=f0, K=K,
                                   Kc=Kc, fs=fs)
    return fit_gram(A, o, dinv, mask), rhs, dinv


def eaqhm_gram(s_win, fm_win, am_win, o, wl, colmask_k, fs,
               dtype=torch.float64, eps=1e-4):
    """Non-stationary-fit normal equations (reference functions.py:472-535).

    fm_win/am_win: [B, N, Kc] track windows (positive harmonics 1..Kc at
    slots 0..Kc-1), already overlay-corrected; zeros are repaired here.
    colmask_k: [B, Kc] selected harmonics.  Returns (R, rhs, dinv): on a
    CUDA tensor from the kernels, on a CPU tensor from the plain version.
    """
    if s_win.device.type == "cpu":
        _count_plain(eaqhm_gram)
        return eaqhm_gram_reference(s_win, fm_win, am_win, o, wl, colmask_k,
                                    fs, dtype=dtype, eps=eps)
    A, rhs, dinv, mask = fit_basis("eaqhm", s_win, o, wl, dtype,
                                   fm_win=fm_win, am_win=am_win,
                                   colmask_k=colmask_k, fs=fs, eps=eps)
    return fit_gram(A, o, dinv, mask), rhs, dinv


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
        for entry in (iqhm_gram, eaqhm_gram):
            entry.plain_calls = 0
    _tls.captured = None


reset_counts()
