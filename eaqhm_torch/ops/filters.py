"""IIR filtering: elliptic design (host, float64, once per (fs, fc, type))
and its application on the tensor's device (lfilter, filtfilt,
ellip_filter, lfilter_blocked).

The reference uses 6th-order elliptic filters with zero-phase ``filtfilt``
for the optional pre-analysis high-pass and the VAD (reference
misc.py:167-182: ``ellip(6, .5, 60, 2*fc/fs, ftype)``).  Design is a tiny
host computation (scipy).  The main path keeps its host VAD and pre-filter
(scipy), as the JAX package does; the device filters serve device-resident
pipelines (``models.vad.voiced_unvoiced_frames``).

``lfilter`` runs the transposed direct-form II recursion in order, as
scipy and the JAX package's scan do: on CUDA one launch of the hand kernel
``kernels/csrc/lfilter.cu`` (one thread per row), on the CPU its plain
version, a loop over samples vectorised over rows.  The 30 Hz high-pass
(poles at radius 0.99939) needs float64, which the H100 has.

``lfilter_blocked`` is the JAX package's block-parallel formulation
(eaqhm_tpu/ops/filters.py:137-185) in state space (z[n+1] = A z[n] + B x[n],
y[n] = C z[n] + D x[n]): a block of L samples is

    y_blk = T x_blk + H z_start,    z_end = A^L z_start + E x_blk

with T the [L, L] lower-triangular Toeplitz matrix of the impulse response,
H[t] = C A^t and E[:, s] = A^(L-1-s) B, built on the host in float64; every
block's zero-state part is one matrix product and the block-boundary states
come from an affine prefix scan over the blocks (ops.scan).  Equal to the
recursion in exact arithmetic, and accurate for moderately conditioned
filters only: for the 30 Hz high-pass the powers of the companion matrix
grow to ~1e10 before they decay, as in the JAX version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import signal as _ssig

from eaqhm_torch.device import as_tensor
from eaqhm_torch.kernels import build
from eaqhm_torch.ops.scan import associative_scan


@functools.lru_cache(maxsize=None)
def design_ellip(fs: float, fc: float, ftype: str = "highpass"):
    """6th-order elliptic, 0.5 dB ripple, 60 dB stopband (reference
    misc.py:181).  Returns (b, a, zi) as float64 numpy arrays; ``zi`` is
    scipy's ``lfilter_zi`` steady-state initializer."""
    b, a = _ssig.ellip(6, 0.5, 60, 2.0 * fc / fs, ftype)
    zi = _ssig.lfilter_zi(b, a)
    return b, a, zi


@functools.lru_cache(maxsize=None)
def _state_space(b_key, a_key):
    """Transposed direct-form II state-space matrices (float64 numpy):
    z[n+1] = A z[n] + B x[n];  y[n] = C z[n] + D x[n]."""
    b = np.asarray(b_key, np.float64)
    a = np.asarray(a_key, np.float64)
    b = b / a[0]
    a = a / a[0]
    order = len(b) - 1
    A = np.zeros((order, order))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(order - 1)
    B = b[1:] - a[1:] * b[0]
    C = np.zeros(order)
    C[0] = 1.0
    D = b[0]
    return A, B, C, D


@functools.lru_cache(maxsize=32)
def _block_operators(b_key, a_key, block: int):
    """Host float64 operators of one block (module docstring): T [L, L],
    H [L, order], E [order, L], A^L [order, order]."""
    A, B, C, D = _state_space(b_key, a_key)
    order = A.shape[0]
    powers = np.empty((block + 1, order, order))       # A^0 .. A^L
    powers[0] = np.eye(order)
    for t in range(block):
        powers[t + 1] = A @ powers[t]
    H = np.einsum("j,tjk->tk", C, powers[:block])       # C A^t
    h = np.concatenate([[D], H[:block - 1] @ B])         # impulse response
    lag = np.arange(block)[:, None] - np.arange(block)[None, :]
    T = np.where(lag >= 0, h[np.clip(lag, 0, block - 1)], 0.0)
    E = np.einsum("sjk,k->js", powers[block - 1::-1], B)  # A^(L-1-s) B
    return T, H, E, powers[block]


def _affine_compose(l, r):
    """z -> A z + v maps: l first, then r."""
    la, lv = l
    ra, rv = r
    return (torch.matmul(ra, la),
            torch.einsum("nij,n...j->n...i", ra, lv) + rv)


def _normalised(b, a):
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    return b / a[0], a / a[0]


def lfilter_reference(b, a, x, z0):
    """Plain version of the kernel: the TDF2 recursion over the last axis
    of x [rows, n] from state z0 [rows, order], vectorised over rows.
    Returns (y, final state).  b, a normalised by a[0]."""
    order = len(b) - 1
    bt = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    at = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    z = z0.clone()
    zero = torch.zeros_like(z[:, :1])
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        xt = x[:, t:t + 1]
        yt = bt[0] * xt + z[:, :1]
        z = (bt[1:] * xt + torch.cat([z[:, 1:], zero], dim=1)
             - at[1:] * yt)[:, :order]
        y[:, t:t + 1] = yt
    return y, z


def _lfilter_kernel(b, a, x, z0):
    """One launch of the hand kernel (counted in ``lfilter.launches``)."""
    sym = {torch.float64: "lfilter_f64", torch.float32: "lfilter_f32"}
    if x.dtype not in sym:
        raise TypeError(f"lfilter takes float32/float64, got {x.dtype}")
    order = len(b) - 1
    coef = torch.as_tensor(np.concatenate([b, a[1:]]), dtype=x.dtype,
                           device=x.device)
    y = torch.empty_like(x)
    zf = torch.empty_like(z0)
    rows, n = x.shape
    # launched with x's device current (its stream belongs to it); the
    # kernel uses no shared memory, so it sets no per-device attribute
    lib = build.load("lfilter")
    with torch.cuda.device(x.device):
        err = getattr(lib, sym[x.dtype])(
            coef.data_ptr(), x.data_ptr(), z0.data_ptr(), y.data_ptr(),
            zf.data_ptr(), rows, n, order,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lfilter kernel launch failed: cudaError {err}")
    lfilter.launches += 1
    lfilter.shapes.append((rows, n, order, str(x.dtype).split(".")[-1]))
    return y, zf


def lfilter_with_state(b, a, x, zi=None, dtype=torch.float64, device=None):
    """IIR filter along the last axis of x (leading batch dims allowed):
    ``scipy.signal.lfilter(b, a, x, zi=zi)``.  Returns (y, final state).

    x: a tensor (kept on its device unless ``device`` is given) or
    array-like (sent to ``device``; None means CUDA, as everywhere in the
    port).  On CUDA one kernel launch; on the CPU the plain version.
    """
    b, a = _normalised(b, a)
    order = len(b) - 1
    x = as_tensor(x, device).to(dtype)
    batch = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if zi is None:
        z0 = torch.zeros((x2.shape[0], order), dtype=dtype, device=x.device)
    else:
        z0 = as_tensor(zi, x.device).to(dtype).expand(
            *batch, order).reshape(-1, order).contiguous()
    if x.device.type == "cuda":
        y, zf = _lfilter_kernel(b, a, x2, z0)
    elif x.device.type == "cpu":
        lfilter.plain_calls += 1
        y, zf = lfilter_reference(b, a, x2, z0)
    else:
        raise ValueError(f"lfilter runs on CUDA or CPU, not {x.device}")
    return y.reshape(x.shape), zf.reshape(*batch, order)


def lfilter(b, a, x, zi=None, dtype=torch.float64, device=None):
    """``scipy.signal.lfilter(b, a, x, zi=zi)`` along the last axis
    (returns y only; see :func:`lfilter_with_state`)."""
    return lfilter_with_state(b, a, x, zi=zi, dtype=dtype, device=device)[0]


def reset_counts() -> None:
    """Set the kernel's launch and plain-call counts to 0."""
    lfilter.launches = 0
    lfilter.shapes = []
    lfilter.plain_calls = 0


reset_counts()


def lfilter_blocked(b, a, x, zi=None, block: int = 1024,
                    dtype=torch.float32, device=None):
    """Block-parallel lfilter for long signals (module docstring): the
    JAX package's formulation, all matrix products and one log-depth scan.
    Accurate for moderately conditioned filters only.  ``device`` as for
    :func:`lfilter_with_state`."""
    x = as_tensor(x, device).to(dtype)
    dev = x.device
    b, a = _normalised(b, a)
    key = (tuple(b), tuple(a))
    order = len(b) - 1
    T, H, E, AL = (torch.as_tensor(m, dtype=dtype, device=dev)
                   for m in _block_operators(*key, block))
    batch = x.shape[:-1]
    n = x.shape[-1]
    nb = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(
        *batch, nb, block)
    if zi is None:
        z0 = torch.zeros((*batch, order), dtype=dtype, device=dev)
    else:
        z0 = as_tensor(zi, dev).to(dtype).expand(*batch, order)
    y0 = torch.matmul(xb, T.T)                          # [..., nb, L]
    zend0 = torch.matmul(xb, E.T)                       # [..., nb, order]
    # prefix maps of blocks 0..k applied to z0 give each block's end state
    mats = AL.expand(nb, order, order)
    Ak, pv = associative_scan(                          # Ak = A^(L(k+1))
        _affine_compose, (mats, zend0.movedim(-2, 0)), dim=0)
    z_end = (torch.einsum("nij,...j->n...i", Ak, z0) + pv).movedim(0, -2)
    z_start = torch.cat([z0[..., None, :], z_end[..., :-1, :]], dim=-2)
    y = y0 + torch.matmul(z_start, H.T)
    return y.reshape(*batch, nb * block)[..., :n]


def filtfilt(b, a, zi, x, dtype=torch.float64, device=None):
    """Zero-phase filtering matching scipy.signal.filtfilt defaults: odd
    extension of 3*max(len(a), len(b)) samples at both ends, forward and
    backward passes each started from ``zi`` scaled by the first sample
    (scipy method='pad', padtype='odd').  ``device`` as for
    :func:`lfilter_with_state`."""
    x = as_tensor(x, device).to(dtype)
    padlen = 3 * max(len(np.atleast_1d(a)), len(np.atleast_1d(b)))
    if x.shape[-1] <= padlen:
        raise ValueError("signal too short for filtfilt padlen=%d" % padlen)
    zi = as_tensor(zi, x.device).to(dtype)
    left = 2.0 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)
    y = lfilter(b, a, ext, zi=zi * ext[..., :1], dtype=dtype)
    y_rev = y.flip(-1)
    y2 = lfilter(b, a, y_rev, zi=zi * y_rev[..., :1], dtype=dtype)
    return y2.flip(-1)[..., padlen:-padlen]


def ellip_filter(x, fs, fc, ftype: str = "highpass", dtype=torch.float64,
                 device=None):
    """Reference ``misc.ellipFilter`` (misc.py:167-182): the elliptic
    filter applied forward and backward.  ``device`` as for
    :func:`lfilter_with_state`."""
    b, a, zi = design_ellip(float(fs), float(fc), ftype)
    return filtfilt(b, a, zi, x, dtype=dtype, device=device)
