"""SWIPE' pitch estimation (reference SWIPE.py:14-195).

A static plan of host float64 constants per (fs, plim, length)
(``make_plan``), uploaded once per (plan, dtype, device) and kept there
(``device_plan``), plus a device runtime: the normalized ERB loudness of
every frame of every power-of-2 window size straight from the signal
(``ops.pitch.loudness``: on CUDA the DFT at the needed bins only, against a
compact table of the DFT's columns cached per (nfft, bins, dtype, device);
matplotlib-PSD semantics), per window a [nf x nERB] @ [nERB x nCand] kernel
product, then the time lerp, the blend and a parabolic fine-tune on a
1/768-octave grid (``ops.pitch.pick``).  ``swipep`` takes one utterance [L]
or a batch [B, L] and returns every 1 ms step; ``f0_grid`` returns the
engines' 5 ms f0 grid, on CUDA written by the pick kernel itself.  On a
CUDA tensor they run the hand kernels, on a CPU tensor their plain versions
(``ops.pitch``; the loudness through the full DFT bases).

Replicated reference quirks: the last selected candidate row per window size
is zero (SWIPE.py:147 loops to len(pc)-1); argmax at the top edge returns
pc[0] (SWIPE.py:120-121); spectra are one-sided PSDs, so loudness is
sqrt(PSD) with the frequency-dependent doubling baked in.
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from eaqhm_torch.ops import pitch as pitch_ops
from eaqhm_torch.ops import stft as stft_ops

# device plans built (each a set of uploads), and the lock they build under
_device_lock = threading.Lock()
device_plans_built = 0


def hz2erbs(hz):
    """Hz -> ERB-rate scale (reference SWIPE.py:186-189)."""
    return 21.4 * np.log10(1 + np.asarray(hz) / 229.0)


def erbs2hz(erbs):
    """ERB-rate -> Hz (reference SWIPE.py:192-195)."""
    return (np.power(10, np.asarray(erbs) / 21.4) - 1) * 229.0


def _primes_upto(n: int) -> List[int]:
    """{1} U primes <= n+1 (reference SWIPE.py:151-163 includes 1)."""
    out = []
    for i in range(1, n + 2):
        if all(i % d for d in range(2, int(np.sqrt(i)) + 1)):
            out.append(i)
    return out


def _candidate_kernel(fERBs: np.ndarray, pc: float) -> np.ndarray:
    """Prime-harmonic cosine kernel row for one candidate (SWIPE.py:166-183)."""
    n = int(np.fix(fERBs[-1] / pc - 0.75))
    q = fERBs / pc
    k = np.zeros_like(fERBs)
    for i in _primes_upto(n):
        a = np.abs(q - i)
        k[a < 0.25] = np.cos(2 * np.pi * q[a < 0.25])
        v = (0.25 < a) & (a < 0.75)
        k[v] = np.cos(2 * np.pi * q[v]) / 2.0
    k = k * np.sqrt(1.0 / fERBs)
    pos = k[k > 0.0]
    return k / np.linalg.norm(pos)


@dataclass
class _WindowPlan:
    nfft: int
    hop: int
    pad_pre: int
    pad_post: int
    window: np.ndarray
    erb_lo: np.ndarray       # [nerb] gather index into rfft bins
    erb_w: np.ndarray        # [nerb] lerp weight
    j: np.ndarray            # candidate subset indices [nj]
    kernel: np.ndarray       # [nj, nerb], last row zeroed
    mu: np.ndarray           # [nj] blend weights
    t_lo: np.ndarray         # [T] gather index into frame-time grid
    t_w: np.ndarray          # [T] lerp weight


@dataclass
class SwipePlan:
    """All static constants for one (fs, plim, signal length)."""
    fs: float
    length: int
    pc: np.ndarray           # [nc] pitch candidates (1/96 octave)
    f0min: float
    f0max: float
    t: np.ndarray            # [T] output times (1 ms)
    windows: List[_WindowPlan] = field(default_factory=list)
    vinv: np.ndarray = None  # [nc, 3, 3]: parabola coeffs = vinv[i] @ y
    nftc: np.ndarray = None  # [nc, gmax] fine grid abscissae
    nftc_mask: np.ndarray = None
    log2pc_left: np.ndarray = None  # [nc] log2(pc[i-1]) (0 at edges)
    # (dtype, device) -> ops.pitch.Plan, built by device_plan
    devices: dict = field(default_factory=dict, repr=False, compare=False)


@functools.lru_cache(maxsize=16)
def make_plan(fs: float, f0min: float, f0max: float, length: int) -> SwipePlan:
    """Precompute the full SWIPE' plan (host, float64): the setup math of
    reference SWIPE.py:26-50 and the per-window constants of SWIPE.py:52-105."""
    fs = float(fs)
    plim = np.array([f0min, f0max], dtype=np.float64)
    dt = 0.001
    dlog2p = 1.0 / 96.0
    dERBs = 0.1

    t = np.arange(0, length / fs, dt)
    log2pc = np.arange(np.log2(plim[0]), np.log2(plim[1]), dlog2p)
    pc = np.power(2.0, log2pc)
    nc = len(pc)

    logWs = np.round(np.log2(8.0 * fs / plim))
    ws_list = np.power(2, np.arange(logWs[0], logWs[1] - 1, -1))
    pO = 8.0 * fs / ws_list
    d = 1 + log2pc - np.log2(8.0 * fs / ws_list[0])
    fERBs = erbs2hz(np.arange(hz2erbs(pc[0] / 4), hz2erbs(fs / 2), dERBs))

    plan = SwipePlan(fs=fs, length=length, pc=pc, f0min=float(f0min),
                     f0max=float(f0max), t=t)
    for i in range(len(ws_list)):
        nfft = int(ws_list[i])
        dn = int(round(4.0 * fs / pO[i]))          # == nfft/2 (dc=4, K=2)
        hop = dn
        pad_pre = nfft // 2
        pad_post = int(dn + nfft / 2)
        npadded = pad_pre + length + pad_post
        window = np.hanning(nfft)

        f = np.arange(nfft // 2 + 1) * fs / nfft
        lo = np.clip(np.searchsorted(f, fERBs, side="right") - 1, 0, len(f) - 2)
        w = (fERBs - f[lo]) / (f[lo + 1] - f[lo])

        # candidate subset for this window size (reference SWIPE.py:79-88)
        if i == len(ws_list) - 1:
            j = np.argwhere(d - (i + 1) > -1).ravel()
            k = np.argwhere(d[j] - (i + 1) < 0).ravel()
        elif i == 0:
            j = np.argwhere(d - (i + 1) < 1).ravel()
            k = np.argwhere(d[j] - (i + 1) > 0).ravel()
        else:
            j = np.argwhere(np.abs(d - (i + 1)) < 1).ravel()
            k = np.arange(len(j))
        mu = np.ones(len(j))
        mu[k] = 1 - np.abs(d[j[k]] - (i + 1))

        kern = np.stack([_candidate_kernel(fERBs, pc[jj]) for jj in j])
        kern[-1, :] = 0.0                           # last row unused

        # frame times, shifted as the reference does (SWIPE.py:92-97)
        tf = stft_ops.frame_times(npadded, nfft, hop, fs)
        ti = np.concatenate([[0.0], tf[:-1]])
        tlo = np.clip(np.searchsorted(ti, t, side="right") - 1, 0, len(ti) - 2)
        tw = (t - ti[tlo]) / (ti[tlo + 1] - ti[tlo])

        plan.windows.append(_WindowPlan(
            nfft=nfft, hop=hop, pad_pre=pad_pre, pad_post=pad_post,
            window=window, erb_lo=lo, erb_w=w, j=j, kernel=kern, mu=mu,
            t_lo=tlo, t_w=tw))

    # ---- fine-tune constants (reference SWIPE.py:108-131) ----
    vinv = np.zeros((nc, 3, 3))
    grids = []
    log2pc_left = np.zeros(nc)
    for ci in range(1, nc - 1):
        I = np.arange(ci - 1, ci + 2)
        tc = 1.0 / pc[I]
        ntc = (tc / tc[1] - 1) * 2 * np.pi
        vinv[ci] = np.linalg.inv(np.vander(ntc, 3))
        ftc = 1.0 / np.power(2.0, np.arange(np.log2(pc[I[0]]),
                                            np.log2(pc[I[2]]), 0.0013021))
        grids.append((ftc / tc[1] - 1) * 2 * np.pi)
        log2pc_left[ci] = np.log2(pc[I[0]])
    gmax = max((len(g) for g in grids), default=0)
    nftc = np.zeros((nc, gmax))
    mask = np.zeros((nc, gmax), dtype=bool)
    for ci in range(1, nc - 1):
        g = grids[ci - 1]
        nftc[ci, :len(g)] = g
        mask[ci, :len(g)] = True
    plan.vinv = vinv
    plan.nftc = nftc
    plan.nftc_mask = mask
    plan.log2pc_left = log2pc_left
    return plan


def _window_tables(plan: SwipePlan, wp: _WindowPlan, dtype, dev):
    def t_(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    if not np.array_equal(wp.j, np.arange(wp.j[0], wp.j[0] + len(wp.j))):
        raise ValueError("a window's candidates are not one run")
    npadded = wp.pad_pre + plan.length + wp.pad_post
    scale = stft_ops.psd_scale(wp.nfft, wp.window, plan.fs)
    bins = np.union1d(wp.erb_lo, wp.erb_lo + 1)     # the needed bins
    return pitch_ops.Window(
        nfft=wp.nfft, hop=wp.hop, pad_pre=wp.pad_pre, pad_post=wp.pad_post,
        nf=stft_ops.frame_count(npadded, wp.nfft, wp.hop),
        window=t_(wp.window), scale=t_(scale),
        erb_lo=t_(wp.erb_lo, torch.long), erb_w=t_(wp.erb_w),
        cols=(stft_ops.dft_columns(wp.nfft, bins, dtype, dev)
              if dev.type == "cuda" else None),
        scale_c=t_(scale[bins]),
        erb_c=t_(np.searchsorted(bins, wp.erb_lo), torch.int32),
        kernel=t_(wp.kernel), j0=int(wp.j[0]), mu=t_(wp.mu),
        t_lo=t_(wp.t_lo, torch.long), t_w=t_(wp.t_w))


def device_plan(plan: SwipePlan, dtype, device) -> pitch_ops.Plan:
    """Every constant the pitch stage reads, in ``dtype`` on ``device``:
    uploaded at the first call of a (plan, dtype, device), under a lock, and
    read-only after (``run_streams``' threads share it): each window's
    tables and, on CUDA, compact DFT table (cached apart,
    ``ops.stft.dft_columns``; a CPU plan's loudness reads the full bases),
    the fine-tune's tables, and the 5 ms f0 grid's times and resample
    tables (``ops.pitch.resample_tables`` on the 1 ms steps' times)."""
    global device_plans_built
    key = (dtype, torch.device(device))
    dp = plan.devices.get(key)
    if dp is not None:
        return dp
    with _device_lock:
        dp = plan.devices.get(key)
        if dp is None:
            dev = key[1]

            def t_(a, dt=dtype):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                       device=dev)

            step = int(round(plan.fs * 5 / 1000))
            lens = plan.nftc_mask.sum(axis=1).astype(np.int32)
            if len(plan.pc) < 3 or lens[1:-1].min() < 1:
                raise ValueError("a pitch plan needs 3 candidates and a fine "
                                 "grid on every inner one")
            t = t_(plan.t)
            t_grid = t_(np.arange(0, plan.length - 1, step) / plan.fs)
            dp = pitch_ops.Plan(
                windows=[_window_tables(plan, wp, dtype, dev)
                         for wp in plan.windows],
                vinv=t_(plan.vinv), nftc=t_(plan.nftc),
                nftc_mask=t_(plan.nftc_mask, torch.bool),
                nftc_len=t_(lens, torch.int32),
                log2pc_left=t_(plan.log2pc_left), t=t, t_grid=t_grid,
                grid=pitch_ops.resample_tables(t, t_grid),
                pc0=float(plan.pc[0]),
                key=(plan.fs, plan.f0min, plan.f0max, plan.length))
            plan.devices[key] = dp
            device_plans_built += 1
    return dp


def _strengths(dp: pitch_ops.Plan, xb):
    """Si [B, nf, nj] of every window size of signals xb [B, L]: the
    loudness, then the candidate-kernel product."""
    return [torch.matmul(ln, w.kernel.t())
            for ln, w in zip(pitch_ops.loudness(xb, dp), dp.windows)]


def swipep(plan: SwipePlan, x):
    """Full SWIPE' estimate of x [L] or [B, L]: [T, 3] or [B, T, 3] (t, f0,
    strength) at every 1 ms step.  The loudness kernel's two launches for
    every window size, one kernel product per window, then one pick kernel
    (CUDA); the plain versions on a CPU tensor."""
    dp = device_plan(plan, x.dtype, x.device)
    xb = x if x.dim() == 2 else x[None]
    out = pitch_ops.pick(_strengths(dp, xb), dp)
    return out if x.dim() == 2 else out[0]


def f0_grid(plan: SwipePlan, x):
    """The engines' 5 ms f0 grid of x [L] or [B, L]: [Q, 3] or [B, Q, 3]
    (t_grid, f0, strength), ``resample_f0_grid`` of ``swipep`` at the
    device plan's ``t_grid``.  On CUDA the pick kernel picks only the steps
    the grid reads and writes the grid itself (one launch); on a CPU tensor
    ``resample_f0_grid(swipep(plan, x), t_grid)``."""
    dp = device_plan(plan, x.dtype, x.device)
    if x.device.type != "cuda":
        return pitch_ops.resample_f0_grid(swipep(plan, x), dp.t_grid)
    xb = x if x.dim() == 2 else x[None]
    out = pitch_ops.pick(_strengths(dp, xb), dp, grid=True)
    return out if x.dim() == 2 else out[0]
