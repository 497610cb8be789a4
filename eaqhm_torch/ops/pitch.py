"""SWIPE' pitch on the device: the hand-written CUDA kernels and their plain
PyTorch versions.

The JAX package computes the pitch stage (eaqhm_tpu/models/swipe.py:203
``pitch_strength`` with eaqhm_tpu/ops/stft.py:46 ``specgram_psd``, :230
``fine_tune``, :258 ``swipep``) as one XLA program per plan, and the engines'
5 ms f0 grid (eaqhm_tpu/models/engine.py:39 ``resample_f0_grid``) after it.
Here a call is

  ``swipe_loudness``  from the signal [B, L], every window size in two
                      launches: the windowed frames' DFT at the bins the
                      ERB lerp reads only, against a compact table of JAX's
                      cos | -sin columns (a small GEMM: FP64 tensor cores /
                      FP32 FFMA), then |X|^2 times the PSD's factor, the ERB
                      lerp, sqrt(max(0, .)), each frame's norm (summed in a
                      fixed order) and the normalized loudness, written as
                      Ln [B, nf, nerb] per window;

then per window the candidate-kernel product ``Si = Ln @ kernel^T`` [B, nf,
nj] (``torch.matmul``), and once a call

  ``swipe_pick``      a warp per (utterance, step): each candidate's
                      strength from every window size's Si (the time lerp,
                      the mu blend, added in window order from 0 as
                      ``index_add_`` adds), the first argmax (a warp
                      reduction), the parabola ``vinv[i] @ y``, the fine
                      grid's first argmax and the edge rule; with
                      ``grid=True`` only the two steps each point of the
                      engines' 5 ms grid reads, written as that grid
                      [B, Q, 3] with ``resample_f0_grid``'s rounding (the
                      tables once per device plan, ``resample_tables``),
                      else every step [B, T, 3] (t, f0, strength).

The kernels round every product and sum of their epilogues on their own, as
the torch ops of their plain versions do (``__dmul_rn`` / ``__dadd_rn`` and
their float32 forms), so swipe_pick is its plain version's function.  On a
CUDA tensor ``loudness`` and ``pick`` launch the kernels (a failed build or
launch raises); on a CPU tensor they run the plain versions,
``loudness_reference(ops.stft.spectrum(...))`` (the full DFT bases) and
``pick_reference`` / ``grid_reference``, counted in their ``.plain_calls``.
``loudness_table_reference`` is the loudness's plain form through the
compact table.  ``swipe_loudness.launches`` / ``swipe_pick.launches`` count
device launches (two a loudness call) and ``.shapes`` record (B, per window
(nfft, nf, nerb, ks), type, plan key) / (B, items, nc, windows, type, plan
key, grid) per call; ``reset_counts()`` sets them to 0.  The pitch stage
runs before the fused loop's graphs, so no launch is recorded into one.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple

import torch

from eaqhm_torch.kernels import build
from eaqhm_torch.ops import stft

MAX_WINDOWS = 16          # window sizes a plan may have (kernels/csrc/swipe.cu)
MAX_CANDIDATES = 512      # candidates swipe_pick takes (16 a lane)
LOUD_ROWS, LOUD_BINS = 128, 64  # swipe_loudness's DFT tile (frames x bins)
MAX_SPLITS = 8            # depth slices of a swipe_loudness launch at most
MAX_ERB = 1024            # ERB points a window of swipe_loudness may have
_lock = threading.Lock()
_prepared = set()         # devices whose kernel attributes are set
_sms = {}                 # device index -> its SMs (the depth splits fill them)


class Window(NamedTuple):
    """The device tables of one window size of a plan."""
    nfft: int
    hop: int
    pad_pre: int
    pad_post: int
    nf: int                   # frames of the padded signal
    window: torch.Tensor      # [nfft] analysis window
    scale: torch.Tensor       # [nbins] PSD factor (doubling / (fs sum w^2))
    erb_lo: torch.Tensor      # [nerb] int64: bin below each ERB point
    erb_w: torch.Tensor       # [nerb] lerp weight
    cols: torch.Tensor        # [nfft, nu, 2] the needed bins' (cos, -sin);
                              # None on a CPU plan (see ``table``)
    scale_c: torch.Tensor     # [nu] PSD factor of each needed bin
    erb_c: torch.Tensor       # [nerb] int32: erb_lo's index among them
    kernel: torch.Tensor      # [nj, nerb] candidate kernels
    j0: int                   # first candidate of the window's rows
    mu: torch.Tensor          # [nj] blend weights
    t_lo: torch.Tensor        # [T] int64: frame below each 1 ms step
    t_w: torch.Tensor         # [T] lerp weight


class Resample(NamedTuple):
    """``resample_f0_grid``'s tables for query times q [..., Q] on rows at
    times [..., T]: the row at or before each query (pc), the next (nx),
    the lerp weight and the queries before the first row."""
    pc: torch.Tensor          # [..., Q] int64
    nx: torch.Tensor          # [..., Q] int64
    g: torch.Tensor           # [..., Q]
    below: torch.Tensor       # [..., Q] bool


class Plan(NamedTuple):
    """The device tables of a plan (``models.swipe.device_plan``)."""
    windows: List[Window]
    vinv: torch.Tensor        # [nc, 3, 3]
    nftc: torch.Tensor        # [nc, gmax] fine grid abscissae
    nftc_mask: torch.Tensor   # [nc, gmax] bool
    nftc_len: torch.Tensor    # [nc] int32: the mask's length per row
    log2pc_left: torch.Tensor  # [nc]
    t: torch.Tensor           # [T] output times
    t_grid: torch.Tensor      # [Q] the engines' 5 ms f0-grid times
    grid: Resample            # the f0 grid's tables on t ([Q] each)
    pc0: float                # the lowest candidate (the edge rule's f0)
    key: tuple                # (fs, f0min, f0max, length) of the plan


class _Kernel:
    """A kernel's counters: launches and their shapes."""

    def __init__(self, name):
        self.name = name
        self.launches = 0
        self.shapes = []


swipe_loudness = _Kernel("swipe_loudness")
swipe_pick = _Kernel("swipe_pick")
KERNELS = (swipe_loudness, swipe_pick)


def _real(dtype) -> str:
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"the pitch kernels take float32 or float64, not {dtype}")


def _ptr(t) -> int:
    return t.data_ptr()


def _index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def library(device):
    """The kernel library, with the DFT kernel's shared-memory attribute
    set on ``device`` and the device's SM count read (once per device,
    outside any capture)."""
    lib = build.load("swipe")
    idx = _index(device)
    if idx not in _prepared:
        with _lock, torch.cuda.device(idx):
            err = lib.swipe_prepare()
            if err != 0:
                raise RuntimeError(f"swipe: setting the DFT kernel's "
                                   f"shared memory on cuda:{idx} failed: "
                                   f"cudaError {err}")
            _sms[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
            _prepared.add(idx)
    return lib


def sm_count(device) -> int:
    """The SMs of a CUDA device (read by ``library``)."""
    library(device)
    return _sms[_index(device)]


def _launch(counter, sym: str, dev: torch.device, shape, *args,
            launches: int = 1) -> None:
    lib = library(dev)
    with torch.cuda.device(dev):
        err = getattr(lib, sym)(*args,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{sym} kernel launch failed: cudaError {err}")
    with _lock:
        counter.launches += launches
        counter.shapes.append(shape)


def _count_plain(entry) -> None:
    with _lock:
        entry.plain_calls += 1


# ---- swipe_loudness ----

def _ln_from_psd(p_lo, p_hi, w: Window):
    """Ln [..., nerb] from the PSD at each ERB point's two bins: their lerp,
    sqrt(max(0, .)) and each frame's unit norm (a zero frame stays 0)."""
    Pe = p_lo * (1 - w.erb_w) + p_hi * w.erb_w
    L = torch.sqrt(torch.clamp(Pe, min=0.0))
    norms = torch.sqrt(torch.sum(L * L, dim=-1, keepdim=True))
    return torch.where(norms > 0, L / torch.where(norms > 0, norms, 1.0),
                       torch.zeros_like(L))


def loudness_reference(spec, w: Window):
    """Normalized ERB loudness Ln [B, nf, nerb] of spectra re | im [B, nf,
    2 nbins] (torch ops): |X|^2 times the PSD factor at the two bins of each
    ERB point, their lerp, sqrt(max(0, .)) and each frame's unit norm."""
    nb = spec.shape[-1] // 2

    def psd(idx):
        re, im = spec[..., idx], spec[..., nb + idx]
        return (re * re + im * im) * w.scale[idx]

    return _ln_from_psd(psd(w.erb_lo), psd(w.erb_lo + 1), w)


def table(w: Window, dtype, device) -> torch.Tensor:
    """The window's compact DFT table [nfft, nu, 2]: a CUDA plan's own; a
    CPU plan keeps none (its loudness reads the full bases), so it comes
    from ``ops.stft.dft_columns``' cache, built at its first request."""
    if w.cols is not None:
        return w.cols
    bins = torch.unique(torch.cat([w.erb_lo, w.erb_lo + 1]))
    return stft.dft_columns(w.nfft, bins.cpu().numpy(), dtype, device)


def loudness_table_reference(x, w: Window):
    """Ln [B, nf, nerb] of signals x [B, L] through the compact table, as
    the kernel forms it (torch ops): the frames (zero padding, hop), x * w,
    their product with the needed bins' (cos, -sin), |X|^2 times each bin's
    factor, then the ERB lerp, the loudness and its norm."""
    xp = torch.nn.functional.pad(x, (w.pad_pre, w.pad_post))
    frames = xp.unfold(-1, w.nfft, w.hop)
    cols = table(w, x.dtype, x.device)
    spec = torch.matmul(frames * w.window, cols.reshape(w.nfft, -1))
    re, im = spec[..., 0::2], spec[..., 1::2]
    P = (re * re + im * im) * w.scale_c                   # [B, nf, nu]
    lo = w.erb_c.long()
    return _ln_from_psd(P[..., lo], P[..., lo + 1], w)


def loudness_splits(M: int, nu: int, nfft: int, sms: int) -> int:
    """The depth slices of one window's DFT over M frames and nu needed
    bins on a card of ``sms`` SMs.  A window whose tiles fill a third of
    the card is not split (the slices' partial sums would cost more than
    they give); a smaller one (the SA19 plans' 130-258 frames, the 48 kHz
    plans' 4-13) is split in two while its tiles are fewer than the SMs, a
    slice keeps at least 128 samples and there are at most MAX_SPLITS, so
    that its table streams through every SM."""
    base = -(-M // LOUD_ROWS) * -(-nu // LOUD_BINS)
    ks = 1
    if base >= sms // 3:
        return ks
    while (base * ks < sms and ks < MAX_SPLITS and nfft % (64 * ks) == 0
           and nfft // (2 * ks) >= 128):
        ks *= 2
    return ks


def loudness_call(x, plan: Plan, sms: int):
    """One swipe_loudness call's outputs (Ln of each window size), its
    scratch and arguments (no launch) on a card of ``sms`` SMs.  Returns
    (outs, sym, args, keep, splits); keep holds the windows' argument
    arrays, the scratch and the tables, to be kept alive."""
    B, L = x.shape
    ws = plan.windows
    n = len(ws)
    cols = [table(w, x.dtype, x.device) for w in ws]
    outs, scratch, splits = [], [], []
    for w in ws:
        nu, M = w.scale_c.shape[0], B * w.nf
        ks = loudness_splits(M, nu, w.nfft, sms)
        splits.append(ks)
        outs.append(torch.empty((B, w.nf, w.erb_c.shape[0]), dtype=x.dtype,
                                device=x.device))
        scratch.append(torch.empty((M, nu) if ks == 1 else (ks, M, nu, 2),
                                   dtype=x.dtype, device=x.device))
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    host = (ptrs(*[_ptr(w.window) for w in ws]),
            ptrs(*[_ptr(c) for c in cols]),
            ptrs(*[_ptr(w.scale_c) for w in ws]),
            ptrs(*[_ptr(w.erb_c) for w in ws]),
            ptrs(*[_ptr(w.erb_w) for w in ws]),
            ptrs(*[_ptr(o) for o in outs]),
            ptrs(*[_ptr(t) for t in scratch]),
            ints(*[w.nf for w in ws]), ints(*[w.nfft for w in ws]),
            ints(*[w.hop for w in ws]), ints(*[w.pad_pre for w in ws]),
            ints(*[w.scale_c.shape[0] for w in ws]),
            ints(*[w.erb_c.shape[0] for w in ws]), ints(*splits))
    args = (_ptr(x), B, L, n,
            *[ctypes.cast(h, ctypes.c_void_p) for h in host])
    return (outs, f"swipe_loudness_{_real(x.dtype)}", args,
            (host, scratch, cols), splits)


def _check_signal(x, plan: Plan):
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"swipe_loudness takes contiguous signals [B, L], "
                         f"not {tuple(x.shape)}")
    if not 0 < len(plan.windows) <= MAX_WINDOWS:
        raise ValueError(f"swipe_loudness takes 1 to {MAX_WINDOWS} window "
                         f"sizes, not {len(plan.windows)}")
    for w in plan.windows:
        npad = w.pad_pre + x.shape[1] + w.pad_post
        if stft.frame_count(npad, w.nfft, w.hop) != w.nf:
            raise ValueError(f"signals of {x.shape[1]} samples for a window "
                             f"of {w.nf} frames")
        cols = table(w, x.dtype, x.device)
        if cols.shape != (w.nfft, w.scale_c.shape[0], 2):
            raise ValueError("the compact table does not fit the window")
        if w.erb_c.shape[0] > MAX_ERB:
            raise ValueError(f"swipe_loudness takes at most {MAX_ERB} ERB "
                             f"points, not {w.erb_c.shape[0]}")
        for t in (w.window, cols, w.scale_c, w.erb_c, w.erb_w):
            if t.device != x.device or not t.is_contiguous():
                raise ValueError("the window's tables must be contiguous and "
                                 "on the signals' device")
        for t in (w.window, cols, w.scale_c, w.erb_w):
            if t.dtype != x.dtype:
                raise TypeError("the window's tables must have the signals' "
                                "dtype")
        if w.erb_c.dtype != torch.int32:
            raise TypeError("erb_c must be int32")


def loudness(x, plan: Plan):
    """Ln [B, nf, nerb] of every window size of signals x [B, L]: on a CUDA
    tensor the kernel (two launches: the DFT of every window, then the ERB
    epilogue), on a CPU tensor the plain version on the full DFT bases
    (``loudness_reference(ops.stft.spectrum(...))``) per window."""
    if x.device.type != "cuda":
        _count_plain(loudness)
        return [loudness_reference(stft.spectrum(
            x, w.nfft, w.hop, w.window, w.pad_pre, w.pad_post), w)
            for w in plan.windows]
    _check_signal(x, plan)
    outs, sym, args, _keep, splits = loudness_call(x, plan,
                                                   sm_count(x.device))
    _launch(swipe_loudness, sym, x.device,
            (x.shape[0], tuple((w.nfft, w.nf, w.erb_c.shape[0], ks)
                               for w, ks in zip(plan.windows, splits)),
             str(x.dtype)[6:], plan.key), *args, launches=2)
    return outs


# ---- swipe_pick ----

def blend_reference(Si, plan: Plan):
    """The blended strength S [B, T, nc] of every window size's Si [B, nf,
    nj] (torch ops): the time lerp onto the 1 ms steps and the mu blend,
    added into zeros in window order (reference SWIPE.py:92-105)."""
    B = Si[0].shape[0]
    nc, T = plan.vinv.shape[0], plan.t.shape[0]
    S = torch.zeros((B, T, nc), dtype=Si[0].dtype, device=Si[0].device)
    for w, si in zip(plan.windows, Si):
        nj = si.shape[2]
        tw = w.t_w[:, None]
        Sit = si[:, w.t_lo, :] * (1 - tw) + si[:, w.t_lo + 1, :] * tw
        j = torch.arange(w.j0, w.j0 + nj, device=si.device)
        S.index_add_(2, j, w.mu * Sit)
    return S


def fine_tune_reference(S, plan: Plan):
    """Parabolic fine-tune of S [..., T, nc] on the 1/768-octave grid
    (reference SWIPE.py:108-131; torch ops): (p, s) [..., T].  A top or
    bottom edge argmax returns pc[0] and the coarse maximum."""
    dtype = S.dtype
    nc = S.shape[-1]
    smax = S.amax(dim=-1)
    i = S.argmax(dim=-1)                 # first maximum, as jnp.argmax
    il = i.clamp(1, nc - 2)
    y = [torch.gather(S, -1, (il + d).unsqueeze(-1)).squeeze(-1)
         for d in (-1, 0, 1)]
    v = plan.vinv[il]                                        # [..., T, 3, 3]
    # vinv[il] @ y with its products and sums written out in one order
    c = [(v[..., a, 0] * y[0] + v[..., a, 1] * y[1]) + v[..., a, 2] * y[2]
         for a in range(3)]
    g = plan.nftc[il]                                        # [..., T, gmax]
    vals = (c[0][..., None] * g * g + c[1][..., None] * g) + c[2][..., None]
    vals = torch.where(plan.nftc_mask[il], vals, -torch.inf)
    sfine = vals.amax(dim=-1)
    kbest = vals.argmax(dim=-1)
    step = (kbest - 1).to(dtype) * (1.0 / 768.0)
    p = torch.pow(2.0, plan.log2pc_left[il] + step)
    edge = (i == 0) | (i == nc - 1)
    p = torch.where(edge, plan.pc0, p)
    s = torch.where(edge, smax, sfine)
    return p, s


def pick_reference(Si, plan: Plan):
    """(t, f0, strength) [B, T, 3] from every window size's Si [B, nf, nj]
    (torch ops: ``blend_reference``, then ``fine_tune_reference``)."""
    p, s = fine_tune_reference(blend_reference(Si, plan), plan)
    return torch.stack([plan.t.expand_as(p), p, s], dim=-1)


def resample_tables(times, q) -> Resample:
    """``resample_f0_grid``'s tables (torch ops) for query times q [..., Q]
    on rows at times [..., T] (both contiguous, one dtype and device)."""
    T = times.shape[-1]
    previ = torch.searchsorted(times, q, right=True) - 1
    below = previ < 0
    pc = previ.clamp(0, T - 1)
    nx = (pc + 1).clamp(0, T - 1)
    t_pc, t_nx = times.gather(-1, pc), times.gather(-1, nx)
    denom = t_nx - t_pc
    ok = denom != 0
    zero = torch.zeros((), dtype=times.dtype, device=times.device)
    g = torch.where(ok, (q - t_pc) / torch.where(ok, denom, 1.0), zero)
    g = torch.where(below | (t_pc == q), zero, g)
    return Resample(pc, nx, g, below)


def resample_rows(rows, r: Resample, q):
    """Rows [..., T, C] (col 0 the time) resampled by the tables r [..., Q]
    at the query times q [..., Q] (torch ops): [..., Q, C], col 0 = q."""
    def rows_at(idx):
        return rows[..., 1:].gather(
            -2, idx[..., None].expand(*idx.shape, rows.shape[-1] - 1))

    out = rows_at(r.pc) * (1 - r.g[..., None]) + rows_at(r.nx) * r.g[..., None]
    out = torch.where(r.below[..., None], rows[..., :1, 1:], out)
    return torch.cat([q[..., None], out], dim=-1)


def resample_f0_grid(f0s, tq):
    """Linear row resampler == reference `getLinear` (functions.py:644-681).

    f0s: [..., T, C] rows with col 0 = time; tq: [Q] query times (same dtype
    and device).  Returns [..., Q, C] with col 0 = tq; each leading index is
    resampled on its own rows (``resample_tables``, then ``resample_rows``).
    """
    times = f0s[..., 0].contiguous()                          # [..., T]
    q = tq.expand(*times.shape[:-1], tq.shape[-1]).contiguous()
    return resample_rows(f0s, resample_tables(times, q), q)


def grid_reference(Si, plan: Plan):
    """The engines' f0 grid [B, Q, 3] from every window size's Si (torch
    ops): ``pick_reference``'s rows resampled onto ``plan.t_grid`` with the
    plan's tables, as ``resample_f0_grid`` resamples them."""
    rows = pick_reference(Si, plan)
    B, Q = rows.shape[0], plan.t_grid.shape[0]
    r = Resample(*(t.expand(B, Q) for t in plan.grid))
    return resample_rows(rows, r, plan.t_grid.expand(B, Q))


def pick_call(Si, plan: Plan, grid: bool = False):
    """One swipe_pick launch's output and arguments (no launch); the host
    arrays of the windows' pointers are returned to be kept alive."""
    n = len(plan.windows)
    B, dtype, dev = Si[0].shape[0], Si[0].dtype, Si[0].device
    nc, gmax = plan.nftc.shape
    T = plan.t.shape[0]
    Q = plan.t_grid.shape[0] if grid else 0
    out = torch.empty((B, Q if grid else T, 3), dtype=dtype, device=dev)
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    host = (ptrs(*[_ptr(s) for s in Si]),
            ptrs(*[_ptr(w.t_lo) for w in plan.windows]),
            ptrs(*[_ptr(w.t_w) for w in plan.windows]),
            ptrs(*[_ptr(w.mu) for w in plan.windows]),
            ints(*[w.j0 for w in plan.windows]),
            ints(*[s.shape[2] for s in Si]),
            ints(*[s.shape[1] for s in Si]))
    tabs = ((_ptr(plan.grid.pc), _ptr(plan.grid.nx), _ptr(plan.grid.g),
             _ptr(plan.grid.below)) if grid else (0,) * 4)
    args = (*[ctypes.cast(h, ctypes.c_void_p) for h in host], n,
            _ptr(plan.vinv), _ptr(plan.nftc), _ptr(plan.nftc_len),
            _ptr(plan.log2pc_left), _ptr(plan.t_grid if grid else plan.t),
            float(plan.pc0), *tabs, Q, _ptr(out), B, nc, T, gmax)
    return out, f"swipe_pick_{_real(dtype)}", args, host


def _check_pick(Si, plan: Plan):
    if len(Si) != len(plan.windows) or not 0 < len(Si) <= MAX_WINDOWS:
        raise ValueError(f"swipe_pick takes one Si per window size (at most "
                         f"{MAX_WINDOWS}), got {len(Si)} for "
                         f"{len(plan.windows)}")
    if not 3 <= plan.vinv.shape[0] <= MAX_CANDIDATES:
        raise ValueError(f"swipe_pick takes 3 to {MAX_CANDIDATES} "
                         f"candidates, not {plan.vinv.shape[0]}")
    B, dtype, dev = Si[0].shape[0], Si[0].dtype, Si[0].device
    for s, w in zip(Si, plan.windows):
        if (s.dim() != 3 or s.shape[0] != B or s.dtype != dtype
                or s.device != dev or not s.is_contiguous()
                or s.shape[2] != w.mu.shape[0]):
            raise ValueError(f"Si must be contiguous [B, nf, nj] of one "
                             f"dtype and device, got {tuple(s.shape)}")
        if s.shape[1] != w.nf:
            raise ValueError(f"Si of {s.shape[1]} frames for a window of "
                             f"{w.nf}")
        if w.t_w.dtype != dtype or w.mu.dtype != dtype:
            raise TypeError("the plan's tables must have Si's dtype")
    for t in (plan.vinv, plan.nftc, plan.nftc_len, plan.log2pc_left,
              plan.t, plan.t_grid, *plan.grid):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("the plan's tables must be contiguous and on "
                             "Si's device")
    for t in (plan.vinv, plan.nftc, plan.log2pc_left, plan.t, plan.t_grid,
              plan.grid.g):
        if t.dtype != dtype:
            raise TypeError("the plan's tables must have Si's dtype")


def pick(Si, plan: Plan, grid: bool = False):
    """From every window size's Si [B, nf, nj]: (t, f0, strength) [B, T, 3]
    at every step, or with grid the engines' f0 grid [B, Q, 3]; the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if Si[0].device.type != "cuda":
        _count_plain(pick)
        return (grid_reference if grid else pick_reference)(Si, plan)
    _check_pick(Si, plan)
    out, sym, args, _host = pick_call(Si, plan, grid)
    _launch(swipe_pick, sym, Si[0].device,
            (Si[0].shape[0], out.shape[1], plan.vinv.shape[0], len(Si),
             str(Si[0].dtype)[6:], plan.key, grid), *args)
    return out


ENTRIES = (loudness, pick)


def plain_calls() -> int:
    """Calls the plain versions served since the counts were set to 0."""
    with _lock:
        return sum(entry.plain_calls for entry in ENTRIES)


def reset_counts() -> None:
    """Set every count of this module to 0."""
    with _lock:
        for counter in KERNELS:
            counter.launches = 0
            counter.shapes = []
        for entry in ENTRIES:
            entry.plain_calls = 0


reset_counts()
