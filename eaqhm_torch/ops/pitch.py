"""SWIPE' pitch on the device: the hand-written CUDA kernels and their plain
PyTorch versions.

The JAX package computes the pitch stage (eaqhm_tpu/models/swipe.py:203
``pitch_strength`` with eaqhm_tpu/ops/stft.py:46 ``specgram_psd``, :230
``fine_tune``, :258 ``swipep``) as one XLA program per plan.  Here a call is,
per window size of the plan: the DFT product of the windowed frames against
the cached bases (``ops.stft.spectrum``, ``torch.matmul``), then

  ``swipe_loudness``  a block per (utterance, frame): at the two bins of
                      every ERB point |X|^2 times the PSD's factor, the ERB
                      lerp, sqrt(max(0, .)), the frame's norm (summed in a
                      fixed order) and the normalized loudness, written
                      only as Ln [B, nerb, nf] (the PSD is never stored);

then the candidate-kernel product ``Si = kernel @ Ln`` (``torch.matmul``), and
once a call

  ``swipe_pick``      a thread per (utterance, 1 ms step): each candidate's
                      strength from every window size's Si (the time lerp,
                      the mu blend, added in window order from 0 as
                      ``index_add_`` adds), the first argmax, the parabola
                      ``vinv[il] @ y``, the fine grid's first argmax and the
                      edge rule, written as [B, T, 3] (t, f0, strength); the
                      strength matrix S is never stored.

The kernels round every product and sum on their own, as the torch ops of
their plain versions do (``__dmul_rn`` / ``__dadd_rn`` and their float32
forms, which the compiler does not contract into fused multiply-adds), so
they pick the grid points the plain versions pick.  On a CUDA tensor ``loudness`` and ``pick``
launch the kernels (a failed build or launch raises); on a CPU tensor they
run the plain versions, ``loudness_reference`` and ``pick_reference``,
counted in their ``.plain_calls``.  ``swipe_loudness.launches`` /
``swipe_pick.launches`` count launches and ``.shapes`` record (B, nf, nerb,
type) / (B, T, nc, windows, type, plan key) per launch; ``reset_counts()`` sets them
to 0.  The pitch stage runs before the fused loop's graphs, so no launch is
recorded into one.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple

import torch

from eaqhm_torch.kernels import build

MAX_WINDOWS = 16          # window sizes a plan may have (kernels/csrc/swipe.cu)
_lock = threading.Lock()


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
    kernel: torch.Tensor      # [nj, nerb] candidate kernels
    j0: int                   # first candidate of the window's rows
    mu: torch.Tensor          # [nj] blend weights
    t_lo: torch.Tensor        # [T] int64: frame below each 1 ms step
    t_w: torch.Tensor         # [T] lerp weight


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


def _launch(counter, sym: str, dev: torch.device, shape, *args) -> None:
    lib = build.load("swipe")
    with torch.cuda.device(dev):
        err = getattr(lib, sym)(*args,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{sym} kernel launch failed: cudaError {err}")
    with _lock:
        counter.launches += 1
        counter.shapes.append(shape)


def _count_plain(entry) -> None:
    with _lock:
        entry.plain_calls += 1


# ---- swipe_loudness ----

def loudness_reference(spec, w: Window):
    """Normalized ERB loudness Ln [B, nerb, nf] of spectra re | im [B, nf,
    2 nbins] (torch ops): |X|^2 times the PSD factor at the two bins of each
    ERB point, their lerp, sqrt(max(0, .)) and each frame's unit norm (a
    zero frame stays 0)."""
    nb = spec.shape[-1] // 2
    lo, hi = w.erb_lo, w.erb_lo + 1

    def psd(idx):
        re, im = spec[..., idx], spec[..., nb + idx]
        return (re * re + im * im) * w.scale[idx]

    Pe = psd(lo) * (1 - w.erb_w) + psd(hi) * w.erb_w        # [B, nf, nerb]
    L = torch.sqrt(torch.clamp(Pe, min=0.0))
    norms = torch.sqrt(torch.sum(L * L, dim=-1, keepdim=True))
    Ln = torch.where(norms > 0, L / torch.where(norms > 0, norms, 1.0),
                     torch.zeros_like(L))
    return Ln.transpose(-1, -2).contiguous()


def loudness_call(spec, w: Window):
    """One swipe_loudness launch's output and arguments (no launch)."""
    B, nf, two_nb = spec.shape
    nerb = w.erb_lo.shape[0]
    out = torch.empty((B, nerb, nf), dtype=spec.dtype, device=spec.device)
    args = (_ptr(spec), _ptr(w.erb_lo), _ptr(w.erb_w), _ptr(w.scale),
            _ptr(out), B, nf, two_nb // 2, nerb)
    return out, f"swipe_loudness_{_real(spec.dtype)}", args


def _check_spec(spec, w: Window):
    if spec.dim() != 3 or not spec.is_contiguous():
        raise ValueError(f"swipe_loudness takes contiguous spectra [B, nf, "
                         f"2 nbins], not {tuple(spec.shape)}")
    if spec.shape[-1] != 2 * (w.nfft // 2 + 1):
        raise ValueError(f"spectra of {spec.shape[-1]} columns for nfft "
                         f"{w.nfft}")
    for t in (w.erb_lo, w.erb_w, w.scale):
        if t.device != spec.device or not t.is_contiguous():
            raise ValueError("the window's tables must be contiguous and on "
                             "the spectra's device")
    if w.erb_w.dtype != spec.dtype or w.scale.dtype != spec.dtype:
        raise TypeError("the window's tables must have the spectra's dtype")


def loudness(spec, w: Window):
    """Ln [B, nerb, nf] of spectra [B, nf, 2 nbins] (``ops.stft.spectrum``):
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if spec.device.type != "cuda":
        _count_plain(loudness)
        return loudness_reference(spec, w)
    _check_spec(spec, w)
    out, sym, args = loudness_call(spec, w)
    B, nf, nerb = spec.shape[0], spec.shape[1], w.erb_lo.shape[0]
    _launch(swipe_loudness, sym, spec.device,
            (B, nf, nerb, str(spec.dtype)[6:]), *args)
    return out


# ---- swipe_pick ----

def blend_reference(Si, plan: Plan):
    """The blended strength S [B, nc, T] of every window size's Si [B, nj,
    nf] (torch ops): the time lerp onto the 1 ms steps and the mu blend,
    added into zeros in window order (reference SWIPE.py:92-105)."""
    B = Si[0].shape[0]
    nc, T = plan.vinv.shape[0], plan.t.shape[0]
    S = torch.zeros((B, nc, T), dtype=Si[0].dtype, device=Si[0].device)
    for w, si in zip(plan.windows, Si):
        nj = si.shape[1]
        tw = w.t_w
        Sit = si[..., w.t_lo] * (1 - tw) + si[..., w.t_lo + 1] * tw
        j = torch.arange(w.j0, w.j0 + nj, device=si.device)
        S.index_add_(1, j, w.mu[:, None] * Sit)
    return S


def fine_tune_reference(S, plan: Plan):
    """Parabolic fine-tune of S [..., nc, T] on the 1/768-octave grid
    (reference SWIPE.py:108-131; torch ops): (p, s) [..., T].  A top or
    bottom edge argmax returns pc[0] and the coarse maximum."""
    dtype = S.dtype
    nc = S.shape[-2]
    smax = S.amax(dim=-2)
    i = S.argmax(dim=-2)                 # first maximum, as jnp.argmax
    il = i.clamp(1, nc - 2)
    y = [torch.gather(S, -2, (il + d).unsqueeze(-2)).squeeze(-2)
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
    """(t, f0, strength) [B, T, 3] from every window size's Si [B, nj, nf]
    (torch ops: ``blend_reference``, then ``fine_tune_reference``)."""
    p, s = fine_tune_reference(blend_reference(Si, plan), plan)
    return torch.stack([plan.t.expand_as(p), p, s], dim=-1)


def pick_call(Si, plan: Plan):
    """One swipe_pick launch's output and arguments (no launch); the host
    arrays of the windows' pointers are returned to be kept alive."""
    n = len(plan.windows)
    B, dtype, dev = Si[0].shape[0], Si[0].dtype, Si[0].device
    nc, gmax = plan.nftc.shape
    T = plan.t.shape[0]
    out = torch.empty((B, T, 3), dtype=dtype, device=dev)
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    host = (ptrs(*[_ptr(s) for s in Si]),
            ptrs(*[_ptr(w.t_lo) for w in plan.windows]),
            ptrs(*[_ptr(w.t_w) for w in plan.windows]),
            ptrs(*[_ptr(w.mu) for w in plan.windows]),
            ints(*[w.j0 for w in plan.windows]),
            ints(*[s.shape[1] for s in Si]),
            ints(*[s.shape[2] for s in Si]))
    args = (*[ctypes.cast(h, ctypes.c_void_p) for h in host], n,
            _ptr(plan.vinv), _ptr(plan.nftc), _ptr(plan.nftc_len),
            _ptr(plan.log2pc_left), _ptr(plan.t), float(plan.pc0), _ptr(out),
            B, nc, T, gmax)
    return out, f"swipe_pick_{_real(dtype)}", args, host


def _check_pick(Si, plan: Plan):
    if len(Si) != len(plan.windows) or not 0 < len(Si) <= MAX_WINDOWS:
        raise ValueError(f"swipe_pick takes one Si per window size (at most "
                         f"{MAX_WINDOWS}), got {len(Si)} for "
                         f"{len(plan.windows)}")
    B, dtype, dev = Si[0].shape[0], Si[0].dtype, Si[0].device
    for s, w in zip(Si, plan.windows):
        if (s.dim() != 3 or s.shape[0] != B or s.dtype != dtype
                or s.device != dev or not s.is_contiguous()
                or s.shape[1] != w.mu.shape[0]):
            raise ValueError(f"Si must be contiguous [B, nj, nf] of one "
                             f"dtype and device, got {tuple(s.shape)}")
        if s.shape[2] != w.nf:
            raise ValueError(f"Si of {s.shape[2]} frames for a window of "
                             f"{w.nf}")
        if w.t_w.dtype != dtype or w.mu.dtype != dtype:
            raise TypeError("the plan's tables must have Si's dtype")
    for t in (plan.vinv, plan.nftc, plan.nftc_len, plan.log2pc_left,
              plan.t):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("the plan's tables must be contiguous and on "
                             "Si's device")
        if t is not plan.nftc_len and t.dtype != dtype:
            raise TypeError("the plan's tables must have Si's dtype")


def pick(Si, plan: Plan):
    """(t, f0, strength) [B, T, 3] from every window size's Si [B, nj, nf]:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if Si[0].device.type != "cuda":
        _count_plain(pick)
        return pick_reference(Si, plan)
    _check_pick(Si, plan)
    out, sym, args, _host = pick_call(Si, plan)
    B, T, nc = Si[0].shape[0], plan.t.shape[0], plan.vinv.shape[0]
    _launch(swipe_pick, sym, Si[0].device,
            (B, T, nc, len(Si), str(Si[0].dtype)[6:], plan.key), *args)
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
