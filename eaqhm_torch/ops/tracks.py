"""The tracks, synthesis and SRER stage of an adaptation: the hand-written
CUDA kernels and their plain PyTorch version.

After the fits of an adaptation, each harmonic column's accepted anchors
(one per analysis instant, spacing ``step`` samples) become dense tracks:
linear am, not-a-knot cubic fm per run of anchors (a 4-point cubic through
synthetic anchors for runs of 2-3), the segment-local phase with its 2 pi M
endpoint correction, fm_current from the unwrapped phase; the DC track is
one not-a-knot cubic over every anchor; s = a0 + 2 sum_k am cos(ph); and
the masked SRER.  The JAX package's eaqhm_tpu/models/tracks.py
``interpolate_tracks_anchors`` (:143), eaqhm_tpu/ops/interp.py
``notaknot_interp_uniform`` (:161), eaqhm_tpu/models/engine.py
``_scatter_and_interp`` (:549) and ``_masked_srer`` (:451), and the batch
engine's ``_interp_and_synth`` (eaqhm_tpu/parallel/batch_engine.py:321),
which XLA fuses on the TPU.

``stage`` takes the anchors of G groups (utterances) of K harmonic columns,
am, fm, ph [G, n, K] (any strides with the last 1, shared by the three),
the optional acceptance mask acc [G, n, K], the DC anchors a0 [G, n] and
the optional voiced mask [G, n].  On a CUDA tensor it launches two kernels
of ``kernels/csrc/tracks.cu`` (no torch op between them):
  ``track_spline``  the not-a-knot second derivatives M of every run of
                    every column, the DC columns included;
  ``track_synth``   every row of every column: dense am and fm_current
                    [G, L, K] (the next adaptation's fit reads them), the
                    anchor rows of am, fm and the corrected ph [3, G, n, K]
                    and of the DC [G, n] (the packaging reads them), s
                    [G, L] (a0 + 2 sum_k am cos(ph), or the harmonic sum
                    alone with the DC track apart), and with ``dense`` the
                    dense fm and ph.
``masked_srer`` launches ``track_srer``: per group the SRER over its first
n_valid samples.  On CPU tensors both run the plain version (``*_reference``:
the torch ops the port had before the kernels), counted in the entry's
``.plain_calls``.  No CUDA call goes to the plain version.

``track_spline.launches`` / ``track_synth.launches`` /
``track_srer.launches`` count kernel launches and ``.shapes`` record per
launch (G, n, K, step, type) / (G, n, K, L, step, fs, (dc, anchors, dense,
acc given, voiced given), type) / (G, L, per-group lengths, type); a
launch recorded into a CUDA graph
counts at each replay (``take_captured``, ``count_replay``,
``.replayed``), as in ``ops.fit``.  The launches allocate their outputs and
scratch with torch (graph-safe) and never synchronize.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from eaqhm_torch.kernels import build

CPLEN = 48          # cp fixed point reached to f64 eps by ~24 unknowns
_lock = threading.Lock()
_tls = threading.local()


# Host-built constants are made on the device once per (shape, dtype,
# device) and reused: an adaptation captured as a CUDA graph copies nothing
# from the host.
@functools.lru_cache(maxsize=64)
def cp_table(dtype, device):
    """Elimination multipliers of the uniform not-a-knot system."""
    ctab = np.zeros(CPLEN + 1)
    for k in range(1, CPLEN + 1):
        ctab[k] = 1.0 / (4.0 - ctab[k - 1])
    return torch.as_tensor(ctab, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def sine_bump(step: int, dtype, device):
    """Cumulative sine bump of the phase endpoint correction, [step]."""
    ft_cum = np.cumsum(np.sin(np.pi * np.arange(0, step + 1) / step))
    return torch.as_tensor(ft_cum[1:], dtype=dtype, device=device)


class Stage(NamedTuple):
    """What ``stage`` returns (None where not asked for)."""
    am: torch.Tensor                    # [G, L, K] dense am
    fm_cur: torch.Tensor                # [G, L, K] dense fm_current
    anchors: Optional[torch.Tensor]     # [3, G, n, K] am, fm, corrected ph
    a0_anchor: Optional[torch.Tensor]   # [G, n] the DC at the anchors
    s: torch.Tensor                     # [G, L] (a0 +) 2 sum_k am cos(ph)
    a0: Optional[torch.Tensor]          # [G, L] the DC track (dc="apart")
    fm: Optional[torch.Tensor]          # [G, L, K] dense fm (dense)
    ph: Optional[torch.Tensor]          # [G, L, K] dense ph (dense)


def _real(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the tracks stage takes float32/float64, got "
                        f"{dtype}")
    return "f64" if dtype == torch.float64 else "f32"


def _check(am, fm, ph, a0, acc, voiced, step, length):
    G, n, K = am.shape
    if fm.shape != am.shape or ph.shape != am.shape:
        raise ValueError(f"tracks stage: am {tuple(am.shape)}, fm "
                         f"{tuple(fm.shape)}, ph {tuple(ph.shape)}")
    if tuple(a0.shape) != (G, n) or (
            acc is not None and tuple(acc.shape) != (G, n, K)) or (
            voiced is not None and tuple(voiced.shape) != (G, n)):
        raise ValueError(f"tracks stage: a0 {tuple(a0.shape)}, acc "
                         f"{None if acc is None else tuple(acc.shape)}, "
                         f"voiced "
                         f"{None if voiced is None else tuple(voiced.shape)}"
                         f" for anchors {(G, n, K)}")
    if n < 2 or step < 1 or step + 1 > 700:
        raise ValueError(f"tracks stage: {n} anchors, step {step} (needs "
                         f"n >= 2, 1 <= step < 700)")
    if K > 0 and length < (n - 1) * step + 1:
        raise ValueError(f"tracks stage: length {length} < (n - 1) * step"
                         f" + 1 = {(n - 1) * step + 1}")


def _bytes(mask):
    """A bool mask as the kernels read it: contiguous bytes (a view, no
    copy, of a contiguous bool tensor)."""
    if mask is None:
        return None
    mask = mask.contiguous()
    return mask.view(torch.uint8) if mask.dtype == torch.bool else \
        mask.to(torch.uint8)


def _layout(am, fm, ph):
    """am, fm, ph sharing strides with a unit last stride: as given, else
    all three contiguous."""
    if am.stride() == fm.stride() == ph.stride() and am.stride(-1) == 1:
        return am, fm, ph
    return am.contiguous(), fm.contiguous(), ph.contiguous()


def spline_call(am, fm, acc, a0, voiced, step):
    """One track_spline launch without the launch: (M [n, G*K + G], the
    symbol, its arguments but the stream, the tensors to keep alive)."""
    G, n, K = am.shape
    dt, dev = am.dtype, am.device
    Ctot = G * K + G
    M = torch.empty((n, Ctot), dtype=dt, device=dev)
    code = torch.empty((n, Ctot), dtype=torch.uint8, device=dev)
    keep = [am, fm, _bytes(acc), a0.to(dt).contiguous(), _bytes(voiced),
            cp_table(dt, dev), M, code]
    ptr = [0 if t is None else t.data_ptr() for t in keep]
    args = (*ptr, G, K, n, am.stride(0), am.stride(1), step)
    return M, f"track_spline_{_real(dt)}", args, keep


def synth_call(am, fm, ph, acc, a0, voiced, M, step, fs, length, *,
               dc, anchors, dense, out=None):
    """One track_synth launch without the launch: (Stage, the symbol, its
    arguments but the stream, the tensors to keep alive).  out: (am,
    fm_cur) buffers [G, L, K] (contiguous) to write into."""
    G, n, K = am.shape
    dt, dev = am.dtype, am.device
    L = int(length)

    def new(*shape):
        return torch.empty(shape, dtype=dt, device=dev)
    if out is None:
        am_o, fmc_o = new(G, L, K), new(G, L, K)
    else:
        am_o, fmc_o = out
        if tuple(am_o.shape) != (G, L, K) or fmc_o.shape != am_o.shape or \
                not (am_o.is_contiguous() and fmc_o.is_contiguous()) or \
                am_o.dtype != dt or fmc_o.dtype != dt:
            raise ValueError(f"tracks stage: out buffers "
                             f"{tuple(am_o.shape)} / {tuple(fmc_o.shape)} "
                             f"for {(G, L, K)} {dt}")
    st = Stage(am=am_o, fm_cur=fmc_o,
               anchors=new(3, G, n, K) if anchors else None,
               a0_anchor=new(G, n) if anchors else None,
               s=new(G, L), a0=new(G, L) if dc == "apart" else None,
               fm=new(G, L, K) if dense else None,
               ph=new(G, L, K) if dense else None)
    ins = [am, fm, ph, _bytes(acc), a0.to(dt).contiguous(), _bytes(voiced),
           M, sine_bump(step, dt, dev)]
    outs = [st.am, st.fm_cur, st.fm, st.ph, st.anchors, st.a0_anchor, st.s,
            st.a0]
    ptr = [0 if t is None else t.data_ptr() for t in ins + outs]
    args = (*ptr, G, K, n, step, L, am.stride(0), am.stride(1),
            int(dc == "sum"), float(fs))
    return st, f"track_synth_{_real(dt)}", args, ins + outs


def srer_call(det, s, lens, std_det, n_valid):
    """One track_srer launch without the launch: (srer [G], the symbol,
    its arguments but the stream, the tensors to keep alive)."""
    G, L = s.shape
    dt = s.dtype
    srer = torch.empty(G, dtype=dt, device=s.device)
    keep = [det, s, None if lens is None else lens.to(torch.int64)
            .contiguous(), None if std_det is None else std_det.to(dt)
            .reshape(1).contiguous(), srer]
    ptr = [0 if t is None else t.data_ptr() for t in keep]
    args = (*ptr, G, L, det.stride(0), int(n_valid or 0))
    return srer, f"track_srer_{_real(dt)}", args, keep


def library():
    return build.load("tracks")


def _launch(counter, sym: str, dev: torch.device, *args) -> None:
    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, sym)(*args,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{sym} kernel launch failed: cudaError {err}")
    _count(counter, 1)


def _need_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"the tracks kernels take CUDA tensors, not "
                         f"{x.device} (the stage's entry points run the "
                         f"plain version on the CPU)")


def track_spline(am, fm, acc, a0, voiced, step: int):
    """The not-a-knot second derivatives M [n, G*K + G] of every run of
    every harmonic column (g*K + k) and of every DC column (G*K + g).
    Launches the kernel (CUDA tensors only)."""
    _need_cuda(am)
    M, sym, args, _keep = spline_call(am, fm, acc, a0, voiced, step)
    _launch(track_spline, sym, am.device, *args)
    G, n, K = am.shape
    _record(track_spline, (G, n, K, step, str(am.dtype)[6:]))
    return M


def track_synth(am, fm, ph, acc, a0, voiced, M, step: int, fs: float,
                length: int, *, dc="sum", anchors=True, dense=False,
                out=None) -> Stage:
    """Every row of every column from the anchors and M (``stage``).
    Launches the kernel (CUDA tensors only)."""
    _need_cuda(am)
    st, sym, args, _keep = synth_call(am, fm, ph, acc, a0, voiced, M, step,
                                      fs, length, dc=dc, anchors=anchors,
                                      dense=dense, out=out)
    _launch(track_synth, sym, am.device, *args)
    G, n, K = am.shape
    mode = (dc, bool(anchors), bool(dense), acc is not None,
            voiced is not None)
    _record(track_synth, (G, n, K, int(length), step, float(fs), mode,
                          str(am.dtype)[6:]))
    return st


def track_srer(det, s, lens=None, std_det=None, n_valid=None):
    """The masked SRER per group [G].  Launches the kernel (CUDA tensors
    only)."""
    _need_cuda(s)
    srer, sym, args, _keep = srer_call(det, s, lens, std_det, n_valid)
    _launch(track_srer, sym, s.device, *args)
    _record(track_srer, (s.shape[0], s.shape[1], lens is not None,
                         str(s.dtype)[6:]))
    return srer


def stage(am, fm, ph, a0, step: int, fs: float, length: int, *, acc=None,
          voiced=None, dc="sum", anchors=True, dense=False,
          out=None) -> Stage:
    """The tracks and synthesis of G groups of K harmonic columns.

    am, fm, ph: [G, n, K] anchor values (anchor i at sample i * step);
    acc: [G, n, K] acceptance (values outside it count as 0) or None; a0:
    [G, n] DC anchors; voiced: [G, n] (a0 outside it counts as 0) or None.
    dc="sum": s = a0 + 2 sum_k am cos(ph); dc="apart": s = 2 sum_k am
    cos(ph) and the DC track returned apart.  anchors: return the anchor
    rows (am, fm, the corrected ph; the DC).  dense: return dense fm and
    ph too.  out: (am, fm_cur) [G, L, K] buffers to write into.  On a CUDA
    tensor the kernels, on a CPU tensor the plain version
    (``stage_reference``)."""
    if dc not in ("sum", "apart"):
        raise ValueError(f"tracks stage: dc {dc!r} not in ('sum', 'apart')")
    _real(am.dtype)
    step, length = int(step), int(length)
    _check(am, fm, ph, a0, acc, voiced, step, length)
    if am.device.type == "cpu":
        _count_plain(stage)
        st = stage_reference(am, fm, ph, a0, step, fs, length, acc=acc,
                             voiced=voiced, dc=dc, anchors=anchors,
                             dense=dense)
        if out is None:
            return st
        out[0].copy_(st.am)
        out[1].copy_(st.fm_cur)
        return st._replace(am=out[0], fm_cur=out[1])
    am, fm, ph = _layout(am, fm, ph.to(am.dtype))
    M = track_spline(am, fm, acc, a0, voiced, step)
    return track_synth(am, fm, ph, acc, a0, voiced, M, step, fs, length,
                       dc=dc, anchors=anchors, dense=dense, out=out)


def masked_srer(det, s, *, std_det=None, n_valid=None, lens=None):
    """SRER over each group's first n_valid samples (the padded tail
    excluded): 20 log10(std_det / std(det - s)) (reference
    functions.py:388).  One utterance: det, s [L], std_det a 0-d tensor,
    n_valid an int; returns a 0-d tensor.  Groups: det, s [G, L], lens [G]
    (int64 tensor), std_det None (the masked std of det); returns [G].  On
    a CUDA tensor the kernel, on a CPU tensor the plain version."""
    one = s.dim() == 1
    if one != (lens is None) or (one and (std_det is None or n_valid is None)):
        raise ValueError("masked_srer: det, s [L] with std_det and n_valid,"
                         " or det, s [G, L] with lens")
    if s.device.type == "cpu":
        _count_plain(masked_srer)
        return masked_srer_reference(det, s, std_det=std_det,
                                     n_valid=n_valid, lens=lens)
    if one:
        return track_srer(det[None], s[None], std_det=std_det,
                          n_valid=n_valid)[0]
    return track_srer(det, s, lens=lens)


# ---------------------------------------------------------------------------
# the plain version: the torch ops of the port before the kernels
# ---------------------------------------------------------------------------

def stage_reference(am, fm, ph, a0, step: int, fs: float, length: int, *,
                    acc=None, voiced=None, dc="sum", anchors=True,
                    dense=False) -> Stage:
    """The plain version of ``stage``: the anchors masked, the groups'
    columns side by side through ``interpolate_tracks_anchors_reference``,
    the DC through ``notaknot_interp_uniform_reference``, the sum over
    each group's K columns."""
    from eaqhm_torch.models.tracks import interpolate_tracks_anchors_reference
    from eaqhm_torch.ops.interp import notaknot_interp_uniform_reference
    G, n, K = am.shape
    L = int(length)
    zero = torch.zeros((), dtype=am.dtype, device=am.device)
    if acc is not None:
        am, fm, ph = (torch.where(acc, x, zero) for x in (am, fm, ph))
    if voiced is not None:
        a0 = torch.where(voiced, a0, zero)
    a0_interp = notaknot_interp_uniform_reference(a0.T, step, L).T  # [G, L]

    def cols(x):                      # [G, n, K] -> [n, G*K]
        return x.permute(1, 0, 2).reshape(n, G * K)

    def groups(x, rows):              # [rows, G*K] -> [G, rows, K]
        return x.reshape(rows, G, K).permute(1, 0, 2)
    am_f, fm_f, ph_f, fm_cur = interpolate_tracks_anchors_reference(
        cols(am), cols(fm), cols(ph), step, fs, L)
    h_sum = torch.sum((am_f * torch.cos(ph_f)).reshape(L, G, K), dim=2).T
    s = a0_interp + 2.0 * h_sum if dc == "sum" else 2.0 * h_sum
    stk = a0_anc = None
    if anchors:
        rows = torch.arange(n, device=am.device) * step
        stk = torch.stack([groups(x[rows], n) for x in (am_f, fm_f, ph_f)])
        a0_anc = a0_interp[:, rows]
    return Stage(am=groups(am_f, L), fm_cur=groups(fm_cur, L), anchors=stk,
                 a0_anchor=a0_anc, s=s,
                 a0=a0_interp if dc == "apart" else None,
                 fm=groups(fm_f, L) if dense else None,
                 ph=groups(ph_f, L) if dense else None)


def spline_reference(am, fm, a0, step: int, *, acc=None, voiced=None):
    """The plain version of ``track_spline``: M [n, G*K + G] of the
    harmonic columns (g*K + k, each run of accepted anchors) and of the DC
    columns (G*K + g, one run over every anchor), by the segmented
    not-a-knot solve of models.tracks."""
    from eaqhm_torch.models.tracks import (_segmented_notaknot_M,
                                           spline_M_reference)
    G, n, K = am.shape
    zero = torch.zeros((), dtype=am.dtype, device=am.device)
    if acc is not None:
        am, fm = torch.where(acc, am, zero), torch.where(acc, fm, zero)
    if voiced is not None:
        a0 = torch.where(voiced, a0, zero)
    cols = [x.permute(1, 0, 2).reshape(n, G * K) for x in (am, fm)]
    dev = am.device
    ones = torch.ones((n, G), dtype=torch.bool, device=dev)
    M_dc = _segmented_notaknot_M(
        a0.T.to(am.dtype), ones, torch.zeros((n, G), dtype=torch.long,
                                             device=dev),
        torch.full((n, G), n - 1, dtype=torch.long, device=dev), float(step))
    return torch.cat([spline_M_reference(*cols, float(step)), M_dc], dim=1)


def masked_srer_reference(det, s, *, std_det=None, n_valid=None, lens=None):
    """The plain version of ``masked_srer``: one utterance as
    eaqhm_tpu/models/engine.py ``_masked_srer`` (:451) writes it, groups as
    the batch step's masked std (eaqhm_tpu/parallel/batch_engine.py)."""
    if lens is None:
        resid = det - s
        m = (torch.arange(resid.shape[0], device=det.device)
             < n_valid).to(det.dtype)
        nf = float(max(n_valid, 1))
        mu = torch.sum(resid * m) / nf
        sd = torch.sqrt(torch.sum(m * (resid - mu) ** 2) / nf)
        return 20.0 * torch.log10(std_det / sd)
    samp = torch.arange(s.shape[1], device=s.device)[None, :]
    msk = (samp < lens[:, None]).to(s.dtype)
    nf = torch.clamp(msk.sum(dim=1), min=1.0)

    def mstd(x):
        mu = torch.sum(x * msk, dim=1) / nf
        return torch.sqrt(torch.sum(msk * (x - mu[:, None]) ** 2, dim=1)
                          / nf)
    return 20.0 * torch.log10(mstd(det) / mstd(det - s))


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

KERNELS = (track_spline, track_synth, track_srer)
ENTRIES = (stage, masked_srer)
_KEY = {track_spline: "spline", track_synth: "synth", track_srer: "srer"}


def plain_calls() -> int:
    """Calls the plain version served since the counts were set to 0."""
    with _lock:
        return sum(entry.plain_calls for entry in ENTRIES)


def _captured() -> dict:
    rec = getattr(_tls, "captured", None)
    if rec is None:
        rec = _tls.captured = {key: [] for key in _KEY.values()}
    return rec


def _count(counter, n: int) -> None:
    if not torch.cuda.is_current_stream_capturing():
        with _lock:
            counter.launches += n


def _count_plain(entry) -> None:
    with _lock:
        entry.plain_calls += 1


def _record(counter, shape) -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured()[_KEY[counter]].append(shape)
    else:
        with _lock:
            counter.shapes.append(shape)


def take_captured() -> dict:
    """The launches (their shapes) this thread recorded into the CUDA graph
    it just captured, and a fresh record for its next capture."""
    out = _captured()
    _tls.captured = None
    return out


def count_replay(captured: dict) -> None:
    """Count the launches of one replay of a graph (``take_captured``)."""
    with _lock:
        for counter, key in _KEY.items():
            counter.launches += len(captured[key])
            counter.replayed += len(captured[key])
            counter.shapes.extend(captured[key])


def reset_counts() -> None:
    """Set every count of this module to 0, and this thread's capture
    record."""
    with _lock:
        for counter in KERNELS:
            counter.launches = 0
            counter.shapes = []
            counter.replayed = 0
        for entry in ENTRIES:
            entry.plain_calls = 0
    _tls.captured = None


reset_counts()
