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
``_combine_buckets`` (:424), ``_scatter_and_interp`` (:549) and
``_masked_srer`` (:451), and the batch engine's ``_interp_and_synth``
(eaqhm_tpu/parallel/batch_engine.py:321), which XLA fuses on the TPU.

``stage`` takes the anchors of G groups (utterances) of K harmonic columns,
am, fm, ph [G, n, K] (any strides with the last 1, shared by the three),
the optional acceptance mask acc [G, n, K], the DC anchors a0 [G, n] and
the optional voiced mask [G, n].  ``stage_tiers`` takes one utterance's
per-tier frame results and the frame map that places them (``Tiers``,
``tier_map``), so the sequential engine scatters no grid.  On CUDA tensors
both launch the kernels of ``kernels/csrc/tracks.cu`` (no torch op between
them):
  ``track_spline``  (two launches: tiles, then apply) the not-a-knot second
                    derivatives M of every run of every column, the DC
                    columns included;
  ``track_synth``   every row of every column: dense am and fm_current
                    [G, L, K] (the next adaptation's fit reads them), the
                    anchor rows of am, fm and the corrected ph [3, G, n, K]
                    and of the DC [G, n] (the packaging reads them), s
                    [G, L] (a0 + 2 sum_k am cos(ph), or the harmonic sum
                    alone with the DC track apart), and with ``dense`` the
                    dense fm and ph.
``masked_srer`` launches ``track_srer`` (``srer_plan``: two launches over
chunks of 2048 samples, the sums, then the squared deviations from the
means and the SRER): per group the SRER over its first n_valid samples.
On CPU tensors they run the plain version
(``*_reference``: the torch ops the port had before the kernels; the tiers
gathered into the grid first), counted in the entry's ``.plain_calls``.  No
CUDA call goes to the plain version.  ``spline_plan`` and ``synth_plan``
and ``srer_plan`` read the kernels' launch geometry, which the launchers
choose (or check) themselves
(kernels/csrc/tracks_plan.h, built for the host by ``build.load_host``).

``track_spline.launches`` / ``track_synth.launches`` /
``track_srer.launches`` count calls (track_spline's two launches, and
track_srer's, count as one) and ``.shapes`` record per call (G, n, K, step,
type) / (G, n, K, L, step, fs, (dc, anchors, dense, acc given, voiced
given), type) / (G, L, per-group lengths, type); a launch recorded into a
CUDA graph counts at each replay (``take_captured``, ``count_replay``,
``.replayed``), as in ``ops.fit``.  The launches allocate their outputs and
scratch with torch (graph-safe) and never synchronize.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from eaqhm_torch.kernels import build

CPLEN = 48          # cp fixed point reached to f64 eps by ~24 unknowns
_lock = threading.Lock()
_tls = threading.local()
_prepared = set()


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


def _check_tiers(tiers, voiced, dt):
    """What the kernels read through the frame map, as ``_check`` for the
    dense form: fmap [n] int32, per tier a0 [Nb], am, fm, ph, acc [Nb, Kb]
    with Kb <= K, am and fm of tier 0's type, ph and a0 real, acc bool or
    uint8, voiced [1, n] bool or None; every tensor on the fmap's device."""
    fmap = tiers.fmap
    dev, n, K = fmap.device, fmap.shape[0], int(tiers.K)
    if fmap.dim() != 1 or fmap.dtype != torch.int32:
        raise ValueError(f"tracks stage: fmap {tuple(fmap.shape)} "
                         f"{fmap.dtype} (needs [n] int32)")
    if voiced is not None and (tuple(voiced.shape) != (1, n)
                               or voiced.device != dev):
        raise ValueError(f"tracks stage: voiced {tuple(voiced.shape)} on "
                         f"{voiced.device} for [1, {n}] on {dev}")
    for t, part in enumerate(tiers.parts):
        a0, am, fm, ph, acc = part
        Nb, Kb = am.shape if am.dim() == 2 else (-1, -1)
        if Kb > K or tuple(a0.shape) != (Nb,) or any(
                tuple(x.shape) != (Nb, Kb) for x in (fm, ph, acc)):
            raise ValueError(f"tracks stage: tier {t}: a0 {tuple(a0.shape)},"
                             f" am {tuple(am.shape)}, fm {tuple(fm.shape)}, "
                             f"ph {tuple(ph.shape)}, acc {tuple(acc.shape)} "
                             f"(needs [Nb] and [Nb, Kb], Kb <= K = {K})")
        if am.dtype != dt or fm.dtype != dt or not (
                ph.dtype.is_floating_point and a0.dtype.is_floating_point
                and not ph.is_complex() and not a0.is_complex()) or \
                acc.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"tracks stage: tier {t}: am {am.dtype}, fm "
                            f"{fm.dtype}, ph {ph.dtype}, a0 {a0.dtype}, acc "
                            f"{acc.dtype} (am and fm {dt}, acc bool)")
        if any(x.device != dev for x in part):
            raise ValueError(f"tracks stage: tier {t} on "
                             f"{[str(x.device) for x in part]}, the frame "
                             f"map on {dev}")


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


MAX_TIERS = 12      # tiers the kernels read (tracks.cu kMaxTiers)


class SplinePlan(NamedTuple):
    R: int          # anchors a tile
    tiles: int      # tiles along the anchor axis
    threads: int    # threads of a block (a warp a tile)


class SynthPlan(NamedTuple):
    Kl: int         # lanes a segment (the columns a thread steps over)
    S: int          # segments side by side in a block
    J: int          # slices of S segments a block takes in turn
    threads: int    # S * Kl rounded up to whole warps
    kept: bool      # fm kept between the passes
    smem: int       # dynamic shared memory, bytes
    blocks: int


def _plans():
    return build.load_host("tracks_plan")


@functools.lru_cache(maxsize=256)
def spline_plan(G: int, n: int, K: int) -> SplinePlan:
    """track_spline's tiles as its launcher chooses them
    (kernels/csrc/tracks_plan.h ``spline_plan``)."""
    out = (ctypes.c_longlong * 3)()
    if _plans().track_spline_plan(G, n, K, out) != 0:
        raise ValueError(f"tracks stage: no spline plan for G={G} n={n} "
                         f"K={K}")
    return SplinePlan(*out)


@functools.lru_cache(maxsize=256)
def synth_plan(G: int, n: int, K: int, step: int, length: int,
               itemsize: int) -> SynthPlan:
    """track_synth's block shape as its launcher chooses it
    (kernels/csrc/tracks_plan.h ``synth_plan``)."""
    out = (ctypes.c_longlong * 7)()
    if _plans().track_synth_plan(G, n, K, step, length, itemsize, out) != 0:
        raise ValueError(f"tracks stage: no synth plan for G={G} n={n} K={K}"
                         f" step={step} L={length}")
    Kl, S, J, threads, kept, smem, blocks = out
    return SynthPlan(Kl, S, J, threads, bool(kept), smem, blocks)


class Tiers(NamedTuple):
    """The per-tier frame results of one utterance and the frame map that
    reads them: what ``stage_tiers`` takes in place of a dense grid."""
    fmap: torch.Tensor    # [n] int32: row * 16 + tier, or -1 (no tier)
    parts: tuple          # per tier (a0 [Nb], am, fm, ph [Nb, Kb], acc
                          # [Nb, Kb] bool)
    K: int                # columns of the grid (the widest tier's Kb)


def tier_map(idx_list, n: int, device) -> torch.Tensor:
    """The frame map [n] int32 of tiers whose frames sit at idx_list (each
    [Nb]): row * 16 + tier where a tier's result lands, -1 where none does.
    As the scatter of eaqhm_tpu/models/engine.py ``_combine_buckets``
    (:424): indices clamped to [0, n], index n a dump row past the grid,
    later tiers over earlier ones.  Torch ops, once per geometry."""
    if len(idx_list) > MAX_TIERS:
        raise ValueError(f"tracks stage: {len(idx_list)} tiers (the kernels "
                         f"take {MAX_TIERS})")
    fmap = torch.full((n + 1,), -1, dtype=torch.int32, device=device)
    for t, idx in enumerate(idx_list):
        rows = torch.arange(idx.shape[0], dtype=torch.int32, device=device)
        fmap[idx.clamp(0, n)] = rows * 16 + t
    return fmap[:n]


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _desc(vals, keep):
    """The anchors' source as the kernels read it (kSrcHead + kSrcTier long
    longs a tier, host memory read before the launch): its address."""
    arr = (ctypes.c_longlong * len(vals))(*vals)
    keep.append(arr)
    return ctypes.addressof(arr)


def _dense_src(am, fm, ph, acc, a0, voiced, keep):
    dt = am.dtype
    ts = [am, fm, ph, _bytes(acc), a0.to(dt).contiguous(), _bytes(voiced)]
    keep.extend(ts)
    return _desc([0, 0] + [_ptr(t) for t in ts]
                 + [am.stride(0), am.stride(1)], keep)


def _tier_src(tiers: Tiers, voiced, dt, keep):
    voiced = _bytes(voiced)
    fmap = tiers.fmap.contiguous()
    vals = [fmap.data_ptr(), len(tiers.parts), 0, 0, 0, 0, 0, _ptr(voiced),
            0, 0]
    keep.extend([fmap, voiced])
    for a0, am, fm, ph, acc in tiers.parts:
        am, fm, ph = _layout(am, fm, ph.to(dt))
        acc = acc.view(torch.uint8) if acc.dtype == torch.bool else \
            acc.to(torch.uint8)
        if acc.stride(-1) != 1:
            acc = acc.contiguous()
        a0 = a0.to(dt)
        keep.extend([am, fm, ph, acc, a0])
        vals += [am.data_ptr(), fm.data_ptr(), ph.data_ptr(), acc.data_ptr(),
                 a0.data_ptr(), am.stride(0), acc.stride(0), a0.stride(0),
                 am.shape[1]]
    return _desc(vals, keep)


def spline_call(src, G, n, K, step, dt, dev):
    """One track_spline call (two launches) without the launch: (M [n, G*K
    + G], the symbol, its arguments but the stream, the scratch).  src: the
    address of the anchors' source (``_dense_src`` / ``_tier_src``)."""
    Ctot = G * K + G
    tiles = spline_plan(G, n, K).tiles
    M = torch.empty((n, Ctot), dtype=dt, device=dev)
    code = torch.empty((n, Ctot), dtype=torch.uint8, device=dev)
    agg = torch.empty((5, tiles, Ctot), dtype=dt, device=dev)
    keep = [cp_table(dt, dev), M, code, agg]
    args = (src, *[t.data_ptr() for t in keep], tiles, G, K, n, step)
    return M, f"track_spline_{_real(dt)}", args, keep


def synth_call(src, G, n, K, dt, dev, M, step, fs, length, *, dc, anchors,
               dense, out=None):
    """One track_synth launch without the launch: (Stage, the symbol, its
    arguments but the stream, the tensors to keep alive).  out: (am,
    fm_cur) buffers [G, L, K] (contiguous) to write into."""
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
    ins = [M, sine_bump(step, dt, dev)]
    outs = [st.am, st.fm_cur, st.fm, st.ph, st.anchors, st.a0_anchor, st.s,
            st.a0]
    args = (src, *[_ptr(t) for t in ins + outs], G, K, n, step, L,
            int(dc == "sum"), float(fs))
    return st, f"track_synth_{_real(dt)}", args, ins + outs


class SrerPlan(NamedTuple):
    chunks: int     # blocks a group and launch
    launches: int   # device launches of a call


@functools.lru_cache(maxsize=256)
def srer_plan(L: int) -> SrerPlan:
    """track_srer's chunks a group of L samples and its launches a call
    (kernels/csrc/tracks_plan.h ``srer_chunks``)."""
    out = (ctypes.c_longlong * 2)()
    if _plans().track_srer_plan(int(L), out) != 0:
        raise ValueError(f"tracks stage: no SRER plan for L={L}")
    return SrerPlan(*out)


def srer_call(det, s, lens, std_det, n_valid):
    """One track_srer call without the launch: (srer [G], the symbol,
    its arguments but the stream, the tensors to keep alive)."""
    G, L = s.shape
    dt = s.dtype
    nch = srer_plan(L).chunks
    srer = torch.empty(G, dtype=dt, device=s.device)
    part = torch.empty((G, nch, 4), dtype=dt, device=s.device)
    cnt = torch.empty(G, dtype=torch.int32, device=s.device)
    keep = [det, s, None if lens is None else lens.to(torch.int64)
            .contiguous(), None if std_det is None else std_det.to(dt)
            .reshape(1).contiguous(), srer, part, cnt]
    ptr = [0 if t is None else t.data_ptr() for t in keep]
    args = (*ptr, G, nch, L, det.stride(0), int(n_valid or 0))
    return srer, f"track_srer_{_real(dt)}", args, keep


def library(device=None):
    """The kernel library; with a CUDA device, track_synth's dynamic
    shared-memory limit is set on that device first (once per device,
    outside any capture)."""
    lib = build.load("tracks")
    if device is None:
        return lib
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _prepared:
        with _lock, torch.cuda.device(idx):
            err = lib.track_prepare()
            if err != 0:
                raise RuntimeError(f"tracks: setting track_synth's shared "
                                   f"memory on cuda:{idx} failed: cudaError "
                                   f"{err}")
            _prepared.add(idx)
    return lib


# kinds and phases of the clocked build (-DTRACKS_PHASE_CLOCKS), by slot
CLOCK_KINDS = ("spline_tiles_f32", "spline_tiles_f64", "spline_apply_f32",
               "spline_apply_f64", "synth_f32", "synth_f64")
CLOCK_PHASES = {"spline_tiles": ("look_back", "walk"),
                "spline_apply": ("folds", "entering_dp", "backward"),
                "synth": ("flags", "state", "pass_1", "pass_2", "row_sums")}


def occupancy(name, G, n, K, step, length, dtype) -> dict:
    """Blocks a SM holds at the launch of this shape (the CUDA runtime's
    count): ``track_spline`` {spline_tiles, spline_apply}, ``track_synth``
    {track_synth}."""
    f64 = int(dtype == torch.float64)
    lib = library(torch.cuda.current_device())
    if name == "track_spline":
        threads = spline_plan(G, n, K).threads
        return {k: lib.track_occupancy(base + f64, threads, 0)
                for k, base in (("spline_tiles", 0), ("spline_apply", 2))}
    plan = synth_plan(G, n, K, step, length, 8 if f64 else 4)
    return {"track_synth": lib.track_occupancy(
        (4 if plan.kept else 6) + f64, plan.threads, plan.smem)}


def _launch(counter, sym: str, dev: torch.device, *args) -> None:
    lib = library(dev)
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


def _spline(src, G, n, K, step, dt, dev):
    M, sym, args, _keep = spline_call(src, G, n, K, step, dt, dev)
    _launch(track_spline, sym, dev, *args)
    _record(track_spline, (G, n, K, step, str(dt)[6:]))
    return M


def _synth(src, G, n, K, dt, dev, M, step, fs, length, *, dc, anchors,
           dense, out, masks):
    st, sym, args, _keep = synth_call(src, G, n, K, dt, dev, M, step, fs,
                                      length, dc=dc, anchors=anchors,
                                      dense=dense, out=out)
    _launch(track_synth, sym, dev, *args)
    _record(track_synth, (G, n, K, int(length), step, float(fs),
                          (dc, bool(anchors), bool(dense)) + masks,
                          str(dt)[6:]))
    return st


def track_spline(am, fm, acc, a0, voiced, step: int):
    """The not-a-knot second derivatives M [n, G*K + G] of every run of
    every harmonic column (g*K + k) and of every DC column (G*K + g).
    Launches the kernels (CUDA tensors only)."""
    _need_cuda(am)
    keep = []
    src = _dense_src(am, fm, am, acc, a0, voiced, keep)
    G, n, K = am.shape
    return _spline(src, G, n, K, int(step), am.dtype, am.device)


def track_synth(am, fm, ph, acc, a0, voiced, M, step: int, fs: float,
                length: int, *, dc="sum", anchors=True, dense=False,
                out=None) -> Stage:
    """Every row of every column from the anchors and M (``stage``).
    Launches the kernel (CUDA tensors only)."""
    _need_cuda(am)
    keep = []
    src = _dense_src(am, fm, ph, acc, a0, voiced, keep)
    G, n, K = am.shape
    return _synth(src, G, n, K, am.dtype, am.device, M, int(step), fs,
                  length, dc=dc, anchors=anchors, dense=dense, out=out,
                  masks=(acc is not None, voiced is not None))


def track_srer(det, s, lens=None, std_det=None, n_valid=None):
    """The masked SRER per group [G].  Launches the kernel (CUDA tensors
    only)."""
    _need_cuda(s)
    srer, sym, args, _keep = srer_call(det, s, lens, std_det, n_valid)
    _launch(track_srer, sym, s.device, *args)
    _record(track_srer, (s.shape[0], s.shape[1], lens is not None,
                         str(s.dtype)[6:]))
    return srer


def _with_out(st, out):
    """A plain version's Stage written into the out buffers (am, fm_cur)."""
    if out is None:
        return st
    out[0].copy_(st.am)
    out[1].copy_(st.fm_cur)
    return st._replace(am=out[0], fm_cur=out[1])


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
        return _with_out(stage_reference(
            am, fm, ph, a0, step, fs, length, acc=acc, voiced=voiced, dc=dc,
            anchors=anchors, dense=dense), out)
    am, fm, ph = _layout(am, fm, ph.to(am.dtype))
    G, n, K = am.shape
    keep = []
    src = _dense_src(am, fm, ph, acc, a0, voiced, keep)
    M = _spline(src, G, n, K, step, am.dtype, am.device)
    return _synth(src, G, n, K, am.dtype, am.device, M, step, fs, length,
                  dc=dc, anchors=anchors, dense=dense, out=out,
                  masks=(acc is not None, voiced is not None))


def stage_tiers(tiers: Tiers, step: int, fs: float, length: int, *,
                voiced=None, dc="sum", anchors=True, dense=False,
                out=None) -> Stage:
    """``stage`` of one group whose anchors are per-tier frame results read
    through a frame map (``Tiers``, ``tier_map``): the grid [1, n, K] holds
    tier t's row r at every frame the map gives (t, r), its columns past
    the tier's Kb and the frames in no tier zero.  voiced: [1, n] or None.
    On CUDA the kernels read the tiers themselves (no grid is built); on
    the CPU the plain version gathers the grid
    (``gather_tiers_reference``), then ``stage_reference``."""
    if dc not in ("sum", "apart"):
        raise ValueError(f"tracks stage: dc {dc!r} not in ('sum', 'apart')")
    if not tiers.parts or len(tiers.parts) > MAX_TIERS:
        raise ValueError(f"tracks stage: {len(tiers.parts)} tiers (1 to "
                         f"{MAX_TIERS})")
    dt = tiers.parts[0][1].dtype
    _real(dt)
    step, length = int(step), int(length)
    n, K = tiers.fmap.shape[0], int(tiers.K)
    _check_tiers(tiers, voiced, dt)
    if n < 2 or step < 1 or step + 1 > 700 or (
            K > 0 and length < (n - 1) * step + 1):
        raise ValueError(f"tracks stage: {n} anchors, step {step}, length "
                         f"{length}")
    if tiers.fmap.device.type == "cpu":
        _count_plain(stage_tiers)
        a0, am, fm, ph, acc = gather_tiers_reference(tiers)
        return _with_out(stage_reference(
            am[None], fm[None], ph[None], a0[None], step, fs, length,
            acc=acc[None], voiced=voiced, dc=dc, anchors=anchors,
            dense=dense), out)
    dev = tiers.fmap.device
    keep = []
    src = _tier_src(tiers, voiced, dt, keep)
    M = _spline(src, 1, n, K, step, dt, dev)
    return _synth(src, 1, n, K, dt, dev, M, step, fs, length, dc=dc,
                  anchors=anchors, dense=dense, out=out,
                  masks=(True, voiced is not None))


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


def gather_tiers_reference(tiers: Tiers):
    """The plain version of the kernels' read through the frame map: the
    dense grid (a0 [n], am, fm, ph [n, K], acc [n, K] bool) gathered from
    the tiers, frame by frame, with torch ops."""
    fmap = tiers.fmap.long()
    n, K = fmap.shape[0], int(tiers.K)
    dt = tiers.parts[0][1].dtype
    dev = fmap.device
    a0 = torch.zeros(n, dtype=dt, device=dev)
    am, fm, ph = (torch.zeros((n, K), dtype=dt, device=dev)
                  for _ in range(3))
    acc = torch.zeros((n, K), dtype=torch.bool, device=dev)
    tier, row = fmap & 15, fmap >> 4
    for t, (a0_t, am_t, fm_t, ph_t, acc_t) in enumerate(tiers.parts):
        sel = (fmap >= 0) & (tier == t)
        r = row[sel]
        Kb = am_t.shape[1]
        a0[sel] = a0_t.to(dt)[r]
        am[sel, :Kb] = am_t[r]
        fm[sel, :Kb] = fm_t[r]
        ph[sel, :Kb] = ph_t.to(dt)[r]
        acc[sel, :Kb] = acc_t[r]
    return a0, am, fm, ph, acc


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
ENTRIES = (stage, stage_tiers, masked_srer)
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
