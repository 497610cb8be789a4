"""eaQHM engine: per-adaptation analysis/synthesis + the adaptation loop.

Reference parity target: functions.py:35-418 `eaQHMAnalysisAndSynthesis`.
Dense [length, K] track arrays with boolean masks replace per-frame Python
loops.  Each adaptation is batched device work (Gram builds and solves per
harmonic tier, acceptance, track interpolation, synthesis, SRER).  The
adaptation loop and its keep-previous-on-decline rule (functions.py:394-402)
run on the host, one scalar fetch per adaptation, or, with
``fused_adapt_loop``, as the JAX package's fused loop
(eaqhm_tpu/models/engine.py:572-626): every eaQHM adaptation is one step
over static buffers with the keep-best select done on the device, captured
once as a CUDA graph and replayed (``_FusedLoop``).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from eaqhm_torch.config import EaqhmConfig
from eaqhm_torch.device import resolve_device
from eaqhm_torch.models import swipe as swipe_mod
from eaqhm_torch.models import vad as vad_mod
from eaqhm_torch.ops import block_inverse, chol, filters, fit, solver
from eaqhm_torch.ops.pitch import resample_f0_grid  # noqa: F401 (public)
from eaqhm_torch.ops import tracks as tracks_ops
from eaqhm_torch.utils import io as io_mod
from eaqhm_torch.utils.progress import progress_bar

PAGE = 4096              # signal-length quantum of quantize_geometry
# Harmonic tier lattice of the JAX engine (engine.py:828).
K_LATTICE = (24, 32, 40, 48, 64, 96, 128, 192, 256)
# Working-set budget of one batched fit (basis, Grams, solver workspace):
# frames are grouped into batches of config.chunk multiples under it, or of
# fewer frames (at least one) where one chunk is over it.
_BATCH_BYTES = {"cuda": 4 << 30, "cpu": 512 << 20}


@dataclass
class EaqhmResult:
    s_recon: np.ndarray
    srer: List[float]
    # dense per-instant deterministic components (reference DetComponents,
    # structs.py:7-22, packaged as arrays)
    det_ti: np.ndarray
    det_is_speech: np.ndarray
    det_is_voiced: np.ndarray
    det_a0: np.ndarray
    det_ak: np.ndarray
    det_frange: np.ndarray
    det_pk: np.ndarray
    elapsed: float = 0.0
    f0_grid: Optional[np.ndarray] = None
    timings: dict = field(default_factory=dict)
    # per-adaptation srer_db, seconds (and accepted_harmonics with
    # collect_metrics)
    metrics: List[dict] = field(default_factory=list)
    # harmonic tiers as (frames, window half-width W, harmonic bound Kc)
    tiers: List[Tuple[int, int, int]] = field(default_factory=list)
    # the fused loop's record (None for the host loop): adaptations run
    # eagerly, graph replays, whether this call captured the graph
    fused: Optional[dict] = None


@dataclass
class Geometry:
    """Host frame geometry of one utterance (JAX engine.py:748-929)."""
    length: int
    Lpad: int                 # length padded to the 4096-sample page
    No_pad: int               # analysis frames over Lpad
    No_ti: int                # analysis frames over the true length
    centers: np.ndarray       # [No_pad] 0-based window centers
    in_margin: np.ndarray     # [No_ti]
    voiced: np.ndarray        # [No_ti] analyzed-frame mask
    f0_frame: np.ndarray      # [No_ti] adaptation-0 f0
    K_frame: np.ndarray       # [No_ti]
    wl_frame: np.ndarray      # [No_ti] window half-widths (0 off voiced)
    f0_stale: float           # f0 of the last voiced frame
    Kmax: int
    det: np.ndarray           # [length] deterministic part
    std_det: float
    # harmonic tiers: (frame indices, window half-width W, harmonic bound Kc)
    buckets: List[Tuple[np.ndarray, int, int]]


def frame_geometry(f0_grid_np, vti, v_sp, v_vo, frame_step: int, s_np,
                   fs: int, config: EaqhmConfig, Lpad: int) -> Geometry:
    """Kmax, the fullWaveform fixup / deterministic mask, per-frame
    f0/K/wl and the harmonic-tier buckets, all host numpy.

    Tiers carry only their real frames (no capacity padding); their (W, Kc)
    bounds follow the JAX engine, which makes every shape a function of the
    length page and the config.  Zero window weight and identity columns
    make those bounds exact in float64.
    """
    length = len(s_np)
    step = int(config.step)
    f0min, _ = config.pitch_limits
    grid_step = int(round(fs * 5 / 1000))
    Ng_true = len(np.arange(0, length - 1, grid_step))
    Fmax = int(fs / 2 - 200)
    if config.partials > 0:
        Kmax = int(config.partials)
    else:
        # min over the true-length grid rows only (padded-tail rows
        # estimate pitch on silence)
        Kmax = int(round(Fmax / f0_grid_np[:Ng_true, 1].min()) + 10)
    margin = config.margin_samples
    if config.full_waveform:
        v_sp, v_vo = vad_mod.full_waveform_fixup(vti, v_sp, v_vo, margin,
                                                 length)
        det = s_np
    else:
        det = s_np * vad_mod.deterministic_part_mask(vti, v_sp, v_vo,
                                                     frame_step, length)
    std_det = float(np.std(det))

    ti_pad = np.arange(1, Lpad, step)
    No_pad = len(ti_pad)
    centers = ti_pad - 1
    ti = ti_pad[:len(np.arange(1, length, step))]
    No_ti = len(ti)
    framei = ti / frame_step
    fi = framei.astype(int)
    in_margin = (ti > margin) & (ti < length - margin)
    fi_prev = np.clip(fi - 1, 0, len(v_vo) - 1)
    fi_c = np.clip(fi, 0, len(v_vo) - 1)
    voiced = in_margin & v_vo[fi_prev] & v_vo[fi_c]

    # per-frame f0 at adaptation 0 (functions.py:183-185)
    dec = framei - fi
    f0_frame = (1 - dec) * f0_grid_np[fi_prev, 1] + dec * f0_grid_np[fi_c, 1]
    K_frame = np.minimum(Kmax, (Fmax / f0_frame).astype(int))
    wl_frame = np.maximum(120, np.round(
        (config.pitch_periods / 2) * fs / f0_frame)).astype(int)
    wl_frame = np.where(voiced, wl_frame, 0)

    voiced_idx = np.nonzero(voiced)[0]
    if len(voiced_idx) == 0:
        raise ValueError("no voiced frames to analyze")
    f0_stale = float(f0_frame[voiced_idx[-1]])   # reference quirk #1
    K_v = K_frame[voiced_idx]
    wl_v = wl_frame[voiced_idx]
    pp2 = config.pitch_periods / 2
    buckets = []
    if config.quantize_geometry:
        # static bounds from the pitch floor (fine-tune can dip 1/768
        # octave below f0min, reference SWIPE.py:108-131)
        f0_floor = f0min * 2.0 ** (-1.0 / 768.0)
        if config.partials > 0:
            Kc_bound = int(config.partials)
        else:
            Kc_bound = int(round(Fmax / f0_floor) + 10) + 1
        Kc_bq = next((t for t in K_LATTICE if t >= Kc_bound), Kc_bound)
        tiers = [t for t in K_LATTICE if t < Kc_bq] + [Kc_bq]

        def tier_W(tk, top):
            # frames in tier tk have f0 > Fmax/(tk+1); the top tier (K
            # capped at Kmax) sees f0 down to the floor
            if top:
                w = max(120, int(np.ceil(pp2 * fs / f0_floor)))
            else:
                w = max(120, int(np.ceil(pp2 * fs * (tk + 1) / Fmax)))
            return -(-w // 8) * 8

        tW = [tier_W(tk, i == len(tiers) - 1) for i, tk in enumerate(tiers)]
        tsel = np.searchsorted(tiers, K_v)
        for i, w in enumerate(tW):
            tsel = np.where((tsel == i) & (wl_v > w), i + 1, tsel)
        if tsel.max(initial=0) >= len(tiers):
            tsel = np.minimum(tsel, len(tiers) - 1)
            tW[-1] = max(tW[-1], -(-int(wl_v.max()) // 8) * 8)
        for i, tk in enumerate(tiers):
            gi = voiced_idx[tsel == i]
            if len(gi):
                buckets.append((gi, tW[i], tk))
    else:
        Kc = int(K_v.max())
        tiers_e = [t for t in K_LATTICE if t < Kc] + [Kc]
        bucket_tier = np.searchsorted(tiers_e, K_v)
        min_bucket = max(256, len(voiced_idx) // 16)
        pending = []
        for b in range(len(tiers_e)):
            sel = bucket_tier == b
            if not sel.any():
                continue
            pending.append(np.nonzero(sel)[0])
            # merge undersized buckets upward
            if (sum(len(p) for p in pending) < min_bucket
                    and b < len(tiers_e) - 1):
                continue
            vsel = np.concatenate(pending)
            pending = []
            buckets.append((voiced_idx[vsel], int(wl_v[vsel].max()),
                            int(K_v[vsel].max())))
    return Geometry(length=length, Lpad=Lpad, No_pad=No_pad, No_ti=No_ti,
                    centers=centers, in_margin=in_margin, voiced=voiced,
                    f0_frame=f0_frame, K_frame=K_frame, wl_frame=wl_frame,
                    f0_stale=f0_stale, Kmax=Kmax, det=det, std_det=std_det,
                    buckets=buckets)


def _batch_frames(chunk: int, N: int, Kc: int, cdtype, device) -> int:
    """Frames per batched fit: a multiple of chunk whose basis + Gram +
    solver workspace fits the device's batch budget; where one chunk is
    over the budget (the widest tiers: ~363 MB a frame in complex128 at
    Kc = 487), as many frames as fit, and at least one.  How frames are
    batched does not change a float64 result."""
    itemsize = torch.empty((), dtype=cdtype).element_size()
    M = 2 * (2 * Kc + 1)
    per_frame = itemsize * (4 * N * (2 * Kc + 1) + 3 * M * M)
    n = _BATCH_BYTES[torch.device(device).type] // per_frame
    return n // chunk * chunk if n >= chunk else max(1, n)


def _loud_enough(pos):
    """150 dB relative-amplitude acceptance gate (functions.py:303-312)."""
    absp = pos.abs()
    pos_ok = absp > 0
    logamp = torch.where(pos_ok, 20.0 * torch.log10(
        torch.where(pos_ok, absp, 1.0)), -torch.inf)
    return logamp > logamp.amax(dim=1, keepdim=True) - 150.0


def _mask_voiced(a0_val, acc, voiced):
    """a0 and acceptance off the non-analyzed rows.  A select, not JAX's
    product with the mask: such a row's solve may be NaN (a one-sample
    window is singular), and XLA turns JAX's product into this select too,
    so both packages give 0 there."""
    return (torch.where(voiced, a0_val, torch.zeros_like(a0_val)),
            voiced[:, None] & acc)


def iqhm_accept(amps, f0, Kc: int, voiced=None):
    """Adaptation-0 acceptance + parameter extraction (functions.py:303-324,
    a == 0 branch: fm = k*f0).  amps: [B, 2Kc+1] complex; f0: [B]; voiced:
    [B] analyzed-frame mask, or None when every row is analyzed.  Returns
    (a0_val, am, fm, ph, acc).  Shared by the per-utterance and batched
    engines, as JAX's (eaqhm_tpu/models/engine.py:118-129)."""
    pos = amps[:, Kc + 1:]
    k1 = torch.arange(1, Kc + 1, device=amps.device)[None, :].to(f0.dtype)
    a0_val = amps[:, Kc].real
    acc = _loud_enough(pos)
    if voiced is not None:
        a0_val, acc = _mask_voiced(a0_val, acc, voiced)
    return a0_val, pos.abs(), k1 * f0[:, None], pos.angle(), acc


def eaqhm_accept(amps, fmis, fmc, dead, h, do_update, Kc: int,
                 voiced=None):
    """Adaptation >=1 acceptance + fm update (functions.py:303-324, a > 0:
    150 dB gate AND |fmismatch| < h; fm <- fm + fmismatch when the stale-f0
    test allows, with the dead-track bootstrap's 140 Hz on harmonic 1).
    h: 0-d or per-row [B] tensor; do_update: a bool or a per-row [B] bool
    tensor; voiced: [B] analyzed-frame mask, or None when every row is
    analyzed.  Returns (a0_val, am, fm, ph, acc).  Shared by both engines,
    as JAX's (eaqhm_tpu/models/engine.py:132-146)."""
    pos = amps[:, Kc + 1:]
    hb = h[:, None] if h.dim() else h
    acc = _loud_enough(pos) & (fmis.abs() < hb)
    a0_val = amps[:, Kc].real
    if voiced is not None:
        a0_val, acc = _mask_voiced(a0_val, acc, voiced)
    first = torch.arange(Kc, device=amps.device)[None, :] == 0
    fmc_eff = torch.where(dead[:, None] & first, fit.DEAD_TRACK_F0, fmc)
    if isinstance(do_update, torch.Tensor):
        fm = torch.where(do_update[:, None], fmc_eff + fmis, fmc_eff)
    else:
        fm = fmc_eff + fmis if do_update else fmc_eff
    return a0_val, pos.abs(), fm, pos.angle(), acc


def _iqhm_stage(s, centers, f0, K, wl, W: int, Kc: int, fs: float,
                chunk: int, method):
    """Adaptation-0 fits of one tier: batched stationary LS + acceptance.
    Reference functions.py:183-324 (a == 0 branch)."""
    dtype = s.dtype
    n = _batch_frames(chunk, 2 * W + 1, Kc, solver.complex_dtype(dtype),
                      s.device)
    utt = torch.zeros(min(n, centers.shape[0]), dtype=torch.long,
                      device=s.device)
    xs = []
    for b0 in range(0, centers.shape[0], n):
        c = centers[b0:b0 + n]
        with record_function("eaqhm/fit"):
            R, rhs, dinv = solver.iqhm_gram_tables(
                s, utt[:len(c)], c, W, wl[b0:b0 + n].clamp(min=1),
                f0[b0:b0 + n], K[b0:b0 + n], fs, Kc, dtype=dtype)
        with record_function("eaqhm/solve"):
            xs.append(solver.solve_gram(R, rhs, dtype, method=method) * dinv)
    amps, _ = solver.split_amps(torch.cat(xs), Kc)
    return iqhm_accept(amps, f0, Kc)


def _eaqhm_bucket(s, fm_current, am_current, centers, wl, dead, mask_k,
                  dead_center, h, do_update: bool, W: int, Kc: int,
                  fs: float, chunk: int, method):
    """Adaptation >=1 fits of one tier: batched non-stationary LS +
    acceptance (reference functions.py:198-324, a > 0 branch).

    The dead-track bootstrap (fm=140 Hz, am=1e-3, functions.py:204-210)
    keeps the reference's left-visibility semantics: a frame's window sees
    bootstrap values at dead centers strictly left of its own center, plus
    its own center when the frame itself is dead.  dead/mask_k/dead_center
    come from all analyzed frames (windows overlap other tiers).  Track
    columns beyond this tier's Kc are zero, so the fit reads the tables'
    first Kc columns (through their stride: nothing is gathered or copied).
    """
    dtype = s.dtype
    fmc = fm_current[centers, :Kc]
    n = _batch_frames(chunk, 2 * W + 1, Kc, solver.complex_dtype(dtype),
                      s.device)
    utt = torch.zeros(min(n, centers.shape[0]), dtype=torch.long,
                      device=s.device)
    parts = []
    for b0 in range(0, centers.shape[0], n):
        c = centers[b0:b0 + n]
        mk = mask_k[b0:b0 + n]
        with record_function("eaqhm/fit"):
            R, rhs, dinv = solver.eaqhm_gram_tables(
                s, fm_current, am_current, dead_center, utt[:len(c)], c,
                dead[b0:b0 + n], W, wl[b0:b0 + n].clamp(min=1), mk, fs,
                dtype=dtype)
        with record_function("eaqhm/solve"):
            x = solver.solve_gram(R, rhs, dtype, method=method) * dinv
        amps, _, fmis = solver.eaqhm_extract(x, mk, Kc, fs)
        parts.append((amps, fmis))
    amps = torch.cat([p[0] for p in parts])
    fmis = torch.cat([p[1] for p in parts])
    return eaqhm_accept(amps, fmis, fmc, dead, h, do_update, Kc)


class Adaptation(NamedTuple):
    """One adaptation's result, as the loops read it: the dense am and
    fm_current the next adaptation's fits read [L, Kc], the anchor rows of
    am, fm and the corrected ph [3, No, Kc] and of the DC [No] (the
    packaging), the synthesis [L] and the SRER (0-d)."""
    am: torch.Tensor
    fm_cur: torch.Tensor
    stk: torch.Tensor
    a0: torch.Tensor
    s_rec: torch.Tensor
    srer: torch.Tensor


class _Adapter:
    """Device state of one utterance's adaptations: the signal, the tier
    tensors (uploaded once) and the synthesis geometry.  Every value that
    differs between utterances of one geometry is a tensor (``load`` copies
    them in), so a captured adaptation serves them all."""

    def __init__(self, s, det, geo: Geometry, config: EaqhmConfig, fs: int,
                 method):
        dev = s.device
        self.s = s
        self.det = det
        self.geo = geo
        self.fs = float(fs)
        self.step = int(config.step)
        self.chunk = int(config.chunk)
        self.method = method
        self.Kcm = max(kc for _, _, kc in geo.buckets)
        self.std_det = torch.tensor(geo.std_det, dtype=s.dtype, device=dev)
        self.tiers = []
        for gi, W, Kc in geo.buckets:
            self.tiers.append(dict(
                idx=torch.as_tensor(gi, device=dev),
                centers=torch.as_tensor(geo.centers[gi], device=dev),
                f0=torch.as_tensor(geo.f0_frame[gi], dtype=s.dtype,
                                   device=dev),
                K=torch.as_tensor(geo.K_frame[gi], device=dev),
                wl=torch.as_tensor(geo.wl_frame[gi], device=dev),
                W=W, Kc=Kc))
        self.all_centers = torch.cat([t["centers"] for t in self.tiers])
        voiced = torch.zeros(geo.No_pad, dtype=torch.bool, device=dev)
        for t in self.tiers:
            voiced[t["idx"]] = True
        self.voiced = voiced
        # where each frame's tier result lands (ops.tracks.tier_map): the
        # tracks stage reads the tiers through it
        self.fmap = tracks_ops.tier_map([t["idx"] for t in self.tiers],
                                        geo.No_pad, dev)

    def key(self, do_update: bool):
        """Everything an adaptation's launches depend on besides the
        adapter's tensors: the geometry (as the JAX package keys its
        compiled programs), dtype, device, solve method and update rule."""
        g = self.geo
        return (self.s.device, self.s.dtype, g.Lpad, g.length, self.fs,
                self.step, self.chunk, self.method, do_update,
                tuple((t["idx"].shape[0], t["W"], t["Kc"])
                      for t in self.tiers))

    def load(self, other: "_Adapter") -> None:
        """Copy another utterance's tensors of the same key in."""
        for name in ("s", "det", "std_det", "all_centers", "voiced", "fmap"):
            getattr(self, name).copy_(getattr(other, name))
        for t, u in zip(self.tiers, other.tiers):
            for name in ("idx", "centers", "f0", "K", "wl"):
                t[name].copy_(u[name])
        self.geo = other.geo

    def _finish(self, parts, out=None) -> Adaptation:
        """Frame results to tracks, synthesis and SRER: on CUDA the tracks
        kernels (ops.tracks), which read each tier's results (a0, am, fm,
        ph, acc) through the frame map, on the CPU their plain version.
        out: (am, fm_cur) [L, Kc] buffers for the dense tracks (the fused
        loop's state, which every fit of the adaptation has read by
        then)."""
        g = self.geo
        with record_function("eaqhm/tracks"):
            st = tracks_ops.stage_tiers(
                tracks_ops.Tiers(self.fmap, tuple(parts), self.Kcm),
                self.step, self.fs, g.Lpad, voiced=self.voiced[None],
                out=None if out is None else (out[0][None], out[1][None]))
            srer = tracks_ops.masked_srer(self.det, st.s[0],
                                          std_det=self.std_det,
                                          n_valid=g.length)
        return Adaptation(am=st.am[0], fm_cur=st.fm_cur[0],
                          stk=st.anchors[:, 0], a0=st.a0_anchor[0],
                          s_rec=st.s[0], srer=srer)

    def adapt0(self, out=None) -> Adaptation:
        """Adaptation 0: stationary fits, tracks, synthesis, SRER."""
        parts = [_iqhm_stage(self.s, t["centers"], t["f0"], t["K"], t["wl"],
                             t["W"], t["Kc"], self.fs, self.chunk,
                             self.method) for t in self.tiers]
        return self._finish(parts, out)

    def adapt(self, fm_current, am_current, h, do_update: bool,
              out=None) -> Adaptation:
        """Adaptation >= 1; h: 0-d tensor, the fm-mismatch bound.  The
        dead-track overlay is computed over all analyzed frames before the
        per-tier fits, so every tier's windows see every dead frame as the
        reference's in-place writes would.  out: as ``_finish``'s (the
        tracks read here may be written there)."""
        mask_all = fm_current[self.all_centers] != 0           # [Nv, Kcm]
        dead_all = ~mask_all.any(dim=1)
        dead_center = torch.zeros(self.s.shape[0], dtype=torch.bool,
                                  device=self.s.device)
        dead_center[self.all_centers] = dead_all
        parts = []
        off = 0
        for t in self.tiers:
            nb = t["centers"].shape[0]
            Kb = t["Kc"]
            dd = dead_all[off:off + nb]
            first = torch.arange(Kb, device=dd.device)[None, :] == 0
            mk = torch.where(dd[:, None], first, mask_all[off:off + nb, :Kb])
            parts.append(_eaqhm_bucket(
                self.s, fm_current, am_current, t["centers"], t["wl"], dd, mk,
                dead_center, h, do_update, t["W"], Kb, self.fs, self.chunk,
                self.method))
            off += nb
        return self._finish(parts, out)


def _package(out: Adaptation):
    """DetComponents packaging: the analysis grid is uniform (centers =
    arange(No) * step), and the tracks stage wrote the anchor rows.
    Returns (stk [3, No, Kc], vec [No + L])."""
    return out.stk, torch.cat([out.a0, out.s_rec])


# Captured adaptations of recent geometries (CUDA only), most recent last:
# per key a pool of loops, each taken by one call at a time, so two threads
# analyzing utterances of one geometry at once never share a loop's
# buffers (the second builds and captures a loop of its own).
_GRAPH_CACHE_SIZE = 4          # loops kept over all keys
_graphs: "OrderedDict[tuple, List[_FusedLoop]]" = OrderedDict()
_graphs_lock = threading.Lock()
_capture_lock = threading.Lock()


def clear_graph_cache() -> None:
    """Drop every captured adaptation graph and its memory pool."""
    with _graphs_lock:
        _graphs.clear()


def _take_loop(key) -> "Optional[_FusedLoop]":
    """A cached loop of this key for the caller's sole use, or None."""
    with _graphs_lock:
        pool = _graphs.get(key)
        if pool is None:
            return None
        loop = pool.pop()
        if not pool:
            del _graphs[key]
        return loop


def _keep_loop(key, loop: "_FusedLoop") -> None:
    """Return a loop with a captured graph to the cache."""
    with _graphs_lock:
        _graphs.setdefault(key, []).append(loop)
        _graphs.move_to_end(key)
        while sum(len(v) for v in _graphs.values()) > _GRAPH_CACHE_SIZE:
            oldest = next(iter(_graphs))
            _graphs[oldest].pop(0)
            if not _graphs[oldest]:
                del _graphs[oldest]


class _FusedLoop:
    """The fused adaptation loop (JAX engine.py:572-626) of one geometry.

    ``step`` is one eaQHM adaptation over static buffers: fits, solves,
    combine, tracks, synthesis and SRER (``_Adapter.adapt``), the strided
    package, and the keep-previous-on-decline select done on the device with
    torch.where (improved = SRER above the previous adaptation's, as the JAX
    body); it leaves [SRER, stop] in ``out``, the one value the host reads
    per adaptation.  On the CPU each adaptation runs the step eagerly.  On
    CUDA the first eaQHM adaptation of a new geometry runs the step eagerly
    on the capture stream (it is the call's adaptation 1, not a throwaway
    run: it creates the library handles and workspaces the capture needs);
    the step is then captured once as a CUDA graph and every further
    adaptation is one replay, with the fm-mismatch bound h written to its
    static scalar before it.  The loop stays in a cache keyed by the
    geometry (``_Adapter.key``), so a later call of the same geometry
    replays from adaptation 1 on; a call takes its loop out of the cache
    for its own use and returns it at the end.  A failed capture or replay
    raises: there is no fallback to the host loop.
    """

    def __init__(self, ad: _Adapter, do_update: bool):
        self.ad = ad
        self.do_update = do_update
        dev, dt = ad.s.device, ad.s.dtype
        L, K, No = ad.geo.Lpad, ad.Kcm, ad.geo.No_pad
        self.fm = torch.zeros((L, K), dtype=dt, device=dev)
        self.am = torch.zeros_like(self.fm)
        self.h = torch.zeros((), dtype=dt, device=dev)
        self.prev = torch.zeros((), dtype=dt, device=dev)
        self.stk = torch.zeros((3, No, K), dtype=dt, device=dev)
        self.vec = torch.zeros(No + L, dtype=dt, device=dev)
        self.out = torch.zeros(2, dtype=dt, device=dev)
        self.graph = None
        self.captured = None       # kernel launches recorded in the graph
        self.side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def step(self) -> None:
        # the dense tracks go straight into the state buffers: every fit of
        # the adaptation has read them when the tracks stage writes them
        out = self.ad.adapt(self.fm, self.am, self.h, self.do_update,
                            out=(self.am, self.fm))
        improved = out.srer > self.prev
        stk, vec = _package(out)
        self.stk.copy_(torch.where(improved, stk, self.stk))
        self.vec.copy_(torch.where(improved, vec, self.vec))
        self.prev.copy_(out.srer)
        self.out.copy_(torch.stack([out.srer,
                                    (~improved).to(out.srer.dtype)]))

    def start(self, out0: Adaptation) -> None:
        """Load adaptation 0's result (its tracks already in the state
        buffers, ``adapt0(out=(loop.am, loop.fm))``) as the loop's best."""
        stk, vec = _package(out0)
        for buf, val in ((self.prev, out0.srer), (self.stk, stk),
                         (self.vec, vec)):
            buf.copy_(val)

    def run(self, h: float, record: dict, last: bool):
        """One eaQHM adaptation with bound h; returns (SRER, stop, seconds
        of the adaptation up to its SRER on the host, capture excluded)."""
        t0 = time.time()
        self.h.fill_(h)
        if self.graph is not None:
            self.graph.replay()
            chol.count_replay(self.captured[0])
            block_inverse.count_replay(self.captured[1])
            fit.count_replay(self.captured[2])
            tracks_ops.count_replay(self.captured[3])
            record["replays"] += 1
        elif self.side is None:
            self.step()
            record["eager"] += 1
        else:
            self.side.wait_stream(torch.cuda.current_stream(self.side.device))
            with torch.cuda.stream(self.side):
                self.step()
            torch.cuda.current_stream(self.side.device).wait_stream(self.side)
            record["eager"] += 1
        srer, stop = self.out.tolist()
        seconds = time.time() - t0
        if self.graph is None and self.side is not None and not (
                stop or last):
            t_c = time.time()
            # kernel attributes set outside capture
            chol.library(self.ad.s.device)
            fit.library(self.ad.s.device)
            tracks_ops.library(self.ad.s.device)
            if (self.ad.method or solver.default_solve_method(
                    self.ad.s.dtype)) == "block_inverse":
                block_inverse.library(self.ad.s.device)
            chol.take_captured()
            block_inverse.take_captured()
            fit.take_captured()
            tracks_ops.take_captured()
            graph = torch.cuda.CUDAGraph()
            # "thread_local": CUDA calls of other threads (stream workers)
            # neither break this capture nor fail because of it.  One
            # capture at a time, and not the torch.cuda.graph context, whose
            # device synchronize fails while another thread captures.  The
            # allocator's cached blocks are released first, as that context
            # does (while any capture is under way the allocator releases
            # none, so other threads' allocations could otherwise run out
            # of memory that sits cached for another stream).
            with _capture_lock, torch.cuda.stream(self.side):
                torch.cuda.empty_cache()
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.step()
                finally:
                    graph.capture_end()
            self.captured = (chol.take_captured(),
                             block_inverse.take_captured(),
                             fit.take_captured(),
                             tracks_ops.take_captured())
            self.graph = graph
            record["capture_s"] = time.time() - t_c
        return srer, bool(stop), seconds


def _fused_loop(ad: _Adapter, config: EaqhmConfig, do_update: bool,
                verbose: bool):
    """Adaptation 0 eagerly, then ``_FusedLoop`` until the SRER declines or
    max_adaptations.  Returns (srer, fetched package, timings, metrics,
    record)."""
    t_a = time.time()
    key = ad.key(do_update)
    loop = _take_loop(key) if ad.s.is_cuda else None
    if loop is None:
        loop = _FusedLoop(ad, do_update)
    else:
        loop.ad.load(ad)
    record = {"eager": 1, "replays": 0, "capture_s": 0.0,
              "cached_graph": loop.graph is not None}
    with record_function("eaqhm/adapt_loop"):
        out0 = loop.ad.adapt0(out=(loop.am, loop.fm))
        srer = [float(out0.srer)]
        seconds = [time.time() - t_a]
        loop.start(out0)
        n = config.max_adaptations
        for a in range(1, n + 1):
            cur, stop, sec = loop.run(ad.geo.f0_stale / (a + 1), record,
                                      a == n)
            srer.append(cur)
            seconds.append(sec)
            if stop:
                break
        fetched = (loop.stk.cpu().numpy(), loop.vec.cpu().numpy())
    if loop.graph is not None:
        _keep_loop(key, loop)
    dt = time.time() - t_a
    timings = {"adapt_loop": dt, "graph_capture": record["capture_s"]}
    metrics = []
    for a, (v, sec) in enumerate(zip(srer, seconds)):
        timings[f"adaptation_{a}"] = sec
        metrics.append({"adaptation": a, "srer_db": v, "seconds": sec})
        if verbose:
            print(f"SRER: {v} dB in Adaptation No: {a}")
    return srer, fetched, timings, metrics, record


def _host_loop(ad: _Adapter, config: EaqhmConfig, do_update: bool,
               verbose: bool):
    """The host-driven loop, one SRER fetch per adaptation, with the
    reference's keep-previous-on-decline rule (functions.py:394-402) or,
    with stop_on_decline=False, the best so far kept while it goes on
    (JAX engine.py:1013-1017).  Returns (srer, fetched package, timings,
    metrics)."""
    geo = ad.geo
    bar = progress_bar(total=config.max_adaptations + 1, desc="adaptations",
                       enabled=config.loading_screen)
    srer: List[float] = []
    timings = {}
    metrics: List[dict] = []
    best = None
    fm_cur = am_cur = None
    h = torch.empty((), dtype=ad.s.dtype, device=ad.s.device)
    for a in range(config.max_adaptations + 1):
        t_a = time.time()
        if a == 0:
            out = ad.adapt0()
        else:
            h.fill_(geo.f0_stale / (a + 1))
            out = ad.adapt(fm_cur, am_cur, h, do_update)
        am_cur, fm_cur = out.am, out.fm_cur
        cur = float(out.srer)
        srer.append(cur)
        dt = time.time() - t_a
        timings[f"adaptation_{a}"] = dt
        m = {"adaptation": a, "srer_db": cur, "seconds": dt}
        if config.collect_metrics:
            m["accepted_harmonics"] = int(torch.count_nonzero(out.stk[0]))
        metrics.append(m)
        if bar is not None:
            bar.set_postfix_str(f"SRER {cur:.3f} dB")
            bar.update(1)
        if verbose:
            print(f"SRER: {cur} dB in Adaptation No: {a}")
        if a != 0 and srer[a] <= srer[a - 1]:
            if config.stop_on_decline:
                break            # keep-previous-on-decline
            if srer[a] <= max(srer[:a]):
                continue         # keep the best so far, keep going
        best = _package(out)
    if bar is not None:
        bar.close()
    t_s = time.time()
    fetched = (best[0].cpu().numpy(), best[1].cpu().numpy())
    timings["packaging"] = time.time() - t_s
    return srer, fetched, timings, metrics


def _finish_result(srer, fetched, geo: Geometry, t_start, f0_grid_np,
                   timings, metrics, fused=None):
    """Unpack the fetched DetComponents package into an EaqhmResult
    (reference functions.py:404-411 packaging semantics)."""
    stk, vec = fetched
    No_ti = geo.No_ti
    No_grid = stk.shape[1]
    am_fin, fm_fin, ph_fin = stk[0][:No_ti], stk[1][:No_ti], stk[2][:No_ti]
    voiced = geo.voiced
    keep = (am_fin != 0) & voiced[:, None]
    return EaqhmResult(
        s_recon=vec[No_grid:No_grid + geo.length],
        srer=srer,
        det_ti=geo.centers[:No_ti],
        # the reference marks every in-margin instant isSpeech=True
        # (functions.py:325-329)
        det_is_speech=geo.in_margin,
        det_is_voiced=voiced,
        det_a0=np.where(voiced, vec[:No_ti], 0.0),
        det_ak=np.where(keep, am_fin, 0.0),
        det_frange=np.where(keep, fm_fin, 0.0),
        det_pk=np.where(keep, ph_fin, 0.0),
        elapsed=time.time() - t_start,
        f0_grid=f0_grid_np,
        timings=timings,
        metrics=metrics,
        tiers=[(len(gi), W, Kc) for gi, W, Kc in geo.buckets],
        fused=fused,
    )


def resolve_dtype(config: EaqhmConfig, device: torch.device) -> torch.dtype:
    if config.dtype == "auto":
        return torch.float32 if device.type == "cuda" else torch.float64
    if config.dtype not in ("float32", "float64"):
        raise ValueError(f"unknown dtype {config.dtype!r}")
    return torch.float64 if config.dtype == "float64" else torch.float32


def _check_supported(config: EaqhmConfig, dtype, device) -> None:
    if device.type == "cuda" and dtype == torch.float32 and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        # the solve amplifies Gram rounding by cond(R): the Grams need full
        # float32 products (the JAX package runs them at HIGHEST precision)
        raise ValueError("float32 analysis needs full-precision matmuls: "
                         "turn TF32 off")


def analyze(signal, fs: int, config: EaqhmConfig = EaqhmConfig(),
            device=None, verbose: bool = False) -> EaqhmResult:
    """Full eaQHM analysis/synthesis of one utterance.

    Mirrors reference `eaQHMAnalysisAndSynthesis` (functions.py:35-418):
    batched device work per adaptation, driven by the host loop or (with
    ``config.fused_adapt_loop``, ``stop_on_decline`` on and
    ``collect_metrics`` off, as in the JAX package) the fused loop.
    device: None (CUDA, raising when absent), "cuda", "cpu" or a
    torch.device.
    """
    t_start = time.time()
    device = resolve_device(device)
    dtype = resolve_dtype(config, device)
    _check_supported(config, dtype, device)
    s_np = np.asarray(signal, np.float64).ravel()
    length = int(s_np.shape[0])
    fs = int(fs)
    step = int(config.step)
    stage_t = {}

    if config.fc > 0:
        # pre-analysis high-pass in host f64 (see models.vad)
        from scipy.signal import filtfilt
        b, a_, _ = filters.design_ellip(fs, config.fc, "highpass")
        s_np = filtfilt(b, a_, s_np)

    # SWIPE' and the frame grid run on the signal padded to the length page
    Lpad = -(-length // PAGE) * PAGE if config.quantize_geometry else length
    s = torch.as_tensor(np.pad(s_np, (0, Lpad - length)), dtype=dtype,
                        device=device)
    f0min, f0max = config.pitch_limits

    # ---- pitch (SWIPE') + 5 ms f0 grid ----
    t_s = time.time()
    plan = swipe_mod.make_plan(float(fs), float(f0min), float(f0max), Lpad)
    grid_step = int(round(fs * 5 / 1000))
    if config.replicate_quirks:
        # reference getLinear raises when a 5 ms-grid query lies beyond the
        # last SWIPE' row (functions.py:676-677)
        Ng_true = len(np.arange(0, length - 1, grid_step))
        t_last = (Ng_true - 1) * grid_step / fs
        if t_last > np.arange(0, length / fs, 0.001)[-1]:
            raise ValueError(
                f"Can't interpolate f0 grid: query time {t_last:.6f}s "
                "exceeds the last pitch row (reference getLinear raise, "
                "functions.py:676-677)")
    with record_function("eaqhm/pitch"):
        f0_grid = swipe_mod.f0_grid(plan, s)
    stage_t["pitch_dispatch"] = time.time() - t_s

    # ---- VAD (host f64) while the device computes the pitch ----
    t_s = time.time()
    vti, v_sp, v_vo, frame_step = vad_mod.voiced_unvoiced_frames_host(
        s_np, fs, config.is_male, replicate_quirks=config.replicate_quirks)
    stage_t["vad"] = time.time() - t_s
    t_s = time.time()
    f0_grid_np = f0_grid.cpu().numpy()
    stage_t["pitch"] = time.time() - t_s

    t_s = time.time()
    geo = frame_geometry(f0_grid_np, vti, v_sp, v_vo, frame_step, s_np, fs,
                         config, Lpad)
    det = torch.as_tensor(np.pad(geo.det, (0, Lpad - length)), dtype=dtype,
                          device=device)
    method = None if config.solve_method == "auto" else config.solve_method
    ad = _Adapter(s, det, geo, config, fs, method)
    do_update = bool(geo.f0_stale > f0min)
    stage_t["host_geometry"] = time.time() - t_s

    # the fused loop under the JAX package's rule (engine.py:940-941)
    fused = None
    if (config.fused_adapt_loop and config.stop_on_decline
            and not config.collect_metrics):
        srer, fetched, timings, metrics, fused = _fused_loop(
            ad, config, do_update, verbose)
    else:
        srer, fetched, timings, metrics = _host_loop(ad, config, do_update,
                                                     verbose)
    timings.update(stage_t)
    return _finish_result(srer, fetched, geo, t_start, f0_grid_np, timings,
                          metrics, fused)


def eaqhm_analysis_and_synthesis(speech_file: str, gender="other",
                                 step: int = 15, max_adpt: int = 10,
                                 pitch_periods: int = 3,
                                 analysis_window: int = 32,
                                 full_waveform: bool = True, fc: float = 0,
                                 partials: int = 0, print_prompts: bool = True,
                                 loading_screen: bool = False, device=None,
                                 **kw):
    """Reference-signature entry point (functions.py:35-37).

    Returns (s_recon, SRER, result, elapsed); `result` carries the dense
    DetComponents arrays.
    """
    fs, s = io_mod.read_wav(speech_file)
    cfg = EaqhmConfig(gender=gender, step=step, max_adaptations=max_adpt,
                      pitch_periods=pitch_periods,
                      analysis_window=analysis_window,
                      full_waveform=full_waveform, fc=fc, partials=partials,
                      loading_screen=loading_screen, **kw)
    res = analyze(s, fs, cfg, device=device, verbose=print_prompts)
    return res.s_recon, res.srer, res, res.elapsed
