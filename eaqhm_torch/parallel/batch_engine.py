"""Batched full-pipeline eaQHM engine, on one device or over a device mesh
(eaqhm_tpu/parallel/batch_engine.py).

A batch of utterances, zero-padded to one length, goes through the whole
pipeline in lockstep: SWIPE' pitch, the 5 ms f0 grid, host VAD and frame
geometry, adaptation 0 (iQHM), then eaQHM adaptations with the
keep-previous-on-decline rule (reference functions.py:394-402) applied per
utterance; the loop stops when no utterance improved.

Static geometry, as JAX: the batch shares one padded length L, one frame
grid, and the (W, Kc) bounds of the pitch floor; per-frame window
half-widths and harmonic counts stay data-dependent values under those
bounds, masked exactly as the per-utterance engine masks them.  Frames
solve in a tier lattice (``_make_tiers``); ``make_tier_plan`` sorts each
utterance's frames by tier and gives each 64-frame chunk of the sorted
order the largest tier present in it, as JAX does.

Where JAX vmaps over utterances and lax.maps over chunks with a lax.cond per
tier (thousands of small launches per adaptation in eager PyTorch), the port
gathers every chunk of one tier across the batch (and the local shard) and
fits and solves them as one batched fit, in as few pieces as the device's
batch budget allows (``engine._batch_frames``).  Frame solves are
independent, so in float64 this changes roundings only.  The solve is
``solver.solve_gram`` with the dtype's default method, as JAX's batch path
(config.solve_method does not apply here): float64 "cholesky", the hand
CUDA kernel at M = 4 K_t + 2 for each tier K_t; float32 "block_inverse"
with its ridged rerun on the kernel.  Pitch runs per utterance; the tracks,
synthesis and SRER stage (``ops.tracks``, its hand kernels on CUDA) takes
every utterance at once (harmonic columns are independent: each utterance
is one group of columns, with its own DC track, partial sum and SRER).

With a mesh (``parallel.mesh.make_mesh``), every rank runs the same program
(SPMD over ``torch.distributed``) on the same signals:
- "data" splits the batch, padded to a multiple of the data size with
  copies of its first utterance (dropped from the result);
- "model" splits each utterance's frames (No padded to a multiple of mp);
  the anchor results are all-gathered over the model group, the track
  interpolation re-shards over harmonics (Kc padded to Kc_pad), and the
  synthesis partials are all-reduced over the model group;
- per-utterance SRERs are all-gathered over the data group every
  adaptation (every rank takes the same lockstep decisions), the SRER sum
  and count of ``srer_mean`` are all-reduced over it, and at the end every
  rank returns the whole BatchResult, as JAX's single controller does.

When to use it: on one device the per-utterance engine is the faster corpus
path (``parallel.streams``): the batch pays the pitch floor's geometry on
every utterance and runs them all to the last one's convergence (the card's
own figure is in PERF.md).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from eaqhm_torch.config import EaqhmConfig
from eaqhm_torch.device import resolve_device
from eaqhm_torch.models import engine as engine_mod
from eaqhm_torch.models import swipe as swipe_mod
from eaqhm_torch.models import vad as vad_mod
from eaqhm_torch.ops import solver
from eaqhm_torch.ops import tracks as tracks_ops
from eaqhm_torch.parallel.corpus import pad_batch


@dataclass(frozen=True)
class BatchGeometry:
    """Static geometry shared by every utterance in a batch."""
    fs: float
    length: int          # padded common length
    step: int
    No: int              # frames on the analysis grid (padded to mp multiple)
    W: int               # window half-width bound (from f0min)
    Kc: int              # harmonic-count bound (from f0min)
    chunk: int = 64
    dp: int = 1          # data-parallel size
    mp: int = 1          # model-parallel size (frame/harmonic sharding)
    # ascending (W_t, K_t) tiers, the last (W, Kc); () means one tier
    tiers: tuple = ()

    @property
    def tier_list(self) -> tuple:
        return self.tiers if self.tiers else ((self.W, self.Kc),)

    @property
    def No_loc(self) -> int:
        return self.No // self.mp

    @property
    def n_chunks_loc(self) -> int:
        return -(-self.No_loc // self.chunk)

    @property
    def Kc_pad(self) -> int:
        return ((self.Kc + self.mp - 1) // self.mp) * self.mp

    @property
    def Kc_loc(self) -> int:
        return self.Kc_pad // self.mp


def _mesh_shape(mesh) -> tuple:
    return (1, 1) if mesh is None else tuple(mesh.shape)


def make_batch_geometry(fs: int, length: int, config: EaqhmConfig,
                        mesh=None, chunk: int = 64) -> BatchGeometry:
    """Derive the static batch geometry from the pitch floor.

    W bound: max(120, round((pitchPeriods/2)*fs/f0min)) (functions.py:191);
    Kc bound: round((fs/2-200)/f0min) + 10 (functions.py:115-120) unless
    `partials` overrides.
    """
    f0min, _ = config.pitch_limits
    step = int(config.step)
    W = int(max(120, round((config.pitch_periods / 2) * fs / f0min)))
    if config.partials > 0:
        Kc = int(config.partials)
    else:
        Kc = int(round((fs / 2 - 200) / f0min) + 10)
    dp, mp = _mesh_shape(mesh)
    No = len(np.arange(1, length, step))
    No = ((No + mp - 1) // mp) * mp
    # the uniform anchor grid must fit inside the padded length
    # (the tracks stage assembles (No-1)*step+1 samples)
    length = max(int(length), (No - 1) * step + 1)
    tiers = _make_tiers(W, Kc, float(fs), config.pitch_periods)
    return BatchGeometry(fs=float(fs), length=int(length), step=step, No=No,
                         W=W, Kc=Kc, chunk=chunk, dp=dp, mp=mp, tiers=tiers)


# JAX's harmonic-count lattice, kept so that both packages solve each frame
# at the same M = 4K+2 (126, 190, 254, 382, 510 for K = 31, 47, 63, 95,
# 127).  Its reason there (M just under the TPU's 128-lane tiles) does not
# hold on the card, where the Cholesky kernel takes any M.
_K_LATTICE = (23, 31, 47, 63, 95, 127, 191, 255)


def _make_tiers(W: int, Kc: int, fs: float, pitch_periods: int) -> tuple:
    """2-3 tier (W_t, K_t) lattice under the worst-case (W, Kc) bound.

    Frames in a sub-tier have K = int(Fmax/f0) <= K_t, i.e. f0 above
    Fmax/(K_t+1), which also bounds their window half-length
    wl < max(120, pp2*fs*(K_t+1)/Fmax) (reference functions.py:191).
    """
    Fmax = fs / 2 - 200
    pp2 = pitch_periods / 2

    def tier_W(K_t):
        w = max(120, int(np.ceil(pp2 * fs * (K_t + 1) / Fmax)))
        return min(W, -(-w // 8) * 8)

    subs = [t for t in _K_LATTICE if t < Kc][-2:]
    return tuple((tier_W(t), t) for t in subs) + ((W, Kc),)


def make_tier_plan(geom: BatchGeometry, voiced, wl_frame, K_frame):
    """Host-side tier assignment for one utterance -> (order, chunk_tier).

    voiced/wl_frame/K_frame: [No] numpy arrays.  Within each model shard's
    local frame range, frames are stably sorted by tier id (non-analyzed
    frames carry a sentinel and sort last, so their chunks are skipped
    entirely); each chunk of the sorted order then solves in ONE tier, the
    largest present.

    Returns order [No] int32 (local indices per shard, concatenated) and
    chunk_tier [mp * n_chunks_loc] int32 (-1 = chunk has nothing to solve).
    """
    tiers = geom.tier_list
    nt = len(tiers)
    sent = nt                                    # sentinel: not analyzed
    tsel = np.full(geom.No, sent, np.int32)
    for i in reversed(range(nt)):
        W_t, K_t = tiers[i]
        fits = (K_frame <= K_t) & (wl_frame <= W_t)
        tsel = np.where(voiced & fits, i, tsel)
    tsel = np.where(voiced & (tsel == sent), nt - 1, tsel)

    No_loc, chunk = geom.No_loc, geom.chunk
    n_ch = geom.n_chunks_loc
    order = np.empty(geom.No, np.int32)
    ct = np.empty(geom.mp * n_ch, np.int32)
    for m in range(geom.mp):
        loc = tsel[m * No_loc:(m + 1) * No_loc]
        o = np.argsort(loc, kind="stable").astype(np.int32)
        order[m * No_loc:(m + 1) * No_loc] = o
        st = np.full(n_ch * chunk, sent, np.int32)
        st[:No_loc] = loc[o]
        st = st.reshape(n_ch, chunk)
        live = st < sent
        mx = np.where(live, st, -1).max(axis=1)
        ct[m * n_ch:(m + 1) * n_ch] = mx
    return order, ct


# --------------------------------------------------------------------------
# this rank's part of the batch
# --------------------------------------------------------------------------

class _Shard:
    """The utterances [b0, b0 + B_loc) and frames [m No_loc, (m+1) No_loc)
    this rank holds (what JAX's data_sharding / frame_sharding place), as
    device tensors, with the frames of every live chunk grouped by tier:
    tier t -> {b, j (local frame), c (center), wl, f0, K, vo}."""

    def __init__(self, geom: BatchGeometry, mesh, device, dtype, sig_np,
                 det_np, lens, vo_np, wl_np, f0f_np, Kf_np, order_np, ct_np):
        self.d = 0 if mesh is None else mesh.get_local_rank("data")
        self.m = 0 if mesh is None else mesh.get_local_rank("model")
        B_loc = sig_np.shape[0] // geom.dp
        rows = slice(self.d * B_loc, (self.d + 1) * B_loc)
        self.B_loc = B_loc
        self.device = device

        def t(a, dt=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)
        self.s = t(sig_np[rows], dtype)                        # [B_loc, L]
        self.det = t(det_np[rows], dtype)
        self.lens = t(lens[rows])
        self.vo = t(vo_np[rows])                               # [B_loc, No]
        L, No_loc, chunk = geom.length, geom.No_loc, geom.chunk
        n_ch = geom.n_chunks_loc
        centers = np.minimum(np.arange(geom.No) * geom.step, L - 1)
        self.centers = t(centers)
        # the live chunks of this shard, frames grouped by the chunk's tier
        pos = np.arange(n_ch * chunk)
        groups = {}
        for bl in range(B_loc):
            b = self.d * B_loc + bl
            lo = self.m * No_loc
            order = order_np[b, lo:lo + No_loc]
            ct = ct_np[b, self.m * n_ch:(self.m + 1) * n_ch][pos // chunk]
            keep = (pos < No_loc) & (ct >= 0)
            for ti in np.unique(ct[keep]):
                j = order[pos[keep & (ct == ti)]]
                groups.setdefault(int(ti), []).append((bl, j))
        self.groups = []
        for ti in sorted(groups):
            bl = np.concatenate([np.full(len(j), b) for b, j in groups[ti]])
            j = np.concatenate([j for _, j in groups[ti]])
            jg = self.m * No_loc + j                           # global frame
            W_t, K_t = geom.tier_list[ti]
            b_abs = self.d * B_loc + bl
            self.groups.append(dict(
                W=W_t, K=K_t, b=t(bl), j=t(j), c=t(centers[jg]),
                wl=t(np.maximum(wl_np[b_abs, jg], 1)),
                f0=t(f0f_np[b_abs, jg], dtype), Kf=t(Kf_np[b_abs, jg]),
                vo=t(vo_np[b_abs, jg])))


def _pad_amps(a, Kc: int, K_t: int):
    """[n, 2K_t+1] amplitudes -> [n, 2Kc+1], zeros in the outer slots."""
    out = a.new_zeros((a.shape[0], 2 * Kc + 1))
    out[:, Kc - K_t:Kc + K_t + 1] = a
    return out


def _solve_tier(g, fit, geom: BatchGeometry, dtype, device):
    """Run ``fit(sl)`` over the tier's frames in batches under the device's
    budget; returns the concatenated results."""
    n = engine_mod._batch_frames(geom.chunk, 2 * g["W"] + 1, g["K"],
                                 solver.complex_dtype(dtype), device)
    parts = [fit(slice(i, i + n)) for i in range(0, len(g["c"]), n)]
    return [torch.cat(p) for p in zip(*parts)]


def _scatter(shard: _Shard, geom: BatchGeometry, outs, dtype):
    """Per-tier accepted (a0, am, fm, ph, acc) -> the shard's frame grid
    [B_loc, No_loc(, Kc_pad)], with am/fm/ph zeroed where not accepted
    (all the track stage reads); frames outside every live chunk stay 0."""
    B_loc, No_loc, Kp = shard.B_loc, geom.No_loc, geom.Kc_pad
    dev = shard.device
    a0 = torch.zeros(B_loc * No_loc, dtype=dtype, device=dev)
    tr = torch.zeros((3, B_loc * No_loc, Kp), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for g, (a0_g, am, fm, ph, acc) in zip(shard.groups, outs):
        idx = g["b"] * No_loc + g["j"]
        a0[idx] = a0_g
        tr[:, idx, :geom.Kc] = torch.stack(
            [torch.where(acc, x, zero) for x in (am, fm, ph)])
    return a0.reshape(B_loc, No_loc), tr.reshape(3, B_loc, No_loc, Kp)


def _local_iqhm(shard: _Shard, geom: BatchGeometry, dtype):
    """Adaptation-0 solves of this shard's live chunks (reference
    functions.py:183-196), every chunk in its tier; the shared acceptance
    core masks the non-analyzed frames of a live chunk."""
    Kc = geom.Kc
    outs = []
    for g in shard.groups:
        def fit(sl, g=g):
            R, rhs, dinv = solver.iqhm_gram_tables(
                shard.s, g["b"][sl], g["c"][sl], g["W"], g["wl"][sl],
                g["f0"][sl], g["Kf"][sl], geom.fs, g["K"], dtype=dtype)
            x = solver.solve_gram(R, rhs, dtype) * dinv
            return (solver.split_amps(x, g["K"])[0],)
        amps, = _solve_tier(g, fit, geom, dtype, shard.device)
        outs.append(engine_mod.iqhm_accept(_pad_amps(amps, Kc, g["K"]),
                                           g["f0"], Kc, voiced=g["vo"]))
    return _scatter(shard, geom, outs, dtype)


def _local_eaqhm(shard: _Shard, geom: BatchGeometry, fm_cur, am_cur, h,
                 do_update, dtype):
    """Adaptation >=1 solves of this shard's live chunks (reference
    functions.py:198-324 with the dead-track bootstrap overlay).  fm_cur /
    am_cur: [B_loc, L, Kc_pad] tracks of the local utterances; h,
    do_update: [B_loc].  A frame of tier t never carries live harmonics
    above K_t, so the tier's columns are exact."""
    L, Kc = geom.length, geom.Kc
    fm_k = fm_cur[:, :, :Kc]
    # dead centers over every frame of each utterance (windows cross
    # shards and tiers)
    fmc_all = fm_k[:, shard.centers]                        # [B_loc, No, Kc]
    vo = shard.vo
    dead_all = vo & ~((fmc_all != 0) & vo[..., None]).any(dim=-1)
    dead_center = torch.zeros((shard.B_loc, L), dtype=torch.bool,
                              device=shard.device)
    dead_center[:, shard.centers] = dead_all
    first = torch.arange(Kc, device=shard.device)[None, :] == 0
    outs = []
    for g in shard.groups:
        K_t = g["K"]
        fmc = fm_k[g["b"], g["c"]]                                  # [n, Kc]
        mask = (fmc != 0) & g["vo"][:, None]
        dead = g["vo"] & ~mask.any(dim=1)
        mask = torch.where(dead[:, None], first, mask)

        def fit(sl, g=g, K_t=K_t, dead=dead, mask=mask):
            mk = mask[sl, :K_t]
            R, rhs, dinv = solver.eaqhm_gram_tables(
                shard.s, fm_cur, am_cur, dead_center, g["b"][sl],
                g["c"][sl], dead[sl], g["W"], g["wl"][sl], mk, geom.fs,
                dtype=dtype)
            x = solver.solve_gram(R, rhs, dtype) * dinv
            a, _, fmi = solver.eaqhm_extract(x, mk, K_t, geom.fs)
            return a, fmi
        amps, fmis = _solve_tier(g, fit, geom, dtype, shard.device)
        fmis_p = fmis.new_zeros((fmis.shape[0], Kc))
        fmis_p[:, :K_t] = fmis
        outs.append(engine_mod.eaqhm_accept(
            _pad_amps(amps, Kc, K_t), fmis_p, fmc, dead, h[g["b"]],
            do_update[g["b"]], Kc, voiced=g["vo"]))
    return _scatter(shard, geom, outs, dtype)


def _interp_and_synth(a0_val, tr, geom: BatchGeometry):
    """Track interpolation + partial synthesis for one harmonic shard.

    a0_val [B, No]; tr [3, B, No, Kc_loc] (am, fm, ph, zero where not
    accepted).  Every utterance's harmonic columns go through the tracks
    stage at once (``ops.tracks.stage``: each column interpolates on its
    own; the kernels on CUDA, the plain version on the CPU).  Returns
    (a0_interp [B, L], s_partial [B, L], harmonics only, so model-shard
    sums do not multiply the DC; am_f, fm_cur [B, L, Kc_loc])."""
    st = tracks_ops.stage(tr[0], tr[1], tr[2], a0_val, geom.step, geom.fs,
                          geom.length, dc="apart", anchors=False)
    return st.a0, st.s, st.am, st.fm_cur


def _all_gather(x, group, dim: int):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# --------------------------------------------------------------------------
# sharded batched adaptation step
# --------------------------------------------------------------------------

def make_batch_step(mesh, geom: BatchGeometry, adapt0: bool):
    """The step of one adaptation over this rank's shard.

    step(shard, dtype) for adaptation 0, step(shard, dtype, fm, am, h,
    do_update) after it (fm/am [B_loc, L, Kc_pad] tracks; h, do_update
    [B_loc]).  Returns (s_rec [B_loc, L], fm_cur, am_f [B_loc, L, Kc_pad],
    srer_b [B_loc])."""
    model = None if mesh is None else mesh.get_group("model")
    Kl = geom.Kc_loc

    def step(shard: _Shard, dtype, *state):
        if adapt0:
            a0_val, tr = _local_iqhm(shard, geom, dtype)
        else:
            a0_val, tr = _local_eaqhm(shard, geom, *state, dtype)
        if model is not None:
            # anchors are small: gather every shard's frames
            a0_val = _all_gather(a0_val, model, 1)
            tr = _all_gather(tr, model, 2)
        k_lo = shard.m * Kl                   # re-shard over harmonics
        a0_i, s_part, am_f, fm_cur = _interp_and_synth(
            a0_val, tr[..., k_lo:k_lo + Kl], geom)
        if model is not None:
            s_part = s_part.contiguous()
            dist.all_reduce(s_part, group=model)
            am_f = _all_gather(am_f, model, 2)
            fm_cur = _all_gather(fm_cur, model, 2)
        s_rec = s_part + a0_i                 # a0 redundant per shard
        # masked SRER over each utterance's true length
        srer_b = tracks_ops.masked_srer(shard.det, s_rec, lens=shard.lens)
        return s_rec, fm_cur, am_f, srer_b

    return step


# --------------------------------------------------------------------------
# batched analysis (full pipeline)
# --------------------------------------------------------------------------

@dataclass
class BatchResult:
    srer: np.ndarray            # [B, n_adapt] per-utterance trajectories
    final_srer: np.ndarray      # [B]
    s_recon: np.ndarray         # [B, L]
    n_adaptations: int
    srer_mean: float


def _host_prologue(sig_np, lens, f0_grid, geom: BatchGeometry,
                   config: EaqhmConfig, fs: int, rows):
    """VAD + frame geometry of the utterances ``rows`` (JAX
    batch_engine.py:528-586): voiced [B, No], wl, f0, K, h0 and the
    deterministic part; rows outside ``rows`` stay zero."""
    B, L = sig_np.shape
    step = geom.step
    margin = config.margin_samples
    ti = np.arange(1, L, step)[:geom.No]
    No_real = len(ti)
    vo_np = np.zeros((B, geom.No), bool)
    wl_np = np.zeros((B, geom.No), np.int32)
    f0f_np = np.zeros((B, geom.No), np.float64)
    Kf_np = np.zeros((B, geom.No), np.int32)
    h0_np = np.zeros(B)
    det_np = np.array(sig_np)
    Fmax = int(fs / 2 - 200)
    for b in rows:
        ulen = int(lens[b])
        vti, v_sp, v_vo, frame_step = vad_mod.voiced_unvoiced_frames_host(
            sig_np[b, :ulen], fs, config.is_male,
            replicate_quirks=config.replicate_quirks)
        if config.full_waveform:
            v_sp, v_vo = vad_mod.full_waveform_fixup(vti, v_sp, v_vo, margin,
                                                     ulen)
        else:
            mask = vad_mod.deterministic_part_mask(vti, v_sp, v_vo,
                                                   frame_step, ulen)
            det_np[b, :ulen] = sig_np[b, :ulen] * mask
        v_vo = np.asarray(v_vo)
        framei = ti / frame_step
        fi = framei.astype(int)
        in_margin = (ti > margin) & (ti < ulen - margin)
        fi_prev = np.clip(fi - 1, 0, len(v_vo) - 1)
        fi_c = np.clip(fi, 0, len(v_vo) - 1)
        voiced = in_margin & v_vo[fi_prev] & v_vo[fi_c]
        dec = framei - fi
        g = f0_grid[b]
        f0_frame = (1 - dec) * g[fi_prev, 1] + dec * g[fi_c, 1]
        K_frame = np.minimum(geom.Kc, (Fmax / np.maximum(f0_frame, 1.0))
                             .astype(int))
        wl_frame = np.maximum(120, np.round(
            (config.pitch_periods / 2) * fs / np.maximum(f0_frame, 1.0))
        ).astype(np.int32)
        wl_frame = np.minimum(wl_frame, geom.W)
        vo_np[b, :No_real] = voiced
        wl_np[b, :No_real] = np.where(voiced, wl_frame, 0)
        f0f_np[b, :No_real] = f0_frame
        Kf_np[b, :No_real] = K_frame
        vidx = np.nonzero(voiced)[0]
        h0_np[b] = f0_frame[vidx[-1]] if len(vidx) else 0.0   # stale-f0 quirk
    return vo_np, wl_np, f0f_np, Kf_np, h0_np, det_np


def _prepare(sig_np, lens, geom: BatchGeometry, config: EaqhmConfig, fs: int,
             mesh, device, dtype, rows):
    """Pitch (the utterances ``rows`` in one call, one fetch), the host
    prologue and the tier plan of the utterances ``rows``; returns (shard,
    h0 [Bp])."""
    Bp, L = sig_np.shape
    f0min, f0max = config.pitch_limits
    plan = swipe_mod.make_plan(float(fs), float(f0min), float(f0max), L)
    x = torch.as_tensor(sig_np[rows], dtype=dtype, device=device)
    f0 = swipe_mod.f0_grid(plan, x).cpu().numpy()
    f0_grid = np.zeros((Bp,) + f0.shape[1:])
    f0_grid[rows] = f0
    # the tier plan is fixed across adaptations: membership comes from the
    # adaptation-0 per-frame bounds, like the per-utterance engine's tiers
    vo_np, wl_np, f0f_np, Kf_np, h0_np, det_np = _host_prologue(
        sig_np, lens, f0_grid, geom, config, fs, rows)
    order_np = np.zeros((Bp, geom.No), np.int32)
    ct_np = np.zeros((Bp, geom.mp * geom.n_chunks_loc), np.int32)
    for b in rows:
        order_np[b], ct_np[b] = make_tier_plan(geom, vo_np[b], wl_np[b],
                                               Kf_np[b])
    shard = _Shard(geom, mesh, device, dtype, sig_np, det_np, lens, vo_np,
                   wl_np, f0f_np, Kf_np, order_np, ct_np)
    return shard, h0_np


def analyze_batch(signals: Sequence[np.ndarray], fs: int,
                  config: EaqhmConfig = EaqhmConfig(), mesh=None,
                  geom: Optional[BatchGeometry] = None,
                  verbose: bool = False, device=None) -> BatchResult:
    """Full-pipeline batched analysis of equal-or-padded utterances.

    Pipeline per utterance: SWIPE' pitch, 5 ms f0 grid, host VAD (float64
    elliptic filters), adaptation 0, eaQHM loop with the per-utterance
    keep-previous-on-decline rule (functions.py:394-402), all utterances in
    lockstep until none improved.  mesh: None (one process, one device) or
    a ``parallel.mesh.make_mesh`` mesh, every rank calling with the same
    signals.  device: None (CUDA, raising when absent), "cuda", "cpu" or a
    torch.device; a mesh over NCCL runs each rank on its current CUDA
    device.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dtype = engine_mod.resolve_dtype(config, device)
    engine_mod._check_supported(config, dtype, device)
    B = len(signals)
    dp, _ = _mesh_shape(mesh)
    sigs = [np.asarray(s, np.float64) for s in signals]
    sigs += [sigs[0]] * (-B % dp)          # pad the batch to the data size
    sig_np, lens = pad_batch(sigs)
    Bp, L = sig_np.shape
    fs = int(fs)
    if geom is None:
        geom = make_batch_geometry(fs, L, config, mesh)
    if geom.length > L:   # anchor-grid fit may extend the padded length
        sig_np = np.pad(sig_np, ((0, 0), (0, geom.length - L)))
    L = geom.length
    B_loc = Bp // geom.dp
    d = 0 if mesh is None else mesh.get_local_rank("data")
    rows = range(d * B_loc, (d + 1) * B_loc)

    f0min = config.pitch_limits[0]
    try:
        shard, h0_np = _prepare(sig_np, lens, geom, config, fs, mesh, device,
                                dtype, rows)
        failure = None
    except Exception as e:  # noqa: BLE001 (re-raised below, on every rank)
        if mesh is None:
            raise
        failure = e
    if mesh is not None:
        # a rank whose utterances fail here must not leave the others
        # waiting in the next collective: all ranks raise
        flag = torch.tensor([float(failure is not None)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if failure is not None:
            raise failure
        if flag.item():
            raise RuntimeError("analyze_batch failed on another rank")
    data = None if mesh is None else mesh.get_group("data")

    step0 = make_batch_step(mesh, geom, adapt0=True)
    stepN = make_batch_step(mesh, geom, adapt0=False)
    h0_loc = h0_np[rows.start:rows.stop]
    # the reference gates the fm update on f0_stale > f0min, per utterance
    do_upd = torch.as_tensor(h0_loc > f0min, device=device)

    srer_hist: List[np.ndarray] = []
    best_srer = np.full(Bp, -np.inf)
    active = np.ones(Bp, bool)
    best_srec = None
    fm_cur = am_cur = None
    for a in range(config.max_adaptations + 1):
        t_a = time.time()
        if a == 0:
            out = step0(shard, dtype)
        else:
            h_b = torch.as_tensor(h0_loc / (a + 1), dtype=dtype,
                                  device=device)
            out = stepN(shard, dtype, fm_cur, am_cur, h_b, do_upd)
        s_rec, fm_new, am_new, srer_b = out
        if data is not None:
            srer_b = _all_gather(srer_b, data, 0)
        srer_np = srer_b.cpu().numpy().astype(np.float64)
        srer_hist.append(srer_np)
        improved = active & (srer_np > best_srer)
        if a == 0:
            improved = np.ones(Bp, bool)
        active = improved.copy()
        imp = torch.as_tensor(improved[rows.start:rows.stop], device=device)
        best_srec = s_rec if best_srec is None else torch.where(
            imp[:, None], s_rec, best_srec)
        best_srer = np.where(improved, srer_np, best_srer)
        fm_cur, am_cur = fm_new, am_new
        if verbose:
            print(f"[batch] adaptation {a}: mean SRER "
                  f"{float(np.mean(srer_np)):.4f} dB, active "
                  f"{int(active.sum())}/{Bp}, {time.time() - t_a:.3f} s")
        if a > 0 and not active.any():
            break

    # corpus statistic: the real utterances' kept SRER, summed over the
    # data shards
    real = torch.as_tensor(np.arange(rows.start, rows.stop) < B,
                           device=device)
    kept = torch.as_tensor(best_srer[rows.start:rows.stop], device=device)
    tot = torch.stack([torch.where(real, kept, 0.0).sum(),
                       real.sum().to(kept.dtype)])
    if data is not None:
        dist.all_reduce(tot, group=data)
        best_srec = _all_gather(best_srec, data, 0)
    return BatchResult(
        srer=np.stack(srer_hist, axis=1)[:B],
        final_srer=best_srer[:B],
        s_recon=best_srec.cpu().numpy()[:B],
        n_adaptations=len(srer_hist),
        srer_mean=float(tot[0] / tot[1]),
    )
