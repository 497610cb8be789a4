"""Per-harmonic track interpolation (reference functions.py:346-381).

For each harmonic, contiguous anchor runs (consecutive accepted analysis
instants) get linearly interpolated AM, not-a-knot cubic FM, and phase
integrated with the 2*pi*M endpoint correction (functions.py:537-575); the
instantaneous-frequency track is rebuilt from the unwrapped phase.

Anchors sit on the uniform analysis grid (spacing `step` samples), so all
harmonics and all runs are processed at once on the [n_ti, K] anchor grid.
On a CUDA tensor ``interpolate_tracks_anchors`` runs the hand kernels of
``ops.tracks`` (kernels/csrc/tracks.cu, writing dense fm and ph as well);
on a CPU tensor its plain version ``interpolate_tracks_anchors_reference``:
run detection by shifted masks, the not-a-knot spline as a segmented
Thomas solve by two affine scans (ops.scan), runs shorter than 4 anchors as
the reference's synthetic-anchor 4-point cubic, and phase integration per
inter-anchor segment as one [n_pairs, step, K] cumsum.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from eaqhm_torch.ops import tracks as tracks_ops
from eaqhm_torch.ops.interp import cubic4_eval
from eaqhm_torch.ops.scan import associative_scan, cumsum

MIN_INTERP_SIZE = 4  # reference misc.py:14


@functools.lru_cache(maxsize=64)
def _segment_rows(L: int, step: int, n_pairs: int, device):
    """[L, 1]: rows at offsets 1..step after their segment's left anchor."""
    slot_of = np.minimum(np.arange(L) // step, n_pairs - 1)
    r_of = np.arange(L) - slot_of * step
    return torch.as_tensor((r_of > 0) & (r_of <= step), device=device)[:, None]


def _affine(l, r):
    """Compose affine maps v -> a v + b: ``l`` first, then ``r``."""
    la, lb = l
    ra, rb = r
    return la * ra, ra * lb + rb


def _roll(x, shift):
    return torch.roll(x, shift, dims=0)


def _segmented_notaknot_M(y, in_run, start_slot, end_slot, h):
    """Second derivatives M on the anchor grid for every run at once.

    y: [n, K] anchor values; in_run: [n, K]; start/end_slot: [n, K] (valid
    where in_run); h: spacing.  Returns M [n, K].

    Forward sweep: with uniform spacing the elimination multiplier
    cp_i = 1 / (4 - cp_{i-1}) depends only on the position in the run, so it
    comes from a host table; dp_i = (d_i/h - dp_{i-1}) / (4 - cp_{i-1}) is an
    affine prefix composition.  Backward sweep v_i = dp_i - cp_i v_{i+1} is
    an affine suffix composition.  Both are log-depth scans.  (cumprod is no
    substitute: the a-products decay by ~0.27 per slot and underflow.)
    """
    dtype = y.dtype
    dev = y.device
    n, K = y.shape
    s = torch.arange(n, device=dev)[:, None]
    d = (6.0 / h) * (_roll(y, -1) - 2.0 * y + _roll(y, 1))
    interior = in_run & (s > start_slot) & (s < end_slot)
    known = interior & ((s == start_slot + 1) | (s == end_slot - 1))
    un = interior & ~known
    M_known = d / (6.0 * h)
    zero = torch.zeros((), dtype=dtype, device=dev)
    ctab_t = tracks_ops.cp_table(dtype, dev)
    prev_block = torch.where(~un, s, -1).cummax(dim=0).values
    pos = (s - prev_block).clamp(0, tracks_ops.CPLEN)
    cp_prev = ctab_t[(pos - 1).clamp(0, tracks_ops.CPLEN)]
    g = 4.0 - cp_prev
    cp = torch.where(un, ctab_t[pos], zero)

    a_f = torch.where(un, -1.0 / g, zero)
    b_f = torch.where(un, d / (h * g), torch.where(known, M_known, zero))
    _, dp = associative_scan(_affine, (a_f, b_f), dim=0)

    a_b = torch.where(un, -cp, zero)
    b_b = torch.where(known, M_known, torch.where(un, dp, zero))
    _, M = associative_scan(_affine, (a_b, b_b), dim=0, reverse=True)
    # not-a-knot endpoints: linear extrapolation of M (uniform h)
    is_start = in_run & (s == start_slot)
    is_end = in_run & (s == end_slot)
    M_start = 2.0 * _roll(M, -1) - _roll(M, -2)
    M_end = 2.0 * _roll(M, 1) - _roll(M, 2)
    return torch.where(is_end, M_end, torch.where(is_start, M_start, M))


def _runs(A_am):
    """Run detection on the anchor grid [n, K] (accepted: am != 0): (acc,
    in_run, run_start, run_end, start_slot, end_slot), the slots valid
    where in_run."""
    n, K = A_am.shape
    false_row = torch.zeros((1, K), dtype=torch.bool, device=A_am.device)
    acc = A_am != 0
    acc_prev = torch.cat([false_row, acc[:-1]])
    acc_next = torch.cat([acc[1:], false_row])
    in_run = acc & (acc_prev | acc_next)
    run_start = acc & ~acc_prev & acc_next
    run_end = acc & acc_prev & ~acc_next
    s_idx = torch.arange(n, device=A_am.device)[:, None]
    start_slot = torch.where(run_start, s_idx, -1).cummax(dim=0).values
    end_slot = torch.where(run_end, s_idx, n + 1).flip(0).cummin(
        dim=0).values.flip(0)
    return acc, in_run, run_start, run_end, start_slot, end_slot


def spline_M_reference(A_am, A_fm, h):
    """The not-a-knot second derivatives of every run of every column of
    the anchor grid [n, K]: the plain version of ops.tracks.track_spline's
    harmonic columns."""
    _, in_run, _, _, start_slot, end_slot = _runs(A_am)
    return _segmented_notaknot_M(A_fm, in_run, start_slot, end_slot, h)


def segment_phase(seg_fm, ph_s, ph_e, step: int, fs: float):
    """Phase integration of every inter-anchor segment at once
    (functions.py:537-575).

    seg_fm: [n_pairs, step, K], the fm samples at offsets 1..step after each
    segment's left anchor; ph_s/ph_e: [n_pairs, K] anchor phases.  Each
    segment integrates 2*pi*fm/fs from its own left-anchor phase, then the
    endpoint mismatch modulo 2*pi is removed with the sine-bump correction.
    Returns the corrected phases at offsets 1..step: [n_pairs, step, K].
    """
    dtype = seg_fm.dtype
    h = float(step)
    pm = ph_s[:, None, :] + cumsum(seg_fm, dim=1) * (2.0 * math.pi / fs)
    pm_end = pm[:, -1, :]
    Mw = torch.round((pm_end - ph_e) / (2.0 * math.pi))
    er = math.pi * (pm_end - ph_e - 2.0 * math.pi * Mw) / (2.0 * h)
    corr = er[:, None, :] * tracks_ops.sine_bump(step, dtype, seg_fm.device)[
        None, :, None]
    return pm - corr


def interpolate_tracks(am_recon, fm_recon, ph_recon, step: int, fs: float,
                       n_ti: int, length: int):
    """Track interpolation on dense [length, K] arrays whose anchor rows
    (i * step, i < n_ti) hold the accepted values: the anchor rows are
    taken, then ``interpolate_tracks_anchors``.  Returns dense (am_filled,
    fm_filled, ph_filled, fm_current), as reference functions.py:346-381."""
    rows = torch.arange(n_ti, device=am_recon.device) * step
    return interpolate_tracks_anchors(am_recon[rows], fm_recon[rows],
                                      ph_recon[rows], step, fs, length)


def interpolate_tracks_anchors(A_am, A_fm, A_ph, step: int, fs: float,
                               length: int):
    """Track interpolation from anchor values.

    A_am/A_fm/A_ph: [n_ti, K] per-analysis-instant values (zero = not
    accepted); anchor i sits at sample i*step.  Returns dense (am_filled,
    fm_filled, ph_filled, fm_current), each [length, K], interpolated as
    reference functions.py:346-381: on a CUDA tensor by the tracks kernels
    (``ops.tracks.stage`` with dense fm and ph), on a CPU tensor by the
    plain version.
    """
    if A_am.device.type == "cpu":
        return interpolate_tracks_anchors_reference(A_am, A_fm, A_ph, step,
                                                    fs, length)
    st = tracks_ops.stage(A_am[None], A_fm[None], A_ph[None],
                          A_am.new_zeros((1, A_am.shape[0])), step, fs,
                          length, dc="apart", anchors=False, dense=True)
    return st.am[0], st.fm[0], st.ph[0], st.fm_cur[0]


def interpolate_tracks_anchors_reference(A_am, A_fm, A_ph, step: int,
                                         fs: float, length: int):
    """The plain version of ``interpolate_tracks_anchors``: the torch ops
    of eaqhm_tpu/models/tracks.py:143-269."""
    dtype = A_am.dtype
    dev = A_am.device
    n_ti, K = A_am.shape
    L = length
    n_pairs = n_ti - 1
    h = float(step)
    zero = torch.zeros((), dtype=dtype, device=dev)

    acc, in_run, run_start, run_end, start_slot, end_slot = _runs(A_am)
    pair = acc[:-1] & acc[1:]                           # [n_pairs, K]
    run_len = end_slot - start_slot + 1

    # ---- FM spline values ----
    M = _segmented_notaknot_M(A_fm, in_run, start_slot, end_slot, h)
    r = torch.arange(1, step, device=dev)[None, :, None].to(dtype)
    Bc = r / h
    Ac = 1.0 - Bc
    ys = A_fm[:-1][:, None, :]
    ye = A_fm[1:][:, None, :]
    Ms = M[:-1][:, None, :]
    Me = M[1:][:, None, :]
    fm_spline = (Ac * ys + Bc * ye
                 + ((Ac ** 3 - Ac) * Ms + (Bc ** 3 - Bc) * Me) * (h * h) / 6.0)

    # small runs (< 4 anchors): synthetic left anchors at 0, step, ...
    st = start_slot[:-1]
    m_len = run_len[:-1]
    small = pair & (m_len < MIN_INTERP_SIZE)
    zs = torch.zeros_like(st)
    sl3 = torch.stack([zs, st, st + 1, st + 2], dim=-1)
    sl2 = torch.stack([zs, torch.ones_like(st), st, st + 1], dim=-1)
    slots4 = torch.where((m_len == 3)[..., None], sl3, sl2)   # [n_pairs, K, 4]
    # keep abscissae distinct where the small-run path is unused
    slots4 = torch.where(small[..., None], slots4,
                         torch.arange(4, device=dev).expand_as(slots4))
    slots4 = slots4.clamp(0, n_ti - 1)
    x4 = slots4.to(dtype) * h
    kk = torch.arange(K, device=dev)[None, :, None]
    y4 = A_fm[slots4, kk]
    q = (torch.arange(n_pairs, device=dev)[:, None, None].to(dtype) * h
         + torch.arange(1, step, device=dev)[None, None, :].to(dtype))
    fm_small = cubic4_eval(x4, y4, q.expand(n_pairs, K, step - 1))
    fm_small = fm_small.permute(0, 2, 1)                # [n_pairs, step-1, K]
    fm_fill = torch.where(small[:, None, :], fm_small, fm_spline)

    # ---- AM linear values ----
    am_fill = (1.0 - Bc) * A_am[:-1][:, None, :] + Bc * A_am[1:][:, None, :]

    # ---- dense blocks [n_pairs, step, K] from anchors (no scatters) ----
    Lp = n_pairs * step + 1

    def assemble(anchors, fill):
        inner = torch.where(pair[:, None, :], fill, zero)
        block = torch.cat([anchors[:-1][:, None, :], inner], dim=1)
        return torch.cat([block.reshape(-1, K), anchors[-1:],
                          anchors.new_zeros((L - Lp, K))], dim=0)

    def strided(anchors):
        """Dense [L, K] with anchors at rows i*step, zero elsewhere."""
        z = anchors.new_zeros((n_pairs, step - 1, K))
        block = torch.cat([anchors[:-1][:, None, :], z], dim=1)
        return torch.cat([block.reshape(-1, K), anchors[-1:],
                          anchors.new_zeros((L - Lp, K))], dim=0)

    fm_out = assemble(A_fm, fm_fill)
    am_out = assemble(A_am, am_fill)

    # ---- phase integration per segment ----
    fm_blocks = fm_out[:Lp - 1].reshape(n_pairs, step, K)
    seg_fm = torch.cat(
        [fm_blocks[:, 1:, :],
         torch.cat([fm_blocks[1:, :1, :], fm_out[Lp - 1:Lp][None]], dim=0)],
        dim=1)                                           # [n_pairs, step, K]
    pm_c = segment_phase(seg_fm, A_ph[:-1], A_ph[1:], step, fs)
    ph_fill = pm_c[:, :step - 1, :]
    # run-end anchors take the final segment's corrected endpoint
    take_end = pair & run_end[1:]
    A_ph2 = torch.cat(
        [A_ph[:1], torch.where(take_end, pm_c[:, -1, :], A_ph[1:])], dim=0)
    ph_out = assemble(A_ph2, ph_fill)

    # ---- fm_current from unwrapped phase diffs (functions.py:375) ----
    rmask = _segment_rows(L, step, n_pairs, dev)
    pair_dense = torch.cat(
        [pair[:, None, :].expand(n_pairs, step, K).reshape(-1, K),
         pair[-1:].expand(L - n_pairs * step, K)], dim=0)
    cov = (pair_dense & rmask) | strided(in_run)
    dph = ph_out - torch.cat([ph_out[:1], ph_out[:-1]], dim=0)
    ddmod = torch.remainder(dph + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dph > 0), math.pi, ddmod)
    starts_dense = strided(run_start)
    fm_current = torch.where(
        starts_dense, fm_out,
        torch.where(cov & ~starts_dense, (fs / (2.0 * math.pi)) * ddmod,
                    zero))
    return am_out, fm_out, ph_out, fm_current
