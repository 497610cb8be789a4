"""Voiced/unvoiced and speech/nonspeech classification (VAD).

Reference: functions.py:577-642 `voicedUnvoicedFrames`.  30 ms window on a
5 ms grid; a 30 Hz elliptic high-pass feeds the full-band energy, a 1000 Hz
(male) / 1500 Hz (other) low-pass feeds the "smooth" energy; frames are
speech if full-band energy > -60 dB, voiced if (full - smooth) < 10 dB and
smooth > -50 dB; both flag tracks are then smoothed.

The main path runs the host version (numpy/scipy float64, as the JAX
package's production engine does): the 30 Hz high-pass has poles at radius
0.99939 and diverges in float32, and the work is microseconds per
utterance.  ``voiced_unvoiced_frames`` is the device version for
device-resident pipelines: float64 filtering on the tensor's device
(ops.filters), one gather and two reductions for the windowed energies.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.signal import filtfilt

from eaqhm_torch.device import as_tensor
from eaqhm_torch.ops import filters, medfilt


def _flag_smooth_idx(L: int, p: int, ad: int):
    i = np.arange(L)[:, None]
    j = np.arange(p - 1)[None, :]
    idx = np.where(j <= i, L - 1 - i + j, L + (j - i))
    return np.clip(idx, 0, L + 2 * ad - 1)


def reference_flag_smooth(flags, p: int = 5, device=None):
    """The reference's flag "median filter" (see reference_flag_smooth_np).
    flags: a tensor (kept on its device unless ``device`` is given) or
    array-like (sent to ``device``; None means CUDA)."""
    x = as_tensor(flags, device)
    L = x.shape[-1]
    ad = (p - 1) // 2
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], ad), x,
                    x[..., -1:].expand(*x.shape[:-1], ad)], dim=-1)
    idx = torch.as_tensor(_flag_smooth_idx(L, p, ad), device=x.device)
    count = xp[..., idx].to(torch.int32).sum(dim=-1)
    return count >= (p - 1) // 2


def reference_flag_smooth_np(flags, p: int = 5):
    """Bit-faithful replica of the reference's flag "median filter".

    ``misc.medfilt`` (misc.py:184-206) builds ``toeplitz(flipud(x[0:L]),
    x[L:L+p-1])``, so the intended order-5 median is a time-reversed median
    of 4: a flag is set when >= (p-1)/2 of its p-1 reversed-window samples
    are set (``statistics.median`` of an even window gives 0.5, which is
    truthy downstream).
    """
    x = np.asarray(flags)
    L = x.shape[-1]
    ad = (p - 1) // 2
    xp = np.concatenate([np.repeat(x[..., :1], ad, axis=-1), x,
                         np.repeat(x[..., -1:], ad, axis=-1)], axis=-1)
    win = xp[..., _flag_smooth_idx(L, p, ad)]
    return win.astype(np.int32).sum(axis=-1) >= (p - 1) // 2


def voiced_unvoiced_frames_host(s, fs: int, is_male: bool,
                                replicate_quirks: bool = True):
    """Returns (ti [No], is_speech [No], is_voiced [No], frame_step); ti are
    1-based sample instants as the reference keeps them."""
    s = np.asarray(s, np.float64).ravel()
    length = len(s)
    b, a, _ = filters.design_ellip(fs, 30, "highpass")
    sf = filtfilt(b, a, s)
    b, a, _ = filters.design_ellip(fs, 1000 if is_male else 1500, "lowpass")
    sm = filtfilt(b, a, sf)

    window_len = int(round(0.03 * fs))
    if window_len % 2 == 0:
        window_len += 1
    step = int(round(0.005 * fs))
    midlen = (window_len - 1) // 2
    wr = np.arange(-midlen - 1, midlen)
    ti = np.arange(1, length, step)
    valid = (ti > midlen) & (ti < length - midlen)
    idx = np.clip(ti[:, None] + wr[None, :], 0, length - 1)

    def db(x):
        sd = x[idx].std(axis=-1)
        with np.errstate(divide="ignore"):
            return np.where(valid, 20.0 * np.log10(sd), -np.inf)

    sp_en = db(sf)
    sm_en = db(sm)
    is_speech = valid & (sp_en > -60.0)
    with np.errstate(invalid="ignore"):
        is_voiced = is_speech & ((sp_en - sm_en) < 10.0) & (sm_en > -50.0)

    if replicate_quirks:
        is_speech = reference_flag_smooth_np(is_speech, 5)
        is_voiced = reference_flag_smooth_np(is_voiced, 5)
    else:
        from scipy.ndimage import median_filter
        is_speech = median_filter(is_speech.astype(float), size=5,
                                  mode="nearest") > 0.5
        is_voiced = median_filter(is_voiced.astype(float), size=5,
                                  mode="nearest") > 0.5
    return ti, is_speech, is_voiced, int(ti[1] - ti[0])


def _windowed_std_db(x, ti, window_range, valid):
    """20 log10 of the std of each analysis window of x, -inf off valid."""
    idx = np.clip(ti[:, None] + window_range[None, :], 0, x.shape[-1] - 1)
    win = x[..., torch.as_tensor(idx, device=x.device)]     # [No_ti, wlen]
    m = win.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((win - m) ** 2).mean(dim=-1))
    db = 20.0 * torch.log10(std)
    return torch.where(torch.as_tensor(valid, device=x.device), db,
                       torch.full_like(db, -torch.inf))


def voiced_unvoiced_frames(s, fs: int, is_male: bool, dtype=torch.float64,
                           replicate_quirks: bool = True, device=None):
    """Device VAD: the host version's function on the signal's device.

    s: a tensor (kept on its device unless ``device`` is given) or
    array-like (sent to ``device``; None means CUDA).  Returns (ti [No] numpy, is_speech [No] bool tensor, is_voiced [No] bool
    tensor, frame_step); ti are 1-based sample instants.  Needs float64 for
    the 30 Hz high-pass.
    """
    s = as_tensor(s, device).to(dtype)
    length = s.shape[-1]
    sf = filters.ellip_filter(s, fs, 30, "highpass", dtype=dtype)
    sm = filters.ellip_filter(sf, fs, 1000 if is_male else 1500, "lowpass",
                              dtype=dtype)

    window_len = int(round(0.03 * fs))
    if window_len % 2 == 0:
        window_len += 1
    step = int(round(0.005 * fs))
    midlen = (window_len - 1) // 2
    wr = np.arange(-midlen - 1, midlen)                 # functions.py:619
    ti = np.arange(1, length, step)
    valid = (ti > midlen) & (ti < length - midlen)

    sp_en = _windowed_std_db(sf, ti, wr, valid)
    sm_en = _windowed_std_db(sm, ti, wr, valid)
    valid_t = torch.as_tensor(valid, device=s.device)
    is_speech = valid_t & (sp_en > -60.0)
    # sp < sm + 10 is (sp - sm) < 10 without the -inf - -inf NaN of silent
    # frames (functions.py:626-633)
    is_voiced = is_speech & (sp_en < sm_en + 10.0) & (sm_en > -50.0)

    if replicate_quirks:
        is_speech = reference_flag_smooth(is_speech, 5)
        is_voiced = reference_flag_smooth(is_voiced, 5)
    else:
        is_speech = medfilt.medfilt(is_speech.to(dtype), 5) > 0.5
        is_voiced = medfilt.medfilt(is_voiced.to(dtype), 5) > 0.5
    return ti, is_speech, is_voiced, int(ti[1] - ti[0])


def full_waveform_fixup(ti, is_speech, is_voiced, margin: float, length: int):
    """fullWaveform=True flag override (reference functions.py:140-146):
    every frame with margin/2 < ti < length - margin/2 becomes voiced (and
    non-speech frames there become speech)."""
    inside = (ti > margin / 2) & (ti < length - margin / 2)
    sp = np.where(inside & ~is_voiced & ~is_speech, True, is_speech)
    vo = np.where(inside, True, is_voiced)
    return sp, vo


def deterministic_part_mask(ti, is_speech, is_voiced, frame_step: int,
                            length: int):
    """fullWaveform=False: sample mask of voiced runs +-frame_step
    (reference functions.py:127-138).

    Each maximal run of (speech & voiced) frames [first..last] contributes
    samples [ti_first - frame_step, ti_last + frame_step] (inclusive).  A run
    still open at the final frame is dropped, as the reference only flushes
    a run when it meets a non-voiced frame.
    """
    sv = np.asarray(is_speech & is_voiced)
    ti = np.asarray(ti)
    prev = np.concatenate(([False], sv[:-1]))
    starts = np.nonzero(sv & ~prev)[0]
    ends = np.nonzero(~sv & prev)[0]
    n = len(ends)
    lo = np.maximum(0, ti[starts[:n]] - frame_step)
    hi = np.minimum(length - 1, ti[ends - 1] + frame_step)
    d = np.zeros(length + 1, np.int64)
    np.add.at(d, lo, 1)
    np.add.at(d, hi + 1, -1)
    return np.cumsum(d[:length]) > 0
