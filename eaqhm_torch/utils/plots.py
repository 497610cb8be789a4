"""Diagnostic plots: before/after spectrograms and time-domain views.

Reference parity: `plotGraphs` (reference main.py:18-42) draws two
spectrograms (matplotlib `specgram`, color limits vmin=-180 / vmax=-40 dB)
and two time-domain plots of the original and reconstructed signals.  The
reference relies on a side effect — SWIPE' leaves a live `specgram` figure
behind (reference SWIPE.py:66, SURVEY.md §2.5 quirk #5) that `plotGraphs`
merely decorates.  Here the plots are self-contained and headless-safe: each
figure is created explicitly and (optionally) written to disk, so the
framework works on display-less hosts and in CI.

matplotlib is imported lazily so the compute path never pays for it.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_spectrogram(s, fs: int, title: str, out: Optional[str] = None,
                     nfft: int = 256, vmin: float = -180.0,
                     vmax: float = -40.0):
    """One spectrogram figure with the reference's color limits.

    Mirrors the reference's `plt.specgram(...)` + colorbar + labels
    (main.py:19-30): default NFFT=256, Hann window, PSD mode — identical
    semantics to the figure the reference decorates.
    """
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 4))
    _, _, _, im = ax.specgram(np.asarray(s).ravel(), NFFT=nfft, Fs=fs,
                              vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax, format="%+2.0f dB")
    ax.set_title(title)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("Frequency [Hz]")
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


def plot_time_domain(s, fs: int, title: str, out: Optional[str] = None):
    """Time-domain waveform plot (reference main.py:32-42)."""
    plt = _mpl()
    s = np.asarray(s).ravel()
    t = np.arange(len(s)) / fs
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(t, s, linewidth=0.5)
    ax.set_title(title)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("Amplitude")
    ax.set_xlim(0, t[-1] if len(t) else 1)
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


def plot_graphs(s, s_recon, fs: int, out_dir: Optional[str] = None,
                prefix: str = "eaqhm") -> Sequence:
    """Before/after diagnostic set: 2 spectrograms + 2 time-domain plots.

    The equivalent of reference `plotGraphs` (main.py:18-42).
    With `out_dir` set, writes four PNGs and returns their paths; otherwise
    returns the four live figures.
    """
    items = [
        (plot_spectrogram, s, "Original signal (spectrogram)", "spec_orig"),
        (plot_spectrogram, s_recon, "Reconstructed signal (spectrogram)",
         "spec_recon"),
        (plot_time_domain, s, "Original signal", "time_orig"),
        (plot_time_domain, s_recon, "Reconstructed signal", "time_recon"),
    ]
    results = []
    for fn, sig, title, stem in items:
        out = (os.path.join(out_dir, f"{prefix}_{stem}.png")
               if out_dir else None)
        results.append(fn(sig, fs, title, out=out))
    return results


def plot_pitch(f0_grid, out: Optional[str] = None, title: str = "SWIPE' f0"):
    """Pitch-track diagnostic: the (t, f0) rows from the SWIPE' stage."""
    plt = _mpl()
    g = np.asarray(f0_grid)
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(g[:, 0], g[:, 1], linewidth=0.8)
    ax.set_title(title)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("f0 [Hz]")
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig
