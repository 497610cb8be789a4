"""Batched STFT with matplotlib-`specgram` PSD semantics.

SWIPE' in the reference computes its spectra with
``matplotlib.pyplot.specgram`` (reference SWIPE.py:64-66), whose default is a
one-sided PSD: ``Pxx = |rfft(w*frame)|^2``, every bin except DC and Nyquist
doubled, divided by ``fs * sum(w^2)``.  The downstream column normalization
cancels constant scaling but not the frequency-dependent doubling.

Frames start at sample 0 with hop ``NFFT - noverlap``; frame count is
``(len(x) - NFFT) // hop + 1``; times are frame centers.  The DFT is one
matrix product against the bases cos | -sin, built on the host in float64
once per (nfft, dtype, device), cast to the dtype as the JAX package casts
them (eaqhm_tpu/ops/stft.py:24-30), and kept on the device (``dft_basis``,
at most ``BASIS_CACHE`` of them, least recently used dropped first).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

# bases kept on the devices, as the JAX package's lru_cache(maxsize=8)
BASIS_CACHE = 8
_bases = OrderedDict()           # (nfft, dtype, device) -> [nfft, 2 nbins]
_bases_lock = threading.Lock()
_building = {}                   # (nfft, dtype, device) -> its build's lock
bases_built = 0                  # host builds (each an upload) so far


def _dft_bases(nfft: int):
    """One-sided DFT bases (host float64): cos / -sin [nfft, nfft//2+1]."""
    n = np.arange(nfft)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.cos(ang), -np.sin(ang)


def dft_basis(nfft: int, dtype, device) -> torch.Tensor:
    """The bases cos | -sin [nfft, 2 (nfft//2+1)] in ``dtype`` on
    ``device``: built on the host and uploaded at the first request of a
    (nfft, dtype, device), read from the cache after.  Safe from several
    threads: one builds a key while the others asking for it wait; the
    cache's lock is not held during the build, so requests for other keys
    go on."""
    global bases_built
    key = (int(nfft), dtype, torch.device(device))
    with _bases_lock:
        basis = _bases.get(key)
        if basis is not None:
            _bases.move_to_end(key)
            return basis
        building = _building.setdefault(key, threading.Lock())
    with building:
        with _bases_lock:
            basis = _bases.get(key)
        if basis is None:
            cosb, sinb = _dft_bases(nfft)
            host = np.concatenate([cosb, sinb], axis=1).astype(
                str(dtype)[6:])
            basis = torch.from_numpy(host).to(key[2])
            with _bases_lock:
                _bases[key] = basis
                bases_built += 1
                while len(_bases) > BASIS_CACHE:
                    _bases.popitem(last=False)
    return basis


def basis_cache_bytes() -> int:
    """Bytes the cached bases hold on their devices."""
    with _bases_lock:
        return sum(b.numel() * b.element_size() for b in _bases.values())


def clear_basis_cache() -> None:
    with _bases_lock:
        _bases.clear()


def frame_count(n: int, nfft: int, hop: int) -> int:
    return (n - nfft) // hop + 1


def frame_starts(n: int, nfft: int, hop: int) -> np.ndarray:
    return np.arange(frame_count(n, nfft, hop)) * hop


def frame_times(n: int, nfft: int, hop: int, fs: float) -> np.ndarray:
    """Frame-center times as returned by matplotlib specgram."""
    return (frame_starts(n, nfft, hop) + nfft / 2.0) / fs


def psd_scale(nfft: int, window, fs: float) -> np.ndarray:
    """Per bin the PSD's factor (host float64): the one-sided doubling over
    fs * sum(w^2)."""
    scale = np.full(nfft // 2 + 1, 2.0)
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    return scale / (fs * float(np.sum(np.asarray(window) ** 2)))


def spectrum(x, nfft: int, hop: int, window, pad_pre: int = 0,
             pad_post: int = 0):
    """The windowed frames' DFT, re | im [..., n_frames, 2 (nfft//2+1)].

    x: [..., n] tensor, zero-padded by (pad_pre, pad_post) and framed along
    its last axis; window: [nfft] tensor in x's dtype on x's device.  One
    product against the cached bases (``dft_basis``).
    """
    if pad_pre or pad_post:
        x = torch.nn.functional.pad(x, (pad_pre, pad_post))
    frames = x.unfold(-1, nfft, hop)                         # [..., nf, nfft]
    return torch.matmul(frames * window, dft_basis(nfft, x.dtype, x.device))


def specgram_psd(x, nfft: int, hop: int, window, fs: float):
    """One-sided PSD spectrogram, matplotlib semantics.

    x: [..., n] tensor (framed along the last axis); window: [nfft] numpy
    analysis window.  Returns Pxx: [..., nfft//2 + 1, n_frames] in x's dtype
    and on x's device.
    """
    dtype, dev = x.dtype, x.device
    spec = spectrum(x, nfft, hop, torch.as_tensor(window, dtype=dtype,
                                                  device=dev))
    nbins = nfft // 2 + 1
    re, im = spec[..., :nbins], spec[..., nbins:]
    p = re * re + im * im                                    # |rfft|^2
    p = p * torch.as_tensor(psd_scale(nfft, window, fs), dtype=dtype,
                            device=dev)
    return p.movedim(-1, -2)                                 # [..., freq, time]
