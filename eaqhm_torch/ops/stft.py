"""Batched STFT with matplotlib-`specgram` PSD semantics.

SWIPE' in the reference computes its spectra with
``matplotlib.pyplot.specgram`` (reference SWIPE.py:64-66), whose default is a
one-sided PSD: ``Pxx = |rfft(w*frame)|^2``, every bin except DC and Nyquist
doubled, divided by ``fs * sum(w^2)``.  The downstream column normalization
cancels constant scaling but not the frequency-dependent doubling.

Frames start at sample 0 with hop ``NFFT - noverlap``; frame count is
``(len(x) - NFFT) // hop + 1``; times are frame centers.  The plain DFT is
one matrix product against the bases cos | -sin, built on the host in
float64 once per (nfft, dtype, device), cast to the dtype as the JAX package
casts them (eaqhm_tpu/ops/stft.py:24-30), and kept on the device
(``dft_basis``, at most ``BASIS_CACHE`` of them, least recently used dropped
first): the CPU path and the plain versions use them.  The pitch kernel
``swipe_loudness`` reads instead a compact table of the columns a window's
ERB lerp needs (``dft_columns``: the same expression evaluated at those
bins only, so its entries are the bases' bit for bit), cached per (nfft,
bins, dtype, device); only a CUDA plan keeps one.
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
_building = {}                   # a key of either cache -> its build's lock
bases_built = 0                  # host builds (each an upload) so far
# compact tables of needed columns, per (nfft, bins, dtype, device)
COLUMNS_CACHE = 16
_columns = OrderedDict()
columns_built = 0


def _dft_bases(nfft: int):
    """One-sided DFT bases (host float64): cos / -sin [nfft, nfft//2+1]."""
    n = np.arange(nfft)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.cos(ang), -np.sin(ang)


def _cached(cache, key, limit: int, make):
    """cache[key], made by ``make()`` at the first request of the key and
    kept after (at most ``limit`` entries, least recently used dropped
    first).  Safe from several threads: one makes a key while the others
    asking for it wait; the cache's lock is not held while it is made, so
    requests for other keys go on.  Returns (value, whether it was made)."""
    with _bases_lock:
        value = cache.get(key)
        if value is not None:
            cache.move_to_end(key)
            return value, False
        building = _building.setdefault(key, threading.Lock())
    with building:
        with _bases_lock:
            value = cache.get(key)
        if value is not None:
            return value, False
        value = make()
        with _bases_lock:
            cache[key] = value
            while len(cache) > limit:
                cache.popitem(last=False)
    return value, True


def dft_basis(nfft: int, dtype, device) -> torch.Tensor:
    """The bases cos | -sin [nfft, 2 (nfft//2+1)] in ``dtype`` on
    ``device``: built on the host and uploaded at the first request of a
    (nfft, dtype, device), read from the cache after (``_cached``)."""
    global bases_built
    key = (int(nfft), dtype, torch.device(device))

    def make():
        cosb, sinb = _dft_bases(nfft)
        host = np.concatenate([cosb, sinb], axis=1).astype(str(dtype)[6:])
        return torch.from_numpy(host).to(key[2])

    basis, made = _cached(_bases, key, BASIS_CACHE, make)
    if made:
        with _bases_lock:
            bases_built += 1
    return basis


def _dft_columns(nfft: int, bins) -> np.ndarray:
    """The columns ``bins`` of the one-sided DFT bases (host float64), each
    bin's (cos, -sin) side by side: [nfft, len(bins), 2].  The bases'
    expression (``_dft_bases``) evaluated at those k only."""
    n = np.arange(nfft)[:, None]
    k = np.asarray(bins, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1)


def dft_columns(nfft: int, bins, dtype, device) -> torch.Tensor:
    """The compact table [nfft, nu, 2] of the needed bins ``bins`` (sorted
    int array) in ``dtype`` on ``device``, built on the host at the first
    request of a (nfft, bins, dtype, device) and cached after (``_cached``,
    at most ``COLUMNS_CACHE``; keyed by the bins, not the plan, so plans of
    many lengths share one table)."""
    global columns_built
    bins = np.asarray(bins, dtype=np.int64)
    key = (int(nfft), bins.tobytes(), dtype, torch.device(device))

    def make():
        host = _dft_columns(nfft, bins).astype(str(dtype)[6:])
        return torch.from_numpy(host).to(key[3])

    table, made = _cached(_columns, key, COLUMNS_CACHE, make)
    if made:
        with _bases_lock:
            columns_built += 1
    return table


def columns_cache_bytes() -> int:
    """Bytes the cached compact tables hold on their devices."""
    with _bases_lock:
        return sum(t.numel() * t.element_size() for t in _columns.values())


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
