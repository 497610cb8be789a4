"""Anchor grids for the tracks stage's tests and chip_smoke.py (numpy, from
a seed; no JAX).

``anchor_case(seed, G, n, K)`` gives G groups of K harmonic columns of n
anchors: am, fm, ph and the acceptance acc [G, n, K] (values outside acc
are noise the stage must mask), the DC anchors a0 and voiced [G, n], and a
signal det [G, L] with its valid lengths.  Accepted runs of every length
(1, 2, 3: the synthetic-anchor cubic; 4, 5 and longer: the spline) come
from accepting each anchor with probability ``p_acc``; column 0 of each
group has no run, column 1 a run from the first anchor and one to the
last, column 2 a run of 3 near the start and one of 2 to the last anchor;
one accepted anchor has am exactly 0 (it splits its run).  Short runs
never start at slots 0 or 1: there the synthetic anchors at slots 0 and 1
coincide with the run's and the 4-point cubic is singular in both packages
(the analysis margin keeps the engine's runs past them).  fm stays inside
the band, so the wrapped phase differences stay away from +-pi.
"""
import numpy as np


def anchor_case(seed, G=1, n=120, K=7, step=15, extra=37, fs=16000.0,
                p_acc=0.8):
    rng = np.random.default_rng(seed)
    acc = rng.uniform(size=(G, n, K)) < p_acc
    acc[:, 1, :] = False
    if K > 0:
        acc[:, :, 0] = False
    if K > 1:
        acc[:, :6, 1] = True
        acc[:, 6, 1] = False
        acc[:, n - 9:, 1] = True
        acc[:, n - 10, 1] = False
    if K > 2:
        acc[:, :, 2] = False
        acc[:, 5:8, 2] = True
        acc[:, n - 2:, 2] = True
    band = (fs / 2 - 400.0) / (K + 1)
    kk = np.arange(1, K + 1)
    fm = band * kk * (1.0 + 0.02 * rng.normal(size=(G, n, K)))
    am = rng.uniform(0.01, 0.3, size=(G, n, K))
    if K > 3:
        hit = np.nonzero(acc[0, 10:n - 10, 3])[0]
        if len(hit):
            am[0, 10 + hit[len(hit) // 2], 3] = 0.0
    ph = rng.uniform(-np.pi, np.pi, size=(G, n, K))
    a0 = rng.normal(scale=0.05, size=(G, n))
    voiced = rng.uniform(size=(G, n)) < 0.9
    L = (n - 1) * step + 1 + extra
    det = rng.normal(scale=0.3, size=(G, L))
    lens = L - rng.integers(0, max(1, extra), size=G)
    return dict(am=am, fm=fm, ph=ph, acc=acc, a0=a0, voiced=voiced, det=det,
                lens=lens, L=L, step=step, fs=fs)


def stage_errors(got, want, step, n, flip_hz=None):
    """The kernels' stage ``got`` against the plain version's ``want``
    (ops.tracks.Stage of n anchors a column, torch tensors on one device):
    per output its largest difference over the largest entry of ``want``,
    the number of flipped segments, and the largest difference of all.
    With flip_hz (float32), a segment whose fm_current differs by more
    than flip_hz at one of its rows took the other Mw (the phase-end round
    at a tie: float32 sums in another order can cross it, and the
    segment's phase then moves by up to 2 pi): such segments are counted,
    and their rows, their right anchor's phase and the rows of s they feed
    are left out of the comparison."""
    import torch
    G, L, K = want.am.shape
    keep_rows = torch.ones((G, L, K), dtype=torch.bool, device=want.am.device)
    keep_anchor = None
    flips = 0
    if flip_hz is not None and K > 0:
        Lp = (n - 1) * step + 1
        d = (got.fm_cur - want.fm_cur).abs()[:, 1:Lp]
        seg = d.reshape(G, n - 1, step, K).amax(dim=2) > flip_hz
        flips = int(seg.sum())
        keep_rows[:, 1:Lp] = ~seg.repeat_interleave(step, dim=1)
        keep_anchor = torch.ones((G, n, K), dtype=torch.bool,
                                 device=want.am.device)
        keep_anchor[:, 1:] = ~seg
    errs = {}
    largest = [0.0]

    def rel(name, g, w, keep=None):
        if not w.numel():
            errs[name] = 0.0
            return
        d = (g - w).abs()
        if keep is not None:
            d = torch.where(keep, d, torch.zeros_like(d))
        largest[0] = max(largest[0], float(d.max()))
        errs[name] = float(d.max().double()
                           / w.abs().max().double().clamp(min=1e-300))
    rel("am", got.am, want.am)
    rel("fm_cur", got.fm_cur, want.fm_cur, keep_rows)
    rel("s", got.s, want.s, keep_rows.all(dim=2))
    if want.anchors is not None:
        rel("anchors_am_fm", got.anchors[:2], want.anchors[:2])
        rel("anchors_ph", got.anchors[2], want.anchors[2], keep_anchor)
        rel("a0_anchor", got.a0_anchor, want.a0_anchor)
    for name in ("a0", "fm", "ph"):
        w = getattr(want, name)
        if w is not None:
            rel(name, getattr(got, name), w,
                None if name == "a0" else keep_rows)
    return errs, flips, largest[0]
