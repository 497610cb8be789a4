"""Tests of the port that need the card, marked ``gpu``: they skip where
there is no CUDA device.  This file imports neither JAX nor the JAX
package, so on the card it runs alone:

    python -m pytest --noconftest -q -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py tests/test_torch_chol.py
"""
import numpy as np
import pytest
import torch

FS = 16000


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_lfilter_matches_plain_version(dtype):
    """The kernel rounds every product and sum as its plain version does,
    in the same order: equal bit for bit, also on the 30 Hz high-pass, in
    both of the kernel's types."""
    _needs_cuda()
    from eaqhm_torch.ops import filters
    rng = np.random.default_rng(11)
    for fc, ftype in ((30, "highpass"), (1500, "lowpass")):
        b, a, zi = filters.design_ellip(FS, fc, ftype)
        x = torch.as_tensor(rng.normal(size=(3, 4001)), dtype=dtype,
                            device="cuda")
        n = filters.lfilter.launches
        y, zf = filters.lfilter_with_state(b, a, x, zi=zi, dtype=dtype)
        torch.cuda.synchronize()
        assert filters.lfilter.launches == n + 1
        z0 = torch.as_tensor(zi.copy(), dtype=dtype).expand(3, -1)
        yr, zr = filters.lfilter_reference(b / a[0], a / a[0], x.cpu(),
                                           z0.contiguous())
        for got, want in ((y, yr), (zf, zr)):
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                                       equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cuda_fused_loop_matches_host_loop(dtype):
    """On the card the fused loop captures one eaQHM adaptation as a CUDA
    graph and replays it: the same trajectory and reconstruction as the
    host loop, on the golden SA19 resynthesis (female; it improves at
    adaptation 1 and declines at 2, so the first call captures and replays
    once and a warm call replays every eaQHM adaptation).  float64 to the
    tolerances of tests/test_aux_subsystems.py:152-175; float32 to 1e-4 dB
    and 1e-5, since its graph always computes the ridged rerun and selects
    it on the device (the same function, to float32 rounding)."""
    _needs_cuda()
    import os
    import eaqhm_torch
    from eaqhm_torch.models import engine
    from eaqhm_torch.ops import chol
    s = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "sa19_golden.npz"))["s_recon"]
    kw = dict(gender="female", dtype=dtype)
    engine.clear_graph_cache()
    host = eaqhm_torch.analyze(s, FS, eaqhm_torch.EaqhmConfig(**kw))
    cfg = eaqhm_torch.EaqhmConfig(fused_adapt_loop=True, **kw)
    first = eaqhm_torch.analyze(s, FS, cfg)
    chol.reset_counts()
    warm = eaqhm_torch.analyze(s, FS, cfg)
    n = len(host.srer)
    assert n >= 3 and len(first.srer) == len(warm.srer) == n
    assert first.fused["replays"] == n - 2
    assert warm.fused["cached_graph"] and warm.fused["replays"] == n - 1
    assert chol.chol_solve.replayed > 0       # the kernel ran in the graph
    tol = (1e-9, 1e-12) if dtype == "float64" else (1e-4, 1e-5)
    for res in (first, warm):
        np.testing.assert_allclose(res.srer, host.srer, atol=tol[0])
        np.testing.assert_allclose(res.s_recon, host.s_recon, atol=tol[1])
    engine.clear_graph_cache()


# the block-inverse kernel's residual ratios against the plain version's
# (chip_smoke.py BI_RATIO_TOL: about ten times the largest difference of
# its sound runs on the card)
_BI_RATIO_TOL = {torch.complex64: 4e-6, torch.complex128: 1e-14}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-4),
                                       (torch.complex128, 1e-10)])
def test_cuda_block_inverse_matches_plain_version(dtype, tol):
    """The block-inverse kernel against its plain version on the card, on
    both paths (resident and hybrid orders of each type): x to the
    tolerances of tests/test_torch_solver.py, the gate's inputs, and the
    launches per call the wrapper counts; the batch flag cleared by a
    non-finite system."""
    _needs_cuda()
    from eaqhm_torch.ops import block_inverse as bi
    rng = np.random.default_rng(5)
    for B, M in ((7, 37), (5, 130), (3, 258)):
        A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
        R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
        d = np.sqrt(np.real(np.einsum("bii->bi", R)))
        R = torch.as_tensor(R / (d[:, :, None] * d[:, None, :]),
                            dtype=dtype)
        b = torch.as_tensor(rng.normal(size=(B, M))
                            + 1j * rng.normal(size=(B, M)), dtype=dtype)
        n = bi.block_inverse_solve.launches
        sol = bi.block_inverse_solve(R.cuda(), b.cuda())
        torch.cuda.synchronize()
        _, subtrees = bi._nodes(dtype, M)
        kernels = (1 if bi.path_for(dtype, M) == "resident" else
                   len(subtrees) + 1)
        assert bi.block_inverse_solve.launches == n + kernels
        ref = bi.solve_reference(R, b)
        err = (sol.x.cpu() - ref.x).abs().max() / ref.x.abs().max()
        assert err <= tol, (M, err)
        assert bool(sol.ok) and bool(sol.finite.all())
        torch.testing.assert_close(sol.resid_ratio.cpu(), ref.resid_ratio,
                                   rtol=0, atol=_BI_RATIO_TOL[dtype])
        R[1, 0, 0] = 0
        sol = bi.block_inverse_solve(R.cuda(), b.cuda())
        assert not bool(sol.ok) and not bool(sol.finite[1])


def _hpd_systems(rng, B, M, dtype):
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = torch.as_tensor(R / (d[:, :, None] * d[:, None, :]), dtype=dtype)
    b = torch.as_tensor(rng.normal(size=(B, M))
                        + 1j * rng.normal(size=(B, M)), dtype=dtype)
    return R, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-4),
                                       (torch.complex128, 1e-10)])
def test_cuda_block_inverse_at_path_boundaries(dtype, tol):
    """The kernel against its plain version at both sides of every
    boundary of its path table: resident to hybrid (complex64 168 / 169,
    complex128 118 / 119), two blocks a SM to one (complex64 resident
    118 / 119, subtrees 120 / 121 at M = 241), the subtree limit (170 /
    171, 120 / 121), the small nodes (32 / 33), and SA19's top tier at a
    batch below the SM count (154 x 194): x to the tolerances of
    tests/test_torch_solver.py, the gate's inputs, the launch count."""
    _needs_cuda()
    from eaqhm_torch.ops import block_inverse as bi
    rng = np.random.default_rng(8)
    for B, M in ((3, 32), (3, 33), (3, 117), (3, 118), (3, 119), (3, 120),
                 (3, 121), (3, 168), (3, 169), (3, 170), (3, 171), (3, 241),
                 (154, 194)):
        R, b = _hpd_systems(rng, B, M, dtype)
        n = bi.block_inverse_solve.launches
        sol = bi.block_inverse_solve(R.cuda(), b.cuda())
        torch.cuda.synchronize()
        _, subtrees = bi._nodes(dtype, M)
        kernels = (1 if bi.path_for(dtype, M) == "resident" else
                   len(subtrees) + 1)
        assert bi.block_inverse_solve.launches == n + kernels, M
        ref = bi.solve_reference(R, b)
        err = (sol.x.cpu() - ref.x).abs().max() / ref.x.abs().max()
        assert err <= tol, (M, err)
        assert bool(sol.ok) and bool(sol.finite.all()), M
        torch.testing.assert_close(sol.resid_ratio.cpu(), ref.resid_ratio,
                                   rtol=0, atol=_BI_RATIO_TOL[dtype])


@pytest.mark.gpu
def test_cuda_block_inverse_path_table_matches_the_library():
    """The wrapper's path table (pure Python, the shared-memory sizes of
    ops.block_inverse.smem_bytes) equals the kernel library's bi_path and
    bi_subtree_max at every M from 1 to 2000, in both types."""
    _needs_cuda()
    from eaqhm_torch.ops import block_inverse as bi
    lib = bi.library("cuda")
    for c128, dtype in ((0, torch.complex64), (1, torch.complex128)):
        assert lib.bi_subtree_max(c128) == bi.subtree_max(dtype)
        for M in range(1, 2001):
            assert lib.bi_path(M, c128) == bi.PATHS.index(
                bi.path_for(dtype, M)), (dtype, M)


# the fit kernels against their plain version on the card, relative to the
# largest entry of each output: complex128 to rounding (sums in another
# order); complex64 also rounds its phase cumsum in another order than
# torch.cumsum and sums R over N <= 2897 rows in float32
_FIT_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
# (N, Kc, fs) of the main paths' fit batches: SA19's, the corpus paths',
# the presets' and the stress tiers at 16 kHz, the wide tiers at 22.05,
# 44.1 and 48 kHz
_FIT_SHAPES = ((241, 24, 16000.0), (241, 31, 16000.0), (241, 32, 16000.0),
               (257, 40, 16000.0), (301, 47, 16000.0), (301, 59, 16000.0),
               (305, 48, 16000.0), (401, 64, 16000.0), (609, 96, 16000.0),
               (689, 128, 16000.0), (961, 192, 22050.0),
               (1905, 323, 44100.0), (2897, 487, 48000.0))


def fit_inputs(rng, B, N, Kc, fs):
    """One batch of both fits' inputs (numpy): f0 per frame in the upper
    half of the tier's range (Kc harmonics below fs / 2, so every column
    is live and in band), zero gaps inside the window and at its edges,
    wl < W on most frames, a dead frame (no track), a frame with a third of
    the harmonics, a frame with every harmonic masked, fm at exact
    halves."""
    W = (N - 1) // 2
    o = np.arange(-W, W + 1)
    wl = rng.integers(max(1, W // 2), W + 1, size=B)
    wl[0] = W
    s_win = rng.normal(size=(B, N))
    f0 = rng.uniform(0.5, 1.0, size=B) * (fs / 2 / Kc)
    K = np.minimum(Kc, np.floor(fs / 2 / f0)).astype(np.int64)
    K[1] = Kc // 3
    k = np.arange(1, Kc + 1)
    fm = (f0[:, None, None] * k[None, None, :]
          + rng.normal(scale=2.0, size=(B, N, Kc)))
    fm[0, :, 0] = np.round(fm[0, :, 0]) + 0.5
    am = rng.uniform(0.01, 0.5, size=(B, N, Kc))
    gaps = rng.random(size=(B, N, Kc)) < 0.1
    gaps[:, :W // 3, 1] = True                  # before the window's left edge
    gaps[:, N - W // 4:, 2 % Kc] = True         # to its right edge
    gaps[B - 1] = True                          # a dead frame
    fm[gaps] = 0.0
    am[gaps] = 0.0
    colmask = fm[:, W, :] != 0
    colmask[:, 0] = True
    colmask[B - 2] = False                      # every harmonic masked
    return dict(s_win=s_win, o=o, wl=wl, f0=f0, K=K, fm=fm, am=am,
                colmask=colmask)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-300)
            ).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["iqhm", "eaqhm"])
def test_cuda_fit_matches_plain_version(dtype, mode):
    """fit_basis and fit_gram through iqhm_gram / eaqhm_gram on the card
    against the plain version (the torch-op fit) on the same inputs, at
    every (N, Kc) of the main paths' fit batches at its own sampling rate
    (a few frames each): R, rhs and dinv to _FIT_TOL of their largest
    entry, R Hermitian, one launch of each kernel per call."""
    _needs_cuda()
    from eaqhm_torch.ops import fit
    rng = np.random.default_rng(17)
    for N, Kc, fs in _FIT_SHAPES:
        B = 6
        d = {k: torch.as_tensor(v, device="cuda")
             for k, v in fit_inputs(rng, B, N, Kc, fs).items()}
        s_win = d["s_win"].to(dtype)
        n_b, n_g = fit.fit_basis.launches, fit.fit_gram.launches
        if mode == "iqhm":
            args = (s_win, d["o"], d["wl"], d["f0"].to(dtype), d["K"],
                    fs, Kc)
            got = fit.iqhm_gram(*args, dtype=dtype)
            want = fit.iqhm_gram_reference(*args, dtype=dtype)
        else:
            args = (s_win, d["fm"].to(dtype), d["am"].to(dtype), d["o"],
                    d["wl"], d["colmask"], fs)
            got = fit.eaqhm_gram(*args, dtype=dtype)
            want = fit.eaqhm_gram_reference(*args, dtype=dtype)
        torch.cuda.synchronize()
        assert (fit.fit_basis.launches, fit.fit_gram.launches) == \
            (n_b + 1, n_g + 1)
        R = got[0]
        assert torch.equal(R, R.mH), (N, Kc)
        for name, g, w in zip(("R", "rhs", "dinv"), got, want):
            err = _rel(g, w)
            assert err <= _FIT_TOL[dtype], (mode, N, Kc, name, err)


def table_inputs(rng, B, N, Kc, fs):
    """One batch of the table fits' inputs (numpy): two utterances of L =
    3N samples in one table, fm / am tables with Kc + 5 columns (the fit
    reads the first Kc through the stride), frames with windows clamped at
    both ends of each utterance, dead centres left of, at and right of
    frames' centres, dead frames, zero gaps and a run to an utterance's
    end, f0 in the upper half of the tier's range."""
    W = (N - 1) // 2
    L = 3 * N
    utt = np.arange(B) % 2
    ctr = rng.integers(0, L, size=B)
    ctr[:2] = (W // 3, L - 1 - W // 4)                # clamped at both ends
    t = np.arange(L)
    f0 = (0.5 + 0.5 * rng.random(size=(2, 1))) * (fs / 2 / Kc)
    f0_t = f0 * (1.0 + 0.05 * np.sin(2 * np.pi * t / (L / 3.0)))
    k = np.arange(1, Kc + 6)
    fm = f0_t[..., None] * k + rng.normal(scale=2.0, size=(2, L, Kc + 5))
    am = rng.uniform(0.01, 0.5, size=(2, L, Kc + 5))
    gaps = rng.random(size=fm.shape) < 0.1
    gaps[1, L - N:, 1 % Kc] = True
    gaps[:, :, 0] |= rng.random(size=(2, L)) < 0.2
    fm[gaps] = 0.0
    am[gaps] = 0.0
    dead = rng.random(size=(2, L)) < 0.05
    for b in range(2, B):
        dead[utt[b], np.clip(ctr[b] + np.array([-7, 0, 5]), 0, L - 1)] = True
    dd = rng.random(size=B) < 0.5
    f0b = f0[utt, 0] * (1.0 + 0.05 * np.sin(2 * np.pi * ctr / (L / 3.0)))
    K = np.minimum(Kc, np.floor(fs / 2 / f0b)).astype(np.int64)
    colmask = fm[utt, ctr, :Kc] != 0
    colmask[:, 0] = True
    colmask[B - 1] = False
    wl = rng.integers(max(1, W // 2), W + 1, size=B)
    return dict(s=rng.normal(size=(2, L)), fm=fm, am=am, dead=dead, utt=utt,
                ctr=ctr, dd=dd, wl=wl, f0=f0b, K=K, colmask=colmask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["iqhm", "eaqhm"])
def test_cuda_table_fit_matches_plain_version(dtype, mode):
    """The engines' entry points (iqhm_gram_tables / eaqhm_gram_tables: the
    kernels read the signal and track tables, the overlay applied in
    fit_basis) against the plain version (the torch-op gather and overlay,
    then the torch-op fit) on the same tables, at every main-path (N, Kc)
    at its own sampling rate: R, rhs and dinv to _FIT_TOL of their largest
    entry, R Hermitian, one launch of each kernel per call, none served by
    the plain version."""
    _needs_cuda()
    from eaqhm_torch.ops import fit
    rng = np.random.default_rng(29)
    for N, Kc, fs in _FIT_SHAPES:
        W, B = (N - 1) // 2, 6
        d = {k: torch.as_tensor(v, device="cuda")
             for k, v in table_inputs(rng, B, N, Kc, fs).items()}
        for k in ("s", "fm", "am", "wl", "f0"):
            d[k] = d[k].to(dtype)
        fit.reset_counts()
        if mode == "iqhm":
            args = (d["s"], d["utt"], d["ctr"], W, d["wl"], d["f0"], d["K"],
                    fs, Kc)
            got = fit.iqhm_gram_tables(*args, dtype=dtype)
            s_win = fit.gather_windows(d["s"], d["utt"], d["ctr"], W)
            o = torch.arange(-W, W + 1, device="cuda")
            want = fit.iqhm_gram_reference(s_win, o, d["wl"], d["f0"],
                                           d["K"], fs, Kc, dtype=dtype)
        else:
            args = (d["s"], d["fm"], d["am"], d["dead"], d["utt"], d["ctr"],
                    d["dd"], W, d["wl"], d["colmask"], fs)
            got = fit.eaqhm_gram_tables(*args, dtype=dtype)
            win = fit.gather_windows(d["s"], d["utt"], d["ctr"], W, d["fm"],
                                     d["am"], d["dead"], d["dd"], Kc)
            o = torch.arange(-W, W + 1, device="cuda")
            want = fit.eaqhm_gram_reference(*win, o, d["wl"], d["colmask"],
                                            fs, dtype=dtype)
        torch.cuda.synchronize()
        assert (fit.fit_basis.launches, fit.fit_gram.launches) == (1, 1)
        assert fit.plain_fits() == 0
        R = got[0]
        assert torch.equal(R, R.mH), (N, Kc)
        for name, g, w in zip(("R", "rhs", "dinv"), got, want):
            err = _rel(g, w)
            assert err <= _FIT_TOL[dtype], (mode, N, Kc, name, err)


@pytest.mark.gpu
def test_cuda_fit_gram_plan_matches_the_library():
    """fit_gram's plan (tiles, live pieces, piece slots) as the library
    computes it equals ops.fit.gram_plan at every main-path Kc, and the
    executed work stays within 1.35 of the least."""
    _needs_cuda()
    import ctypes
    from eaqhm_torch.ops import fit
    lib = fit.library("cuda")
    out = (ctypes.c_longlong * 3)()
    for _, Kc, _ in _FIT_SHAPES:
        assert lib.fit_gram_plan(Kc, out) == 0
        assert tuple(out) == fit.gram_plan(Kc), Kc
        assert fit.gram_work_ratio(Kc) <= 1.35, Kc


# the tracks kernels against their plain version: float64 to rounding;
# float32 sums M's affine maps, the in-segment phase and the K-sum in other
# orders (a few float32 ulps of the phase, times fs / 2 pi in fm_current),
# about ten times the largest such gap; a segment whose phase-end round
# flips (none at these shapes) would be counted and left out
TRACK_TOL = {torch.float64: 1e-10, torch.float32: 2e-5}
TRACK_SRER_TOL_DB = {torch.float64: 1e-9, torch.float32: 1e-4}


def _track_case(seed, dtype, **kw):
    from torch_track_cases import anchor_case
    c = anchor_case(seed, **kw)
    t = {k: torch.as_tensor(c[k], device="cuda") for k in
         ("am", "fm", "ph", "acc", "a0", "voiced", "det", "lens")}
    for k in ("am", "fm", "ph", "a0", "det"):
        t[k] = t[k].to(dtype)
    return c, t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_tracks_stage_matches_plain_version(dtype):
    """track_spline, track_synth and track_srer against the plain version
    on the same CUDA tensors: one utterance as the engine calls them (the
    acceptance and voiced masks, anchors, s with the DC, L > Lp), three
    utterances as the batch engine does (masked values, the DC apart, a
    strided anchor table, per-utterance lengths), 300 columns (more than a
    block), step 4 with L = Lp, and the dense mode; two launches agree bit
    for bit; the counts move by one launch a kernel and no plain call."""
    _needs_cuda()
    from eaqhm_torch.ops import tracks
    from torch_track_cases import stage_errors
    cases = [(dict(seed=0), dict(dc="sum"), True),
             (dict(seed=1, G=3, n=90, K=5), dict(dc="apart"), False),
             (dict(seed=2, n=30, K=300, extra=3), dict(dc="sum"), True),
             (dict(seed=3, n=50, K=9, step=4, extra=0), dict(dc="sum",
                                                             dense=True),
              True)]
    for kw, mode, masks in cases:
        c, t = _track_case(kw.pop("seed"), dtype, **kw)
        step, fs, L = c["step"], c["fs"], c["L"]
        if masks:
            args = (t["am"], t["fm"], t["ph"], t["a0"])
            extra = dict(acc=t["acc"], voiced=t["voiced"])
        else:
            wide = torch.zeros((3,) + tuple(t["am"].shape[:2])
                               + (t["am"].shape[2] + 2,), dtype=dtype,
                               device="cuda")
            for i, k in enumerate(("am", "fm", "ph")):
                wide[i, ..., 1:-1] = torch.where(t["acc"], t[k], 0)
            args = (wide[0, ..., 1:-1], wide[1, ..., 1:-1],
                    wide[2, ..., 1:-1], torch.where(t["voiced"], t["a0"], 0))
            extra = {}
        tracks.reset_counts()
        got = tracks.stage(*args, step, fs, L, **extra, **mode)
        again = tracks.stage(*args, step, fs, L, **extra, **mode)
        want = tracks.stage_reference(*args, step, fs, L, **extra, **mode)
        torch.cuda.synchronize()
        assert tracks.track_spline.launches == 2
        assert tracks.track_synth.launches == 2 and tracks.plain_calls() == 0
        for a, b in zip(got, again):
            assert a is None or torch.equal(a, b)
        errs, flips, _ = stage_errors(got, want, step, c["am"].shape[1],
                                   flip_hz=1e-3 * fs)
        assert flips == 0 and max(errs.values()) <= TRACK_TOL[dtype], errs
        if masks:
            std = torch.std(t["det"][0, :int(c["lens"][0])], correction=0)
            srer = tracks.masked_srer(t["det"][0], got.s[0], std_det=std,
                                      n_valid=int(c["lens"][0]))
            ref = tracks.masked_srer_reference(t["det"][0], got.s[0],
                                               std_det=std,
                                               n_valid=int(c["lens"][0]))
        else:
            s_rec = got.s + got.a0
            srer = tracks.masked_srer(t["det"], s_rec, lens=t["lens"])
            ref = tracks.masked_srer_reference(t["det"], s_rec,
                                               lens=t["lens"])
        assert tracks.track_srer.launches == 1
        d = (srer - ref).abs().max().item()
        assert d <= TRACK_SRER_TOL_DB[dtype], d


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_public_track_functions_match_plain_version(dtype):
    """interpolate_tracks_anchors, interpolate_tracks and
    notaknot_interp_uniform on CUDA tensors (the kernels, with dense fm and
    ph; the DC columns alone, shorter and longer than the anchors cover)
    against their plain versions."""
    _needs_cuda()
    from eaqhm_torch.models import tracks as tt
    from eaqhm_torch.ops import interp, tracks
    c, t = _track_case(4, dtype, n=80, K=6)
    am, fm, ph = (torch.where(t["acc"][0], t[k][0], 0)
                  for k in ("am", "fm", "ph"))
    tol = TRACK_TOL[dtype]
    tracks.reset_counts()
    got = tt.interpolate_tracks_anchors(am, fm, ph, c["step"], c["fs"],
                                        c["L"])
    want = tt.interpolate_tracks_anchors_reference(am, fm, ph, c["step"],
                                                   c["fs"], c["L"])
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= tol * w.abs().max()
    rows = torch.arange(80, device="cuda") * c["step"]
    dense = [torch.zeros((c["L"], 6), dtype=dtype, device="cuda")
             for _ in range(3)]
    for d, a in zip(dense, (am, fm, ph)):
        d[rows] = a
    for g, w in zip(tt.interpolate_tracks(*dense, c["step"], c["fs"], 80,
                                          c["L"]), want):
        assert (g - w).abs().max() <= tol * w.abs().max()
    yv = t["a0"][0]
    for length in (79 * c["step"] - 7, 79 * c["step"] + 40):
        for y in (yv, torch.stack([yv, 2 * yv], dim=1)):
            g = interp.notaknot_interp_uniform(y, c["step"], length)
            w = interp.notaknot_interp_uniform_reference(
                y if y.dim() == 2 else y[:, None], c["step"], length)
            w = w if y.dim() == 2 else w[:, 0]
            assert g.shape == w.shape
            assert (g - w).abs().max() <= tol * w.abs().max()
    assert tracks.track_synth.launches == 6 and tracks.plain_calls() == 0


def _boundary_case(dtype):
    """One group of 9 columns over 200 anchors whose runs meet track_spline's
    tile boundaries (32 anchors a tile at this size, spline_plan): column 0
    has no run; columns 1-3 runs of 2, 3 and 4 across a boundary; column 4 a
    run of 60 across two; column 5 one of 49 from a boundary; column 6 a
    start at a tile's last anchor and ends at a tile's first and second;
    column 7 runs everywhere; column 8 every anchor."""
    rng = np.random.default_rng(17)
    n, K, step = 200, 9, 15
    acc = np.zeros((1, n, K), bool)
    for k, (a, b) in ((1, (31, 33)), (2, (63, 66)), (3, (94, 98)),
                      (4, (20, 80)), (5, (96, 145)), (6, (95, 101)),
                      (6, (120, 129)), (6, (150, 161)), (8, (0, n))):
        acc[0, a:b, k] = True
    acc[0, :, 7] = rng.uniform(size=n) < 0.9
    fm = 150.0 * np.arange(1, K + 1) * (1 + 0.02 * rng.normal(size=(1, n, K)))
    am = rng.uniform(0.01, 0.3, size=(1, n, K))
    ph = rng.uniform(-np.pi, np.pi, size=(1, n, K))
    t = {k: torch.as_tensor(v, device="cuda", dtype=dtype)
         for k, v in (("am", am), ("fm", fm), ("ph", ph),
                      ("a0", rng.normal(scale=0.05, size=(1, n))))}
    t["acc"] = torch.as_tensor(acc, device="cuda")
    return t, step, 16000.0, (n - 1) * step + 21


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_spline_tile_boundaries(dtype):
    """track_spline where tile boundaries fall inside runs of 2, 3, 4, 49
    and more anchors, at a run's start and end, a column with no run:
    M against the plain spline, the stage against the plain stage, two
    launches bitwise equal."""
    _needs_cuda()
    from eaqhm_torch.ops import tracks
    from torch_track_cases import stage_errors
    t, step, fs, L = _boundary_case(dtype)
    assert tracks.spline_plan(1, 200, 9)[0] == 32
    args = (t["am"], t["fm"], t["acc"], t["a0"], None, step)
    M = tracks.track_spline(*args)
    again = tracks.track_spline(*args)
    ref = tracks.spline_reference(t["am"], t["fm"], t["a0"], step,
                                  acc=t["acc"])
    torch.cuda.synchronize()
    assert torch.equal(M, again)
    assert (M - ref).abs().max() <= TRACK_TOL[dtype] * ref.abs().max()
    sargs = (t["am"], t["fm"], t["ph"], t["a0"], step, fs, L)
    got = tracks.stage(*sargs, acc=t["acc"])
    want = tracks.stage_reference(*sargs, acc=t["acc"])
    errs, flips, _ = stage_errors(got, want, step, 200, flip_hz=1e-3 * fs)
    assert flips == 0 and max(errs.values()) <= TRACK_TOL[dtype], errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_tracks_every_mode(dtype):
    """Every dc / anchors / dense mode of the stage against the plain
    version, with and without the masks; two launches bitwise equal."""
    _needs_cuda()
    import itertools
    from eaqhm_torch.ops import tracks
    from torch_track_cases import stage_errors
    c, t = _track_case(8, dtype, G=2, n=70, K=11)
    step, fs, L = c["step"], c["fs"], c["L"]
    args = (t["am"], t["fm"], t["ph"], t["a0"], step, fs, L)
    for dc, anchors, dense, masks in itertools.product(
            ("sum", "apart"), (True, False), (True, False), (True, False)):
        kw = dict(acc=t["acc"], voiced=t["voiced"]) if masks else {}
        mode = dict(dc=dc, anchors=anchors, dense=dense)
        got = tracks.stage(*args, **kw, **mode)
        again = tracks.stage(*args, **kw, **mode)
        want = tracks.stage_reference(*args, **kw, **mode)
        torch.cuda.synchronize()
        for a, b, w in zip(got, again, want):
            assert (a is None) == (w is None) and (
                a is None or torch.equal(a, b))
        errs, flips, _ = stage_errors(got, want, step, 70, flip_hz=1e-3 * fs)
        assert flips == 0 and max(errs.values()) <= TRACK_TOL[dtype], (
            mode, masks, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_stage_tiers_matches_dense_form(dtype):
    """stage_tiers (the kernels reading three tiers of Kb = 3, 5 and 7
    through the frame map: a frame in no tier, an index past the grid)
    against the dense kernels on the grid the plain version gathers (bit
    for bit: the same arithmetic in the same order) and against the plain
    version; two launches bitwise equal; one launch of each kernel a
    stage, none of the plain version."""
    _needs_cuda()
    from eaqhm_torch.ops import tracks
    from torch_track_cases import anchor_case, stage_errors
    c = anchor_case(21, n=60, K=7)
    rng = np.random.default_rng(21)
    n, step, fs, L = 60, c["step"], c["fs"], c["L"]
    frames = rng.permutation(n)
    idx = [np.sort(frames[1:21]), np.sort(frames[21:40]),
           np.append(np.sort(frames[40:]), n)]
    parts = []
    for kb, ix in zip((3, 5, 7), idx):
        rows = np.minimum(ix, n - 1)
        part = [c["a0"][0, rows]] + [c[k][0, rows, :kb]
                                     for k in ("am", "fm", "ph", "acc")]
        parts.append(tuple(torch.as_tensor(
            x, device="cuda", dtype=None if x.dtype == bool else dtype)
            for x in part))
    fmap = tracks.tier_map([torch.as_tensor(ix, device="cuda")
                            for ix in idx], n, "cuda")
    voiced = (fmap >= 0)[None]
    tiers = tracks.Tiers(fmap, tuple(parts), 7)
    tracks.reset_counts()
    got = tracks.stage_tiers(tiers, step, fs, L, voiced=voiced)
    again = tracks.stage_tiers(tiers, step, fs, L, voiced=voiced)
    assert tracks.track_spline.launches == tracks.track_synth.launches == 2
    assert tracks.plain_calls() == 0
    a0, am, fm, ph, acc = tracks.gather_tiers_reference(tiers)
    dense = tracks.stage(am[None], fm[None], ph[None], a0[None], step, fs, L,
                         acc=acc[None], voiced=voiced)
    want = tracks.stage_reference(am[None], fm[None], ph[None], a0[None],
                                  step, fs, L, acc=acc[None], voiced=voiced)
    torch.cuda.synchronize()
    for a, b, d in zip(got, again, dense):
        assert a is None or (torch.equal(a, b) and torch.equal(a, d))
    errs, flips, _ = stage_errors(got, want, step, n, flip_hz=1e-3 * fs)
    assert flips == 0 and max(errs.values()) <= TRACK_TOL[dtype], errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_synth_blocks_of_several_slices(dtype):
    """track_synth where a block takes several slices of segments in turn
    (synth_plan's J > 1, as at the batch engine's and the stress shapes):
    the batch engine's form (8 utterances of 59 columns, the DC apart, no
    masks: 236 threads of segments, 20 more to whole warps)
    and the sequential engine's (one utterance, the masks), against the
    plain version; two launches bitwise equal."""
    _needs_cuda()
    from eaqhm_torch.ops import tracks
    from torch_track_cases import stage_errors
    for kw, mode, masks in ((dict(G=8, n=2134, K=59), dict(dc="apart"),
                             False),
                            (dict(G=1, n=2400, K=40), dict(dc="sum"), True)):
        c, t = _track_case(9, dtype, **kw)
        step, fs, L, n = c["step"], c["fs"], c["L"], kw["n"]
        plan = tracks.synth_plan(kw["G"], n, kw["K"], step, L,
                                 t["am"].element_size())
        assert plan.J > 1, plan
        if masks:
            args = (t["am"], t["fm"], t["ph"], t["a0"])
            extra = dict(acc=t["acc"], voiced=t["voiced"])
        else:
            args = tuple(torch.where(t["acc"], t[k], 0)
                         for k in ("am", "fm", "ph")) + (
                torch.where(t["voiced"], t["a0"], 0),)
            extra = {}
        got = tracks.stage(*args, step, fs, L, **extra, **mode)
        again = tracks.stage(*args, step, fs, L, **extra, **mode)
        want = tracks.stage_reference(*args, step, fs, L, **extra, **mode)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert a is None or torch.equal(a, b)
        errs, flips, _ = stage_errors(got, want, step, n, flip_hz=1e-3 * fs)
        assert flips == 0 and max(errs.values()) <= TRACK_TOL[dtype], (
            kw, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_track_srer_on_many_blocks(dtype):
    """track_srer over many chunks a group (the stress length, 470 chunks
    of 2048 samples; 33 chunks; a batch of groups with ragged lengths; a
    length under one chunk; lengths past L and of 0 and 1): bitwise equal
    across two calls and in a CUDA graph's replay, equal to the plain
    version to rounding, two device launches a call."""
    _needs_cuda()
    from eaqhm_torch.ops import tracks
    from torch_graph_nodes import captured, kernel_nodes
    rng = np.random.default_rng(5)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for G, L, lens in ((1, 962560, None), (2, 65537, [65537, 60000]),
                       (6, 40000, [40000, 39999, 2048, 2049, 50000, 1]),
                       (3, 700, [700, 0, 699])):
        det = torch.as_tensor(rng.normal(size=(G, L)), dtype=dtype,
                              device="cuda")
        s = det + 0.05 * torch.as_tensor(rng.normal(size=(G, L)),
                                         dtype=dtype, device="cuda")
        if lens is None:
            nv = L - 1234
            std = torch.std(det[0, :nv], correction=0)
            kw = dict(std_det=std, n_valid=nv)
            det, s = det[0], s[0]
        else:
            kw = dict(lens=torch.as_tensor(lens, device="cuda"))
        tracks.reset_counts()
        a = tracks.masked_srer(det, s, **kw)
        b = tracks.masked_srer(det, s, **kw)
        ref = tracks.masked_srer_reference(det, s, **kw)
        torch.cuda.synchronize()
        assert tracks.track_srer.launches == 2
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))
        live = torch.isfinite(ref)
        assert torch.equal(live, torch.isfinite(a))
        assert (a[live] - ref[live]).abs().max().item() <= tol, (G, L)
        graph, c = captured(lambda: tracks.masked_srer(det, s, **kw))
        tracks.take_captured()
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(c.view(bits), a.view(bits))
        assert kernel_nodes(graph) == tracks.srer_plan(
            s.shape[-1]).launches == 2



@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cell", ["small", "sa19", "batch", "wide48"])
def test_cuda_pitch_kernels_match_plain_version(dtype, cell):
    """swipe_loudness from the signal against its plain version on the full
    DFT bases (seeded voices with a silent stretch): Ln to 1e-12 / 1e-5 of
    its largest entry; swipe_pick on the plain version's Si equal bit for
    bit to pick_reference (every step) and to grid_reference (the f0
    grid); the whole kernel route against the plain route with the
    tolerances above, the steps that moved (f0 to another grid point, or
    the coarse pick to another candidate) counted and printed: none in
    float64 beyond near ties (strength agreeing), at most 0.1% of the
    steps; every coarse move a near tie proven on the blended strengths
    (at both argmaxes they agree to the tolerance in each route), and only
    those steps' strength not held to it.  Two launches of swipe_loudness and one of swipe_pick a call;
    swipep and f0_grid build no DFT basis."""
    _needs_cuda()
    from eaqhm_torch.models import swipe
    from eaqhm_torch.ops import pitch, stft
    from torch_pitch_cases import coarse_moves, compare_picks, voices
    fs, (lo, hi), B, L = {"small": (16000, (160.0, 300.0), 2, 9000),
                          "sa19": (16000, (160.0, 300.0), 1, 65536),
                          "batch": (16000, (70.0, 500.0), 8, 32000),
                          "wide48": (48000, (50.0, 180.0), 1, 8192)}[cell]
    name = str(dtype)[6:]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    plan = swipe.make_plan(float(fs), lo, hi, L)
    x = torch.as_tensor(voices(B, L, fs, lo, hi, 17), dtype=dtype,
                        device="cuda")
    dp = swipe.device_plan(plan, dtype, x.device)
    pitch.reset_counts()
    Si_k, Si_p = [], []
    for w, ln in zip(dp.windows, pitch.loudness(x, dp)):
        ref = pitch.loudness_reference(stft.spectrum(
            x, w.nfft, w.hop, w.window, w.pad_pre, w.pad_post), w)
        assert (ln - ref).abs().max().item() <= tol * ref.abs().max().item()
        Si_k.append(torch.matmul(ln, w.kernel.t()))
        Si_p.append(torch.matmul(ref, w.kernel.t()))
    rows = pitch.pick(Si_p, dp)
    grid = pitch.pick(Si_p, dp, grid=True)
    want = pitch.pick_reference(Si_p, dp)
    route = compare_picks(pitch.pick(Si_k, dp).cpu().numpy(),
                          want.cpu().numpy(), name, coarse_moves(
                              pitch.blend_reference(Si_k, dp),
                              pitch.blend_reference(Si_p, dp), tol))
    torch.cuda.synchronize()
    print(f"{cell} {name}: kernel route {route}; rows unequal "
          f"{int((rows != want).sum())}, grid unequal "
          f"{int((grid != pitch.grid_reference(Si_p, dp)).sum())}")
    assert torch.equal(rows, want)
    assert torch.equal(grid, pitch.grid_reference(Si_p, dp))
    assert pitch.swipe_loudness.launches == 2
    assert pitch.swipe_pick.launches == 3 and pitch.plain_calls() == 0
    assert route["t_equal"] and route["strength_rel_err"] <= tol
    assert route["coarse_ties"] == route["coarse_moved"]
    assert route["f0_moved"] <= 1e-3 * route["steps"]
    if dtype == torch.float64:
        assert route["f0_moved_strength_rel_err"] <= tol
    pitch.reset_counts()
    built = stft.bases_built
    out = swipe.swipep(plan, x)
    assert out.shape == (B, len(plan.t), 3)
    g = swipe.f0_grid(plan, x)
    assert g.shape == (B, dp.t_grid.shape[0], 3)
    assert torch.equal(g, pitch.grid_reference(
        [torch.matmul(ln, w.kernel.t())
         for w, ln in zip(dp.windows, pitch.loudness(x, dp))], dp))
    assert pitch.swipe_loudness.launches == 3 * 2
    assert pitch.swipe_pick.launches == 2 and stft.bases_built == built
