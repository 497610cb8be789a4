"""The redesigned pitch kernels' plain forms on the CPU, float64, against the
JAX package: the compact DFT table swipe_loudness reads, the loudness from
the signal through it, the depth split of its launches, and the f0 grid
that swipe_pick writes in its epilogue."""
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eaqhm_torch.models import engine as te
from eaqhm_torch.models import swipe as tsw
from eaqhm_torch.ops import pitch
from eaqhm_torch.ops import stft as tstft
from eaqhm_tpu.models import engine as je
from eaqhm_tpu.models import swipe as jsw
from eaqhm_tpu.ops import stft as jstft
from test_torch_pitch_kernels import CASES, _case, _voice

torch.set_num_threads(1)


def _jax_ln(jplan, wp, s):
    """JAX's normalized loudness of one window size (the lines of
    pitch_strength before the kernel product), as [nf, nerb]."""
    xz = jnp.pad(jnp.asarray(s), (wp.pad_pre, wp.pad_post))
    P = jstft.specgram_psd(xz, wp.nfft, wp.hop, wp.window, jplan.fs)
    w = jnp.asarray(wp.erb_w)[:, None]
    Pe = P[wp.erb_lo, :] * (1 - w) + P[wp.erb_lo + 1, :] * w
    L = jnp.sqrt(jnp.maximum(0.0, Pe))
    norms = jnp.sqrt(jnp.sum(L * L, axis=0, keepdims=True))
    Ln = jnp.where(norms > 0, L / jnp.where(norms > 0, norms, 1.0), 0.0)
    return np.asarray(Ln).T


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compact_table_equals_jax_basis_columns(dtype):
    """The compact table of a window's needed bins holds the columns of the
    JAX package's _dft_bases bit for bit, each bin's (cos, -sin) side by
    side, and is cached by (nfft, bins, dtype, device)."""
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    plan = tsw.make_plan(16000.0, 70.0, 500.0, 8192)
    for wp in plan.windows:
        bins = np.union1d(wp.erb_lo, wp.erb_lo + 1)
        got = tstft.dft_columns(wp.nfft, bins, tdtype, "cpu")
        cosb, sinb = jstft._dft_bases(wp.nfft, np.dtype(dtype))
        assert got.dtype == tdtype and got.shape == (wp.nfft, len(bins), 2)
        np.testing.assert_array_equal(got[..., 0].numpy(), cosb[:, bins])
        np.testing.assert_array_equal(got[..., 1].numpy(), sinb[:, bins])
        assert tstft.dft_columns(wp.nfft, bins.copy(), tdtype, "cpu") is got
        assert len(bins) <= wp.nfft // 2 + 1
    wide = plan.windows[0]                  # 2048: a fraction of the bins
    assert len(np.union1d(wide.erb_lo, wide.erb_lo + 1)) < wide.nfft // 4


@pytest.mark.parametrize("name", CASES)
def test_loudness_from_the_signal_matches_jax(name):
    """The loudness's plain form through the compact table (signal -> Ln)
    equals the plain version on the full DFT bases to 1e-12 of its largest
    entry and JAX's pitch_strength Ln to the same, per window size, on one
    utterance and on a batch of three."""
    fs, (lo, hi), s = _case(name)
    L = len(s)
    xs = np.stack([s, _voice(L, fs, 150.0, 11), np.zeros(L)])
    jplan = jsw.make_plan(float(fs), lo, hi, L)
    tplan = tsw.make_plan(float(fs), lo, hi, L)
    dp = tsw.device_plan(tplan, torch.float64, "cpu")
    x = torch.as_tensor(xs)
    for w, jwp in zip(dp.windows, jplan.windows):
        got = pitch.loudness_table_reference(x, w)
        ref = pitch.loudness_reference(tstft.spectrum(
            x, w.nfft, w.hop, w.window, w.pad_pre, w.pad_post), w)
        assert got.shape == ref.shape == (3, w.nf, w.erb_lo.shape[0])
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-12 * scale
        assert torch.equal(got[2], torch.zeros_like(got[2]))
        want = _jax_ln(jplan, jwp, s)
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                                   atol=1e-12 * scale)


def test_loudness_splits_fill_the_card():
    """The depth is split only where a window's tiles are few against the
    card's SMs (132 on the H100 SXM; 40 and 200 for other cards), by powers
    of two, each slice at least 128 samples and a multiple of the kernel's
    32-sample stage, at most MAX_SPLITS."""
    cells = ((8128, 242, 512), (3768, 245, 512), (943, 478, 2048),
             (130, 362, 1024), (258, 242, 512), (4, 722, 8192),
             (10, 496, 2048))     # Corpus-64, stress x 3, SA19 x 2, 48 kHz x 2
    for sms, want in ((132, (1, 1, 1, 8, 4, 8, 8)),
                      (40, (1, 1, 1, 4, 4, 4, 8)),
                      (200, (1, 1, 4, 8, 4, 8, 8))):
        assert tuple(pitch.loudness_splits(*c, sms) for c in cells) == want
        for M, nu, nfft in ((1, 2, 32), (4, 722, 8192), (64, 100, 512)):
            ks = pitch.loudness_splits(M, nu, nfft, sms)
            assert ks & (ks - 1) == 0 and nfft % (32 * ks) == 0
            assert ks == 1 or nfft // ks >= 128
            assert ks <= pitch.MAX_SPLITS


@pytest.mark.parametrize("name", ("other", "male_22k"))
def test_f0_grid_plain_version_matches_jax(name):
    """The fused grid's plain version (grid_reference: the plan's resample
    tables) equals resample_f0_grid of pick_reference bit for bit; f0_grid
    on the CPU equals resample_f0_grid of swipep bit for bit, for one
    utterance and a batch; both equal JAX's swipep + resample_f0_grid to
    the fixtures' tolerance.  The plan's tables are resample_f0_grid's own
    on the steps' times."""
    fs, (lo, hi), s = _case(name)
    L = len(s)
    xs = np.stack([s, _voice(L, fs, 0.5 * (lo + hi), 12)])
    tplan = tsw.make_plan(float(fs), lo, hi, L)
    jplan = jsw.make_plan(float(fs), lo, hi, L)
    x = torch.as_tensor(xs)
    dp = tsw.device_plan(tplan, torch.float64, "cpu")
    step = int(round(fs * 5 / 1000))
    tq = np.arange(0, L - 1, step) / fs
    np.testing.assert_array_equal(dp.t_grid.numpy(), tq)
    tabs = pitch.resample_tables(dp.t, dp.t_grid)
    for a, b in zip(tabs, dp.grid):
        assert torch.equal(a, b)
    Si = [torch.matmul(pitch.loudness_table_reference(x, w), w.kernel.t())
          for w in dp.windows]
    want = te.resample_f0_grid(pitch.pick_reference(Si, dp), dp.t_grid)
    got = pitch.grid_reference(Si, dp)
    assert got.shape == (2, len(tq), 3)
    assert torch.equal(got, want)
    pitch.reset_counts()
    grid = tsw.f0_grid(tplan, x)
    assert pitch.pick.plain_calls == 1
    assert torch.equal(grid, te.resample_f0_grid(tsw.swipep(tplan, x),
                                                 dp.t_grid))
    assert torch.equal(tsw.f0_grid(tplan, x[1]), grid[1])
    for b in range(2):
        jg = je.resample_f0_grid(jsw.swipep(jplan, jnp.asarray(xs[b])),
                                 jnp.asarray(tq))
        np.testing.assert_allclose(grid[b].numpy(), np.asarray(jg),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(jg),
                                   rtol=1e-9, atol=1e-12)


def test_pick_comparison_exempts_only_proven_ties():
    """compare_picks leaves out of the strength check only the steps whose
    coarse argmax moved at a near tie proven on both routes' blended
    strengths; a coarse move without a tie stays held (GPU test and the
    smoke's pitch phase use it)."""
    from torch_pitch_cases import coarse_moves, compare_picks
    rng = np.random.default_rng(0)
    Sk = rng.uniform(size=(2, 50, 20)).astype(np.float32)
    Sk[0, 3] = 0.1
    Sk[0, 3, 5], Sk[0, 3, 6] = 0.9, np.float32(0.9) + np.float32(1e-7)
    Sp = Sk.copy()
    Sp[0, 3, 6] = np.float32(0.9) - np.float32(1e-7)  # a near tie flips
    Sk[1, 7] = 0.1
    Sk[1, 7, 2] = 0.95
    Sp[1, 7] = Sk[1, 7]
    Sp[1, 7, 2], Sp[1, 7, 9] = 0.5, 0.96              # a real move
    for S_got, S_want in ((Sk, Sp), (torch.as_tensor(Sk),
                                     torch.as_tensor(Sp))):
        moved, tie, gap = coarse_moves(S_got, S_want, 1e-5)
        assert np.argwhere(moved).tolist() == [[0, 3], [1, 7]]
        assert np.argwhere(tie).tolist() == [[0, 3]]
        assert gap > 0.4
    got = np.zeros((2, 50, 3))
    got[..., 1], got[..., 2] = 100.0, 1.0
    want = got.copy()
    want[0, 3, 2] = 0.9
    r = compare_picks(got, want, "float32", coarse_moves(Sk, Sp, 1e-5))
    assert r["coarse_moved"] == 2 and r["coarse_ties"] == 1
    assert r["strength_rel_err"] == 0.0 and r["f0_moved"] == 2
    assert abs(r["tie_strength_rel_err"] - 0.1) < 1e-12
    want[1, 7, 2] = 0.8
    r = compare_picks(got, want, "float32", coarse_moves(Sk, Sp, 1e-5))
    assert abs(r["strength_rel_err"] - 0.2) < 1e-12


def test_cache_builds_one_key_without_holding_the_others():
    """ops.stft's caches build a key outside the cache-wide lock: while one
    key's build runs, another key is built and served; a key asked for by
    several threads is built once."""
    import threading
    started, release = threading.Event(), threading.Event()
    cache, made = OrderedDict(), []

    def slow():
        started.set()
        assert release.wait(10)
        made.append("a")
        return "A"

    def fast():
        made.append("b")
        return "B"

    out = {}
    ta = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, tstft._cached(cache, ("a",), 4, slow))) for i in range(3)]
    ta[0].start()
    assert started.wait(10)
    for t in ta[1:]:
        t.start()
    assert tstft._cached(cache, ("b",), 4, fast) == ("B", True)
    release.set()
    for t in ta:
        t.join(10)
    assert made == ["b", "a"]
    assert sorted(out.values()) == [("A", False), ("A", False), ("A", True)]
    assert tstft._cached(cache, ("b",), 4, fast) == ("B", False)
