"""The fit (eaqhm_torch.ops.fit) on the CPU: its plain version against the
JAX package's iqhm_gram / eaqhm_gram, float64, inputs from a numpy seed;
the table fits (the engines' entry points: frames read from the signal and
track tables by utterance and centre, the dead-track overlay applied in
the fit) against JAX's gathers (``s[rows]``, ``dead_overlay_windows``)
followed by its fits; the entry points' routes (the plain fit on CPU
tensors, counted; the kernel wrappers refuse anything but CUDA tensors);
fit_gram's plan; the launch arguments against the kernel library's
argtypes.  Tolerance 1e-12 of the largest entry of R, rhs and dinv: the
same arithmetic, summed in another order (R's entries are sums of N
products of entries of size <= 1; dinv and rhs scale them)."""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eaqhm_torch.kernels import build
from eaqhm_torch.ops import fit
from eaqhm_tpu.models import engine as je
from eaqhm_tpu.ops import solver as js

torch.set_num_threads(1)
FS = 16000.0
TOL = 1e-12
# B frames, W half-width, Kc harmonics: 2Kc+1 = 15 and M = 30 are no
# multiple of any tile of the kernels (16-entry pieces, 32 x 32 tiles,
# 16 or 8 rows a stage)
B, W, KC = 7, 27, 7
# fit_gram's executed work over the least may not pass this at the main
# paths' orders (SA19, corpus, presets, stress and wide tiers)
MAIN_PATH_KC = (24, 31, 32, 40, 47, 48, 59, 64, 96, 128, 192, 323, 487)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _inputs(seed):
    """One batch of both fits' inputs: wl < W on all frames but the first,
    zero gaps inside the window and runs of zeros up to its left and right
    edges, a dead frame (every track zero, every harmonic masked), masked
    harmonics, fm at exact halves (round half to even), K < Kc."""
    rng = np.random.default_rng(seed)
    N = 2 * W + 1
    o = np.arange(-W, W + 1)
    wl = rng.integers(W // 2, W, size=B)
    wl[0] = W
    s_win = rng.normal(size=(B, N))
    f0 = rng.uniform(100.0, 300.0, size=B)
    K = rng.integers(2, KC + 1, size=B)
    k = np.arange(1, KC + 1)
    fm = (f0[:, None, None] * k[None, None, :]
          + rng.normal(scale=3.0, size=(B, N, KC)))
    fm[0, :, 0] = np.round(fm[0, :, 0]) + 0.5
    fm[2, ::3, 1] = np.round(fm[2, ::3, 1]) - 0.5
    am = rng.uniform(0.01, 0.5, size=(B, N, KC))
    gaps = rng.random(size=(B, N, KC)) < 0.2
    gaps[:, W // 3:W - 2, 2] = True            # a run inside the window
    gaps[:, :W - 3, 3] = True                  # zeros to the left edge
    gaps[:, W + 4:, 4] = True                  # zeros to the right edge
    gaps[:, W, :2] = False
    gaps[B - 1] = True                         # the dead frame
    fm[gaps] = 0.0
    am[gaps] = 0.0
    colmask = fm[:, W, :] != 0
    colmask[1, -3:] = False
    return dict(s_win=s_win, o=o, wl=wl, f0=f0, K=K, fm=fm, am=am,
                colmask=colmask)


# two utterances of L samples in one table; the tables hold KCS >= KC
# track columns, of which the fit reads the first KC through the stride
L_UTT, KCS = 83, KC + 3


def _tables(seed):
    """Both fits' inputs as tables: s [2, L], fm, am [2, L, KCS], dead
    centres [2, L]; per frame its utterance, centre (windows clamped at both
    ends of an utterance), dead flag, wl, f0, K and harmonic mask.  Dead
    centres lie left of a frame's centre, right of it and at it (with the
    frame dead and not); zero gaps in the tracks, a run to a window's
    edge."""
    rng = np.random.default_rng(seed)
    utt = np.array([0, 0, 0, 1, 1, 1, 1])
    ctr = np.array([3, 40, L_UTT - 5, 0, 30, 52, L_UTT - 1])
    dd = np.array([False, True, False, True, False, False, True])
    wl = rng.integers(W // 2, W + 1, size=B)
    wl[1] = W
    s = rng.normal(size=(2, L_UTT))
    f0 = rng.uniform(100.0, 300.0, size=B)
    K = rng.integers(2, KC + 1, size=B)
    t = np.arange(L_UTT)
    f0_t = 150.0 + 40.0 * np.sin(2 * np.pi * t / 70.0)
    k = np.arange(1, KCS + 1)
    fm = (f0_t[None, :, None] * k[None, None, :]
          + rng.normal(scale=3.0, size=(2, L_UTT, KCS)))
    fm[0, ::4, 0] = np.round(fm[0, ::4, 0]) + 0.5
    am = rng.uniform(0.01, 0.5, size=(2, L_UTT, KCS))
    gaps = rng.random(size=(2, L_UTT, KCS)) < 0.2
    gaps[0, 20:38, 2] = True                   # a run into frame 1's centre
    gaps[1, 31:, 3] = True                     # to the utterance's end
    gaps[:, :, 0] |= rng.random(size=(2, L_UTT)) < 0.3
    fm[gaps] = 0.0
    am[gaps] = 0.0
    dead = np.zeros((2, L_UTT), dtype=bool)
    dead[0, [34, 40, 47, 2]] = True            # left of, at, right of 40
    dead[1, [0, 25, 30, 36, 50, L_UTT - 1]] = True
    colmask = fm[utt, ctr, :KC] != 0
    colmask[:, 0] = True
    colmask[4, -2:] = False
    return dict(s=s, fm=fm, am=am, dead=dead, utt=utt, ctr=ctr, dd=dd,
                wl=wl, f0=f0, K=K, colmask=colmask)


def _jax_rows(d):
    o = np.arange(-W, W + 1)
    return d["utt"][:, None] * L_UTT + np.clip(d["ctr"][:, None] + o, 0,
                                               L_UTT - 1), o


def test_iqhm_gram_plain_matches_jax():
    d = _inputs(1)
    args = (d["s_win"], d["o"], d["wl"], d["f0"], d["K"])
    want = js.iqhm_gram(*map(jnp.asarray, args), FS, KC)
    got = fit.iqhm_gram_reference(*map(_t, args), FS, KC)
    for a, b in zip(got, want):
        _close(a, b)


def test_eaqhm_gram_plain_matches_jax():
    d = _inputs(2)
    args = (d["s_win"], d["fm"], d["am"], d["o"], d["wl"], d["colmask"])
    want = js.eaqhm_gram(*map(jnp.asarray, args), FS)
    got = fit.eaqhm_gram_reference(*map(_t, args), FS)
    for a, b in zip(got, want):
        _close(a, b)


def test_iqhm_table_fit_matches_jax_gather():
    """The stationary table fit's plain version equals JAX's s[rows] then
    iqhm_gram: two utterances in one table, windows clamped at both ends."""
    d = _tables(7)
    rows, o = _jax_rows(d)
    s_flat = d["s"].reshape(-1)
    want = js.iqhm_gram(jnp.asarray(s_flat[rows]), jnp.asarray(o),
                        jnp.asarray(d["wl"]), jnp.asarray(d["f0"]),
                        jnp.asarray(d["K"]), FS, KC)
    got = fit.iqhm_gram_tables(_t(d["s"]), _t(d["utt"]), _t(d["ctr"]), W,
                               _t(d["wl"]), _t(d["f0"]), _t(d["K"]), FS, KC)
    for a, b in zip(got, want):
        _close(a, b)


def test_eaqhm_table_fit_matches_jax_gather():
    """The non-stationary table fit's plain version (the tables read
    through their stride, the overlay, the repair) equals JAX's
    dead_overlay_windows then eaqhm_gram on the flattened tables: dead
    centres on both sides of a centre and at it, frames dead and not,
    windows clamped at both ends, Kc = 7 of 10 table columns."""
    d = _tables(8)
    rows, o = _jax_rows(d)
    flat = {k: d[k].reshape(2 * L_UTT, -1)[:, :KC] for k in ("fm", "am")}
    fm_win, am_win = je.dead_overlay_windows(
        jnp.asarray(flat["fm"]), jnp.asarray(flat["am"]), jnp.asarray(rows),
        jnp.asarray(d["dead"].reshape(-1)), jnp.asarray(d["dd"]),
        jnp.asarray(o), KC)
    want = js.eaqhm_gram(jnp.asarray(d["s"].reshape(-1)[rows]), fm_win,
                         am_win, jnp.asarray(o), jnp.asarray(d["wl"]),
                         jnp.asarray(d["colmask"]), FS)
    got = fit.eaqhm_gram_tables(
        _t(d["s"]), _t(d["fm"]), _t(d["am"]), _t(d["dead"]), _t(d["utt"]),
        _t(d["ctr"]), _t(d["dd"]), W, _t(d["wl"]), _t(d["colmask"]), FS)
    for a, b in zip(got, want):
        _close(a, b)


def test_one_utterance_tables_and_window_tables():
    """A table of one utterance ([L], [L, KCS], [L]) reads as utterance 0;
    windows read as tables of one frame each (what iqhm_gram / eaqhm_gram
    hand the kernels on the card) give the windows back."""
    d = _tables(9)
    sel = d["utt"] == 1
    one = fit.gather_windows(
        _t(d["s"][1]), _t(np.zeros(sel.sum(), dtype=np.int64)),
        _t(d["ctr"][sel]), W, _t(d["fm"][1]), _t(d["am"][1]),
        _t(d["dead"][1]), _t(d["dd"][sel]), KC)
    two = fit.gather_windows(
        _t(d["s"]), _t(d["utt"][sel]), _t(d["ctr"][sel]), W, _t(d["fm"]),
        _t(d["am"]), _t(d["dead"]), _t(d["dd"][sel]), KC)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    s_win, fm_win, am_win = two
    utt, ctr, w = fit._as_tables(s_win)
    dead = torch.zeros(s_win.shape, dtype=torch.bool)
    again = fit.gather_windows(s_win, utt, ctr, w, fm_win, am_win, dead,
                               dead[:, 0], KC)
    for a, b in zip(again, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["iqhm", "eaqhm", "iqhm_tables",
                                  "eaqhm_tables"])
def test_cpu_tensors_take_the_plain_version(mode):
    """On CPU tensors an entry point is the plain fit, bit for bit; the fit
    is counted as served by the plain version and nothing is launched."""
    fit.reset_counts()
    if mode in ("iqhm", "eaqhm"):
        d = {k: _t(v) for k, v in _inputs(4).items()}
        win = d
    else:
        d = {k: _t(v) for k, v in _tables(4).items()}
        win = dict(zip(("s_win", "fm", "am"), fit.gather_windows(
            d["s"], d["utt"], d["ctr"], W, d["fm"], d["am"], d["dead"],
            d["dd"], KC)))
        win["o"] = torch.arange(-W, W + 1)
    if mode.startswith("iqhm"):
        plain = (win["s_win"], win["o"], d["wl"], d["f0"], d["K"], FS, KC)
        want = fit.iqhm_gram_reference(*plain)
        entry = fit.iqhm_gram if mode == "iqhm" else fit.iqhm_gram_tables
        args = plain if mode == "iqhm" else (
            d["s"], d["utt"], d["ctr"], W, d["wl"], d["f0"], d["K"], FS, KC)
    else:
        plain = (win["s_win"], win["fm"], win["am"], win["o"], d["wl"],
                 d["colmask"], FS)
        want = fit.eaqhm_gram_reference(*plain)
        entry = fit.eaqhm_gram if mode == "eaqhm" else fit.eaqhm_gram_tables
        args = plain if mode == "eaqhm" else (
            d["s"], d["fm"], d["am"], d["dead"], d["utt"], d["ctr"], d["dd"],
            W, d["wl"], d["colmask"], FS)
    got = entry(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert entry.plain_calls == 1 and fit.plain_fits() == 1
    assert fit.fit_basis.launches == fit.fit_gram.launches == 0
    fit.reset_counts()
    assert entry.plain_calls == 0 and fit.plain_fits() == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrappers_take_cuda_tensors_only(device):
    """fit_basis and fit_gram have no plain route of their own: a tensor
    off CUDA is refused, and nothing is counted."""
    d = {k: _t(v).to(device) for k, v in _tables(5).items()}
    fit.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.fit_basis("iqhm", d["s"], d["utt"], d["ctr"], W, d["wl"],
                      torch.float64, f0=d["f0"], K=d["K"], Kc=KC, fs=FS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.fit_basis("eaqhm", d["s"], d["utt"], d["ctr"], W, d["wl"],
                      torch.float32, fm=d["fm"], am=d["am"], dead=d["dead"],
                      dd=d["dd"], colmask_k=d["colmask"], fs=FS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.fit_gram(torch.zeros((1, 3, 5), dtype=torch.complex64,
                                 device=device),
                     torch.zeros((1, 10, 10), dtype=torch.complex64,
                                 device=device),
                     torch.ones(1, 10, device=device),
                     torch.ones(1, 5, dtype=torch.uint8, device=device))
    assert fit.fit_basis.launches == fit.fit_gram.launches == 0
    assert fit.plain_fits() == 0


def test_cuda_request_without_a_card_raises():
    """An entry point given tensors neither on the CPU nor on CUDA raises,
    and the launch path without the CUDA toolkit raises instead of falling
    back."""
    d = {k: _t(v).to("meta") for k, v in _inputs(5).items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.eaqhm_gram(d["s_win"], d["fm"], d["am"], d["o"], d["wl"],
                       d["colmask"], FS)
    t = {k: _t(v).to("meta") for k, v in _tables(5).items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.eaqhm_gram_tables(t["s"], t["fm"], t["am"], t["dead"], t["utt"],
                              t["ctr"], t["dd"], W, t["wl"], t["colmask"],
                              FS)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the library builds here")
    with pytest.raises(RuntimeError):
        fit.library("cuda")


def test_gram_plan():
    """fit_gram's plan: its tiles hold every live 16 x 16 piece of the
    Grams' upper triangles (columns but the DC) once, each launched tile
    holds one, and the executed work over the least stays within 1.35 at
    the main paths' orders (1.17-3.41 before the redesign)."""
    for Kc in (1, 7, 24, 59, 96, 323):
        n = 2 * Kc
        ntiles, live, slots = fit.gram_plan(Kc)
        pieces = set()
        for J in range(-(-n // fit.TILE_C)):
            for I in range(-(-n // fit.TILE_R)):
                mine = [(I * fit.TILE_R + a, J * fit.TILE_C + c)
                        for a in range(0, fit.TILE_R, fit.PIECE)
                        for c in range(0, fit.TILE_C, fit.PIECE)]
                mine = [(r, c) for r, c in mine
                        if r < n and c < n and c + fit.PIECE - 1 >= r]
                pieces.update(mine)
                assert bool(mine) == (I < min(-(-n // fit.TILE_R), (
                    J * fit.TILE_C + fit.TILE_C - 1) // fit.TILE_R + 1))
        assert live == len(pieces), Kc
        assert slots == ntiles * (fit.TILE_R // fit.PIECE) * (
            fit.TILE_C // fit.PIECE), Kc
    ratios = {Kc: fit.gram_work_ratio(Kc) for Kc in MAIN_PATH_KC}
    assert max(ratios.values()) <= 1.35, ratios
    assert min(ratios.values()) >= 1.0, ratios


_CT = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_longlong: int,
       ctypes.c_double: float}


@pytest.mark.parametrize("mode,dtype", [("iqhm", torch.float32),
                                        ("iqhm", torch.float64),
                                        ("eaqhm", torch.float32),
                                        ("eaqhm", torch.float64)])
def test_launch_arguments_match_the_library(mode, dtype):
    """kernels.build registers fit.cu; every argument the wrappers pass
    (the stream last) has the Python type of its argtype, in number and
    order; the tables are passed as they lie (a strided track table is not
    copied)."""
    src, syms = build.KERNELS["fit"]
    assert src == "fit.cu"
    d = {k: _t(v) for k, v in _tables(6).items()}
    d["fm"] = d["fm"].to(dtype)
    d["am"] = d["am"].to(dtype)
    out, sym, args, keep = fit.basis_call(
        mode, d["s"], d["utt"], d["ctr"], W, d["wl"], dtype, fs=FS, Kc=KC,
        f0=d["f0"], K=d["K"], fm=d["fm"], am=d["am"], dead=d["dead"],
        dd=d["dd"], colmask_k=d["colmask"])
    A, R, rhs, dinv, mask = out
    assert A.dtype == R.dtype == fit.complex_dtype(dtype)
    assert dinv.dtype == dtype and tuple(R.shape) == (B, 4 * KC + 2,
                                                      4 * KC + 2)
    if mode == "eaqhm":
        assert keep[1].data_ptr() == d["fm"].data_ptr()
        assert args[-5:-3] == (L_UTT * KCS, KCS)
    calls = [(sym, args), fit.gram_call(A, R, dinv, mask)[1:3]]
    for sym, args in calls:
        argtypes = syms[sym]
        assert len(argtypes) == len(args) + 1, sym
        assert argtypes[-1] is ctypes.c_void_p          # the stream
        for a, t in zip(args, argtypes):
            assert type(a) is _CT[t], (sym, a, t)
    assert syms["fit_gram_plan"] == [ctypes.c_int, ctypes.c_void_p]
    assert syms["fit_occupancy"] == [ctypes.c_int, ctypes.c_int]
