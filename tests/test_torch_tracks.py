"""Track interpolation (eaqhm_torch.models.tracks, ops.interp, ops.scan)
against the JAX package, float64 on the CPU, and the phase integration
against phase-integration calls captured from the reference."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eaqhm_torch.models import tracks as tt
from eaqhm_torch.ops import interp as ti
from eaqhm_torch.ops.scan import associative_scan
from eaqhm_tpu.models import tracks as jt
from eaqhm_tpu.ops import interp as ji

torch.set_num_threads(1)
STEP, FS = 15, 16000.0


def _close(a, b, rtol=1e-10):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _anchors(seed, n_ti=160, K=6):
    """Anchor grids whose accepted runs have lengths 1-6 (and longer).
    Runs start past slot 8, as the analysis margin guarantees in the
    engine: the synthetic anchors of short runs sit at slots 0, 1, ..."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((n_ti, K), bool)
    for k in range(K):
        i = 8 + int(rng.integers(0, 4))
        while i < n_ti:
            run = int(rng.choice([1, 2, 3, 4, 5, 6, 12]))
            acc[i:i + run, k] = True
            i += run + int(rng.integers(1, 5))
    acc[-3:] = False
    kk = np.arange(1, K + 1)
    fm = np.where(acc, 210.0 * kk + rng.normal(scale=4.0, size=acc.shape), 0)
    am = np.where(acc, rng.uniform(0.01, 0.3, size=acc.shape), 0)
    ph = np.where(acc, rng.uniform(-np.pi, np.pi, size=acc.shape), 0)
    return am, fm, ph


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolate_tracks_anchors_matches_jax(seed):
    am, fm, ph = _anchors(seed)
    length = (am.shape[0] - 1) * STEP + 1 + 37
    jr = jt.interpolate_tracks_anchors(jnp.asarray(am), jnp.asarray(fm),
                                       jnp.asarray(ph), STEP, FS, length)
    tr = tt.interpolate_tracks_anchors(torch.as_tensor(am),
                                       torch.as_tensor(fm),
                                       torch.as_tensor(ph), STEP, FS, length)
    for a, b in zip(tr, jr):
        _close(a, b)


def test_notaknot_interp_uniform_matches_jax_and_scipy():
    from scipy.interpolate import interp1d
    rng = np.random.default_rng(3)
    yv = rng.normal(size=90)
    length = 89 * STEP + 23
    jr = np.asarray(ji.notaknot_interp_uniform(jnp.asarray(yv), STEP, length))
    tr = ti.notaknot_interp_uniform(torch.as_tensor(yv), STEP, length).numpy()
    _close(tr, jr)
    ref = interp1d(np.arange(90) * STEP, yv, kind=3,
                   fill_value="extrapolate")(np.arange(length))
    _close(tr, ref, rtol=1e-8)


def test_cubic4_lerp_spline_eval_match_jax():
    rng = np.random.default_rng(4)
    x4 = np.stack([np.zeros(5), np.full(5, 40.0), np.full(5, 41.0),
                   np.full(5, 42.0)], -1) * STEP
    y4 = rng.normal(size=(5, 4))
    q = np.tile(np.arange(600.0, 630.0), (5, 1))
    _close(ti.cubic4_eval(torch.as_tensor(x4), torch.as_tensor(y4),
                          torch.as_tensor(q)),
           ji.cubic4_eval(jnp.asarray(x4), jnp.asarray(y4), jnp.asarray(q)))
    xp = np.cumsum(rng.uniform(0.5, 2.0, size=12))
    fp = rng.normal(size=(3, 12))
    xq = np.linspace(xp[0] - 1, xp[-1] + 1, 50)
    _close(ti.lerp(torch.as_tensor(xp), torch.as_tensor(fp),
                   torch.as_tensor(xq)),
           ji.lerp(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(xq)))
    M = np.asarray(ji.notaknot_M(jnp.asarray(xp), jnp.asarray(fp)))
    _close(ti.spline_eval(torch.as_tensor(xp), torch.as_tensor(fp),
                          torch.as_tensor(M), torch.as_tensor(xq)),
           ji.spline_eval(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(M),
                          jnp.asarray(xq)))


def _affine(l, r):
    return l[0] * r[0], r[0] * l[1] + r[1]


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_a_loop(n, reverse):
    """The affine composition the spline sweeps use, against the
    sequential recurrence (what jax.lax.associative_scan computes)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(-0.5, 0.5, size=(n, 3))
    b = rng.normal(size=(n, 3))
    _, v = associative_scan(_affine, (torch.as_tensor(a), torch.as_tensor(b)),
                            dim=0, reverse=reverse)
    loop = np.zeros_like(b)
    acc = np.zeros(3)
    order = range(n - 1, -1, -1) if reverse else range(n)
    for i in order:
        acc = a[i] * acc + b[i]
        loop[i] = acc
    _close(v, loop, rtol=1e-13)


@pytest.mark.parametrize("j", range(7))
def test_segment_phase_matches_captured_reference_calls(golden, j):
    """ph0-ph6 of sa19_golden.npz are phase_integr_interpolation calls of
    the reference (functions.py:537-575): anchor indices, the dense fm (in
    radians per sample) and phase tracks, and the output over the run.
    Each segment restarts at its left anchor's phase; the last sample is
    the corrected end of the last segment.  fm and ph were stored as
    float32, so the tolerance is float32 phase accuracy (a few 1e-7 rad on
    phases up to ~6e3 rad)."""
    idx = golden[f"ph{j}_idx"].astype(np.int64)
    fm = torch.as_tensor(golden[f"ph{j}_fm"].astype(np.float64))
    ph = torch.as_tensor(golden[f"ph{j}_ph"].astype(np.float64))
    out = golden[f"ph{j}_out"]
    step = int(idx[1] - idx[0])
    assert np.all(np.diff(idx) == step)
    rows = torch.as_tensor(idx[:-1])[:, None] + torch.arange(1, step + 1)
    seg = tt.segment_phase(fm[rows][..., None], ph[idx[:-1]][:, None],
                           ph[idx[1:]][:, None], step, fs=2 * np.pi)[..., 0]
    got = torch.cat([ph[idx[:-1]][:, None], seg[:, :-1]], dim=1).reshape(-1)
    got = torch.cat([got, seg[-1, -1:]]).numpy()
    assert got.shape == out.shape
    np.testing.assert_allclose(got, out, rtol=0, atol=2e-6)


@pytest.mark.parametrize("m", [4, 6, 100])
def test_notaknot_interp_matches_jax_and_interp1d(m):
    """ops.interp.notaknot_M / notaknot_interp on sorted nonuniform anchors
    (tests/test_ops.py's case), extrapolating past both ends: against the
    JAX package and scipy's interp1d(kind=3)."""
    from scipy.interpolate import interp1d
    rng = np.random.default_rng(40 + m)
    x = np.sort(rng.uniform(0, 100, size=m))
    y = rng.normal(size=(3, m))
    q = rng.uniform(x[0] - 5, x[-1] + 5, size=50)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    _close(ti.notaknot_M(xt, yt), ji.notaknot_M(jnp.asarray(x),
                                                jnp.asarray(y)))
    got = ti.notaknot_interp(xt, yt, torch.as_tensor(q))
    _close(got, ji.notaknot_interp(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(q)))
    ref = interp1d(x, y, kind=3, axis=-1, fill_value="extrapolate")(q)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)


def test_interpolate_tracks_matches_jax():
    """models.tracks.interpolate_tracks on dense [length, K] inputs with
    the anchors at rows i * step (zeros elsewhere) against the JAX
    package's."""
    am, fm, ph = _anchors(5, n_ti=80, K=4)
    n_ti = am.shape[0]
    length = (n_ti - 1) * STEP + 1 + 20
    dense = []
    for a in (am, fm, ph):
        d = np.zeros((length, a.shape[1]))
        d[np.arange(n_ti) * STEP] = a
        dense.append(d)
    jr = jt.interpolate_tracks(*[jnp.asarray(d) for d in dense], STEP, FS,
                               n_ti, length)
    tr = tt.interpolate_tracks(*[torch.as_tensor(d) for d in dense], STEP,
                               FS, n_ti, length)
    for a, b in zip(tr, jr):
        _close(a, b)
