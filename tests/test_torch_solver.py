"""Batched LS fits (eaqhm_torch.ops.solver) against the JAX package, float64
on the CPU, inputs from a numpy seed.  Tolerance 1e-10 relative: the same
arithmetic, summed in another order."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eaqhm_torch.ops import chol
from eaqhm_torch.ops import solver as ts
from eaqhm_tpu.ops import solver as js

torch.set_num_threads(1)
REF = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_parity_ref.npz")
B, KC, W, FS = 8, 12, 60, 16000.0
RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _frames(seed):
    rng = np.random.default_rng(seed)
    o = np.arange(-W, W + 1)
    wl = rng.integers(20, W + 1, size=B)
    s_win = rng.normal(size=(B, 2 * W + 1))
    return rng, o, wl, s_win


def _tracks(rng, zero_frac=0.15):
    """fm/am windows with zero gaps (so repair_tracks interpolates)."""
    N = 2 * W + 1
    k = np.arange(1, KC + 1)
    fm = (rng.uniform(150, 250, size=(B, 1, 1)) * k[None, None, :]
          + rng.normal(scale=3.0, size=(B, N, KC)))
    am = rng.uniform(0.01, 0.5, size=(B, N, KC))
    gaps = rng.random(size=(B, N, KC)) < zero_frac
    gaps[:, W, :3] = False                 # centers of the first harmonics
    fm[gaps] = 0.0
    am[gaps] = 0.0
    colmask = fm[:, W, :] != 0
    colmask[:, -2:] = False
    return fm, am, colmask


def test_windows_match_numpy():
    o = torch.arange(-40, 41, dtype=torch.float64)
    np.testing.assert_allclose(ts.blackman_window(o, 40.0).numpy(),
                               np.blackman(81), atol=1e-15)
    np.testing.assert_allclose(ts.hamming_window(o, 40.0).numpy(),
                               np.hamming(81), atol=1e-15)


def test_build_gram_split_matches_jax():
    rng, o, wl, s_win = _frames(0)
    Kc2 = 2 * KC + 1
    E1 = (rng.normal(size=(B, 2 * W + 1, Kc2))
          + 1j * rng.normal(size=(B, 2 * W + 1, Kc2)))
    w = rng.uniform(0.0, 1.0, size=(B, 2 * W + 1))
    cm = rng.random(size=(B, Kc2)) < 0.8
    E1 = E1 * cm[:, None, :]
    jr = js.build_gram_split(jnp.asarray(E1), jnp.asarray(w), jnp.asarray(o),
                             jnp.asarray(s_win), jnp.asarray(cm))
    tr = ts.build_gram_split(_t(E1), _t(w), _t(o), _t(s_win), _t(cm))
    for a, b in zip(tr, jr):
        _close(a, b)


def test_iqhm_gram_matches_jax():
    rng, o, wl, s_win = _frames(1)
    f0 = rng.uniform(100, 300, size=B)
    K = rng.integers(3, KC + 1, size=B)
    jr = js.iqhm_gram(jnp.asarray(s_win), jnp.asarray(o), jnp.asarray(wl),
                      jnp.asarray(f0), jnp.asarray(K), FS, KC)
    tr = ts.iqhm_gram(_t(s_win), _t(o), _t(wl), _t(f0), _t(K), FS, KC)
    for a, b in zip(tr, jr):
        _close(a, b)


def test_repair_tracks_matches_jax():
    rng, o, wl, _ = _frames(2)
    fm, am, _ = _tracks(rng, zero_frac=0.4)
    fm[0, :, 0] = 0.0                      # a column with no nonzero at all
    fm[1, :W, 1] = 0.0                     # only next / only previous
    fm[1, W + 1:, 2] = 0.0
    jr = js.repair_tracks(jnp.asarray(fm), jnp.asarray(am), jnp.asarray(o),
                          jnp.asarray(wl))
    tr = ts.repair_tracks(_t(fm), _t(am), _t(o), _t(wl))
    for a, b in zip(tr, jr):
        _close(a, b)


def test_eaqhm_gram_matches_jax():
    rng, o, wl, s_win = _frames(3)
    fm, am, cm = _tracks(rng)
    jr = js.eaqhm_gram(jnp.asarray(s_win), jnp.asarray(fm), jnp.asarray(am),
                       jnp.asarray(o), jnp.asarray(wl), jnp.asarray(cm), FS)
    tr = ts.eaqhm_gram(_t(s_win), _t(fm), _t(am), _t(o), _t(wl), _t(cm), FS)
    for a, b in zip(tr, jr):
        _close(a, b)


def _hpd(seed, M=2 * (2 * KC + 1)):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = R / (d[:, :, None] * d[:, None, :])
    b = rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))
    return R, b


def test_solve_gram_cholesky_f64_matches_jax():
    R, b = _hpd(4)
    xj = js.solve_gram(jnp.asarray(R), jnp.asarray(b), jnp.float64,
                       method="cholesky")
    xt = ts.solve_gram(_t(R), _t(b), torch.float64)      # auto = cholesky
    _close(xt, xj)


def test_solve_gram_pallas_refines_in_float64():
    """JAX's float64 "pallas" (solver.py:302-315): complex64 Pallas solves
    (interpret mode, recorded in tests/golden/torch_parity_ref.npz by
    tools/make_torch_parity_ref.py) with the refinement residual in
    complex128.  Both sides are a complex64 factor plus one complex128
    refinement, each within ~(cond(R) * eps32)^2 ~ 3e-13 of the exact
    solution here (cond 9.4); measured apart by 9.8e-14 relative, held to
    1e-12."""
    ref = np.load(REF)
    R, b = ref["pallas_f64/4x37/R"], ref["pallas_f64/4x37/b"]
    rng = np.random.default_rng(37)              # the recorded inputs
    A = rng.normal(size=(4, 37, 37)) + 1j * rng.normal(size=(4, 37, 37))
    R_in = A @ np.conj(np.swapaxes(A, -1, -2)) / 37 + np.eye(37)
    d = np.sqrt(np.real(np.einsum("bii->bi", R_in)))
    np.testing.assert_array_equal(R, R_in / (d[:, :, None] * d[:, None, :]))
    np.testing.assert_array_equal(
        b, rng.normal(size=(4, 37)) + 1j * rng.normal(size=(4, 37)))
    x = ts.solve_gram(_t(R), _t(b), torch.float64, method="pallas").numpy()
    _close(x, ref["pallas_f64/4x37/x"], rtol=1e-12)
    # and not a complex128 solve: the complex64 factor leaves a trace far
    # above float64 rounding
    assert np.abs(x - np.linalg.solve(R, b[..., None])[..., 0]).max() > 1e-15


@pytest.mark.parametrize("non_pd", [False, True])
def test_solve_gram_float32_cholesky_takes_the_ridged_rerun(non_pd):
    """Counted on the plain path: a healthy batch is one solve; a batch with
    a non-PD system is one solve plus the ridged rerun (one more
    factorization and one substitution with its kept factor)."""
    R, b = _hpd(6)
    if non_pd:
        lam = np.linalg.eigvalsh(R[3]).min()
        R[3] = R[3] - (lam + 3e-6) * np.eye(R.shape[-1])
    chol.reset_counts()
    x = ts.solve_gram(_t(R.astype(np.complex64)), _t(b.astype(np.complex64)),
                      torch.float32, method="cholesky")
    assert torch.isfinite(torch.view_as_real(x)).all()
    assert chol.chol_solve.plain_calls == (2 if non_pd else 1)
    assert chol.chol_subst.plain_calls == (1 if non_pd else 0)
    assert chol.chol_solve.launches == chol.chol_subst.launches == 0


def test_solve_gram_float32_pallas_factors_once():
    R, b = _hpd(7)
    chol.reset_counts()
    x = ts.solve_gram(_t(R.astype(np.complex64)), _t(b.astype(np.complex64)),
                      torch.float32, method="pallas").numpy()
    assert (chol.chol_solve.plain_calls, chol.chol_subst.plain_calls) == (1, 1)
    xe = np.linalg.solve(R, b[..., None])[..., 0]
    assert np.abs(x - xe).max() / np.abs(xe).max() < 1e-5


def test_solve_gram_float32_cholesky_ridge_matches_jax():
    """A non-PD system makes the float32 'cholesky' branch rerun the batch
    ridged (solver.py:363-390); both packages take the same path."""
    R, b = _hpd(6)
    # system 3 gets smallest eigenvalue -3e-6: its plain factorization
    # fails, the 1e-5 ridge makes it positive definite again
    lam = np.linalg.eigvalsh(R[3]).min()
    R[3] = R[3] - (lam + 3e-6) * np.eye(R.shape[-1])
    R32, b32 = R.astype(np.complex64), b.astype(np.complex64)
    L, info = torch.linalg.cholesky_ex(_t(R32))
    assert info[3] != 0
    xj = np.asarray(js.solve_gram(jnp.asarray(R32), jnp.asarray(b32),
                                  jnp.float32, method="cholesky"))
    xt = ts.solve_gram(_t(R32), _t(b32), torch.float32,
                       method="cholesky").numpy()
    assert np.isfinite(xt).all() and np.isfinite(xj).all()
    # the healthy systems: the ridged solve plus one refinement lands on
    # the same solution in both packages to float32 accuracy
    ok = [0, 1, 2, 4, 5, 6, 7]
    np.testing.assert_allclose(xt[ok], xj[ok], rtol=1e-4, atol=2e-5)
    x64 = np.linalg.solve(R[ok], b[ok][..., None])[..., 0]
    assert np.abs(xt[ok] - x64).max() / np.abs(x64).max() < 1e-4


@pytest.mark.parametrize("rdtype", ["float64", "float32"])
def test_auto_resolves_as_jax(rdtype):
    """solve_method "auto": float64 -> "cholesky", float32 ->
    "block_inverse", in both packages."""
    assert ts.default_solve_method(getattr(torch, rdtype)) == \
        js.default_solve_method(getattr(jnp, rdtype))


# JAX's block inverse and solve on seeded HPD batches are recorded in
# tests/golden/torch_parity_ref.npz (tools/make_torch_parity_ref.py
# --cases block_inverse).  float64: the same arithmetic in another order
# (1e-10 relative); float32: rounding of a recursion over cond(R) ~ 10
# systems (1e-4 relative).
_BI_TOL = {"float64": 1e-10, "float32": 1e-4}
_BI_CASES = [(dt, m) for dt in ("float64", "float32") for m in (16, 37, 64)]


@pytest.mark.parametrize("dtype,M", _BI_CASES)
def test_block_inverse_matches_jax(dtype, M):
    ref = np.load(REF)
    p = f"block_inverse/{dtype}/4x{M}/"
    R, b = _t(ref[p + "R"]), _t(ref[p + "b"])
    _close(ts.gj_inverse(R), ref[p + "gj"], rtol=_BI_TOL[dtype])
    _close(ts.hpd_block_inverse(R), ref[p + "inv"], rtol=_BI_TOL[dtype])
    chol.reset_counts()
    x = ts.solve_gram(R, b, getattr(torch, dtype), method="block_inverse")
    _close(x, ref[p + "x"], rtol=_BI_TOL[dtype])
    assert chol.chol_solve.plain_calls == 0        # healthy: no rerun


@pytest.mark.parametrize("case", ["nonpd", "zero_pivot"])
def test_block_inverse_float32_ridge_matches_jax(case):
    """The non-PD float32 batch of the cholesky tests above (system 3 at
    smallest eigenvalue -3e-6).  Its block inverse stays finite in both
    packages, so JAX keeps it; system 3's refinement leaves a residual 1e2
    times its right-hand side, so the port's residual gate reruns the batch
    ridged (R + 1e-5 I is positive definite there).  With a zero pivot the
    inverse is not finite and both packages rerun.  The rerun is one more
    factorization and one substitution; the healthy systems agree with
    JAX to float32 accuracy either way."""
    ref = np.load(REF)
    p = f"block_inverse/nonpd/{case}/"
    R, b, xj = ref[p + "R"], ref[p + "b"], ref[p + "x"]
    assert bool(ref[p + "inv_finite"]) == (case == "nonpd")
    chol.reset_counts()
    xt = ts.solve_gram(_t(R), _t(b), torch.float32,
                       method="block_inverse").numpy()
    assert chol.chol_solve.plain_calls == chol.chol_subst.plain_calls == 1
    ok = [0, 1, 2, 4, 5, 6, 7]
    np.testing.assert_allclose(xt[ok], xj[ok], rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(np.isfinite(xt), np.isfinite(xj))
    R64 = R.astype(np.complex128)
    x64 = np.linalg.solve(R64[ok], b[ok][..., None].astype(np.complex128))
    assert np.abs(xt[ok] - x64[..., 0]).max() / np.abs(x64).max() < 1e-4


def test_eaqhm_extract_matches_jax():
    rng = np.random.default_rng(8)
    M = 2 * (2 * KC + 1)
    x = rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))
    x[0, KC + 3] = 0.0                         # |a|^2 == 0 guard
    cm = rng.random(size=(B, KC)) < 0.7
    jr = js.eaqhm_extract(jnp.asarray(x), jnp.asarray(cm), KC, FS)
    tr = ts.eaqhm_extract(_t(x), _t(cm), KC, FS)
    for a, b in zip(tr, jr):
        _close(a, b)


def test_eaqhm_batch_matches_jax():
    rng, o, wl, s_win = _frames(9)
    fm, am, cm = _tracks(rng)
    jr = js.eaqhm_batch(jnp.asarray(s_win), jnp.asarray(fm), jnp.asarray(am),
                        jnp.asarray(o), jnp.asarray(wl), jnp.asarray(cm), FS,
                        method="cholesky")
    tr = ts.eaqhm_batch(_t(s_win), _t(fm), _t(am), _t(o), _t(wl), _t(cm), FS)
    for a, b in zip(tr, jr):
        _close(a, b, rtol=1e-9)


def test_iqhm_batch_matches_jax():
    rng, o, _, s_win = _frames(10)
    # the engine's geometry: wl = 1.5 periods, so the harmonics resolve
    f0 = rng.uniform(420, 600, size=B)
    wl = np.round(1.5 * FS / f0).astype(int)
    K = rng.integers(3, KC + 1, size=B)
    jr = js.iqhm_batch(jnp.asarray(s_win), jnp.asarray(o), jnp.asarray(wl),
                       jnp.asarray(f0), jnp.asarray(K), FS, KC,
                       method="cholesky")
    tr = ts.iqhm_batch(_t(s_win), _t(o), _t(wl), _t(f0), _t(K), FS, KC)
    for a, b in zip(tr, jr):
        _close(a, b, rtol=1e-9)
