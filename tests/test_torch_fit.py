"""The fit (eaqhm_torch.ops.fit) on the CPU: its plain version against the
JAX package's iqhm_gram / eaqhm_gram, float64, inputs from a numpy seed;
the entry points' routes (the plain fit on CPU tensors, counted; the kernel
wrappers refuse anything but CUDA tensors); the launch arguments against
the kernel library's argtypes.  Tolerance 1e-12 of the largest entry of R, rhs and dinv: the same
arithmetic, summed in another order (R's entries are sums of N products of
entries of size <= 1; dinv and rhs scale them)."""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eaqhm_torch.kernels import build
from eaqhm_torch.ops import fit
from eaqhm_tpu.ops import solver as js

torch.set_num_threads(1)
FS = 16000.0
TOL = 1e-12
# B frames, W half-width, Kc harmonics: 2Kc+1 = 15 and M = 30 are no
# multiple of any tile of the kernels (64 columns, 16 or 8 rows)
B, W, KC = 7, 27, 7


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


@pytest.mark.parametrize("mode", ["iqhm", "eaqhm"])
def test_cpu_tensors_take_the_plain_version(mode):
    """On CPU tensors an entry point is the plain fit, bit for bit; the fit
    is counted as served by the plain version and nothing is launched."""
    d = {k: _t(v) for k, v in _inputs(4).items()}
    fit.reset_counts()
    if mode == "iqhm":
        args = (d["s_win"], d["o"], d["wl"], d["f0"], d["K"], FS, KC)
        entry, other = fit.iqhm_gram, fit.eaqhm_gram
        want = fit.iqhm_gram_reference(*args)
    else:
        args = (d["s_win"], d["fm"], d["am"], d["o"], d["wl"], d["colmask"],
                FS)
        entry, other = fit.eaqhm_gram, fit.iqhm_gram
        want = fit.eaqhm_gram_reference(*args)
    got = entry(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (entry.plain_calls, other.plain_calls) == (1, 0)
    assert fit.fit_basis.launches == fit.fit_gram.launches == 0
    fit.reset_counts()
    assert entry.plain_calls == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrappers_take_cuda_tensors_only(device):
    """fit_basis and fit_gram have no plain route of their own: a tensor
    off CUDA is refused, and nothing is counted."""
    d = {k: _t(v).to(device) for k, v in _inputs(5).items()}
    fit.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.fit_basis("iqhm", d["s_win"], d["o"], d["wl"], torch.float64,
                      f0=d["f0"], K=d["K"], Kc=KC, fs=FS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.fit_basis("eaqhm", d["s_win"], d["o"], d["wl"], torch.float32,
                      fm_win=d["fm"], am_win=d["am"],
                      colmask_k=d["colmask"], fs=FS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.fit_gram(torch.zeros((1, 3, 5), dtype=torch.complex64,
                                 device=device), d["o"][:3],
                     torch.ones(1, 10, device=device),
                     torch.ones(1, 5, dtype=torch.uint8, device=device))
    assert fit.fit_basis.launches == fit.fit_gram.launches == 0
    assert fit.iqhm_gram.plain_calls == fit.eaqhm_gram.plain_calls == 0


def test_cuda_request_without_a_card_raises():
    """An entry point given tensors neither on the CPU nor on CUDA raises,
    and the launch path without the CUDA toolkit raises instead of falling
    back."""
    d = {k: _t(v).to("meta") for k, v in _inputs(5).items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit.eaqhm_gram(d["s_win"], d["fm"], d["am"], d["o"], d["wl"],
                       d["colmask"], FS)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the library builds here")
    with pytest.raises(RuntimeError):
        fit.library("cuda")


_CT = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_longlong: int,
       ctypes.c_double: float}


@pytest.mark.parametrize("mode,dtype", [("iqhm", torch.float32),
                                        ("iqhm", torch.float64),
                                        ("eaqhm", torch.float32),
                                        ("eaqhm", torch.float64)])
def test_launch_arguments_match_the_library(mode, dtype):
    """kernels.build registers fit.cu; every argument the wrappers pass
    (the stream last) has the Python type of its argtype, in number and
    order."""
    src, syms = build.KERNELS["fit"]
    assert src == "fit.cu"
    d = {k: _t(v) for k, v in _inputs(6).items()}
    out, sym, args, _ = fit.basis_call(
        mode, d["s_win"], d["o"], d["wl"], dtype, f0=d["f0"], K=d["K"],
        Kc=KC, fm_win=d["fm"], am_win=d["am"], colmask_k=d["colmask"],
        fs=FS)
    A, rhs, dinv, mask = out
    assert A.dtype == fit.complex_dtype(dtype) and dinv.dtype == dtype
    calls = [(sym, args), fit.gram_call(A, d["o"], dinv, mask)[1:3]]
    for sym, args in calls:
        argtypes = syms[sym]
        assert len(argtypes) == len(args) + 1, sym
        assert argtypes[-1] is ctypes.c_void_p          # the stream
        for a, t in zip(args, argtypes):
            assert type(a) is _CT[t], (sym, a, t)
