"""The widest tiers: sample rates and pitch floors whose top tier passes
Kc = 128, float64 on the CPU, against the JAX package's results recorded in
tests/golden/torch_parity_ref.npz (group wide/, written by
tools/make_torch_parity_ref.py --cases wide): 0.5 s tones built as config
4's signal at 22.05 kHz and 44.1 kHz (f0 = 80 Hz, male preset: Kc = 192 and
323, M = 770 and 1294) and at 48 kHz (f0 = 55 Hz, gender=(50, 180): Kc =
487, M = 1950).  On the card the Cholesky kernel serves these orders on its
cluster path; here the plain versions run.  No end-to-end run here (a
float64 analyze at 22.05 kHz takes minutes on the CPU): chip_smoke.py's
wide phase holds the card's to the same fixture.  And the batch floor: a
tier whose one chunk is over the batch budget is fitted in smaller
batches, with the same float64 result."""
import json
import os

import numpy as np
import pytest
import torch

import eaqhm_torch
from eaqhm_torch import benchmarks
from eaqhm_torch.models import engine as te
from eaqhm_torch.models import swipe as tswipe
from eaqhm_torch.models import vad as tvad
from eaqhm_torch.ops import solver as ts

torch.set_num_threads(1)
REF = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_parity_ref.npz")
RTOL = 1e-10          # the same arithmetic summed in another order
# name: (f0 of the tone, Kc of the top tier)
CASES = {"fs22050": (80.0, 192), "fs44100": (80.0, 323),
         "fs48000": (55.0, 487)}


@pytest.fixture(scope="module")
def ref():
    with np.load(REF) as f:
        return {k[len("wide/"):]: f[k] for k in f.files
                if k.startswith("wide/")}


def _close(a, b, rtol=RTOL):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _case(ref, name):
    p = name + "/"
    fs = int(ref[p + "fs"])
    cfg = eaqhm_torch.config_from_dict(json.loads(str(ref[p + "config"])))
    return p, ref[p + "signal"], fs, cfg


def _geometry(s, fs, cfg):
    Lpad = -(-len(s) // te.PAGE) * te.PAGE
    f0min, f0max = cfg.pitch_limits
    plan = tswipe.make_plan(float(fs), f0min, f0max, Lpad)
    f0s = tswipe.swipep(plan, torch.as_tensor(np.pad(s, (0, Lpad - len(s)))))
    grid = torch.as_tensor(np.arange(0, Lpad - 1, fs * 5 // 1000) / fs)
    f0_grid = te.resample_f0_grid(f0s, grid).numpy()
    vti, sp, vo, fstep = tvad.voiced_unvoiced_frames_host(s, fs, cfg.is_male)
    return te.frame_geometry(f0_grid, vti, sp, vo, fstep, s, fs, cfg, Lpad)


@pytest.mark.parametrize("name", list(CASES))
def test_wide_geometry_matches_jax(ref, name):
    """The port's pitch, host VAD and frame geometry give JAX's tier
    tensors at each rate, the top tier at Kc = 192 / 323 / 487; the tone is
    benchmarks.stress_signal's construction at that rate and f0."""
    p, s, fs, cfg = _case(ref, name)
    f0, Kc_top = CASES[name]
    np.testing.assert_array_equal(
        benchmarks.stress_signal(len(s) / fs, fs, f0), s)
    geo = _geometry(s, fs, cfg)
    assert geo.No_pad == int(ref[p + "No"])
    assert len(geo.buckets) == int(ref[p + "n_tiers"])
    for i, (gi, W, Kc) in enumerate(geo.buckets):
        t = f"{p}tier{i}/"
        assert (W, Kc) == (int(ref[t + "W"]), int(ref[t + "Kc"]))
        np.testing.assert_array_equal(gi, ref[t + "idx"])
        np.testing.assert_array_equal(geo.centers[gi], ref[t + "centers"])
        np.testing.assert_array_equal(geo.K_frame[gi], ref[t + "K"])
        np.testing.assert_array_equal(geo.wl_frame[gi], ref[t + "wl"])
        _close(geo.f0_frame[gi], ref[t + "f0"], rtol=1e-12)
    assert geo.buckets[-1][2] == Kc_top


@pytest.fixture(scope="module")
def fits(ref):
    """Adaptation 0's fit (iqhm_gram) of the top tier's first frames, per
    case, computed once for the tests below."""
    out = {}
    for name in CASES:
        p, s, fs, _ = _case(ref, name)
        t = f"{p}tier{int(ref[p + 'n_tiers']) - 1}/"
        n = int(ref[p + "fit/n"])
        W, Kc = int(ref[t + "W"]), int(ref[t + "Kc"])
        Lpad = -(-len(s) // te.PAGE) * te.PAGE
        o = np.arange(-W, W + 1)
        rows = np.clip(ref[t + "centers"][:n, None] + o[None, :], 0,
                       Lpad - 1)
        s_win = np.pad(s, (0, Lpad - len(s)))[rows]
        out[name] = ts.iqhm_gram(
            torch.as_tensor(s_win), torch.as_tensor(o),
            torch.as_tensor(np.maximum(ref[t + "wl"][:n], 1)),
            torch.as_tensor(ref[t + "f0"][:n]),
            torch.as_tensor(ref[t + "K"][:n]), float(fs), Kc,
            dtype=torch.float64)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_wide_fit_and_float64_solve_match_jax(ref, fits, name):
    """The fit at M = 770 / 1294 / 1950 and solve_gram(float64, the
    Cholesky solve) against JAX's: the Gram through its diagonal and its
    products with 4 seeded vectors, the right-hand side, the equilibration
    and the solution, to 1e-10 relative."""
    p = name + "/"
    R, rhs, dinv = fits[name]
    Kc = CASES[name][1]
    assert R.shape == (int(ref[p + "fit/n"]), 2 * (2 * Kc + 1),
                       2 * (2 * Kc + 1))
    _close(torch.diagonal(R, dim1=-2, dim2=-1), ref[p + "fit/R_diag"])
    _close(R.numpy() @ ref[p + "fit/probes"], ref[p + "fit/R_probes"])
    _close(rhs, ref[p + "fit/rhs"])
    _close(dinv, ref[p + "fit/dinv"])
    _close(ts.solve_gram(R, rhs, torch.float64), ref[p + "fit/x"])


@pytest.mark.parametrize("name", list(CASES))
def test_wide_float32_pallas_solve_matches_jax(ref, fits, name):
    """solve_gram(float32, "pallas") on the complex64 cast of the same Gram
    (its first frame: the plain guard-rule factorization is a column loop,
    seconds at M = 1950 on one thread) against JAX's float64 solution, to
    the complex64 tolerance of
    tests/test_torch_solver.py.  (JAX's own float32 "pallas" solve is not
    recorded at these orders: its Pallas kernel in interpret mode compiles
    for 14-48 min on the CPU with 24-34 GB of memory.)"""
    p = name + "/"
    R, rhs, _ = fits[name]
    x = ts.solve_gram(R[:1].to(torch.complex64), rhs[:1].to(torch.complex64),
                      torch.float32, method="pallas").numpy()
    np.testing.assert_allclose(x, ref[p + "fit/x"][:1], rtol=1e-4, atol=2e-5)


def test_batch_frames_drop_below_a_chunk_only_over_the_budget():
    """One chunk over the budget: as many frames as fit, at least one;
    otherwise multiples of the chunk, as before."""
    c128 = torch.complex128
    budget = te._BATCH_BYTES["cuda"]
    per_frame = 16 * (4 * 2881 * 975 + 3 * 1950 ** 2)   # Kc = 487, W = 1440
    assert te._batch_frames(128, 2881, 487, c128, "cuda") \
        == budget // per_frame == 11
    assert te._batch_frames(128, 305, 24, c128, "cuda") % 128 == 0
    assert te._batch_frames(128, 10 ** 6, 487, c128, "cuda") == 1


def test_sub_chunk_batches_give_the_chunk_batches_result(monkeypatch):
    """float64 analyze of a short tone (the 210 Hz four-harmonic tone of
    tests/test_aux_subsystems.py:158-160, 0.3 s) with a batch budget of one
    byte, so every batch holds one frame, against the same call under the
    default budget (one chunk-aligned batch per tier): the same
    adaptations, SRER and waveform."""
    fs = 16000
    t = np.arange(int(0.3 * fs)) / fs
    s = sum(0.3 / k * np.sin(2 * np.pi * k * 210 * t) for k in range(1, 5))
    cfg = eaqhm_torch.EaqhmConfig(gender=(150.0, 250.0), max_adaptations=1,
                                  dtype="float64")
    base = eaqhm_torch.analyze(s, fs, cfg, device="cpu")
    seen = []
    orig = te._batch_frames

    def record(chunk, N, Kc, cdtype, device):
        n = orig(chunk, N, Kc, cdtype, device)
        seen.append(n)
        return n

    monkeypatch.setattr(te, "_batch_frames", record)
    monkeypatch.setitem(te._BATCH_BYTES, "cpu", 1)
    got = eaqhm_torch.analyze(s, fs, cfg, device="cpu")
    assert seen and set(seen) == {1}, seen
    assert len(got.srer) == len(base.srer) == 2
    _close(got.srer, base.srer, rtol=1e-12)
    _close(got.s_recon, base.s_recon, rtol=1e-12)
