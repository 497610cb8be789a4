"""The stress configuration (the JAX benchmark's config 4: 60 s at f0
76-84 Hz, male preset) at full width, float64 on the CPU, against the JAX
package's results on the stress slice (samples 32,000-40,000, where every
frame lies in the Kc = 128 tier: M = 514), recorded in
tests/golden/torch_parity_ref.npz (group stress/, written by
tools/make_torch_parity_ref.py --cases stress).  No end-to-end run here:
the slice alone costs minutes on the CPU; chip_smoke.py holds the card's
end-to-end run to the same fixture."""
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
FS = 16000
REF = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_parity_ref.npz")
RTOL = 1e-10          # the same arithmetic summed in another order


@pytest.fixture(scope="module")
def ref():
    with np.load(REF) as f:
        return {k[len("stress/"):]: f[k] for k in f.files
                if k.startswith("stress/")}


def _close(a, b, rtol=RTOL):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def test_stress_signal_matches_jax(ref):
    """benchmarks.stress_signal() is the JAX config-4 signal, bit for bit,
    on the slice the fixture recorded; config 4's configuration is JAX's."""
    s = benchmarks.stress_signal()
    assert s.shape == (60 * FS,)
    a, b = ref["slice"]
    np.testing.assert_array_equal(s[a:b], ref["signal"])
    cfg4 = eaqhm_torch.config_from_dict(json.loads(str(ref["config4"])))
    assert benchmarks.stress_config(benchmarks.Run("cpu")) == cfg4


def _slice_geometry(ref):
    s = ref["signal"]
    cfg = eaqhm_torch.config_from_dict(json.loads(str(ref["config"])))
    Lpad = -(-len(s) // te.PAGE) * te.PAGE
    f0min, f0max = cfg.pitch_limits
    plan = tswipe.make_plan(float(FS), f0min, f0max, Lpad)
    f0s = tswipe.swipep(plan, torch.as_tensor(np.pad(s, (0, Lpad - len(s)))))
    grid = torch.as_tensor(np.arange(0, Lpad - 1, FS * 5 // 1000) / FS)
    f0_grid = te.resample_f0_grid(f0s, grid).numpy()
    vti, sp, vo, fstep = tvad.voiced_unvoiced_frames_host(s, FS, cfg.is_male)
    return te.frame_geometry(f0_grid, vti, sp, vo, fstep, s, FS, cfg, Lpad)


def test_stress_slice_geometry_matches_jax(ref):
    """The port's pitch, male-branch host VAD and frame geometry on the
    slice give JAX's tier tensors: one tier, Kc = 128 (M = 514), 470
    frames."""
    geo = _slice_geometry(ref)
    assert geo.No_pad == int(ref["No"])
    assert len(geo.buckets) == int(ref["n_tiers"]) == 1
    gi, W, Kc = geo.buckets[0]
    assert (len(gi), W, Kc) == (470, int(ref["tier0/W"]), 128)
    assert int(ref["tier0/Kc"]) == 128
    np.testing.assert_array_equal(gi, ref["tier0/idx"])
    np.testing.assert_array_equal(geo.centers[gi], ref["tier0/centers"])
    np.testing.assert_array_equal(geo.K_frame[gi], ref["tier0/K"])
    np.testing.assert_array_equal(geo.wl_frame[gi], ref["tier0/wl"])
    _close(geo.f0_frame[gi], ref["tier0/f0"], rtol=1e-12)


def test_stress_fit_and_solve_at_m514_match_jax(ref):
    """Adaptation 0's fit (iqhm_gram) of the tier's first 8 frames and
    solve_gram (float64: the Cholesky solve) at M = 514 against JAX's: the
    Gram through its diagonal and its products with 4 seeded vectors, the
    right-hand side, the equilibration and the solution, to 1e-10
    relative (the equilibrated Grams have condition numbers below 10)."""
    n = 8
    W, Kc = int(ref["tier0/W"]), int(ref["tier0/Kc"])
    s = ref["signal"]
    Lpad = -(-len(s) // te.PAGE) * te.PAGE
    o = np.arange(-W, W + 1)
    rows = np.clip(ref["tier0/centers"][:n, None] + o[None, :], 0, Lpad - 1)
    s_win = np.pad(s, (0, Lpad - len(s)))[rows]
    R, rhs, dinv = ts.iqhm_gram(
        torch.as_tensor(s_win), torch.as_tensor(o),
        torch.as_tensor(np.maximum(ref["tier0/wl"][:n], 1)),
        torch.as_tensor(ref["tier0/f0"][:n]),
        torch.as_tensor(ref["tier0/K"][:n]), float(FS), Kc,
        dtype=torch.float64)
    assert R.shape == (n, 514, 514)
    _close(torch.diagonal(R, dim1=-2, dim2=-1), ref["fit/R_diag"])
    _close(R.numpy() @ ref["fit/probes"], ref["fit/R_probes"])
    _close(rhs, ref["fit/rhs"])
    _close(dinv, ref["fit/dinv"])
    _close(ts.solve_gram(R, rhs, torch.float64), ref["fit/x"])
