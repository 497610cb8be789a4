"""The PyTorch engine end to end against eaqhm_tpu.analyze, float64 on the
CPU, on 1 s synthetic tones (tests/test_aux_subsystems.py:158-166).

The JAX results come from tests/golden/torch_parity_ref.npz, written by
tools/make_torch_parity_ref.py from eaqhm_tpu (each JAX analyze compiles
for ~10 s, too long to redo in every run).  Tolerances are those of
tests/test_engine_golden.py: SRER 1e-6 dB, waveform and amplitudes 1e-8.
"""
import json
import os

import numpy as np
import pytest
import torch

import eaqhm_torch
from eaqhm_torch.models import engine as te
from eaqhm_torch.models import vad as tvad

torch.set_num_threads(1)
FS = 16000
REF = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_parity_ref.npz")
CASES = ["default", "deterministic_part", "unquantized_fc_partials"]


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


def _case(ref, name):
    p = f"engine/{name}/"
    cfg = eaqhm_torch.config_from_dict(json.loads(str(ref[p + "config"])))
    return p, ref[p + "signal"], cfg


@pytest.mark.parametrize("case", CASES)
def test_host_geometry_matches_jax(ref, case):
    """The lifted geometry alone, fed the JAX run's f0 grid and the host
    VAD, against the tier tensors eaqhm_tpu.analyze built."""
    p, s, cfg = _case(ref, case)
    if cfg.fc > 0:
        from scipy.signal import filtfilt
        from eaqhm_torch.ops.filters import design_ellip
        b, a, _ = design_ellip(FS, cfg.fc, "highpass")
        s = filtfilt(b, a, s)
    Lpad = -(-len(s) // 4096) * 4096 if cfg.quantize_geometry else len(s)
    vti, sp, vo, fstep = tvad.voiced_unvoiced_frames_host(s, FS, cfg.is_male)
    geo = te.frame_geometry(ref[p + "f0_grid"], vti, sp, vo, fstep, s, FS,
                            cfg, Lpad)
    assert geo.No_pad == int(ref[p + "No"])
    assert len(geo.buckets) == int(ref[p + "n_tiers"])
    for i, (gi, W, Kc) in enumerate(geo.buckets):
        t = f"{p}tier{i}/"
        assert (W, Kc) == (int(ref[t + "W"]), int(ref[t + "Kc"]))
        np.testing.assert_array_equal(gi, ref[t + "idx"])
        np.testing.assert_array_equal(geo.centers[gi], ref[t + "centers"])
        np.testing.assert_array_equal(geo.f0_frame[gi], ref[t + "f0"])
        np.testing.assert_array_equal(geo.K_frame[gi], ref[t + "K"])
        np.testing.assert_array_equal(geo.wl_frame[gi], ref[t + "wl"])


@pytest.mark.parametrize("case", CASES)
def test_analyze_matches_jax(ref, case):
    p, s, cfg = _case(ref, case)
    rt = eaqhm_torch.analyze(s, FS, cfg, device="cpu")
    srer = ref[p + "srer"]
    assert len(rt.srer) == len(srer)
    np.testing.assert_allclose(rt.srer, srer, rtol=0, atol=1e-6)
    assert np.isfinite(rt.srer).all() and rt.srer[0] > 5.0
    for name, atol in (("s_recon", 1e-8), ("det_ak", 1e-8), ("det_a0", 1e-8),
                       ("det_frange", 1e-6), ("det_pk", 1e-7)):
        np.testing.assert_allclose(getattr(rt, name), ref[p + name], rtol=0,
                                   atol=atol, err_msg=name)
    for name in ("det_ti", "det_is_speech", "det_is_voiced"):
        np.testing.assert_array_equal(getattr(rt, name), ref[p + name])
    np.testing.assert_allclose(rt.f0_grid, ref[p + "f0_grid"], rtol=1e-9)


def test_file_entry_point_matches_analyze(ref, tmp_path):
    from eaqhm_torch.utils.io import read_wav, write_wav
    _, s, _ = _case(ref, "default")
    path = str(tmp_path / "tone.wav")
    write_wav(path, FS, s)
    s_recon, srer, res, elapsed = eaqhm_torch.eaqhm_analysis_and_synthesis(
        path, gender=(150.0, 250.0), max_adpt=0, print_prompts=False,
        device="cpu")
    fs, s16 = read_wav(path)
    direct = eaqhm_torch.analyze(s16, fs, eaqhm_torch.EaqhmConfig(
        gender=(150.0, 250.0), max_adaptations=0), device="cpu")
    assert srer == direct.srer and len(srer) == 1
    np.testing.assert_array_equal(s_recon, direct.s_recon)
    assert elapsed > 0 and res.tiers == direct.tiers


def _option_case(ref, name):
    p = f"engine_options/{name}/"
    cfg = eaqhm_torch.config_from_dict(json.loads(str(ref[p + "config"])))
    return p, ref[p + "signal"], cfg


def test_block_inverse_analyze_matches_jax(ref):
    """float64 analyze with solve_method="block_inverse" on the 1 s tone
    against eaqhm_tpu's (recorded)."""
    p, s, cfg = _option_case(ref, "block_inverse")
    rt = eaqhm_torch.analyze(s, FS, cfg, device="cpu")
    assert len(rt.srer) == len(ref[p + "srer"])
    np.testing.assert_allclose(rt.srer, ref[p + "srer"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.s_recon, ref[p + "s_recon"], rtol=0,
                               atol=1e-8)


def test_no_stop_on_decline_and_metrics_match_jax(ref):
    """stop_on_decline=False (keep the best so far, keep going) and
    collect_metrics (accepted harmonics per adaptation) against eaqhm_tpu's
    recorded trajectory, on the tone's first 0.5 s."""
    p, s, cfg = _option_case(ref, "no_stop_metrics")
    assert not cfg.stop_on_decline and cfg.collect_metrics
    rt = eaqhm_torch.analyze(s, FS, cfg, device="cpu")
    srer = ref[p + "srer"]
    assert len(rt.srer) == len(srer) == cfg.max_adaptations + 1
    np.testing.assert_allclose(rt.srer, srer, rtol=0, atol=1e-6)
    assert [m["accepted_harmonics"] for m in rt.metrics] == \
        ref[p + "accepted_harmonics"].tolist()
    np.testing.assert_allclose(rt.s_recon, ref[p + "s_recon"], rtol=0,
                               atol=1e-8)


def test_fused_loop_matches_host_loop():
    """The fused loop (eager steps on the CPU, with the device-side
    keep-best select) against the host loop on the four-harmonic tone of
    tests/test_aux_subsystems.py:152-175, with that test's tolerances."""
    t = np.arange(FS) / FS
    s = sum(0.3 / k * np.sin(2 * np.pi * k * 210 * t) for k in range(1, 5))
    kw = dict(gender=(150.0, 250.0), max_adaptations=3)
    r_host = eaqhm_torch.analyze(s, FS, eaqhm_torch.EaqhmConfig(**kw),
                                 device="cpu")
    r_fused = eaqhm_torch.analyze(
        s, FS, eaqhm_torch.EaqhmConfig(fused_adapt_loop=True, **kw),
        device="cpu")
    assert r_host.fused is None
    assert r_fused.fused["eager"] == len(r_fused.srer)
    assert r_fused.fused["replays"] == 0
    assert len(r_host.srer) == len(r_fused.srer)
    np.testing.assert_allclose(r_fused.srer, r_host.srer, atol=1e-9)
    np.testing.assert_allclose(r_fused.s_recon, r_host.s_recon, atol=1e-12)
    np.testing.assert_allclose(r_fused.det_ak, r_host.det_ak, atol=1e-12)
    np.testing.assert_allclose(r_fused.det_pk, r_host.det_pk, atol=1e-10)
