"""The PyTorch port as a package: its config mirrors the JAX one, it imports
neither JAX nor the JAX package, and its entry points never fall back to
the CPU on their own."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import eaqhm_torch
from eaqhm_torch import config as tcfg
from eaqhm_tpu import config as jcfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_match():
    assert _fields(tcfg.EaqhmConfig) == _fields(jcfg.EaqhmConfig)
    assert tcfg._GENDER_LIMITS == jcfg._GENDER_LIMITS


@pytest.mark.parametrize("kw", [
    {},
    {"gender": "female", "max_adaptations": 3, "dtype": "float64"},
    {"gender": (150.0, 250.0), "full_waveform": False, "fc": 60.0,
     "solve_method": "pallas", "quantize_geometry": False},
])
def test_config_from_dict_round_trips(kw):
    j = jcfg.EaqhmConfig(**kw)
    t = tcfg.config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.pitch_limits == j.pitch_limits
    assert t.is_male == j.is_male
    assert t.margin_samples == j.margin_samples
    assert tcfg.config_from_dict(dataclasses.asdict(t)) == t


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        tcfg.config_from_dict({"gender": "male", "mesh": 8})


def test_import_leaves_jax_out():
    """Every module of the port imports without JAX, the JAX package or
    matplotlib (the card has none; plots import it when called)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import eaqhm_torch, eaqhm_torch.models.engine, "
            "eaqhm_torch.benchmarks, "
            "eaqhm_torch.kernels.build, eaqhm_torch.ops.chol, "
            "eaqhm_torch.ops.block_inverse, eaqhm_torch.ops.fit, "
            "eaqhm_torch.ops.filters, eaqhm_torch.ops.medfilt, "
            "eaqhm_torch.ops.tracks, eaqhm_torch.models.tracks, "
            "eaqhm_torch.ops.pitch, eaqhm_torch.ops.stft, "
            "eaqhm_torch.models.vad, eaqhm_torch.cli, eaqhm_torch.structs, "
            "eaqhm_torch.parallel.corpus, eaqhm_torch.parallel.streams, "
            "eaqhm_torch.parallel.batch_engine, eaqhm_torch.parallel.mesh, "
            "eaqhm_torch.parallel.determinism, eaqhm_torch.utils.checkpoint, "
            "eaqhm_torch.utils.compat, eaqhm_torch.utils.plots, "
            "eaqhm_torch.utils.progress; "
            "print(sorted(m for m in sys.modules "
            "if m in ('jax', 'matplotlib') "
            "or m.startswith(('jax.', 'eaqhm_tpu', 'matplotlib.'))))")
    out = subprocess.run([sys.executable, "-I", "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|eaqhm_tpu)\b|import_module\(\s*['\"]"
    r"(jax|eaqhm_tpu)", re.M)


def test_sources_import_neither_jax_nor_the_jax_package():
    """The port's package, chip_smoke.py, the tools that run the port on
    the card and the helpers of its GPU tests."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    paths += [os.path.join(ROOT, "tests", f) for f in (
        "torch_track_cases.py", "torch_spline_tiles.py", "test_torch_cuda.py",
        "torch_pitch_cases.py")]
    paths += [os.path.join(ROOT, "tools", f) for f in (
        "bench_tracks_phases.py", "bench_fit_phases.py",
        "bench_pitch_phases.py",
        "bench_chol_phases.py", "bench_block_inverse_phases.py",
        "profile_torch_adapt.py", "torch_chol_route.py",
        "torch_solver_residuals.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "eaqhm_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for p in paths:
        with open(p) as f:
            assert not _IMPORT.search(f.read()), p


def _tone(n=16000, fs=16000):
    t = np.arange(n) / fs
    return sum(0.3 / k * np.sin(2 * np.pi * k * 210 * t) for k in range(1, 5))


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = eaqhm_torch.EaqhmConfig(gender=(150.0, 250.0), max_adaptations=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        eaqhm_torch.analyze(_tone(), 16000, cfg)
    from eaqhm_torch.utils.io import write_wav
    path = str(tmp_path / "tone.wav")
    write_wav(path, 16000, _tone())
    with pytest.raises(RuntimeError, match="CUDA"):
        eaqhm_torch.eaqhm_analysis_and_synthesis(path, gender="female")


@pytest.mark.parametrize("kw", [
    {"solve_method": "block_inverse"},
    {"fused_adapt_loop": True},
    {"collect_metrics": True},
    {"stop_on_decline": False},
    {"loading_screen": True},
])
def test_every_option_runs_on_the_cpu(kw, capsys):
    """Each option the first slices left out runs on the CPU: one
    adaptation on 0.5 s with 8 partials, so the case stays cheap (its
    parity is in tests/test_torch_engine.py and test_torch_solver.py)."""
    cfg = eaqhm_torch.EaqhmConfig(gender=(150.0, 250.0), max_adaptations=1,
                                  partials=8, **kw)
    res = eaqhm_torch.analyze(_tone(8000), 16000, cfg, device="cpu")
    assert 1 <= len(res.srer) <= 2 and np.all(np.isfinite(res.srer))
    assert np.all(np.isfinite(res.s_recon))
    assert (res.fused is not None) == bool(kw.get("fused_adapt_loop"))
    assert all(("accepted_harmonics" in m) == bool(kw.get("collect_metrics"))
               for m in res.metrics)
    if kw.get("loading_screen"):
        assert "adaptations" in capsys.readouterr().err + \
            capsys.readouterr().out


def test_dtype_auto_follows_the_device():
    from eaqhm_torch.models.engine import resolve_dtype
    cfg = eaqhm_torch.EaqhmConfig()
    assert resolve_dtype(cfg, torch.device("cpu")) == torch.float64
    assert resolve_dtype(cfg, torch.device("cuda")) == torch.float32
    cfg32 = eaqhm_torch.EaqhmConfig(dtype="float32")
    assert resolve_dtype(cfg32, torch.device("cpu")) == torch.float32
