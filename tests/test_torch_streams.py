"""The port's utterance streams (eaqhm_torch.parallel.streams) against its
sequential engine, as tests/test_streams.py holds the JAX package's: every
utterance through a worker reproduces the sequential result (final SRER
within 1e-9 dB, tests/test_streams.py:40-43), work spreads over the
workers, failures stay isolated, and the default devices are CUDA's.
Short tones, 8 partials, unquantized geometry (8 harmonics, not the 24 of
the lattice), 3 adaptations at most: the runs stay cheap.
"""
import numpy as np
import pytest
import torch

from eaqhm_torch.config import EaqhmConfig
from eaqhm_torch.models import engine
from eaqhm_torch.parallel.streams import run_streams

FS = 16000
SRER_TOL_DB = 1e-9


def _tone(f0, n=6400, seed=0):
    """Four harmonics with faded edges (tests/test_batch_engine.py's
    utterance, shorter)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    s = sum((0.3 / k) * np.cos(2 * np.pi * k * f0 * t
                               + rng.uniform(0, 2 * np.pi))
            for k in range(1, 5))
    env = np.ones(n)
    env[:1200] = 0.5 - 0.5 * np.cos(np.pi * np.arange(1200) / 1200)
    env[-1200:] = env[:1200][::-1]
    return s * env


@pytest.fixture(scope="module")
def stream_run():
    cfg = EaqhmConfig(gender=(150.0, 280.0), max_adaptations=3, partials=8,
                      quantize_geometry=False)
    sigs = [_tone(180.0 + 23 * i, seed=i) for i in range(3)]
    seq = [engine.analyze(s, FS, cfg, device="cpu") for s in sigs]
    bad = np.zeros(64)              # shorter than the edge margin: raises
    out = run_streams([sigs[0], bad, sigs[1], sigs[2]], FS, cfg,
                      devices=["cpu", "cpu"])
    return seq, out


def test_streams_match_sequential(stream_run):
    seq, out = stream_run
    for i, r in zip((0, 2, 3), seq):
        got = out.done[i]
        assert got["n_adaptations"] == len(r.srer)
        assert abs(got["final_srer_db"] - max(r.srer)) <= SRER_TOL_DB
    assert abs(out.srer_mean - np.mean([max(r.srer) for r in seq])) < 1e-9


def test_streams_failure_isolation(stream_run):
    _, out = stream_run
    assert set(out.done) == {0, 2, 3}
    assert set(out.failed) == {1}


def test_streams_per_worker_statistics(stream_run):
    _, out = stream_run
    # two workers on one device keep separate records
    assert sorted(out.per_device) == ["cpu#0", "cpu#1"]
    assert sum(st["utterances"] for st in out.per_device.values()) == 4
    assert {d["device"] for d in out.done.values()} <= set(out.per_device)
    assert out.audio_seconds == pytest.approx(3 * 6400 / FS)
    assert out.audio_seconds_per_second > 0


def test_streams_default_devices_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_streams([np.zeros(8000)], FS, EaqhmConfig())
