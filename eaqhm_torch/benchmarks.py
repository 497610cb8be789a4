"""Benchmark entry points of the PyTorch port for the BASELINE.json
configurations: the counterpart of the JAX package's ``benchmarks.py``.

Usage:
    python -m eaqhm_torch.benchmarks --config 1   # SA19 default (+ bench.py's keys)
    python -m eaqhm_torch.benchmarks --config 2   # high-pass + gender presets
    python -m eaqhm_torch.benchmarks --config 3   # batch of 64 utterances
    python -m eaqhm_torch.benchmarks --config 4   # 60 s / f0=80 Hz stress
    python -m eaqhm_torch.benchmarks --config 5   # sharded corpus step
    python -m eaqhm_torch.benchmarks --config 6   # per-device streams

Options: ``--device`` (default CUDA, raising without a card; ``cpu`` runs
the kernels' plain versions), ``--dtype``, ``--solve-method``, ``--chunk``
(the JAX module's EAQHM_SOLVE_METHOD / EAQHM_CHUNK), ``--repeats``,
``--n-utts`` and ``--seconds`` (configs 3, 5, 6), ``--wav`` (an input in
place of the SA19 resynthesis).  Configs 3 and 5 join the process group of
torchrun's environment when there is one (``parallel.mesh.multihost_init``).

Each prints one JSON line with the JAX module's metric name and keys
(``METRICS``), plus ``device`` (the card's name, or "cpu"), ``dtype`` (the
resolved float type), ``kernels`` (launches and plain-version calls of the
Cholesky kernel's two entry points over the timed calls; counts set to 0
before them) and ``input``.  SA19.WAV is not in the repository: the SA19
configs read the reference's resynthesis of it, ``s_recon`` of
tests/golden/sa19_golden.npz (63,488 samples at 16 kHz).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from eaqhm_torch.config import EaqhmConfig
from eaqhm_torch.device import resolve_device

# The NumPy reference's single-core CPU rate on SA19.WAV (BASELINE.md:
# 221.07 s for 3.968 s of audio): the denominator of vs_baseline.  It is a
# CPU number of the reference implementation, not a device measurement.
BASELINE_AUDIO_S_PER_S = 0.01795
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden")
SA19_RESYNTH = "tests/golden/sa19_golden.npz:s_recon"
FS = 16000
# The JAX package's metric name and keys per config (eaqhm_tpu/
# benchmarks.py), and bench.py's keys (bench.py:93-107) for config 1.
_JAX_BASE = ("metric", "value", "unit", "vs_baseline")
_PORT = ("device", "dtype", "kernels", "input")
METRICS = {
    1: ("sa19_default", ("final_srer_db", "elapsed_s", "srer_matched",
                         "audio_seconds", "ref_final_srer_db",
                         "srer_delta_db", "backend", "n_adaptations",
                         "warmup_runs", "warmup_s", "timings")),
    2: ("sa19_highpass_presets", ("final_srer_db",)),
    3: ("corpus_batch_full_pipeline", ("srer_mean_db", "batch",
                                       "n_adaptations", "n_devices",
                                       "elapsed_s", "path")),
    4: ("stress_60s_f080", ("final_srer_db", "n_adaptations", "elapsed_s",
                            "toggles")),
    5: ("corpus_sharded_full_pipeline", ("n_utts", "done", "failed",
                                         "srer_mean_db", "n_devices",
                                         "elapsed_s")),
    6: ("corpus_streams_per_device", ("sequential_1dev", "n_devices",
                                      "scaling_efficiency", "srer_mean_db",
                                      "failed", "per_device", "elapsed_s")),
}
# config 3 on one device has no lockstep adaptation count (JAX's line
# leaves it out there too)
_OPTIONAL = {3: ("n_adaptations",)}


class Run:
    """Where and how a benchmark runs: the device (CUDA unless asked for
    the CPU), the config overrides (dtype, solve method, chunk) and the
    input of the SA19 configs."""

    def __init__(self, device=None, dtype="auto", solve_method="auto",
                 chunk=None, wav=None):
        self.device = resolve_device(device)
        self.cfg_kw = {"dtype": dtype, "solve_method": solve_method}
        if chunk is not None:
            self.cfg_kw["chunk"] = int(chunk)
        self.wav = wav

    def config(self, **kw) -> EaqhmConfig:
        """The benchmark's configuration ``kw`` with the overrides on top."""
        return EaqhmConfig(**{**kw, **self.cfg_kw})

    def device_name(self) -> str:
        if self.device.type != "cuda":
            return self.device.type
        idx = self.device.index
        return torch.cuda.get_device_name(
            torch.cuda.current_device() if idx is None else idx)

    def dtype_name(self, cfg: EaqhmConfig) -> str:
        from eaqhm_torch.models import engine
        return str(engine.resolve_dtype(cfg, self.device)).split(".")[-1]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def recording(self):
        """(fs, signal, input name) of the SA19 configs."""
        if self.wav is not None:
            from eaqhm_torch.utils.io import read_wav
            fs, s = read_wav(self.wav)
            return fs, s, self.wav
        s = np.load(os.path.join(GOLDEN, "sa19_golden.npz"))["s_recon"]
        return FS, s, SA19_RESYNTH


class Launches:
    """The Cholesky, block-inverse, fit, tracks and pitch kernels' counts
    summed over the timed calls."""

    def __init__(self):
        self.counts = {name: {"launches": 0, "plain_calls": 0}
                       for name in ("chol_solve", "chol_subst",
                                    "block_inverse", "fit_basis", "fit_gram",
                                    "track_spline", "track_synth",
                                    "track_srer", "swipe_loudness",
                                    "swipe_pick")}

    def __call__(self, fn, *args, **kw):
        """fn(*args, **kw) with the counts set to 0 before it and added in
        after it."""
        from eaqhm_torch.ops import block_inverse, chol, fit, pitch, tracks
        chol.reset_counts()
        block_inverse.reset_counts()
        fit.reset_counts()
        tracks.reset_counts()
        pitch.reset_counts()
        out = fn(*args, **kw)
        plain_fits = fit.plain_fits()
        plain_tracks = tracks.plain_calls()
        for name in self.counts:
            if name.startswith("fit"):
                # the plain fit serves both kernels' work at once
                f, plain = getattr(fit, name), plain_fits
            elif name.startswith("track"):
                # the plain stage serves the three kernels' work
                f, plain = getattr(tracks, name), plain_tracks
            elif name.startswith("swipe"):
                f = getattr(pitch, name)
                plain = (pitch.loudness if name == "swipe_loudness"
                         else pitch.pick).plain_calls
            else:
                f = (block_inverse.block_inverse_solve
                     if name == "block_inverse" else getattr(chol, name))
                plain = f.plain_calls
            self.counts[name]["launches"] += f.launches
            self.counts[name]["plain_calls"] += plain
        return out


def _emit(config_no: int, run: Run, cfg: EaqhmConfig, value, launches,
          input_name: str, unit="audio-s/s", **extra) -> dict:
    """Print one JSON line (the JAX keys, then the port's) and return it;
    the keys must be those of METRICS[config_no]."""
    metric, keys = METRICS[config_no]
    line = {"metric": metric, "value": round(float(value), 4), "unit": unit,
            "vs_baseline": round(float(value) / BASELINE_AUDIO_S_PER_S, 2)}
    line.update(extra)
    line.update(device=run.device_name(), dtype=run.dtype_name(cfg),
                kernels=launches.counts, input=input_name)
    want = set(_JAX_BASE + keys + _PORT)
    missing = want - set(line) - set(_OPTIONAL.get(config_no, ()))
    if missing or set(line) - want:
        raise AssertionError(f"config {config_no}: keys {sorted(line)} "
                             f"against {sorted(want)}")
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(line), flush=True)
    return line


def _timed_analyze(run: Run, s, fs, cfg, repeats, launches):
    """A first call (kernel build and first use included), then the best
    of ``repeats`` warm calls.  Returns (result, best s, first s)."""
    from eaqhm_torch.models import engine
    t0 = time.time()
    res = engine.analyze(s, fs, cfg, device=run.device)
    run.sync()
    first = time.time() - t0
    times = []
    for _ in range(repeats):
        t0 = time.time()
        res = launches(engine.analyze, s, fs, cfg, device=run.device)
        run.sync()
        times.append(time.time() - t0)
    return res, min(times), first


def _ref_final_srer(input_name: str) -> Optional[float]:
    """The JAX package's float64 final SRER on the resynthesis
    (tests/golden/torch_smoke_ref.npz); None for another input."""
    if input_name != SA19_RESYNTH:
        return None
    ref = np.load(os.path.join(GOLDEN, "torch_smoke_ref.npz"))
    return float(np.max(ref["srer"]))


def bench_config1(run: Run, repeats=3):
    """SA19 (the resynthesis), default female params, full adaptation loop
    to convergence; bench.py's keys, with srer_matched / srer_delta_db
    against the JAX package's float64 final SRER on the same input."""
    fs, s, name = run.recording()
    cfg = run.config(gender="female")
    launches = Launches()
    res, el, first = _timed_analyze(run, s, fs, cfg, repeats, launches)
    final = float(np.max(res.srer))
    ref = _ref_final_srer(name)
    audio = len(s) / fs
    line = _emit(
        1, run, cfg, audio / el, launches, name,
        final_srer_db=round(final, 6), elapsed_s=round(el, 3),
        srer_matched=None if ref is None else bool(final - ref > -0.1),
        audio_seconds=audio, ref_final_srer_db=ref,
        srer_delta_db=None if ref is None else round(final - ref, 6),
        backend=run.device.type, n_adaptations=len(res.srer),
        warmup_runs=[round(first, 1)], warmup_s=round(first, 1),
        timings={k: round(v, 3) for k, v in res.timings.items()})
    return line, {"result": res}


def bench_config2(run: Run, repeats=3):
    """SA19 (the resynthesis) full-waveform with the 30 Hz high-pass, for
    the female, male and child pitch presets."""
    fs, s, name = run.recording()
    out, results = {}, {}
    total_audio = total_time = 0.0
    launches = Launches()
    for gender in ("female", "male", "child"):
        cfg = run.config(gender=gender, fc=30.0, full_waveform=True)
        res, el, _ = _timed_analyze(run, s, fs, cfg, max(1, repeats - 1),
                                    launches)
        out[gender] = round(float(np.max(res.srer)), 4)
        results[gender] = res
        total_audio += len(s) / fs
        total_time += el
    line = _emit(2, run, cfg, total_audio / total_time, launches, name,
                 final_srer_db=out)
    return line, {"results": results}


def stress_signal(seconds: float = 60.0, fs: int = FS,
                  f0_hz: float = 80.0) -> np.ndarray:
    """Config 4's input (eaqhm_tpu/benchmarks.py:177-183): eleven harmonics
    of f0 = 80 + 4 sin(2 pi 0.3 t) Hz with 1/k amplitudes, plus white
    noise of std 0.01 (numpy seed 1); f0_hz moves the 80 Hz centre (the
    wide tiers' tones)."""
    t = np.arange(int(fs * seconds)) / fs
    f0 = f0_hz + 4.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    s = sum((0.25 / k) * np.sin(k * phase) for k in range(1, 12))
    s += 0.01 * np.random.default_rng(1).normal(size=len(s))
    return s


def stress_config(run: Run) -> EaqhmConfig:
    """Config 4's configuration: male preset, max_adaptations=10."""
    return run.config(gender="male", max_adaptations=10)


def bench_config4(run: Run, repeats=1, seconds: float = 60.0):
    """Stress: a 60 s utterance at f0 ~ 80 Hz, the male preset's full-band
    harmonic count (tiers Kc = 96 and 128: M = 386 and 514)."""
    s = stress_signal(seconds)
    cfg = stress_config(run)
    launches = Launches()
    res, el, _ = _timed_analyze(run, s, FS, cfg, repeats, launches)
    line = _emit(4, run, cfg, seconds / el, launches,
                 f"stress_signal(seconds={seconds})",
                 final_srer_db=round(float(np.max(res.srer)), 4),
                 n_adaptations=len(res.srer), elapsed_s=round(el, 3),
                 toggles=dict(run.cfg_kw))
    return line, {"result": res}


def corpus(run: Run, n: int, seconds: float):
    """The JAX benchmark's corpus inputs (eaqhm_tpu/benchmarks.py:88-116)
    with the SA19 recording replaced by the configured one
    (``parallel.corpus.corpus_signals``).  Returns (signals, fs, name)."""
    from eaqhm_torch.parallel.corpus import corpus_signals
    fs, rec, name = run.recording()
    return corpus_signals(rec, n, fs, seconds), fs, name


def corpus_config(run: Run) -> EaqhmConfig:
    """The corpus configs' configuration: female, max_adaptations=6."""
    return run.config(gender="female", max_adaptations=6)


def _mesh():
    """A mesh over torchrun's process group when there is one of more than
    one rank, else None (one process; no group is created)."""
    import torch.distributed as dist
    from eaqhm_torch.parallel.mesh import make_mesh, multihost_init
    if multihost_init() and dist.get_world_size() > 1:
        return make_mesh()
    return None


def bench_config3(run: Run, batch=64, repeats=2, seconds=2.0):
    """A batch of utterances through the full pipeline, with the JAX
    package's rule for the path: ``analyze_batch`` over the mesh when there
    is more than one device, else the sequential per-utterance engine (on
    one device the batch engine pads every utterance to the batch's worst
    geometry with nothing to shard over)."""
    from eaqhm_torch.models import engine
    from eaqhm_torch.parallel.batch_engine import analyze_batch
    sigs, fs, name = corpus(run, batch, seconds)
    cfg = corpus_config(run)
    mesh = _mesh()
    audio = batch * seconds
    launches = Launches()
    if mesh is not None:
        out = analyze_batch(sigs, fs, cfg, mesh=mesh, device=run.device)
        times = []
        for _ in range(repeats):
            t0 = time.time()
            out = launches(analyze_batch, sigs, fs, cfg, mesh=mesh,
                           device=run.device)
            times.append(time.time() - t0)
        el = min(times)
        line = _emit(3, run, cfg, audio / el, launches, name,
                     srer_mean_db=round(float(out.srer_mean), 3),
                     batch=batch, n_adaptations=int(out.n_adaptations),
                     n_devices=mesh.size(), elapsed_s=round(el, 3),
                     path="batch_engine")
        return line, {"final_srer": list(out.final_srer)}
    results = [engine.analyze(s, fs, cfg, device=run.device) for s in sigs]
    times = []
    for _ in range(repeats):
        t0 = time.time()
        results = launches(lambda: [engine.analyze(s, fs, cfg,
                                                   device=run.device)
                                    for s in sigs])
        run.sync()
        times.append(time.time() - t0)
    el = min(times)
    finals = [float(np.max(r.srer)) for r in results]
    line = _emit(3, run, cfg, audio / el, launches, name,
                 srer_mean_db=round(float(np.mean(finals)), 3), batch=batch,
                 n_devices=1, elapsed_s=round(el, 3),
                 path="sequential_per_utterance")
    return line, {"final_srer": finals}


def bench_config5(run: Run, n_utts=16, repeats=1, seconds=2.0):
    """The sharded corpus driver end to end over a written wav corpus:
    reads, pitch, VAD, adaptation loops, SRER stats all-reduced over the
    mesh (``run_corpus_sharded``; a run of one process is
    ``run_corpus``).  A first pass, then the timed one, as JAX's."""
    from eaqhm_torch.parallel.corpus import run_corpus_sharded
    from eaqhm_torch.utils.io import write_wav
    sigs, fs, name = corpus(run, n_utts, seconds)
    cfg = corpus_config(run)
    mesh = _mesh()
    bs = max(4, mesh.shape[0]) if mesh is not None else None
    launches = Launches()
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, s in enumerate(sigs):
            paths.append(os.path.join(d, f"utt{i:05d}.wav"))
            write_wav(paths[-1], fs, s)
        res = run_corpus_sharded(paths, cfg, mesh=mesh, batch_size=bs,
                                 device=run.device)
        res = launches(run_corpus_sharded, paths, cfg, mesh=mesh,
                       batch_size=bs, device=run.device)
    srers = [v["final_srer_db"] for v in res.done.values()]
    line = _emit(5, run, cfg, res.audio_seconds_per_second, launches, name,
                 n_utts=n_utts, done=len(res.done), failed=len(res.failed),
                 srer_mean_db=round(float(np.mean(srers)), 3)
                 if srers else None,
                 n_devices=mesh.size() if mesh is not None else 1,
                 elapsed_s=round(res.elapsed, 3))
    return line, {"result": res}


def bench_config6(run: Run, n_utts=16, repeats=2, seconds=2.0):
    """Per-device utterance streams (``run_streams``, one worker per
    visible card) against the sequential engine on the same work, with the
    scaling efficiency streams / (n_devices * sequential)."""
    from eaqhm_torch.models import engine
    from eaqhm_torch.parallel.streams import run_streams
    sigs, fs, name = corpus(run, n_utts, seconds)
    cfg = corpus_config(run)
    if run.device.type == "cuda":
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = [str(run.device)]
    audio = n_utts * seconds
    for s in sigs[:2]:
        engine.analyze(s, fs, cfg, device=devices[0])
    times = []
    for _ in range(repeats):
        t0 = time.time()
        for s in sigs:
            engine.analyze(s, fs, cfg, device=devices[0])
        run.sync()
        times.append(time.time() - t0)
    seq_rate = audio / min(times)
    out = run_streams(sigs, fs, cfg, devices=devices)
    launches = Launches()
    times = []
    for _ in range(repeats):
        t0 = time.time()
        out = launches(run_streams, sigs, fs, cfg, devices=devices)
        times.append(time.time() - t0)
    el = min(times)
    rate = audio / el
    line = _emit(6, run, cfg, rate, launches, name,
                 sequential_1dev=round(seq_rate, 4), n_devices=len(devices),
                 scaling_efficiency=round(rate / (len(devices) * seq_rate),
                                          4),
                 srer_mean_db=round(out.srer_mean, 3),
                 failed=len(out.failed), per_device=out.per_device,
                 elapsed_s=round(el, 3))
    return line, {"result": out}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="eaqhm_torch.benchmarks")
    p.add_argument("--config", type=int, default=1, choices=sorted(METRICS))
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default CUDA, raising without a "
                        "card; cpu runs the kernels' plain versions)")
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "float32", "float64"])
    p.add_argument("--solve-method", default="auto",
                   choices=["auto", "block_inverse", "cholesky", "pallas"])
    p.add_argument("--chunk", type=int, default=None,
                   help="frames per batched fit (EaqhmConfig.chunk)")
    p.add_argument("--n-utts", type=int, default=None,
                   help="utterances of configs 3, 5, 6 (defaults 64, 16, "
                        "16)")
    p.add_argument("--seconds", type=float, default=None,
                   help="seconds per utterance of configs 3, 5, 6 "
                        "(default 2), of config 4's signal (default 60)")
    p.add_argument("--wav", default=None,
                   help="input of configs 1, 2 and the corpus recording of "
                        "3, 5, 6 (default: the SA19 resynthesis)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    run = Run(args.device, args.dtype, args.solve_method, args.chunk,
              args.wav)
    kw = {}
    if args.seconds is not None:
        kw["seconds"] = args.seconds
    n = args.config
    if n in (1, 2):
        line, _ = {1: bench_config1, 2: bench_config2}[n](
            run, repeats=args.repeats)
    elif n == 4:
        line, _ = bench_config4(run, repeats=max(1, args.repeats - 2), **kw)
    else:
        size = {3: "batch", 5: "n_utts", 6: "n_utts"}[n]
        if args.n_utts is not None:
            kw[size] = args.n_utts
        line, _ = {3: bench_config3, 5: bench_config5, 6: bench_config6}[n](
            run, repeats=args.repeats, **kw)
    return line


if __name__ == "__main__":
    main()
