"""Device-time breakdown of eaqhm_torch.analyze on one CUDA GPU.

Runs the port's main path for each configuration asked, on the golden SA19
resynthesis of tests/golden/sa19_golden.npz (female preset; --signal sa19,
the default), on config 4's stress signal (benchmarks.stress_signal(),
60 s, male preset, max_adaptations=10; --signal stress) or on the wide
phase's 48 kHz tone of chip_smoke.py (benchmarks.stress_signal(0.15,
48000, 55.0), gender (50, 180), max_adaptations=2, the top tier at
M = 1950; --signal wide48): ``--warm`` calls
to warm up (the first builds kernels and, for the fused loop, captures its
graph), ``--timed`` warm calls without the profiler, then one under
torch.profiler.  A configuration is DTYPE[:SOLVE_METHOD][:fused] (e.g.
float32:block_inverse, float64:fused).  The kernels are built first.
Prints, per configuration: the first call's wall seconds, warm wall seconds (unprofiled, each call), the profiled call's wall, device busy
seconds and idle share against both walls, per-adaptation seconds, device
time per layer span (eaqhm/pitch, eaqhm/fit, eaqhm/solve, eaqhm/tracks;
graph replays run no spans: the span's range on the device timeline, from
its first kernel to its last, host gaps included), the tracks span per
adaptation (its device time and the launches made inside it: kernels,
copies and memsets the host issued between the span's start and end),
the pitch span's work (``pitch_span``: the launches the host issued inside
it, by kind (kernels, copies, memsets), its host-to-device copies, and its
device busy time, the sum of the device events of those
launches, kept apart from the span's timeline range), the engine's
``pitch_dispatch`` and ``pitch`` timings of the profiled call (and the
first call's ``pitch_dispatch``, which builds the plan's device tables, and
each unprofiled warm call's, ``warm_pitch_dispatch_s``), the DFT tables
the pitch stage keeps on the card after the calls (``dft_cache_bytes``: the
full bases, and the compact tables where the package has them), and the
top kernels.  With
--peaks, one more unprofiled call per configuration measures the peak
device memory of each stage: the peak is reset just before every call of
the fit (iqhm_gram_tables / eaqhm_gram_tables), the solve (solve_gram)
and the tracks stage (engine._Adapter._finish) and read just after it
(the device synchronized on both sides), and the largest reading per
stage is kept beside the call's own peak.  The whole report goes to
<out>.json and, with --trace, a Chrome trace per configuration to
<out>_<config>.json (default <out>: build/profile, which .gitignore lists).
With PYTHONPATH naming another checkout, that checkout's package runs (this
one is appended to sys.path after it).

    python3 tools/profile_torch_adapt.py [--configs float64 float32 ...]
                                         [--signal sa19|stress|wide48]
                                         [--peaks]
                                         [--warm N] [--timed N]
                                         [--out OUT_PREFIX] [--trace]
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)
import eaqhm_torch  # noqa: E402
from eaqhm_torch import benchmarks  # noqa: E402

SPANS = ("eaqhm/pitch", "eaqhm/fit", "eaqhm/solve", "eaqhm/tracks",
         "eaqhm/adapt_loop")
# host-side runtime calls that put work on the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaGraphLaunch")


def config_of(spec, signal):
    parts = spec.split(":")
    kw = {"sa19": {"gender": "female"},
          "stress": {"gender": "male", "max_adaptations": 10},
          "wide48": {"gender": (50.0, 180.0), "max_adaptations": 2}}[signal]
    kw["dtype"] = parts[0]
    for p in parts[1:]:
        if p == "fused":
            kw["fused_adapt_loop"] = True
        else:
            kw["solve_method"] = p
    return eaqhm_torch.EaqhmConfig(**kw)


def span_work(prof, name):
    """What the host put on the device inside the span ``name``, summed over
    its instances: the runtime calls issued between its start and end by
    kind, the device events they made (matched by correlation id), the
    host-to-device copies among them, and the device busy
    seconds (the sum of those events' durations, no gap counted)."""
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == name and e.device_type == DeviceType.CPU)
    calls = [e for e in events if e.name in LAUNCHES
             and e.device_type == DeviceType.CPU
             and any(a <= e.time_range.start <= b for a, b in spans)]
    ids = {e.id for e in calls}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.id in ids and e.name not in SPANS]
    h2d = [e for e in dev if "HtoD" in e.name]
    return {
        "spans": len(spans),
        "launches": len(calls),
        "kernel_launches": sum("Kernel" in e.name for e in calls),
        "copies": sum("Memcpy" in e.name for e in calls),
        "memsets": sum("Memset" in e.name for e in calls),
        "device_events": len(dev),
        "h2d_copies": len(h2d),
        "device_busy_s": sum(e.time_range.end - e.time_range.start
                             for e in dev) / 1e6,
    }


def span_launches(prof, name):
    """Launches the host issued inside each instance of the span ``name``
    (runtime events whose start falls in the span's host interval)."""
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == name and e.device_type == DeviceType.CPU)
    starts = sorted(e.time_range.start for e in events
                    if e.name in LAUNCHES)
    out = []
    for a, b in spans:
        out.append(int(np.searchsorted(starts, b, side="right")
                       - np.searchsorted(starts, a, side="left")))
    return out


@functools.lru_cache(maxsize=None)
def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def stage_peaks(sig, fs, cfg):
    """One call with the peak device memory reset before every fit, solve
    and tracks-stage call and read after it: {stage: largest peak GiB}."""
    from eaqhm_torch.models import engine
    from eaqhm_torch.ops import solver
    peaks = {"fit": 0.0, "solve": 0.0, "tracks": 0.0}

    def wrap(owner, attr, stage):
        orig = getattr(owner, attr)

        def run(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            peaks[stage] = max(peaks[stage],
                               torch.cuda.max_memory_allocated() / 2**30)
            return out
        setattr(owner, attr, run)
        return orig

    patched = [(solver, "iqhm_gram_tables", "fit"),
               (solver, "eaqhm_gram_tables", "fit"),
               (solver, "solve_gram", "solve"),
               (engine._Adapter, "_finish", "tracks")]
    origs = [wrap(*p) for p in patched]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = eaqhm_torch.analyze(sig, fs, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        for (owner, attr, _), orig in zip(patched, origs):
            setattr(owner, attr, orig)
    torch.cuda.synchronize()
    return {"stage_peak_gib": peaks, "wall_s": wall, "srer": res.srer,
            "call_peak_gib_after_last_stage":
                torch.cuda.max_memory_allocated() / 2**30}


def profile_config(sig, fs, spec, args):
    from eaqhm_torch.ops import stft
    cfg = config_of(spec, args.signal)
    first = first_pitch = None
    for _ in range(args.warm):
        t0 = time.time()
        r = eaqhm_torch.analyze(sig, fs, cfg, device="cuda")
        torch.cuda.synchronize()
        if first is None:
            first = time.time() - t0
            first_pitch = r.timings.get("pitch_dispatch")
    warm, warm_pitch = [], []
    for _ in range(args.timed):
        t0 = time.time()
        res = eaqhm_torch.analyze(sig, fs, cfg, device="cuda")
        torch.cuda.synchronize()
        warm.append(time.time() - t0)
        warm_pitch.append(res.timings.get("pitch_dispatch"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = eaqhm_torch.analyze(sig, fs, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    if args.trace:
        prof.export_chrome_trace(f"{args.out}_{spec.replace(':', '_')}.json")
    avg = prof.key_averages()
    # device work = the CUDA-side events (kernels, copies).  The spans'
    # CUDA-side entries are GPU annotations: the device-timeline range from
    # the first to the last kernel a span launched, summed over its calls.
    dev = [e for e in avg
           if e.device_type == DeviceType.CUDA and e.key not in SPANS]
    busy_us = sum(e.self_device_time_total for e in dev)
    spans = {e.key: e.self_device_time_total / 1e6 for e in avg
             if e.device_type == DeviceType.CUDA and e.key in SPANS}
    kernels = sorted(((e.key[:120], e.self_device_time_total / 1e6, e.count)
                      for e in dev), key=lambda k: -k[1])[:15]
    busy = busy_us / 1e6
    tracks_launches = span_launches(prof, "eaqhm/tracks")
    n_tracks = len(tracks_launches)
    out = {
        "config": spec, "signal": args.signal, "srer": res.srer,
        "first_call_s": first, "warm_wall_s": warm, "profiled_wall_s": wall,
        "device_busy_s": busy,
        # against the median unprofiled wall (the profiler slows the host)
        "device_idle_share": 1.0 - busy / sorted(warm)[len(warm) // 2],
        "device_idle_share_profiled": 1.0 - busy / wall,
        "per_adaptation_s": [m["seconds"] for m in res.metrics],
        "fused": res.fused, "timings": res.timings,
        "span_device_s": spans,
        "tracks_spans": n_tracks,
        "tracks_device_s_per_span": (spans.get("eaqhm/tracks", 0.0)
                                     / max(n_tracks, 1)),
        "tracks_launches_per_span": tracks_launches,
        "pitch_span": span_work(prof, "eaqhm/pitch"),
        "pitch_timings_s": {k: res.timings.get(k) for k in
                            ("pitch_dispatch", "vad", "pitch")},
        "first_pitch_dispatch_s": first_pitch,
        "warm_pitch_dispatch_s": warm_pitch,
        # DFT tables the pitch stage keeps on the card after the calls
        "dft_cache_bytes": {
            "bases": stft.basis_cache_bytes(),
            "columns": (stft.columns_cache_bytes()
                        if hasattr(stft, "columns_cache_bytes") else None)},
        "top_kernels": kernels, "tiers": res.tiers,
    }
    if args.peaks:
        out["peaks"] = stage_peaks(sig, fs, cfg)
    out["card"] = _card()
    print(json.dumps({k: out[k] for k in (
        "config", "signal", "card", "first_call_s", "warm_wall_s",
        "device_idle_share", "span_device_s", "tracks_spans",
        "tracks_device_s_per_span", "tracks_launches_per_span", "pitch_span",
        "pitch_timings_s", "first_pitch_dispatch_s", "warm_pitch_dispatch_s",
        "dft_cache_bytes")
        + (("peaks",) if args.peaks else ())}),
        flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=["float64", "float32"])
    ap.add_argument("--signal", choices=("sa19", "stress", "wide48"),
                    default="sa19")
    ap.add_argument("--peaks", action="store_true",
                    help="also the peak device memory of each stage")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--timed", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--trace", action="store_true",
                    help="also write a Chrome trace per configuration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_adapt: no CUDA device")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    from eaqhm_torch.kernels import build      # built before the first call
    for name in build.KERNELS:
        build.load(name)
    fs = benchmarks.FS
    if args.signal == "sa19":
        sig = np.load(os.path.join(ROOT, "tests", "golden",
                                   "sa19_golden.npz"))["s_recon"]
    elif args.signal == "wide48":
        fs = 48000
        sig = benchmarks.stress_signal(0.15, fs, 55.0)
    else:
        sig = benchmarks.stress_signal()
    report = {"card": _card(), "torch": torch.__version__,
              "package": os.path.dirname(eaqhm_torch.__file__),
              "runs": [profile_config(sig, fs, c, args)
                       for c in args.configs]}
    with open(args.out + ".json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
