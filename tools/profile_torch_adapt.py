"""Device-time breakdown of eaqhm_torch.analyze on one CUDA GPU.

Runs the port's main path (the golden SA19 resynthesis of
tests/golden/sa19_golden.npz, female preset) for each configuration asked:
two calls to warm up (the first builds kernels and, for the fused loop,
captures its graph), three timed warm calls without the profiler, then one
under torch.profiler.  A configuration is DTYPE[:SOLVE_METHOD][:fused]
(e.g. float32:block_inverse, float64:fused).  Prints, per configuration:
warm wall seconds (unprofiled, each call), the profiled call's wall, device
busy seconds and idle share against both walls, per-adaptation seconds,
device time per layer span (eaqhm/pitch, eaqhm/fit, eaqhm/solve,
eaqhm/tracks; graph replays run no spans) and the top kernels; the whole
report goes to <out>.json and, with --trace, a Chrome trace per
configuration to <out>_<config>.json (default <out>: build/profile, which
.gitignore lists).

    python3 tools/profile_torch_adapt.py [--configs float64 float32 ...]
                                         [--out OUT_PREFIX] [--trace]
"""
import argparse
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
sys.path.insert(0, ROOT)
import eaqhm_torch  # noqa: E402

SPANS = ("eaqhm/pitch", "eaqhm/fit", "eaqhm/solve", "eaqhm/tracks",
         "eaqhm/adapt_loop")


def config_of(spec):
    parts = spec.split(":")
    kw = {"gender": "female", "dtype": parts[0]}
    for p in parts[1:]:
        if p == "fused":
            kw["fused_adapt_loop"] = True
        else:
            kw["solve_method"] = p
    return eaqhm_torch.EaqhmConfig(**kw)


def profile_config(sig, spec, out, trace):
    cfg = config_of(spec)
    for _ in range(2):                                           # warm-up
        eaqhm_torch.analyze(sig, 16000, cfg, device="cuda")
    torch.cuda.synchronize()
    warm = []
    for _ in range(3):
        t0 = time.time()
        res = eaqhm_torch.analyze(sig, 16000, cfg, device="cuda")
        torch.cuda.synchronize()
        warm.append(time.time() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = eaqhm_torch.analyze(sig, 16000, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    if trace:
        prof.export_chrome_trace(f"{out}_{spec.replace(':', '_')}.json")
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
    return {
        "config": spec, "srer": res.srer, "warm_wall_s": warm,
        "profiled_wall_s": wall, "device_busy_s": busy,
        # against the median unprofiled wall (the profiler slows the host)
        "device_idle_share": 1.0 - busy / sorted(warm)[1],
        "device_idle_share_profiled": 1.0 - busy / wall,
        "per_adaptation_s": [m["seconds"] for m in res.metrics],
        "fused": res.fused, "timings": res.timings,
        "span_device_s": spans, "top_kernels": kernels, "tiers": res.tiers,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=["float64", "float32"])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--trace", action="store_true",
                    help="also write a Chrome trace per configuration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_adapt: no CUDA device")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    sig = np.load(os.path.join(ROOT, "tests", "golden",
                               "sa19_golden.npz"))["s_recon"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    report = {"card": card, "torch": torch.__version__,
              "runs": [profile_config(sig, c, args.out, args.trace)
                       for c in args.configs]}
    with open(args.out + ".json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
