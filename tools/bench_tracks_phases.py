"""Where the tracks kernels' time goes, on one CUDA GPU.

Times ``ops.tracks.track_spline``, ``ops.tracks.track_synth`` (and the
whole ``ops.tracks.stage``) and ``ops.tracks.masked_srer`` (the kernel
track_srer) at the launch shapes of the main paths, on
seeded anchor grids of each shape (``tests/torch_track_cases.anchor_case``:
runs of every length, a column with no run, values outside the
acceptance): the device's time of --reps calls captured into a CUDA graph
and replayed (CUDA events around the replays).  Beside each time:
the kernel's bound (chip_smoke.py ``tracks_costs``: the anchors read once
and each output written once at 3.35 TB/s, against its operations), the
registers and spilled bytes ptxas reported for each kernel of the library,
and the blocks a SM holds at that launch (``ops.tracks.occupancy``, where
the package has it).

The kernels are reached only through the functions of ``ops.tracks``, and
this checkout's own package is imported only where PYTHONPATH names no
other, so the same command times another commit's kernels:

    git archive <commit> | tar -x -C build/parent
    PYTHONPATH=build/parent python3 tools/bench_tracks_phases.py \\
        --out build/tracks_parent.json

With --clocks the kernels also run from a second build of
``kernels/csrc/tracks.cu`` with -DTRACKS_PHASE_CLOCKS (the port's own build
has no clocks): clock64 cycles per block by phase, as thread 0 of each
block sees them (``track_phase_clocks``, the kinds and phases the package
names in ``CLOCK_KINDS`` / ``CLOCK_PHASES``; skipped for a package without
them).  SA19's cells also time ``ops.tracks.stage_tiers`` (the same anchors
as three tiers read through the frame map) where the package has it.
The card's name and power limit go beside the numbers; the JSON goes to
--out.

With --line FILE it times instead the kernels line of chip_smoke.py:
track_spline, track_synth and track_srer at every launch shape of the main
paths, on
the same seeded inputs and with the same replays as chip_smoke.py, summed
over the paths' launches.  chip_smoke.py writes FILE
(eaqhm_torch/kernels/build/tracks_line_shapes.json); with PYTHONPATH naming
an older commit the sums are that commit's kernels measured the same way.

    python3 tools/bench_tracks_phases.py [--out build/tracks_phases.json]
        [--cells sa19 stress batch] [--reps 5] [--clocks]
        [--line eaqhm_torch/kernels/build/tracks_line_shapes.json]
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# after PYTHONPATH: a checkout named there is imported before this one
sys.path.append(ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
from eaqhm_torch.kernels import build  # noqa: E402
from eaqhm_torch.ops import tracks  # noqa: E402
from torch_track_cases import anchor_case  # noqa: E402


def _own(name, path):
    """A module of this checkout by its path, whatever PYTHONPATH names."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT,
                                                                     path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _own("chip_smoke", "chip_smoke.py")      # timing and bounds
own_build = _own("own_build", "eaqhm_torch/kernels/build.py")

STEP = 15
ENGINE = ("sum", True, False, True, True)     # engine._Adapter._finish
BATCH = ("apart", False, False, False, False)  # batch_engine
# (group, name, dtype, G, n, K, L, fs, mode): the launch shapes of the main
# paths that take most of the tracks kernels' time (chip_smoke.py's kernels
# line): SA19's stages (16 kHz, tiers to Kc = 32 / 48), the stress stage
# (60 s, Kc = 128) and the batch engine's Corpus-64 and 8-utterance stages
CELLS = (
    ("sa19", "sa19_f32_K48", "float32", 1, 2185, 48, 32768, 16000.0, ENGINE),
    ("sa19", "sa19_f32_K32", "float32", 1, 2185, 32, 32768, 16000.0, ENGINE),
    ("sa19", "sa19_f64_K48", "float64", 1, 2185, 48, 32768, 16000.0, ENGINE),
    ("sa19", "sa19_f64_K32", "float64", 1, 2185, 32, 32768, 16000.0, ENGINE),
    ("sa19", "sa19_f64_4369_K48", "float64", 1, 4369, 48, 65536, 16000.0,
     ENGINE),
    ("stress", "stress_f32", "float32", 1, 64171, 128, 962560, 16000.0,
     ENGINE),
    ("stress", "stress_f64", "float64", 1, 64171, 128, 962560, 16000.0,
     ENGINE),
    ("batch", "batch64_f64", "float64", 64, 2134, 59, 32000, 16000.0, BATCH),
    ("batch", "batch8_f64", "float64", 8, 2134, 59, 32000, 16000.0, BATCH),
)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms of fn on the device timeline (chip_smoke.py graph_ms: reps
    calls captured into a CUDA graph and replayed, so the host's time to
    issue them leaves no gap), the counts' capture record cleared."""
    ms = chip_smoke.graph_ms(fn, reps)
    if hasattr(tracks, "take_captured"):
        tracks.take_captured()
    return ms


def inputs(dtype, G, n, K, L, fs, mode, seed):
    """The anchors of one launch on the card, masked as its caller masks
    them (the batch engine passes masked values and no masks)."""
    dc, anchors, dense, acc, voiced = mode
    dt = getattr(torch, dtype)
    c = anchor_case(seed, G=G, n=n, K=K, step=STEP,
                    extra=L - (n - 1) * STEP - 1, fs=fs)
    t = {k: torch.as_tensor(c[k], device="cuda")
         for k in ("am", "fm", "ph", "acc", "a0", "voiced", "det", "lens")}
    for k in ("am", "fm", "ph", "a0", "det"):
        t[k] = t[k].to(dt)
    if not acc:
        for k in ("am", "fm", "ph"):
            t[k] = torch.where(t["acc"], t[k], 0)
    if not voiced:
        t["a0"] = torch.where(t["voiced"], t["a0"], 0)
    kw = dict(acc=t["acc"] if acc else None,
              voiced=t["voiced"] if voiced else None)
    return t, kw, dict(dc=dc, anchors=anchors, dense=dense)


def read_clocks(lib):
    """{kind: {phase: cycles per block, blocks}} since the last read (the
    read zeroes them), by the package's CLOCK_KINDS and CLOCK_PHASES."""
    kinds = tracks.CLOCK_KINDS
    buf = (ctypes.c_ulonglong * (len(kinds) * 8))()
    assert lib.track_phase_clocks(buf) == 0
    out = {}
    for k, kind in enumerate(kinds):
        c = buf[8 * k:8 * (k + 1)]
        if c[7] == 0:
            continue
        row = {"blocks": c[7]}
        phases = tracks.CLOCK_PHASES[kind.rsplit("_", 1)[0]]
        for i, name in enumerate(phases):
            if c[i]:
                row[name] = c[i] / c[7]
        out[kind] = row
    return out


def ptxas_report(defines=()):
    """Registers and spill bytes per kernel of the tracks library of the
    package imported (its build's ptxas report, read by this checkout's
    kernels/build.py)."""
    flags = (tuple(build.NVCC_FLAGS) + tuple(build.EXTRA_FLAGS.get(
        "tracks", ())) + tuple(f"-D{d}" for d in defines))
    return own_build.read_ptxas(build._lib_path("tracks", flags)
                                + ".ptxas.txt")


def tier_inputs(t, kw, n):
    """Three tiers (Kb = K - 16, K - 8, K) holding the grid's frames in
    turn, and the frame map: the sequential engine's form of the same
    anchors (ops.tracks.stage_tiers)."""
    K = t["am"].shape[2]
    dev = t["am"].device
    frames = torch.randperm(n, generator=torch.Generator().manual_seed(n))
    idx = [frames[i::3].sort().values.to(dev) for i in range(3)]
    parts = []
    for kb, ix in zip((K - 16, K - 8, K), idx):
        parts.append((t["a0"][0, ix], t["am"][0, ix, :kb],
                      t["fm"][0, ix, :kb], t["ph"][0, ix, :kb],
                      kw["acc"][0, ix, :kb]))
    fmap = tracks.tier_map(idx, n, dev)
    return tracks.Tiers(fmap, tuple(parts), K)


def run_cell(cell, reps, clocked):
    group, name, dtype, G, n, K, L, fs, mode = cell
    t, kw, md = inputs(dtype, G, n, K, L, fs, mode, seed=7000 + n + K + G)
    am, fm, ph, a0 = t["am"], t["fm"], t["ph"], t["a0"]
    acc, voiced = kw["acc"], kw["voiced"]

    def spline():
        return tracks.track_spline(am, fm, acc, a0, voiced, STEP)
    M = spline()

    def synth():
        return tracks.track_synth(am, fm, ph, acc, a0, voiced, M, STEP, fs,
                                  L, **md)

    def stage():
        return tracks.stage(am, fm, ph, a0, STEP, fs, L, **kw, **md)
    det, s_rec, skw = chip_smoke.srer_inputs(torch, t, stage(), md["dc"])
    ms = {"track_spline": cuda_ms(spline, reps),
          "track_synth": cuda_ms(synth, reps), "stage": cuda_ms(stage, reps),
          "track_srer": cuda_ms(lambda: tracks.masked_srer(det, s_rec, **skw),
                                reps)}
    if hasattr(tracks, "stage_tiers") and group == "sa19":
        tiers = tier_inputs(t, kw, n)
        ms["stage_tiers"] = cuda_ms(lambda: tracks.stage_tiers(
            tiers, STEP, fs, L, voiced=voiced, **md), reps)
    key = (G, n, K, L, STEP, fs, mode, dtype)
    isz = am.element_size()
    bound = {}
    for kname, (nbytes, ops) in zip(("track_spline", "track_synth",
                                     "track_srer"),
                                    chip_smoke.tracks_costs(key, isz)):
        bound[kname] = max(nbytes / chip_smoke.HBM_BYTES_S * 1e3,
                           ops / chip_smoke.PEAK_FLOP_S[dtype] * 1e3)
    rec = {"group": group, "cell": name, "dtype": dtype, "G": G, "n": n,
           "K": K, "L": L, "ms": ms, "bound_ms": bound,
           "x_bound": {k: ms[k] / bound[k] for k in bound}}
    occ = getattr(tracks, "occupancy", None)
    if occ is not None:
        rec["blocks_per_sm"] = {k: occ(k, G, n, K, STEP, L, am.dtype)
                                for k in ("track_spline", "track_synth")}
    if clocked is not None:
        plain_lib = tracks.library
        tracks.library = lambda *a: clocked
        try:
            spline()
            synth()
            torch.cuda.synchronize()
            read_clocks(clocked)
            spline()
            torch.cuda.synchronize()
            rec["clocks_spline"] = read_clocks(clocked)
            synth()
            torch.cuda.synchronize()
            rec["clocks_synth"] = read_clocks(clocked)
        finally:
            tracks.library = plain_lib
    del t, M
    torch.cuda.empty_cache()
    return rec


def line_sums(path):
    """Sums over the kernels line's launches (chip_smoke.py tracks_phase:
    count x ms of 10 calls replayed, 3 for a shape launched once) of
    track_spline, track_synth and track_srer, on chip_smoke.py's inputs."""
    with open(path) as f:
        rows = json.load(f)
    tot = {"track_spline": 0.0, "track_synth": 0.0, "track_srer": 0.0}
    calls = 0
    for *key, count, seed in rows:
        G, n, K, L, step, fs, mode, tname = key
        key = (G, n, K, L, step, fs, tuple(mode), tname)
        t, args, kw, md = chip_smoke.tracks_inputs(torch, key, seed)
        am, fm, ph, a0 = args[:4]
        acc, voiced = kw["acc"], kw["voiced"]
        M = tracks.track_spline(am, fm, acc, a0, voiced, step)
        reps = 10 if count > 1 else 3
        tot["track_spline"] += count * cuda_ms(lambda: tracks.track_spline(
            am, fm, acc, a0, voiced, step), reps)
        tot["track_synth"] += count * cuda_ms(lambda: tracks.track_synth(
            am, fm, ph, acc, a0, voiced, M, step, fs, L, **md), reps)
        got = tracks.stage(*args, **kw, **md)
        det, s_rec, skw = chip_smoke.srer_inputs(torch, t, got, md["dc"])
        tot["track_srer"] += count * cuda_ms(lambda: tracks.masked_srer(
            det, s_rec, **skw), reps)
        calls += count
        del t, args, M, got
        torch.cuda.empty_cache()
    return {"ms": tot, "calls": calls, "shapes": len(rows)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/tracks_phases.json")
    ap.add_argument("--cells", nargs="*", default=None,
                    help="groups or cell names (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--clocks", action="store_true",
                    help="phase clocks from a TRACKS_PHASE_CLOCKS build")
    ap.add_argument("--line", default=None,
                    help="chip_smoke.py's tracks_line_shapes.json: the "
                         "kernels line's sums instead of the cells")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_tracks_phases: no CUDA device")
    card = smi("name,power.limit")
    print(f"card: {card}; package: {os.path.dirname(tracks.__file__)}",
          flush=True)
    report = {"card": card, "package": os.path.dirname(tracks.__file__),
              "torch": torch.__version__, "cells": []}
    tracks.library()
    report["ptxas"] = ptxas_report()
    print("ptxas " + json.dumps(report["ptxas"]), flush=True)
    clocked = None
    if args.clocks:
        if "track_phase_clocks" in build.KERNELS["tracks"][1] and \
                hasattr(tracks, "CLOCK_KINDS"):
            clocked = build.load("tracks", ("TRACKS_PHASE_CLOCKS",))
            if "track_prepare" in build.KERNELS["tracks"][1]:
                assert clocked.track_prepare() == 0
            report["ptxas_clocked"] = ptxas_report(("TRACKS_PHASE_CLOCKS",))
        else:
            report["clocks"] = "this package has no clocked build"
            print("clocks: this package has no clocked build", flush=True)
    # the card at its clocks before the first reading: a second of launches
    warm = torch.randn((8192, 8192), device="cuda")
    t_end = torch.cuda.Event(enable_timing=True)
    t0 = torch.cuda.Event(enable_timing=True)
    t0.record()
    while True:
        warm = warm @ warm.T * 1e-4
        t_end.record()
        t_end.synchronize()
        if t0.elapsed_time(t_end) > 1000:
            break
    del warm
    if args.line:
        report["line"] = line_sums(args.line)
        print("line " + json.dumps(report["line"]), flush=True)
    for cell in () if args.line else CELLS:
        if args.cells and cell[0] not in args.cells and \
                cell[1] not in args.cells:
            continue
        rec = run_cell(cell, args.reps, clocked)
        report["cells"].append(rec)
        print(json.dumps(rec), flush=True)
    report["sm_clock_after"] = smi("clocks.sm")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
