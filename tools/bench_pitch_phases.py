"""Where the SWIPE' pitch stage's time goes, on one CUDA GPU.

Times each step of the port's pitch stage as the engines call it
(``models.swipe.f0_grid``: the loudness kernel and the candidate-kernel
product per window size, then the pick kernel writing the 5 ms f0 grid) at
the plans of the main paths:

  sa19      the golden SA19 resynthesis (tests/golden/sa19_golden.npz),
            female, padded to the 4096-sample page as ``analyze`` pads it
  stress    config 4's 60 s signal (benchmarks.stress_signal()), male
  corpus64  64 two-second utterances (parallel.corpus.corpus_signals of the
            resynthesis, L = 32,000), female, all 64 in one call
  wide48    the wide phase's 48 kHz tone (benchmarks.stress_signal(0.15,
            48000, 55.0)), gender (50, 180)

Steps, per call (a batch [B, L] in one call): the device-plan lookup (host
clock), ``swipe_loudness`` (from the signal), the kernel GEMM and
``swipe_pick`` (the grid) (CUDA events), and the plain versions timed on the
same inputs beside them (the DFT GEMM on the full bases, the loudness's
torch ops, the pick's and the resample's torch ops).  The parent commit's
steps come from that commit's own copy of this tool run with its package
in the same chip call (its route: the DFT GEMM, its loudness kernel, the
kernel GEMM, its pick kernel over every step, then the resample's torch
ops).

The same kernels' device time with no host gap: ``loudness_graph_ms`` and
``pick_grid_graph_ms``, 5 calls captured into a CUDA graph and replayed,
ms a call, and ``loudness_kernels_us``, the profiler's device time of each
of the loudness's two kernels (the DFT and the ERB pass), us a call.

Beside the steps, ``call_ms``: the package's own ``f0_grid`` and one fetch
to the host, as the engines call them (host clock, warm,
synchronized), and for corpus64 the batch engine's ``_prepare`` (the pitch,
the host VAD and prologue and the tier plans of 64 utterances; host clock)
with its ``_host_prologue`` timed inside it.  Both types are measured
(float64, float32).  With --walls the corpus64 cell also times the two
corpus paths whole, warm (host clock, synchronized): the sequential
per-utterance engine (``analyze`` of each utterance in turn, config 3's
path on one card) and ``analyze_batch`` of the 64, female,
max_adaptations=6, as audio-s/s.  The card's name and power limit go beside the numbers;
the JSON goes to --out.

    python3 tools/bench_pitch_phases.py [--cells sa19 stress corpus64
        wide48] [--dtypes float64 float32] [--reps 5] [--walls]
        [--out OUT.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)
from eaqhm_torch import benchmarks  # noqa: E402
from eaqhm_torch.config import EaqhmConfig  # noqa: E402
from eaqhm_torch.models import engine, swipe  # noqa: E402
from eaqhm_torch.kernels import build  # noqa: E402
from eaqhm_torch.ops import pitch, stft  # noqa: E402
from eaqhm_torch.parallel import batch_engine  # noqa: E402
from eaqhm_torch.parallel.corpus import corpus_signals, pad_batch  # noqa

CELLS = ("sa19", "stress", "corpus64", "wide48")
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def cell_input(name):
    """(signals [B, L] float64, fs, gender) of a cell."""
    fs = benchmarks.FS
    if name in ("sa19", "corpus64"):
        sig = np.load(os.path.join(ROOT, "tests", "golden",
                                   "sa19_golden.npz"))["s_recon"]
        gender = "female"
        if name == "corpus64":
            x, _ = pad_batch(corpus_signals(sig, 64, fs))
            return x, fs, gender
    elif name == "stress":
        sig, gender = benchmarks.stress_signal(), "male"
    else:
        fs, gender = 48000, (50.0, 180.0)
        sig = benchmarks.stress_signal(0.15, fs, 55.0)
    Lpad = -(-len(sig) // engine.PAGE) * engine.PAGE
    return np.pad(sig, (0, Lpad - len(sig)))[None, :], fs, gender


class Steps:
    """CUDA events at the boundaries of named steps, summed over calls."""

    def __init__(self):
        self.marks = []
        self.host = {}

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def add_host(self, name, seconds):
        self.host[name] = self.host.get(name, 0.0) + seconds * 1e3

    def result(self):
        torch.cuda.synchronize()
        out = dict(self.host)
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if name is not None:
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def kernel_call(plan, x, st: Steps, plain: bool):
    """A batch [B, L] through the kernel route, step by step (plain: the
    plain versions on the same inputs); returns the f0 grid."""
    dtype, dev = x.dtype, x.device
    t0 = time.perf_counter()
    dp = swipe.device_plan(plan, dtype, dev)
    st.add_host("plan_lookup", time.perf_counter() - t0)
    st.mark(None)
    if not plain:
        lns = pitch.loudness(x, dp)
        st.mark("swipe_loudness")
    Si = []
    for i, w in enumerate(dp.windows):
        if plain:
            spec = stft.spectrum(x, w.nfft, w.hop, w.window, w.pad_pre,
                                 w.pad_post)
            st.mark("dft_gemm")
            ln = pitch.loudness_reference(spec, w)
            st.mark("loudness_plain")
        else:
            ln = lns[i]
        Si.append(torch.matmul(ln, w.kernel.t()))
        st.mark("kernel_gemm")
    if plain:
        grid = pitch.grid_reference(Si, dp)
        st.mark("pick_and_resample_plain")
    else:
        grid = pitch.pick(Si, dp, grid=True)
        st.mark("swipe_pick")
    return grid


def engine_call(plan, x):
    """The stage as the engines call it, ending in one fetch to the host."""
    return swipe.f0_grid(plan, x).cpu()


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def graph_ms(fn, reps=5):
    """ms a call of fn: reps calls captured into a CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (3 * reps)


def kernel_us(fn, reps=10):
    """The profiler's device time of each kernel of fn, us a call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("::")[-1]:
            round(e.self_device_time_total / reps, 1)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and "_kernel" in e.key}


def device_times(plan, x):
    """The loudness's and the grid pick's graph-replay ms a call and the
    loudness's kernels' device us a call."""
    dp = swipe.device_plan(plan, x.dtype, x.device)
    Si = [torch.matmul(ln, w.kernel.t())
          for ln, w in zip(pitch.loudness(x, dp), dp.windows)]
    return {"loudness_graph_ms": graph_ms(lambda: pitch.loudness(x, dp)),
            "loudness_kernels_us": kernel_us(lambda: pitch.loudness(x, dp)),
            "pick_grid_graph_ms": graph_ms(
                lambda: pitch.pick(Si, dp, grid=True))}


def steps_of(fn, reps):
    fn(Steps())                                    # warm
    runs = []
    for _ in range(reps):
        st = Steps()
        fn(st)
        runs.append(st.result())
    keys = runs[0].keys()
    return {k: sorted(r[k] for r in runs)[len(runs) // 2] for k in keys}


def prepare_ms(x_np, fs, gender, dtype, reps):
    """The batch engine's _prepare over all utterances, and the host
    prologue inside it (host clock, synchronized)."""
    cfg = EaqhmConfig(gender=gender, max_adaptations=6,
                      dtype=str(dtype)[6:])
    sig_np, lens = pad_batch(list(x_np))
    geom = batch_engine.make_batch_geometry(fs, sig_np.shape[1], cfg, None)
    if geom.length > sig_np.shape[1]:
        sig_np = np.pad(sig_np, ((0, 0), (0, geom.length - sig_np.shape[1])))
    dev = torch.device("cuda", torch.cuda.current_device())
    prologue = []
    orig = batch_engine._host_prologue

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        prologue.append((time.perf_counter() - t0) * 1e3)
        return out

    batch_engine._host_prologue = wrapped
    try:
        walls = timed(lambda: batch_engine._prepare(
            sig_np, lens, geom, cfg, fs, None, dev, dtype,
            range(sig_np.shape[0])), reps)
    finally:
        batch_engine._host_prologue = orig
    return {"prepare_ms": walls, "host_prologue_ms": prologue[1:]}


def corpus_walls(fs, gender, dtype, reps):
    """Warm audio-s/s of the sequential engine and of analyze_batch on the
    64 utterances of corpus64 (their unpadded signals)."""
    import eaqhm_torch
    sig = np.load(os.path.join(ROOT, "tests", "golden",
                               "sa19_golden.npz"))["s_recon"]
    sigs = corpus_signals(sig, 64, fs)
    audio = sum(len(s) for s in sigs) / fs
    cfg = EaqhmConfig(gender=gender, max_adaptations=6,
                      dtype=str(dtype)[6:])
    seq = timed(lambda: [eaqhm_torch.analyze(s, fs, cfg, device="cuda")
                         for s in sigs], reps)
    bat = timed(lambda: batch_engine.analyze_batch(sigs, fs, cfg,
                                                   device="cuda"), reps)
    return {"sequential_audio_s_per_s": [audio / (t / 1e3) for t in seq],
            "analyze_batch_audio_s_per_s": [audio / (t / 1e3) for t in bat]}


def run_cell(name, dtype, reps, walls=False):
    x_np, fs, gender = cell_input(name)
    f0min, f0max = EaqhmConfig(gender=gender).pitch_limits
    B, L = x_np.shape
    plan = swipe.make_plan(float(fs), float(f0min), float(f0max), L)
    x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
    out = {"cell": name, "dtype": str(dtype)[6:], "B": B, "L": L,
           "fs": fs, "windows": [w.nfft for w in plan.windows],
           "nc": len(plan.pc), "T": len(plan.t)}

    out["kernel_steps_ms"] = steps_of(
        lambda st: kernel_call(plan, x, st, False), reps)
    out["plain_steps_ms"] = steps_of(
        lambda st: kernel_call(plan, x, st, True), reps)
    out.update(device_times(plan, x))
    out["call_ms"] = timed(lambda: engine_call(plan, x), reps)
    if name == "corpus64":
        out.update(prepare_ms(x_np, fs, gender, dtype, max(2, reps // 2)))
        if walls:
            out.update(corpus_walls(fs, gender, dtype, 2))
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", choices=CELLS, default=list(CELLS))
    ap.add_argument("--dtypes", nargs="+", choices=tuple(DTYPES),
                    default=list(DTYPES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--walls", action="store_true",
                    help="also the corpus paths' warm audio-s/s (corpus64)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "pitch_phases.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_pitch_phases: no CUDA device")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    build.load("swipe")
    report = {"card": card(), "torch": torch.__version__,
              "package": os.path.dirname(swipe.__file__),
              "runs": [run_cell(c, DTYPES[d], args.reps, args.walls)
                       for c in args.cells for d in args.dtypes]}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"card": report["card"], "package": report["package"],
                      "out": args.out}))


if __name__ == "__main__":
    main()
