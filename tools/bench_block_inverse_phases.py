"""Where the block-inverse kernel's time goes, phase by phase, on one CUDA
GPU.

Builds eaqhm_torch/kernels/csrc/block_inverse.cu a second time with
-DBI_PHASE_CLOCKS (a separate library: the port's own build has no clocks)
and runs block_inverse_solve on it at the kernel cells of chip_smoke.py
(BI_CELLS, both types, and SA19's top tier 154 x 194).  For each (type, B,
M, path) it prints the time of one call on the plain build and on the
clocked build (CUDA events, warm, mean of 5), and for each kernel of the
call (resident, subtree, refinement) the cycles per block of each phase
of a block's timeline (thread 0's clock64 at each phase's end, barrier
waits included): load, the nodes of order <= 32 but for their leaves
(small_nodes), their Gauss-Jordan leaves (gj_leaves), the products of the
recursion's levels by depth (level0 the top), x = Ri b with the
refinements, the gate, output.  On the hybrid path it also times each step
of one call of the plain build with CUDA events recorded after it: each
subtree launch, each level's T and U (torch.matmul, baddbmm_), Sc and
P^-1 + U T^H with the -U^H copy (the module's level_cublas), the
refinement; the module's functions are wrapped for that call only.  The
card's name and power limit and its SM clock under load go beside them;
the JSON goes to --out.

    python3 tools/bench_block_inverse_phases.py
        [--out chiprun_out/bi_phases.json] [--shapes c64:BxM c128:BxM ...]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from eaqhm_torch.kernels import build  # noqa: E402
from eaqhm_torch.ops import block_inverse as bi  # noqa: E402

SLOTS = ("load", "small_nodes", "level0", "level1", "level2", "level3",
         "level4", "refine", "gate", "output", "gj_leaves")
KINDS = ("resident", "subtree", "refine")
CELLS = ((512, 98), (512, 130), (512, 162), (154, 194), (512, 194),
         (512, 238), (512, 386), (256, 514), (64, 770), (16, 1294))
DTYPES = {"c64": torch.complex64, "c128": torch.complex128}


def hpd(B, M, dtype, seed):
    """Random equilibrated HPD systems built on the card (as chip_smoke.py's
    hpd_batch)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c128 = torch.complex128
    A = torch.randn((B, M, M), dtype=c128, generator=g, device="cuda")
    b = torch.randn((B, M), dtype=c128, generator=g, device="cuda")
    R = A @ A.mH / M + torch.eye(M, dtype=c128, device="cuda")
    d = torch.diagonal(R, dim1=-2, dim2=-1).real.sqrt()
    R = R / (d[:, :, None] * d[:, None, :]).to(c128)
    return R.to(dtype).contiguous(), b.to(dtype).contiguous()


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def launch_times(R, b):
    """CUDA-event ms of each step of one hybrid call, and their sums by
    kind of step.  An event is recorded after each outermost call of a
    wrapped function returns (a level's own products and copies count in
    its step)."""
    events = []
    depth = [0]

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((label, ev))

    def timed(fn, label_of):
        def wrapped(*args, **kwargs):
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    mark(label_of(*args))
        return wrapped
    bi.block_inverse_solve(R, b)              # warm
    torch.cuda.synchronize()
    saved = (bi._launch, bi.level_cublas, torch.matmul,
             torch.Tensor.baddbmm_)
    bi._launch = timed(saved[0], lambda fn, *a: "subtree" if "invert" in fn
                       else "refine")
    bi.level_cublas = timed(saved[1], lambda mode, *a: ("Sc", "P")[mode])
    torch.matmul = timed(saved[2], lambda *a: "T")
    torch.Tensor.baddbmm_ = timed(saved[3], lambda *a: "U")
    try:
        mark("start")
        bi.block_inverse_solve(R, b)
    finally:
        (bi._launch, bi.level_cublas, torch.matmul,
         torch.Tensor.baddbmm_) = saved
    torch.cuda.synchronize()
    per = [(lab, e0.elapsed_time(e1)) for (_, e0), (lab, e1)
           in zip(events, events[1:])]
    sums = defaultdict(float)
    for lab, ms in per:
        sums[lab] += ms
    return per, dict(sums)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "bi_phases.json"))
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="cells as c64:BxM or c128:BxM")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_block_inverse_phases: no CUDA device")
    cells = [(t, B, M) for t in DTYPES for B, M in CELLS]
    if args.shapes:
        cells = []
        for cell in args.shapes:
            t, bm = cell.split(":")
            B, M = (int(v) for v in bm.split("x"))
            cells.append((t, B, M))
    t0 = time.time()
    plain_lib = bi.library
    plain_lib("cuda")
    t1 = time.time()
    clocked = build.load("block_inverse", ("BI_PHASE_CLOCKS",))
    assert clocked.bi_prepare() == 0
    build_s = {"plain": t1 - t0, "clocked": time.time() - t1}
    print(f"build s {build_s}", flush=True)
    clk = (ctypes.c_ulonglong * (len(KINDS) * 12))()
    rows = []
    for t, B, M in cells:
        dt = DTYPES[t]
        R, b = hpd(B, M, dt, seed=M)
        path = bi.path_for(dt, M)
        plain_ms = cuda_ms(lambda: bi.block_inverse_solve(R, b))
        per_launch, by_step = (launch_times(R, b) if path == "hybrid"
                               else (None, None))
        bi.library = lambda device=None: clocked
        try:
            bi.block_inverse_solve(R, b)
            torch.cuda.synchronize()
            assert clocked.bi_phase_clocks(clk) == 0     # zero the counters
            clocked_ms = cuda_ms(lambda: bi.block_inverse_solve(R, b))
            sm_clock = smi("clocks.sm")
            assert clocked.bi_phase_clocks(clk) == 0
        finally:
            bi.library = plain_lib
        phases = {}
        for k, kind in enumerate(KINDS):
            c = clk[12 * k:12 * (k + 1)]
            if c[11] == 0:
                continue
            cyc = {s: c[i] / c[11] for i, s in enumerate(SLOTS) if c[i]}
            total = sum(cyc.values())
            phases[kind] = {"blocks_per_call": c[11] / 6,
                            "cycles_per_block": cyc,
                            "share": {s: v / total for s, v in cyc.items()}}
        sol = bi.block_inverse_solve(R, b)
        ref = bi.solve_reference(R, b)
        err = ((sol.x - ref.x).abs().max() / ref.x.abs().max()).item()
        row = {"dtype": t, "B": B, "M": M, "path": path,
               "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms,
               "sm_clock_under_load": sm_clock, "phases": phases,
               "launch_ms": per_launch, "launch_ms_by_step": by_step,
               "max_rel_err": err}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "launch_ms"}), flush=True)
    report = {"card": smi("name,power.limit"), "torch": torch.__version__,
              "build_s": build_s, "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])


if __name__ == "__main__":
    main()
