"""Where the Cholesky kernel's time goes, phase by phase, on one CUDA GPU.

Builds eaqhm_torch/kernels/csrc/chol_solve.cu a second time with
-DCHOL_PHASE_CLOCKS (a separate library: the port's own build has no
clocks), runs the fused factor + solve at the main path's shapes (SA19
female tiers), at B = 512, M = 258, at the stress widths and at the wide
tiers' orders (M = 770-1950), and prints for each (type, B, M, path) the
kernel time of the plain build and of the clocked build (CUDA events, warm,
mean of 5) and the cycles of each phase (thread 0's clock64 at each
barrier, waits included).  On the resident path: per block of its
timeline, load, diagonal block, panel rows, trailing update, backward
substitution, output.  On the tiled path (a sequence of launches,
chol_tiled_*): each phase's cycles summed over the blocks of its kernels
(the panel kernels: load, four steps, stores; the next diagonal block's
steps inside the trailing update; the update's loads and products, its
epilogue; backward substitution), per block of those kernels and as a
share of all block cycles.  The card's name and power limit and its SM
clock under load go beside them; the JSON goes to --out.  --shapes
replaces the default cells, e.g. the stress configuration's batches
(c128:256x386 c128:128x514 c64:512x386 c64:256x514); a cell may name a
path (c64:512x194:tiled), otherwise the kernel routes it.

--subst cells (the same form; a cell may name a substitution path,
c64:8x1950:one_block) time instead the substitution with a kept factor
(a "guard" factor from the routed factor + solve): its kernel time in the
plain and the clocked build, and thread 0's cycles of each block by phase:
the load (the staged factor, rhs, 1 / diag), the forward and backward
diagonal-block solves, the forward row and backward column updates, the
waits (barriers, and a tiled launch's wait for the launch ahead of it),
the output; summed over the call's blocks, per block and as shares.

    python3 tools/bench_chol_phases.py [--out chiprun_out/chol_phases.json]
                                       [--shapes c128:BxM[:path] ...]
                                       [--subst c64:BxM[:path] ...]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)
from eaqhm_torch.kernels import build  # noqa: E402
from eaqhm_torch.ops import chol  # noqa: E402

PHASES = ("load", "diagonal_block", "panel_rows", "trailing_update",
          "backward_subst", "output")
TILED_PHASES = ("panel_load", "panel_steps", "next_diagonal_steps",
                "panel_stores", "update_products", "update_epilogue",
                "backward")
SHAPES = {torch.complex64: ((2405, 130), (1610, 162), (154, 194), (512, 258),
                            (512, 386), (256, 514), (64, 770), (8, 1950)),
          torch.complex128: ((2304, 130), (1536, 162), (154, 194),
                             (512, 258), (256, 386), (128, 514), (64, 770),
                             (8, 1950))}


def hpd(B, M, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = R / (d[:, :, None] * d[:, None, :])
    b = rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))
    return (torch.as_tensor(R, dtype=dtype, device="cuda"),
            torch.as_tensor(b, dtype=dtype, device="cuda"))


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


SUBST_PHASES = ("load", "forward_diagonal", "forward_rows",
                "backward_diagonal", "backward_columns", "waits", "output")


def subst_rows(lib, cells):
    """The substitution's phase clocks at each (dtype, B, M, path)."""
    clk = (ctypes.c_ulonglong * 8)()
    rows = []
    for dt, B, M, path in cells:
        cname = str(dt).split(".")[-1]
        sym = getattr(lib, "chol_subst_" + cname.replace("complex", "c"))
        R, b = hpd(B, M, dt)
        _, f = chol.chol_solve(R, b, mode="guard", keep_factor=True)
        del R
        x = torch.empty_like(b)
        path = path or chol.subst_path_for(M)
        stream = torch.cuda.current_stream().cuda_stream

        def clocked():
            err = sym(f.L.data_ptr(), f.d.data_ptr(), b.data_ptr(),
                      x.data_ptr(), B, M, chol.SUBST_PATHS.index(path),
                      stream)
            assert err == 0, err

        row = {"entry": "chol_subst", "dtype": cname, "B": B, "M": M,
               "path": path, "kernel_ms": cuda_ms(
                   lambda: chol.chol_subst(f, b, path=path))}
        read = lib.chol_subst_clocks
        clocked()
        torch.cuda.synchronize()
        assert read(clk) == 0                        # zero the counters
        row["clocked_kernel_ms"] = cuda_ms(clocked)
        row["sm_clock_under_load"] = smi("clocks.sm")
        assert read(clk) == 0
        blocks = clk[7]
        total = sum(clk[i] for i in range(7))
        row["blocks"] = blocks
        row["cycles_per_block"] = {p: clk[i] / blocks
                                   for i, p in enumerate(SUBST_PHASES)}
        row["share"] = {p: clk[i] / total
                        for i, p in enumerate(SUBST_PHASES)}
        xr = chol.chol_subst_reference(chol.unpack_factor(f), b)
        row["max_rel_err"] = ((x - xr).abs().max()
                              / xr.abs().max()).item()
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chol_phases.json"))
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="cells as c64:BxM or c128:BxM")
    ap.add_argument("--subst", nargs="+", default=None,
                    help="substitution cells as c64:BxM[:path]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_chol_phases: no CUDA device")
    types = {"c64": torch.complex64, "c128": torch.complex128}
    if args.subst:
        cells = []
        for cell in args.subst:
            t, bm, *route = cell.split(":")
            B, M = (int(v) for v in bm.split("x"))
            cells.append((types[t], B, M, route[0] if route else None))
        lib = build.load("chol_solve", ("CHOL_PHASE_CLOCKS",))
        report = {"card": smi("name,power.limit"),
                  "torch": torch.__version__,
                  "rows": subst_rows(lib, cells)}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(report["card"])
        return
    shapes = {dt: [(B, M, None) for B, M in cells]
              for dt, cells in SHAPES.items()}
    if args.shapes:
        shapes = {torch.complex64: [], torch.complex128: []}
        for cell in args.shapes:
            t, bm, *route = cell.split(":")
            B, M = (int(v) for v in bm.split("x"))
            shapes[{"c64": torch.complex64, "c128": torch.complex128}[t]] \
                .append((B, M, route[0] if route else None))
    lib = build.load("chol_solve", ("CHOL_PHASE_CLOCKS",))
    clk = (ctypes.c_ulonglong * 8)()
    rows = []
    for dt, cells in shapes.items():
        cname = str(dt).split(".")[-1]
        sym = getattr(lib, "chol_factor_solve_" + cname.replace(
            "complex", "c"))
        for B, M, path in cells:
            R, b = hpd(B, M, dt)
            path = path or chol.path_for(dt, M)
            x = torch.empty_like(b)
            L = (torch.empty((B, M * (M + 1) // 2), dtype=dt, device="cuda")
                 if path != "resident" else None)
            d = (torch.empty((B, M), dtype=R.real.dtype, device="cuda")
                 if path == "tiled" else None)
            plan = chol.tiled_plan(M, B) if path == "tiled" else None
            wk = (torch.empty((B, plan.scratch), dtype=R.real.dtype,
                              device="cuda") if plan else None)
            stream = torch.cuda.current_stream().cuda_stream

            def clocked():
                err = sym(R.data_ptr(), b.data_ptr(), x.data_ptr(),
                          None if L is None else L.data_ptr(),
                          None if d is None else d.data_ptr(),
                          None if wk is None else wk.data_ptr(), B, M, 1,
                          chol.PATHS.index(path), stream)
                assert err == 0, err

            plain_ms = cuda_ms(lambda: chol.chol_solve(R, b, path=path))
            tiled = path == "tiled"
            read = lib.chol_tiled_clocks if tiled else lib.chol_phase_clocks
            clocked()
            torch.cuda.synchronize()
            assert read(clk) == 0                        # zero the counters
            clocked_ms = cuda_ms(clocked)
            sm_clock = smi("clocks.sm")
            assert read(clk) == 0
            if tiled:
                calls = 6                        # cuda_ms: a warm-up and 5
                per = (plan.panel_blocks, plan.update_blocks,
                       plan.backward_blocks)
                kind = (0, 0, 1, 0, 1, 1, 2)
                cyc = {p: clk[i] / (calls * per[kind[i]])
                       for i, p in enumerate(TILED_PHASES)}
                sums = {p: clk[i] for i, p in enumerate(TILED_PHASES)}
                total = sum(sums.values())
                share = {p: v / total for p, v in sums.items()}
                assert clk[7] == calls * sum(per), (clk[7], per)
            else:
                blocks = clk[7]
                cyc = {p: clk[i] / blocks for i, p in enumerate(PHASES)}
                total = sum(cyc.values())
                share = {p: v / total for p, v in cyc.items()}
            xr = chol.chol_solve_reference(R, b)
            err = ((x - xr).abs().max() / xr.abs().max()).item()
            row = {"dtype": cname, "B": B, "M": M, "path": path,
                   "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms,
                   "sm_clock_under_load": sm_clock,
                   "cycles_per_block": cyc,
                   "share": share,
                   "max_rel_err": err}
            rows.append(row)
            print(json.dumps(row), flush=True)
    report = {"card": smi("name,power.limit"), "torch": torch.__version__,
              "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])


if __name__ == "__main__":
    main()
