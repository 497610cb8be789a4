"""The Cholesky kernel's candidate paths against each other, on one CUDA GPU:
the table that eaqhm_torch/kernels/csrc/chol_solve.cu's path_of routes by.

For each (type, B, M) cell, every path that takes M (resident, tiled) runs
the fused factor + solve ("nan" rule, no factor kept) on seeded
equilibrated HPD systems built on the card: its error against cuSOLVER's
route (checked), and its time (CUDA events, warm, mean of --reps
launches), with cuSOLVER's time and the routed path beside them.  The
default cells are PERF.md's per-M batches (M = 98-514, the stress cells
among them), the crossovers (M = 290, 642, 770) and the wide tiers'
(M = 770-6657).  One JSON line per cell, the card's name and power limit,
and the whole report in --out.

    python3 tools/torch_chol_route.py [--out build/chol_route.json]
                                      [--cells c128:BxM c64:BxM ...]
"""
import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from eaqhm_torch.ops import chol  # noqa: E402

CELLS = {"c64": ((512, 98), (512, 130), (512, 162), (512, 194), (512, 258),
                 (512, 386), (256, 514), (256, 642), (128, 770), (64, 770),
                 (32, 1026), (16, 1294), (8, 1950), (2, 6146)),
         "c128": ((512, 98), (512, 130), (512, 162), (512, 194), (512, 258),
                  (256, 290), (256, 386), (128, 514), (128, 642), (64, 770),
                  (32, 1026), (16, 1294), (8, 1950), (2, 6146), (2, 6657))}
TYPES = {"c64": torch.complex64, "c128": torch.complex128}
TOL = {"c64": 2e-5, "c128": 1e-12}


def hpd(B, M, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c128 = torch.complex128
    A = torch.randn((B, M, M), dtype=c128, generator=g, device="cuda")
    b = torch.randn((B, M), dtype=c128, generator=g, device="cuda")
    R = A @ A.mH / M + torch.eye(M, dtype=c128, device="cuda")
    d = torch.diagonal(R, dim1=-2, dim2=-1).real.sqrt()
    R = R / (d[:, :, None] * d[:, None, :]).to(c128)
    return R.to(dtype).contiguous(), b.to(dtype).contiguous()


def cuda_ms(fn, reps):
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


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def candidates(dt, M):
    """The paths that take order M: both where the kernel routes M to the
    resident path (the tiled path takes every order), else the tiled path
    alone (the resident path's shared memory does not fit M)."""
    return (chol.PATHS if chol.path_for(dt, M) == "resident"
            else ("tiled",))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chol_route.json"))
    ap.add_argument("--cells", nargs="+", default=None,
                    help="cells as c64:BxM or c128:BxM")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_chol_route: no CUDA device")
    cells = [(t, B, M) for t, bm in CELLS.items() for B, M in bm]
    if args.cells:
        cells = []
        for cell in args.cells:
            t, bm = cell.split(":")
            B, M = (int(v) for v in bm.split("x"))
            cells.append((t, B, M))
    rows = []
    for t, B, M in cells:
        dt = TYPES[t]
        R, b = hpd(B, M, dt, seed=M)
        xr = chol.chol_solve_reference(R, b)
        reps = args.reps if M <= 2048 else 2
        row = {"dtype": t, "B": B, "M": M,
               "routed": chol.path_for(dt, M),
               "cusolver_ms": cuda_ms(lambda: chol.chol_solve_reference(
                   R, b), reps), "ms": {}, "max_rel_err": {}}
        for path in candidates(dt, M):
            x = chol.chol_solve(R, b, path=path)
            torch.cuda.synchronize()
            err = ((x - xr).abs().max() / xr.abs().max()).item()
            row["max_rel_err"][path] = err
            assert err <= TOL[t], (t, B, M, path, err)
            row["ms"][path] = cuda_ms(
                lambda: chol.chol_solve(R, b, path=path), reps)
        row["fastest"] = min(row["ms"], key=row["ms"].get)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del R, b, xr
        torch.cuda.empty_cache()
    report = {"card": card(), "torch": torch.__version__, "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])


if __name__ == "__main__":
    main()
