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

--subst (cells as --cells, or none for SUBST_CELLS) times instead the
substitution with a kept factor (``chol.chol_subst``): a "guard" factor of
seeded systems kept by the routed factor + solve, then each substitution
path (one_block, tiled), torch.cholesky_solve on
the unpacked factor (one PyTorch call for the same function) and the plain
version's two torch.linalg.solve_triangular calls, each held to the plain
version and timed (eager, and as CUDA graph replays: graph_ms); the
report names the faster of the two library routes
and the path chol_subst routes the cell to.  --subst-line reads
chip_smoke.py's subst_line_<type>.json ([type, B, M, calls] per main-path
shape, written under eaqhm_torch/kernels/build/) and also sums each route
over those calls.  With PYTHONPATH naming another checkout, that
checkout's package is timed (this one is appended to sys.path after it).

    python3 tools/torch_chol_route.py [--out build/chol_route.json]
                                      [--cells c128:BxM c64:BxM ...]
    python3 tools/torch_chol_route.py --subst [c64:BxM ...]
                                      [--subst-line FILE ...] [--reps N]
"""
import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)
from eaqhm_torch.ops import chol  # noqa: E402

CELLS = {"c64": ((512, 98), (512, 130), (512, 162), (512, 194), (512, 258),
                 (512, 386), (256, 514), (256, 642), (128, 770), (64, 770),
                 (32, 1026), (16, 1294), (8, 1950), (2, 6146)),
         "c128": ((512, 98), (512, 130), (512, 162), (512, 194), (512, 258),
                  (256, 290), (256, 386), (128, 514), (128, 642), (64, 770),
                  (32, 1026), (16, 1294), (8, 1950), (2, 6146), (2, 6657))}
# the substitution's cells: the main paths' orders at their batches (SA19,
# the male preset and stress, the wide tiers) and the wide cells
SUBST_CELLS = {t: ((2405, 130), (1610, 162), (154, 194), (512, 258),
                   (512, 386), (256, 514), (64, 770), (16, 1294), (8, 1950),
                   (2, 6146)) for t in ("c64", "c128")}
TYPES = {"c64": torch.complex64, "c128": torch.complex128}
TOL = {"c64": 2e-5, "c128": 1e-12}
SUBST_TOL = {"c64": 2e-4, "c128": 1e-10}


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


def graph_ms(fn, reps):
    """Mean ms of fn on the device timeline: reps calls captured into one
    CUDA graph, replayed three times (no host gap between launches)."""
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
    del graph
    return t0.elapsed_time(t1) / (3 * reps)


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


def subst_row(t, B, M, reps):
    """One substitution cell: every path, the two library routes."""
    dt = TYPES[t]
    R, b = hpd(B, M, dt, seed=M)
    _, f = chol.chol_solve(R, b, mode="guard", keep_factor=True)
    del R
    L = chol.unpack_factor(f)
    xr = chol.chol_subst_reference(L, b)

    def err(x):
        return ((x - xr).abs().max() / xr.abs().max()).item()

    def cholesky_solve():
        return torch.cholesky_solve(b[..., None], L)[..., 0]

    row = {"dtype": t, "B": B, "M": M,
           "routed": chol.subst_path_for(M),
           "ms": {}, "graph_ms": {}, "max_rel_err": {}}
    for path in chol.SUBST_PATHS:
        def run():
            return chol.chol_subst(f, b, path=path)

        x = run()
        torch.cuda.synchronize()
        row["max_rel_err"][path] = err(x)
        assert row["max_rel_err"][path] <= SUBST_TOL[t], (t, B, M, path, row)
        row["ms"][path] = cuda_ms(run, reps)
        row["graph_ms"][path] = graph_ms(run, reps)
    lib = {"cholesky_solve": cholesky_solve,
           "two_solve_triangular": lambda: chol.chol_subst_reference(L, b)}
    row["library_ms"] = {}
    for name, fn in lib.items():
        try:
            x = fn()
            torch.cuda.synchronize()
        except RuntimeError as e:     # a library route's own limits (the
            row["library_ms"][name] = None   # batched cholesky_solve at
            row["library_error"] = str(e).splitlines()[0]   # M = 6146)
            continue
        row["max_rel_err"][name] = err(x)
        assert row["max_rel_err"][name] <= SUBST_TOL[t], (t, B, M, name)
        row["library_ms"][name] = cuda_ms(fn, reps)
    done = {k: v for k, v in row["library_ms"].items() if v is not None}
    row["faster_library"] = min(done, key=done.get)
    row["fastest"] = min(row["ms"], key=row["ms"].get)
    return row


def subst_main(args):
    cells = []                  # --subst-line alone: its shapes only
    if args.subst == []:
        cells = [(t, B, M) for t, bm in SUBST_CELLS.items() for B, M in bm]
    elif args.subst:
        for cell in args.subst:
            t, bm = cell.split(":")
            B, M = (int(v) for v in bm.split("x"))
            cells.append((t, B, M))
    line = []
    for path in args.subst_line or ():
        with open(path) as fh:
            line += [tuple(x) for x in json.load(fh)]
    short = {"complex64": "c64", "complex128": "c128"}
    line = [(short.get(t, t), B, M, n) for t, B, M, n in line]
    cells += [(t, B, M) for t, B, M, _ in line if (t, B, M) not in cells]
    rows = {}
    for t, B, M in cells:
        reps = args.reps if M <= 2048 else 2
        row = subst_row(t, B, M, reps)
        rows[(t, B, M)] = row
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    sums = {}
    for t, B, M, n in line:
        row = rows[(t, B, M)]
        s = sums.setdefault(t, {"calls": 0, "ms": {}, "library_ms": {},
                                "routed_ms": 0.0})
        s["calls"] += n
        s["routed_ms"] += n * row["ms"][row["routed"]]
        for key in ("ms", "library_ms"):
            for k, v in row[key].items():
                if v is not None:
                    s[key][k] = s[key].get(k, 0.0) + n * v
    for t, s in sums.items():
        s["faster_library"] = min(s["library_ms"], key=s["library_ms"].get)
        print(json.dumps({"line": t, **s}), flush=True)
    return {"card": card(), "torch": torch.__version__,
            "package": os.path.dirname(os.path.dirname(chol.__file__)),
            "rows": list(rows.values()), "line_sums": sums}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chol_route.json"))
    ap.add_argument("--cells", nargs="+", default=None,
                    help="cells as c64:BxM or c128:BxM")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--subst", nargs="*", default=None,
                    help="time the substitution instead, at these cells "
                         "(none: SUBST_CELLS)")
    ap.add_argument("--subst-line", nargs="+", default=None,
                    help="chip_smoke.py's subst_line_<type>.json files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_chol_route: no CUDA device")
    if args.subst is not None or args.subst_line:
        report = subst_main(args)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(report["card"])
        return
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
