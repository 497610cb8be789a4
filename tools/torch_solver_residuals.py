"""Readings behind the float32 block-inverse residual gate.

Runs eaqhm_torch.analyze with float32 and solve_method="block_inverse" on
the golden SA19 resynthesis (tests/golden/sa19_golden.npz) for each preset
asked, host loop, and records every batch the solve sees: its size B x M,
the residual ratio max_i ||rhs_i - R_i x_i||inf / ||rhs_i||inf of the
block inverse's returned solution (the quantity ops.solver.residual_ok
holds to _RESID_GATE) and of the solution after one refinement, the
solution's relative error against a complex128 solve of the same system
(max over systems, ||x - x128||inf / ||x128||inf), whether the batch is
finite, and whether the gate sent it to the ridged rerun.  A batch is
"diverged" when its relative error exceeds 1e-2; the gate belongs between
the largest ratio of a healthy batch and the smallest of a diverged one.
Each preset's float64 trajectory (solve "cholesky") is printed beside the
float32 one.  With --signal stress the input is the JAX benchmark's config-4
signal (eaqhm_torch.benchmarks.stress_signal, male preset; tiers M = 386
and 514), cut to --seconds when given.

    python3 tools/torch_solver_residuals.py [--genders female male]
        [--signal sa19|stress] [--device cuda] [--seconds S]
        [--out OUT.json]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import eaqhm_torch  # noqa: E402
from eaqhm_torch import benchmarks  # noqa: E402
from eaqhm_torch.models import engine  # noqa: E402
from eaqhm_torch.ops import solver  # noqa: E402

DIVERGED = 1e-2


def _ratio(R, rhs, x):
    r = (rhs - solver._mv(R, x)).abs().amax(-1)
    live = rhs.abs().amax(-1) > 0
    return float((r[live] / rhs.abs().amax(-1)[live]).amax())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genders", nargs="+", default=["female", "male"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=None,
                    help="cut the signal (a short rehearsal on the CPU)")
    ap.add_argument("--signal", default="sa19", choices=["sa19", "stress"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.signal == "stress":
        s = benchmarks.stress_signal()
        args.genders = ["male"]
    else:
        s = np.load(os.path.join(ROOT, "tests", "golden",
                                 "sa19_golden.npz"))["s_recon"]
    if args.seconds:
        s = s[:int(args.seconds * 16000)]
    orig = solver.solve_gram
    rows = []

    def recording(R, rhs, rdtype, method=None):
        if rdtype == torch.float64:                 # the float64 trajectory
            return orig(R, rhs, rdtype, method)
        Rc, bc = R.contiguous(), rhs.contiguous()
        Ri = solver.hpd_block_inverse(Rc)
        x1 = solver._mv(Ri, bc)
        x1 = x1 + solver._mv(Ri, bc - solver._mv(Rc, x1))   # one refinement
        x = solver.block_inverse_solve(Rc, bc)
        x128 = torch.linalg.solve(Rc.to(torch.complex128),
                                  bc.to(torch.complex128))
        scale = x128.abs().amax(-1).clamp_min(1e-300)
        err = ((x.to(torch.complex128) - x128).abs().amax(-1) / scale).amax()
        rows.append({
            "adaptation": adaptation[0], "B": int(R.shape[0]),
            "M": int(R.shape[-1]), "ratio": _ratio(Rc, bc, x),
            "ratio_after_one": _ratio(Rc, bc, x1),
            "rel_err": float(err),
            "finite": bool(torch.isfinite(torch.view_as_real(x)).all()),
            "gate_reruns": not bool(solver.residual_ok(Rc, bc, x))})
        return orig(R, rhs, rdtype, method)
    adaptation = [-1]
    adapt0, adapt = engine._Adapter.adapt0, engine._Adapter.adapt

    def counted(fn):
        def run(*a, **k):
            adaptation[0] += 1
            return fn(*a, **k)
        return run
    solver.solve_gram = recording
    engine._Adapter.adapt0 = counted(adapt0)
    engine._Adapter.adapt = counted(adapt)
    report = {}
    try:
        for gender in args.genders:
            rows.clear()
            adaptation[0] = -1
            cfg = eaqhm_torch.EaqhmConfig(gender=gender, dtype="float32",
                                          solve_method="block_inverse",
                                          collect_metrics=True)
            res = eaqhm_torch.analyze(s, 16000, cfg, device=args.device)
            ref = eaqhm_torch.analyze(s, 16000, eaqhm_torch.EaqhmConfig(
                gender=gender, dtype="float64"), device=args.device)
            healthy = [r["ratio"] for r in rows if r["rel_err"] <= DIVERGED]
            diverged = [r["ratio"] for r in rows if r["rel_err"] > DIVERGED]
            report[gender] = {
                "batches": list(rows), "srer_db": list(res.srer),
                "float64_srer_db": list(ref.srer),
                "max_healthy_ratio": max(healthy, default=None),
                "min_diverged_ratio": min(diverged, default=None),
                "gate": solver._RESID_GATE}
            for r in rows:
                print(f"{gender} a={r['adaptation']} B={r['B']:4d} "
                      f"M={r['M']:3d} ratio {r['ratio']:.3e} (after one refinement "
                      f"{r['ratio_after_one']:.3e}) rel_err "
                      f"{r['rel_err']:.3e} finite={r['finite']} "
                      f"gate_reruns={r['gate_reruns']}")
            print(f"{gender}: largest healthy ratio "
                  f"{report[gender]['max_healthy_ratio']}, smallest diverged "
                  f"{report[gender]['min_diverged_ratio']}, gate "
                  f"{solver._RESID_GATE}; SRER {res.srer}, float64 "
                  f"{ref.srer}")
    finally:
        solver.solve_gram = orig
        engine._Adapter.adapt0, engine._Adapter.adapt = adapt0, adapt
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
