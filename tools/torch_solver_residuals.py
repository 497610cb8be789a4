"""Readings behind the float32 block-inverse residual gate.

Runs eaqhm_torch.analyze with float32 and solve_method="block_inverse" on
the golden SA19 resynthesis (tests/golden/sa19_golden.npz) for each preset
asked, host loop, and records every batch the solve sees: its size B x M,
the residual ratio max_i ||rhs_i - R_i x_i||inf / ||rhs_i||inf of the
block inverse's returned solution (the quantity the float32 gate holds to
ops.block_inverse.RESID_GATE) and of the solution after one refinement,
the solution's relative error against a complex128 solve of the same
system (max over systems, ||x - x128||inf / ||x128||inf), whether the batch
is finite, and whether the gate sent it to the ridged rerun.  The same
batch also goes through the plain version (block_inverse.solve_reference,
torch ops): its ratio, error and gate decision, and the largest difference
between the two solutions relative to the plain one, so a reading of the
kernel is set beside the plain route's on the very same system.  A batch
is "diverged" when its relative error exceeds 1e-2; the gate belongs
between the largest ratio of a healthy batch and the smallest of a
diverged one.  Each preset's float64 trajectory (solve "cholesky") is
printed beside the float32 one.  With --route plain the float32 trajectory
itself runs on the plain version (on the card too: a measurement of the
route the kernel replaced; the wrapper's counts show the plain calls).
With --signal stress the input is the JAX benchmark's config-4 signal
(eaqhm_torch.benchmarks.stress_signal, male preset; tiers M = 386 and
514), cut to --seconds when given; with --signal corpus64 it is config 3's
64 two-second utterances (benchmarks.corpus, female, max_adaptations=6),
one summary line each (final SRER against float64, gated batches, the
batches the kernel and the plain version decide differently at the gate).
--against REPORT.json (this tool's --out of another run, e.g. the plain
route) sets each case's final float32 SRER beside that run's: the
difference per case and its largest and mean size.

    python3 tools/torch_solver_residuals.py [--genders female male]
        [--signal sa19|stress|corpus64] [--route kernel|plain]
        [--device cuda] [--seconds S] [--out OUT.json]
        [--against OTHER.json]
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
from eaqhm_torch.ops import block_inverse as bi  # noqa: E402
from eaqhm_torch.ops import solver  # noqa: E402

DIVERGED = 1e-2


def _ratio(R, rhs, x):
    r = (rhs - solver._mv(R, x)).abs().amax(-1)
    live = rhs.abs().amax(-1) > 0
    return float((r[live] / rhs.abs().amax(-1)[live]).amax())


def _rel_err(x, x128):
    scale = x128.abs().amax(-1).clamp_min(1e-300)
    return float(((x.to(torch.complex128) - x128).abs().amax(-1)
                  / scale).amax())


def _differ(rows):
    return sum(r["gate_reruns"] != r["gate_reruns_plain"] for r in rows)


def _compare(report, path, route):
    """Each case's final float32 SRER beside the same case's in another
    run's report."""
    with open(path) as f:
        other = json.load(f)
    gaps = []
    for name, v in report.items():
        if name not in other:
            continue
        a = float(np.max(v["srer_db"]))
        b = float(np.max(other[name]["srer_db"]))
        gaps.append(a - b)
        print(f"{name}: final SRER float32 route {route} {a:.6f}, route "
              f"{other[name]['route']} {b:.6f}, difference {a - b:+.6f} dB")
    if gaps:
        g = np.abs(np.asarray(gaps))
        print(f"against {os.path.basename(path)}: {len(gaps)} cases, final "
              f"SRER differences largest {g.max():.6f} dB, mean "
              f"{g.mean():.6f} dB, mean signed {np.mean(gaps):+.6f} dB, "
              f"{int((g > 1e-3).sum())} above 1e-3 dB")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genders", nargs="+", default=["female", "male"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=None,
                    help="cut the signal (a short rehearsal on the CPU)")
    ap.add_argument("--signal", default="sa19",
                    choices=["sa19", "stress", "corpus64"])
    ap.add_argument("--route", default="kernel", choices=["kernel", "plain"],
                    help="the float32 trajectory's solve: the wrapper "
                    "(the kernel on the card) or the plain version")
    ap.add_argument("--out", default=None)
    ap.add_argument("--against", default=None,
                    help="another run's --out: final SRER per case beside")
    args = ap.parse_args()
    # (name, signal, sample rate, configuration keywords)
    if args.signal == "corpus64":
        run = benchmarks.Run(args.device)
        sigs, fs, _ = benchmarks.corpus(run, 64, 2.0)
        cases = [(f"utt{i}", sig, fs, {"gender": "female",
                                        "max_adaptations": 6})
                 for i, sig in enumerate(sigs)]
    else:
        if args.signal == "stress":
            s = benchmarks.stress_signal()
            args.genders = ["male"]
        else:
            s = np.load(os.path.join(ROOT, "tests", "golden",
                                     "sa19_golden.npz"))["s_recon"]
        if args.seconds:
            s = s[:int(args.seconds * 16000)]
        cases = [(g, s, 16000, {"gender": g}) for g in args.genders]
    orig = solver.solve_gram
    orig_bi = solver.block_inverse_solve
    rows = []

    def recording(R, rhs, rdtype, method=None):
        if rdtype == torch.float64:                 # the float64 trajectory
            return orig(R, rhs, rdtype, method)
        Rc, bc = R.contiguous(), rhs.contiguous()
        Ri = solver.hpd_block_inverse(Rc)
        x1 = solver._mv(Ri, bc)
        x1 = x1 + solver._mv(Ri, bc - solver._mv(Rc, x1))   # one refinement
        x = orig_bi(Rc, bc).x                        # the kernel on the card
        plain = bi.solve_reference(Rc, bc)
        x128 = torch.linalg.solve(Rc.to(torch.complex128),
                                  bc.to(torch.complex128))
        dx = ((x - plain.x).abs().amax()
              / plain.x.abs().amax().clamp_min(1e-30))
        rows.append({
            "adaptation": adaptation[0], "B": int(R.shape[0]),
            "M": int(R.shape[-1]), "ratio": _ratio(Rc, bc, x),
            "ratio_after_one": _ratio(Rc, bc, x1),
            "rel_err": _rel_err(x, x128),
            "finite": bool(torch.isfinite(torch.view_as_real(x)).all()),
            "gate_reruns": not bool(bi.gate_inputs(Rc, bc, x).ok),
            "ratio_plain": _ratio(Rc, bc, plain.x),
            "rel_err_plain": _rel_err(plain.x, x128),
            "gate_reruns_plain": not bool(plain.ok),
            "kernel_vs_plain": float(dx)})
        return orig(R, rhs, rdtype, method)
    adaptation = [-1]
    adapt0, adapt = engine._Adapter.adapt0, engine._Adapter.adapt

    def counted(fn):
        def run(*a, **k):
            adaptation[0] += 1
            return fn(*a, **k)
        return run
    solver.solve_gram = recording
    if args.route == "plain":
        solver.block_inverse_solve = bi.solve_reference
    engine._Adapter.adapt0 = counted(adapt0)
    engine._Adapter.adapt = counted(adapt)
    report = {}
    try:
        for name, sig, fs, kw in cases:
            rows.clear()
            adaptation[0] = -1
            cfg = eaqhm_torch.EaqhmConfig(dtype="float32",
                                          solve_method="block_inverse",
                                          collect_metrics=True, **kw)
            res = eaqhm_torch.analyze(sig, fs, cfg, device=args.device)
            ref = eaqhm_torch.analyze(sig, fs, eaqhm_torch.EaqhmConfig(
                dtype="float64", **kw), device=args.device)
            healthy = [r["ratio"] for r in rows if r["rel_err"] <= DIVERGED]
            diverged = [r["ratio"] for r in rows if r["rel_err"] > DIVERGED]
            report[name] = {
                "batches": list(rows), "srer_db": list(res.srer),
                "float64_srer_db": list(ref.srer),
                "final_gap_db": float(np.max(res.srer) - np.max(ref.srer)),
                "max_healthy_ratio": max(healthy, default=None),
                "min_diverged_ratio": min(diverged, default=None),
                "gate": bi.RESID_GATE, "route": args.route}
            if args.signal == "corpus64":
                print(f"{name}: final SRER float32 {np.max(res.srer):.6f} "
                      f"float64 {np.max(ref.srer):.6f} gap "
                      f"{report[name]['final_gap_db']:+.6f} dB; batches "
                      f"{len(rows)}, gated {sum(r['gate_reruns'] for r in rows)}"
                      f" (plain on the same batches "
                      f"{sum(r['gate_reruns_plain'] for r in rows)}; decided "
                      f"differently {_differ(rows)}), route "
                      f"{args.route}", flush=True)
                continue
            for r in rows:
                print(f"{name} a={r['adaptation']} B={r['B']:4d} "
                      f"M={r['M']:3d} ratio {r['ratio']:.3e} (after one refinement "
                      f"{r['ratio_after_one']:.3e}) rel_err "
                      f"{r['rel_err']:.3e} finite={r['finite']} "
                      f"gate_reruns={r['gate_reruns']}; plain ratio "
                      f"{r['ratio_plain']:.3e} rel_err "
                      f"{r['rel_err_plain']:.3e} gate_reruns="
                      f"{r['gate_reruns_plain']}; |x - x_plain| "
                      f"{r['kernel_vs_plain']:.2e}")
            print(f"{name}: batches decided differently by the kernel and "
                  f"the plain version {_differ(rows)} of {len(rows)}")
            print(f"{name}: largest healthy ratio "
                  f"{report[name]['max_healthy_ratio']}, smallest diverged "
                  f"{report[name]['min_diverged_ratio']}, gate "
                  f"{bi.RESID_GATE}, route {args.route}; SRER {res.srer}, "
                  f"float64 "
                  f"{ref.srer}")
    finally:
        solver.solve_gram = orig
        solver.block_inverse_solve = orig_bi
        engine._Adapter.adapt0, engine._Adapter.adapt = adapt0, adapt
    every = [r for v in report.values() for r in v["batches"]]
    print(f"all cases: {_differ(every)} of {len(every)} batches decided "
          f"differently by the kernel and the plain version at the gate; "
          f"gated by the kernel {sum(r['gate_reruns'] for r in every)}, by "
          f"the plain version {sum(r['gate_reruns_plain'] for r in every)} "
          f"(route {args.route})")
    if args.against:
        _compare(report, args.against, args.route)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
