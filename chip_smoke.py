#!/usr/bin/env python3
"""Smoke test of the PyTorch port (eaqhm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Setup: the card's name and power limit, torch/CUDA versions, the build of
   every CUDA kernel from the sources in this checkout; TF32 must be off.
2. Kernel phase: each hand kernel against its plain PyTorch version on the
   card (random equilibrated HPD systems from a numpy seed), in both pivot
   rules ("guard", "nan"), on both paths (resident, global), for the fused
   solve and the kept factor's substitution, with the tolerance asserted and
   the path and times printed.
   Non-PD phase: the "nan" rule returns NaN on exactly the systems whose
   cuSOLVER factorization fails, and solve_gram(float32, "cholesky") on the
   card takes the ridged rerun as the same call on the CPU does.
3. Main path, float64: eaqhm_torch.analyze on the golden SA19 resynthesis
   (tests/golden/sa19_golden.npz, female preset) held against the JAX
   package's float64 result (tests/golden/torch_smoke_ref.npz): the same
   adaptation count, SRER within 1e-6 dB, s_recon and det_ak within 1e-8.
4. Main path, float32: finite SRER and final SRER >= reference - 0.1 dB.
5. One JSON line of the kernels (each kernel at every launch the main path
   made, launches counted per entry point), the nvidia-smi line, and as the
   last line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line.  Without CUDA,
or outside a checkout of the repository, it fails.
"""
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
FS = 16000
# peak rates of an H100 SXM (NVIDIA data sheet): HBM bandwidth, and the
# highest rate at which each type's multiply-adds run (float32 outside the
# tensor cores, since TF32 stays off; float64 on the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"complex64": 67e12, "complex128": 67e12}
KERNEL_TOL = {"complex64": 2e-4, "complex128": 1e-10}
RIDGED_TOL = 1e-2
SRER_TOL_DB = 1e-6
WAVE_TOL = 1e-8
F32_GATE_DB = 0.1


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn over reps launches (CUDA events, warm)."""
    import torch
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


def hpd_batch(B, M, seed, dtype, device):
    """Random equilibrated HPD systems, as tests/test_ops.py builds them."""
    import torch
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = R / (d[:, :, None] * d[:, None, :])
    b = rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))
    return (torch.as_tensor(R, dtype=dtype, device=device),
            torch.as_tensor(b, dtype=dtype, device=device))


def tri(M):
    return M * (M + 1) // 2


def rel_err(x, xr):
    return ((x - xr).abs().max() / xr.abs().max()).item()


def factor_cost(B, M, itemsize, keep):
    """(bytes, real flops) of one factor + solve launch: one triangle of the
    Hermitian R (M(M+1)/2 entries, all the kernel reads) and b read once, x
    written once, and the kept factor (packed triangle + real diagonal)
    written once where asked; M^3/6 complex multiply-adds to factor and M^2
    to substitute, 8 real flops each."""
    nbytes = (tri(M) + 2 * M) * itemsize
    if keep:
        nbytes += tri(M) * itemsize + M * itemsize // 2
    return B * nbytes, B * 8 * (M ** 3 / 6 + M * M)


def subst_cost(B, M, itemsize):
    """(bytes, real flops) of one substitution launch: the packed factor,
    its real diagonal and rhs read once, x written once; M^2 complex
    multiply-adds."""
    return (B * ((tri(M) + 2 * M) * itemsize + M * itemsize // 2),
            B * 8 * M * M)


def bound_ms(nbytes, flops, cname):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[cname] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, chol):
    """Each (dtype, M) cell, both pivot rules: the fused solve and the kept
    factor's substitution against the plain versions on the card; times of
    the fused solve ("nan" rule, no factor kept) and of the cuSOLVER
    route."""
    worst = {}
    for dt in (torch.complex64, torch.complex128):
        cname = str(dt).split(".")[-1]
        tol = KERNEL_TOL[cname]
        for B, M in ((9, 37), (512, 98), (512, 130), (512, 162), (512, 194),
                     (512, 258)):
            R, b = hpd_batch(B, M, seed=M, dtype=dt, device="cuda")
            path = chol.path_for(dt, M)
            errs = {}
            for mode in chol.MODES:
                x, f = chol.chol_solve(R, b, mode=mode, keep_factor=True)
                xs = chol.chol_subst(f, b)
                torch.cuda.synchronize()
                xr = chol.chol_solve_reference(R, b, mode=mode)
                errs[mode] = (rel_err(x, xr), rel_err(xs, xr))
                r = torch.matmul(R, x[..., None])[..., 0] - b
                resid = (r.norm() / b.norm()).item()
                assert max(errs[mode]) <= tol, (cname, B, M, mode, errs)
                assert resid <= 10 * tol, (cname, B, M, mode, resid)
                worst[cname] = max(worst.get(cname, 0.0), *errs[mode])
            k_ms = cuda_ms(lambda: chol.chol_solve(R, b, mode="nan"), 5)
            lib_ms = cuda_ms(lambda: chol.chol_solve_reference(R, b), 5)
            bnd, by = bound_ms(*factor_cost(B, M, R.element_size(), False),
                               cname)
            log(f"kernel chol_solve {cname} B={B} M={M} path={path}: "
                f"kernel_ms={k_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bnd:.4f} ({by}) max_rel_err (solve, subst) "
                f"guard={errs['guard'][0]:.3e},{errs['guard'][1]:.3e} "
                f"nan={errs['nan'][0]:.3e},{errs['nan'][1]:.3e} "
                f"(asserted <= {tol:g})")
    return worst


def non_pd_batch(torch, B, M, shifts, dtype, device, seed=7):
    """hpd_batch with system i shifted to smallest eigenvalue -shifts[i]
    (built in float64, then cast)."""
    R, b = hpd_batch(B, M, seed=seed, dtype=torch.complex128, device="cpu")
    eye = torch.eye(M, dtype=torch.complex128)
    for i, shift in shifts.items():
        lam = torch.linalg.eigvalsh(R[i]).min().item()
        R[i] = R[i] - (lam + shift) * eye
    return R.to(dtype).to(device), b.to(dtype).to(device)


def non_pd_nan_phase(torch, chol):
    """The "cholesky" rule on the card: the kernel's NaN systems are exactly
    those whose cuSOLVER factorization fails, on both paths and types.
    Three systems are far from positive definite (smallest eigenvalue
    -0.05); one only just (-3e-6, the system of tests/test_torch_solver.py),
    where the Pallas guard returns a finite vector."""
    shifts = {5: 0.05, 17: 0.05, 40: 0.05, 23: 3e-6}
    bad = sorted(shifts)
    for dt in (torch.complex64, torch.complex128):
        for M in (130, 258):
            R, b = non_pd_batch(torch, 64, M, shifts, dt, "cuda")
            x = chol.chol_solve(R, b, mode="nan")
            xr = chol.chol_solve_reference(R, b, mode="nan")
            got = torch.isnan(x).any(dim=1).nonzero().flatten().tolist()
            want = torch.isnan(xr).any(dim=1).nonzero().flatten().tolist()
            ok = [i for i in range(64) if i not in bad]
            err = rel_err(x[ok], xr[ok])
            log(f"non-PD {str(dt).split('.')[-1]} M={M}: kernel NaN systems "
                f"{got}, cuSOLVER NaN systems {want}, healthy max_rel_err "
                f"{err:.3e}")
            assert got == want == bad, (dt, M, got, want)
            assert err <= KERNEL_TOL[str(dt).split(".")[-1]], (dt, M, err)


def non_pd_ridge_phase(torch, chol, solver):
    """solve_gram(float32, "cholesky") with a non-PD system (smallest
    eigenvalue -3e-6) on the card against the same call on the CPU: both
    must rerun the batch ridged.  The healthy systems agree to 1e-4
    relative; the ridged one (cond(R + 1e-5 I) ~ 4e5, so any float32 solve
    of it carries ~1e-3 relative error; two CPU orderings differ by 1e-3)
    to RIDGED_TOL relative to its own size."""
    B, M, bad = 16, 130, 3
    R, b = non_pd_batch(torch, B, M, {bad: 3e-6}, torch.complex64, "cpu")
    assert torch.linalg.cholesky_ex(R)[1][bad] != 0
    n0 = chol.chol_solve.launches
    xg = solver.solve_gram(R.cuda(), b.cuda(), torch.float32,
                           method="cholesky").cpu()
    n_solve = chol.chol_solve.launches - n0
    xc = solver.solve_gram(R, b, torch.float32, method="cholesky")
    ok = [i for i in range(B) if i != bad]
    e_ok = rel_err(xg[ok], xc[ok])
    e_bad = rel_err(xg[bad], xc[bad])
    log(f"non-PD ridge rerun float32 M={M}: card vs CPU healthy "
        f"max_rel_err {e_ok:.3e} (<= 1e-4), ridged system {e_bad:.3e} "
        f"(<= {RIDGED_TOL:g}; |x| {xc[bad].abs().max().item():.1f} CPU, "
        f"{xg[bad].abs().max().item():.1f} card), solve launches {n_solve}")
    assert torch.isfinite(torch.view_as_real(xg)).all()
    assert e_ok <= 1e-4 and e_bad <= RIDGED_TOL, (e_ok, e_bad)
    assert n_solve == 2, n_solve       # the solve and the ridged rerun


def kernel_line_entry(torch, chol, dt, fused, subst):
    """The kernel and its plain version at every launch the main path made
    (fused: (B, M, path, mode, keep) per factor + solve launch; subst:
    (B, M, path) per substitution): error asserted, times and bound summed
    over all launches.  library_ms is the cuSOLVER route for the same work:
    a Cholesky plus two triangular solves per factor + solve, two
    triangular solves per substitution."""
    cname = str(dt).split(".")[-1]
    k_ms = {"chol_factor_solve": 0.0, "chol_subst": 0.0}
    l_ms = dict(k_ms)
    p_ms = 0.0
    nbytes = flops = 0.0
    err = 0.0

    def check(what, x, xr, n):
        nonlocal err
        rel = rel_err(x, xr)
        log(f"main-path {what} x{n}: max_rel_err={rel:.3e} "
            f"(asserted <= {KERNEL_TOL[cname]:g})")
        assert rel <= KERNEL_TOL[cname], (cname, what, rel)
        err = max(err, (x - xr).abs().max().item())

    for i, ((B, M, path, mode, keep), n) in enumerate(
            sorted(Counter(fused).items())):
        R, b = hpd_batch(B, M, seed=1000 + i, dtype=dt, device="cuda")
        x = chol.chol_solve(R, b, mode=mode, keep_factor=keep)
        x = x[0] if keep else x
        check(f"chol_solve {cname} B={B} M={M} {path} {mode} keep={keep}",
              x, chol.chol_solve_reference(R, b, mode=mode), n)
        k_ms["chol_factor_solve"] += n * cuda_ms(
            lambda: chol.chol_solve(R, b, mode=mode, keep_factor=keep), 3)
        p_ms += n * cuda_ms(
            lambda: chol.chol_solve_reference(R, b, mode=mode), 3)
        l_ms["chol_factor_solve"] += n * cuda_ms(
            lambda: chol.chol_solve_reference(R, b), 3)
        cb, cf = factor_cost(B, M, R.element_size(), keep)
        nbytes += n * cb
        flops += n * cf
    for i, ((B, M, path), n) in enumerate(sorted(Counter(subst).items())):
        R, b = hpd_batch(B, M, seed=2000 + i, dtype=dt, device="cuda")
        _, f = chol.chol_solve(R, b, mode="guard", keep_factor=True)
        L = chol.unpack_factor(f)
        check(f"chol_subst {cname} B={B} M={M} {path}",
              chol.chol_subst(f, b), chol.chol_subst_reference(L, b), n)
        k_ms["chol_subst"] += n * cuda_ms(lambda: chol.chol_subst(f, b), 3)
        # the plain substitution is itself the library's two triangular
        # solves
        t = n * cuda_ms(lambda: chol.chol_subst_reference(L, b), 3)
        p_ms += t
        l_ms["chol_subst"] += t
        cb, cf = subst_cost(B, M, R.element_size())
        nbytes += n * cb
        flops += n * cf
    bnd, by = bound_ms(nbytes, flops, cname)
    return {"name": f"chol_solve[{cname}]", "route": "cuda",
            "source": "eaqhm_torch/kernels/csrc/chol_solve.cu",
            "replaces": "eaqhm_tpu/ops/pallas_chol.py:68",
            "launches": len(fused) + len(subst),
            "launches_by_entry": {"chol_factor_solve": len(fused),
                                  "chol_subst": len(subst)},
            "factorizations": len(fused),
            "paths": dict(Counter(s[2] for s in fused)),
            "max_abs_err": err, "ms": sum(k_ms.values()), "plain_ms": p_ms,
            "bound_ms": bnd, "bound_by": by,
            "library_ms": sum(l_ms.values()),
            "ms_by_entry": k_ms, "library_ms_by_entry": l_ms}


def run_main_path(torch, chol, eaqhm_torch, sig, dtype_name):
    """Cold run (counted launches and their shapes), then a warm run for
    throughput."""
    cfg = eaqhm_torch.EaqhmConfig(gender="female", dtype=dtype_name)
    chol.reset_counts()
    t0 = time.time()
    res = eaqhm_torch.analyze(sig, FS, cfg, device="cuda")
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = chol.chol_solve.launches
    fused = list(chol.chol_solve.shapes)
    subst = list(chol.chol_subst.shapes)
    assert len(fused) == launches
    assert len(subst) == chol.chol_subst.launches
    assert chol.chol_solve.plain_calls == chol.chol_subst.plain_calls == 0
    t0 = time.time()
    warm = eaqhm_torch.analyze(sig, FS, cfg, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    per_adapt = [round(m["seconds"], 4) for m in warm.metrics]
    log(f"main path {dtype_name}: srer={res.srer} launches: chol_solve "
        f"{launches} chol_subst {len(subst)} paths "
        f"{dict(Counter(x[2] for x in fused))} "
        f"first_call_s={first_s:.3f} warm_s={warm_s:.3f} "
        f"audio_s_per_s={len(sig) / FS / warm_s:.3f} "
        f"per_adaptation_s={per_adapt} "
        f"stages={ {k: round(v, 4) for k, v in warm.timings.items()} } "
        f"tiers={res.tiers}")
    assert launches > 0, f"{dtype_name}: chol_solve never launched"
    if dtype_name == "float32":
        # "pallas": one factorization and one substitution per batch
        assert len(subst) == launches, (launches, len(subst))
    return res, (fused, subst), first_s


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    sys.path.insert(0, ROOT)
    import eaqhm_torch
    from eaqhm_torch.kernels import build
    from eaqhm_torch.ops import chol, solver

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"

    t0 = time.time()
    for name in build.KERNELS:
        build.load(name)
    build_s = time.time() - t0
    log(f"kernel build: {build_s:.2f} s ({list(build.KERNELS)})")

    worst = kernel_phase(torch, chol)
    log(f"kernel phase max relative error: {worst}")
    non_pd_nan_phase(torch, chol)
    non_pd_ridge_phase(torch, chol, solver)

    ref = np.load(os.path.join(GOLDEN, "torch_smoke_ref.npz"))
    sig = np.load(os.path.join(GOLDEN, "sa19_golden.npz"))["s_recon"]

    res64, shapes64, first64 = run_main_path(torch, chol, eaqhm_torch, sig,
                                        "float64")
    log(f"float64 warm-up (kernel build + first call): "
        f"{build_s + first64:.3f} s")
    d_srer = float(np.max(np.abs(np.asarray(res64.srer) - ref["srer"]))) \
        if len(res64.srer) == len(ref["srer"]) else float("inf")
    d_wave = float(np.max(np.abs(res64.s_recon - ref["s_recon"])))
    d_ak = float(np.max(np.abs(res64.det_ak - ref["det_ak"])))
    log(f"float64 vs JAX fixture: adaptations {len(res64.srer)} vs "
        f"{len(ref['srer'])}, max|dSRER|={d_srer:.3e} dB (<= {SRER_TOL_DB}), "
        f"max|ds_recon|={d_wave:.3e} (<= {WAVE_TOL}), "
        f"max|ddet_ak|={d_ak:.3e} (<= {WAVE_TOL})")
    assert len(res64.srer) == len(ref["srer"])
    assert d_srer <= SRER_TOL_DB and d_wave <= WAVE_TOL and d_ak <= WAVE_TOL

    res32, shapes32, first32 = run_main_path(torch, chol, eaqhm_torch, sig,
                                        "float32")
    final32, final_ref = max(res32.srer), float(np.max(ref["srer"]))
    log(f"float32 warm-up (first call): {first32:.3f} s; final SRER "
        f"{final32:.6f} dB vs reference {final_ref:.6f} dB "
        f"(gate >= -{F32_GATE_DB} dB: delta {final32 - final_ref:+.6f})")
    assert np.all(np.isfinite(res32.srer))
    assert final32 >= final_ref - F32_GATE_DB
    assert np.all(np.isfinite(res32.s_recon))
    assert res32.s_recon.shape == ref["s_recon"].shape

    kernels = [
        kernel_line_entry(torch, chol, torch.complex128, *shapes64),
        kernel_line_entry(torch, chol, torch.complex64, *shapes32),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
