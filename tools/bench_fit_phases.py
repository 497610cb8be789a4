"""Where the fit's time goes, step by step, on one CUDA GPU.

The fit is ``ops.fit.iqhm_gram`` (adaptation 0) and ``eaqhm_gram`` (every
eaQHM adaptation; both re-exported by ``ops.solver``), whose plain version
ends in ``build_gram_split``.  For each
cell (B frames of one tier, N = 2W+1 window rows, Kc harmonics; B as
``engine._batch_frames`` cuts the tier for the type), each type and each
mode, the tool runs the fit's torch-op code as a sequence of steps and
records a CUDA event after each, warm, mean of --reps runs:

  eaQHM: the window gather and dead-track overlay
         (``fit.gather_windows``, the plain version's first step);
         ``repair_tracks``; the mask, the integer
         split, the cumsums and both phases (``ext_flip`` included); rho,
         ``polar``, the flips and the concatenation into E1; the Hamming
         window; A and B; each of the three Grams (``torch.matmul``); the
         right-hand side; the [B, M, M] passes: concatenation, identity
         padding, equilibration.
  iQHM:  the gather; the phase; ``polar`` and the mask; the Blackman window; A and B;
         the three Grams; the right-hand side; the [B, M, M] passes.

The steps are the plain version's code (``ops.fit.gather_windows``, then
``iqhm_gram_reference`` / ``eaqhm_gram_reference``: the torch ops the port
ran before the fit kernels) split at its statements; their outputs are held
to one call of the plain version on the same inputs (printed as
max_abs_diff_vs_plain).  Beside the steps: the whole plain call and the
kernels' (``iqhm_gram_tables`` / ``eaqhm_gram_tables`` on CUDA, as the
engines call them: fit_basis reading the tables, then fit_gram, each also
timed alone), each with its peak device memory above its inputs, the
kernels' largest error relative to the plain version's largest entry (R,
rhs, dinv), "library_ms", the three Grams alone on materialized A and B
(cuBLAS), fit_gram's executed work over the least (``fit.gram_work_ratio``)
and its rate (the least and the executed flops over its time), and each
kernel's bound: fit_gram one triangle of each Gram at 67 TFLOP/s (or A
read and R written at 3.35 TB/s, the larger), fit_basis the tables' rows
its windows cover read once and A, rhs, dinv, the mask and R's DC entries
written once at 3.35 TB/s.  Inputs are drawn on the card from a seed:
harmonic tracks of an f0 per frame with zero gaps, dead centres, random
amplitudes and signal.

With --clocks the kernels also run from a second build of
``kernels/csrc/fit.cu`` with -DFIT_PHASE_CLOCKS (the port's own build has
no clocks): clock64 cycles per block of each kernel by phase, as thread 0
of each block sees them (fit_gram: the first depth step, loads, products,
epilogue; fit_basis: the window, the walk's repair, cumsums and phases,
sincos with the A writes, the column sums), and the SM clock under load.
Beside them, what ``-Xptxas -v`` reported for each kernel of the library
(registers, spills, shared memory) and the blocks a SM holds at each cell
(``fit_occupancy``: the CUDA runtime's count for that launch).  --probe
times the FP64 ``mma.sync`` shapes this toolkit's ptxas takes
(``tools/fit_mma_probe.cu``, in-register products, one build per shape).
The card's name and power limit go beside the numbers; the JSON goes to
--out.

    python3 tools/bench_fit_phases.py [--out chiprun_out/fit_phases.json]
        [--cells sa19 stress wide] [--dtypes float32 float64]
        [--modes iqhm eaqhm] [--reps 3] [--clocks] [--probe]
"""
import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from collections import OrderedDict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from eaqhm_torch.kernels import build  # noqa: E402
from eaqhm_torch.models import engine  # noqa: E402
from eaqhm_torch.ops import fit, scan, solver  # noqa: E402

HBM_BYTES_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
PEAK_FLOP_S = 67e12         # FP32 outside the tensor cores; FP64 tensor

FS = 16000.0
CHUNK = 128            # EaqhmConfig.chunk
STEP = 15              # EaqhmConfig.step: the gather's hop
# (group, tier frames, W, Kc, fs): SA19's three tiers, the stress tiers,
# chip_smoke.py's wide tiers at 22.05, 44.1 and 48 kHz
CELLS = (("sa19", 2405, 120, 32, FS), ("sa19", 1610, 128, 40, FS),
         ("sa19", 154, 152, 48, FS), ("stress", 30123, 304, 96, FS),
         ("stress", 33813, 344, 128, FS), ("wide", 671, 480, 192, 22050.0),
         ("wide", 1394, 952, 323, 44100.0), ("wide", 152, 1448, 487, 48000.0))


# the clocked build's (kernel, slot) counters: fit_phase_clocks in fit.cu;
# the last slot counts the blocks that flushed
CLK_KINDS = ("gram_c64", "gram_c128", "basis_eaqhm", "basis_iqhm")
CLK_SLOTS = {"gram": ("fill", "loads", "products", "epilogue", None, None,
                      None),
             "basis": ("window_dc_sums", "centre_walk", "repair",
                       "cumsums_phase", "sincos_A_writes", "column_sums",
                       None)}
# fit_occupancy's kernel numbers
OCC_IDS = {("gram", "float32"): 0, ("gram", "float64"): 1,
           ("eaqhm", "float32"): 2, ("eaqhm", "float64"): 3,
           ("iqhm", "float32"): 4, ("iqhm", "float64"): 5}
PROBE_SHAPES = ("m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16")


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


class Steps:
    """CUDA events after each step of one run."""

    def __init__(self):
        self.events = [("start", self._event())]

    @staticmethod
    def _event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self, name):
        self.events.append((name, self._event()))

    def ms(self):
        torch.cuda.synchronize()
        return OrderedDict((name, e0.elapsed_time(e1)) for (_, e0), (name, e1)
                           in zip(self.events, self.events[1:]))


def make_inputs(B, W, Kc, fs, dtype, seed):
    """One batch of a tier on the card: the engine's tables over L = B *
    STEP + 2W + 1 samples (s, fm and am with Kc columns, the dead centres),
    the frame centers and dead flags, f0, K, wl, the harmonic mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    N = 2 * W + 1
    L = B * STEP + N
    t = torch.arange(L, device=dev, dtype=dtype)
    f0_t = 80.0 + 40.0 * torch.sin(2 * math.pi * t / (fs * 0.7))
    k = torch.arange(1, Kc + 1, device=dev, dtype=dtype)
    fm = f0_t[:, None] * k[None, :] + torch.randn(
        (L, Kc), generator=g, device=dev, dtype=dtype)
    am = torch.rand((L, Kc), generator=g, device=dev, dtype=dtype) * 0.3
    gaps = torch.rand((L, Kc), generator=g, device=dev) < 0.03
    fm = torch.where(gaps, torch.zeros_like(fm), fm)
    am = torch.where(gaps, torch.zeros_like(am), am)
    s = torch.randn(L, generator=g, device=dev, dtype=dtype)
    dead = torch.rand(L, generator=g, device=dev) < 0.02
    centers = W + STEP * torch.arange(B, device=dev)
    f0 = f0_t[centers]
    K = torch.clamp((fs / 2 / f0).floor().long(), max=Kc)
    wl = torch.randint(int(0.8 * W), W + 1, (B,), generator=g, device=dev)
    mask_k = (k[None, :] <= K[:, None].to(dtype)) & (fm[centers] != 0)
    return dict(s=s, fm=fm, am=am, dead_center=dead, L=L, centers=centers,
                utt=torch.zeros(B, dtype=torch.long, device=dev),
                dead=dead[centers], f0=f0, K=K, wl=wl, mask_k=mask_k)


def gram_steps(st, E1, w, o, s_win, colmask1):
    """build_gram_split, statement by statement."""
    A = E1 * w[..., None].to(E1.dtype)
    B = A * o[None, :, None].to(E1.dtype)
    st.mark("A_B")
    Ah = A.mH
    Bh = B.mH
    G0 = torch.matmul(Ah, A)
    st.mark("G0")
    G1 = torch.matmul(Ah, B)
    st.mark("G1")
    G2 = torch.matmul(Bh, B)
    st.mark("G2")
    ws = (w * s_win).to(E1.dtype)
    rhs = torch.cat([solver._mv(Ah, ws), solver._mv(Bh, ws)], dim=-1)
    st.mark("rhs")
    R = torch.cat([torch.cat([G0, G1], dim=-1),
                   torch.cat([G1.mH, G2], dim=-1)], dim=-2)
    st.mark("R_concat")
    colmask = torch.cat([colmask1, colmask1], dim=-1)
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    R = R + eye * (~colmask[:, None, :])
    st.mark("identity_pad")
    diag = torch.diagonal(R, dim1=-2, dim2=-1).real
    dinv = torch.rsqrt(torch.clamp(diag, min=1e-30))
    R = R * (dinv[:, None, :] * dinv[:, :, None]).to(R.dtype)
    rhs = rhs * dinv
    R, rhs = R.contiguous(), rhs.contiguous()
    st.mark("equilibrate")
    return (R, rhs, dinv), (A, B)


def iqhm_steps(inp, W, Kc, fs, dtype):
    """solver.iqhm_gram, statement by statement."""
    st = Steps()
    dev = "cuda"
    o = torch.arange(-W, W + 1, device=dev)
    s_win = fit.gather_windows(inp["s"], inp["utt"], inp["centers"], W)
    st.mark("gather")
    cdtype = solver.complex_dtype(dtype)
    f0, K, wl = inp["f0"], inp["K"], inp["wl"]
    k = torch.arange(-Kc, Kc + 1, device=dev)
    colmask1 = k.abs()[None, :] <= K[:, None]
    phase = ((2 * math.pi / fs) * o[None, :, None].to(dtype)
             * (k[None, None, :].to(dtype) * f0[:, None, None]))
    st.mark("phase")
    E1 = torch.polar(torch.ones_like(phase), phase).to(cdtype)
    E1 = E1 * colmask1[:, None, :]
    st.mark("polar_mask")
    w = solver.blackman_window(o[None, :].to(dtype), wl[:, None].to(dtype))
    st.mark("window")
    out, AB = gram_steps(st, E1, w, o, s_win.to(dtype), colmask1)
    tab = (inp["s"], inp["utt"], inp["centers"], W)

    def plain():
        return fit.iqhm_gram_reference(fit.gather_windows(*tab), o, wl, f0,
                                       K, fs, Kc, dtype=dtype)
    kernels = (lambda: fit.iqhm_gram_tables(*tab, wl, f0, K, fs, Kc,  # noqa
                                            dtype=dtype))
    return st, out, AB, calls(plain, kernels, dtype, "iqhm", tab + (wl,),
                              dict(Kc=Kc, f0=f0, K=K), fs)


def calls(plain, kernels, dtype, mode, basis_args, kw, fs):
    """The plain call, the kernels' call, and each kernel alone (fit_gram on
    fit_basis's outputs), as functions of no argument."""
    def basis():
        return fit.fit_basis(mode, *basis_args, dtype, fs=fs, **kw)

    def gram():
        A, R, _, dinv, mask = out_b
        return fit.fit_gram(A, R, dinv, mask)
    out_b = basis()
    return dict(plain=plain, kernels=kernels, basis=basis, gram=gram)


def eaqhm_steps(inp, W, Kc, fs, dtype, eps=1e-4):
    """engine._eaqhm_bucket's gather and overlay, then solver.eaqhm_gram,
    statement by statement."""
    st = Steps()
    dev = "cuda"
    o = torch.arange(-W, W + 1, device=dev)
    tab = (inp["s"], inp["utt"], inp["centers"], W, inp["fm"], inp["am"],
           inp["dead_center"], inp["dead"], Kc)
    s_win, fm_win, am_win = fit.gather_windows(*tab)
    st.mark("gather_overlay")
    wl, colmask_k = inp["wl"], inp["mask_k"]
    cdtype = solver.complex_dtype(dtype)
    B, N = s_win.shape
    fm_r, am_r = solver.repair_tracks(fm_win.to(dtype), am_win.to(dtype), o,
                                      wl)
    st.mark("repair_tracks")
    cm = colmask_k[:, None, :]
    fm_r = fm_r * cm
    am_r = am_r * cm
    fm_q = torch.round(fm_r)
    fm_res = fm_r - fm_q
    cq = scan.cumsum(fm_q, dim=1)
    cr = scan.cumsum(fm_res, dim=1)
    psi_q = cq - cq[:, W:W + 1, :]
    psi_r = cr - cr[:, W:W + 1, :]

    def mk_phase(pq, pr):
        return (2 * math.pi / fs) * (torch.remainder(pq, fs) + pr)

    def ext_flip(p, c_mid):
        return torch.cat([-c_mid, p[:, :-1, :]], dim=1).flip(1)

    phase = mk_phase(psi_q, psi_r)
    neg_phase = mk_phase(
        ext_flip(psi_q, cq[:, W:W + 1, :]) + fm_q[:, W:W + 1, :],
        ext_flip(psi_r, cr[:, W:W + 1, :]) + fm_res[:, W:W + 1, :])
    st.mark("cumsum_phase")
    am_mid = am_r[:, W:W + 1, :]
    rho = (eps + am_r) / (am_mid + eps)
    pos = (rho * torch.polar(torch.ones_like(phase), phase)).to(cdtype) * cm
    neg = (rho.flip(1) * torch.polar(torch.ones_like(neg_phase),
                                     neg_phase)).to(cdtype) * cm
    neg = neg.flip(2)
    dc = torch.ones((B, N, 1), dtype=cdtype, device=dev)
    E1 = torch.cat([neg, dc, pos], dim=-1)
    colmask1 = torch.cat([colmask_k.flip(-1),
                          torch.ones((B, 1), dtype=torch.bool, device=dev),
                          colmask_k], dim=-1)
    st.mark("polar_flip_concat")
    w = solver.hamming_window(o[None, :].to(dtype), wl[:, None].to(dtype))
    st.mark("window")
    out, AB = gram_steps(st, E1, w, o, s_win.to(dtype), colmask1)

    def plain():
        return fit.eaqhm_gram_reference(*fit.gather_windows(*tab), o, wl,
                                        colmask_k, fs, dtype=dtype, eps=eps)

    def kernels():
        return fit.eaqhm_gram_tables(
            inp["s"], inp["fm"], inp["am"], inp["dead_center"], inp["utt"],
            inp["centers"], inp["dead"], W, wl, colmask_k, fs, dtype=dtype,
            eps=eps)
    kw = dict(fm=inp["fm"], am=inp["am"], dead=inp["dead_center"],
              dd=inp["dead"], colmask_k=colmask_k, eps=eps)
    return st, out, AB, calls(plain, kernels, dtype, "eaqhm",
                              tab[:3] + (W, wl), kw, fs)


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


def read_clocks(lib):
    """{kind: {phase: cycles per block}, blocks} of the clocked build since
    the last read (the read zeroes them)."""
    n = len(CLK_KINDS) * 8
    buf = (ctypes.c_ulonglong * n)()
    assert lib.fit_phase_clocks(buf) == 0
    out = {}
    for k, kind in enumerate(CLK_KINDS):
        c = buf[8 * k:8 * (k + 1)]
        if c[7] == 0:
            continue
        names = CLK_SLOTS[kind.split("_")[0]]
        row = {"blocks": c[7]}
        for i, name in enumerate(names):
            if name is None or not c[i]:
                continue
            row[name] = c[i] if name.startswith("n_") else c[i] / c[7]
        out[kind] = row
    return out


def clocked_run(clocked, fns):
    """The kernels from the clocked build, each alone: (basis clocks, gram
    clocks, ms of each)."""
    plain_lib = fit.library
    fit.library = lambda device=None: clocked
    try:
        fns["basis"]()
        fns["gram"]()
        torch.cuda.synchronize()
        read_clocks(clocked)
        fns["basis"]()
        torch.cuda.synchronize()
        basis = read_clocks(clocked)
        fns["gram"]()
        torch.cuda.synchronize()
        gram = read_clocks(clocked)
        ms = {"basis": cuda_ms(fns["basis"], 3), "gram": cuda_ms(fns["gram"],
                                                               3)}
        read_clocks(clocked)
    finally:
        fit.library = plain_lib
    return basis, gram, ms


def ptxas_report(defines=()):
    """Per kernel of the fit library: registers, spill bytes, shared memory,
    as -Xptxas -v printed them at the build."""
    return build.ptxas_report("fit", defines)


def probe_mma(iters=4096):
    """TFLOP/s of each FP64 mma.sync shape, in-register products on every
    SM (4 blocks of 256 threads a SM); a shape ptxas refuses is reported
    with its error."""
    src = os.path.join(ROOT, "tools", "fit_mma_probe.cu")
    out_dir = os.path.join(build.BUILD, "mma_probe")
    os.makedirs(out_dir, exist_ok=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads = 4 * sms, 256
    res = {}
    for i, shape in enumerate(PROBE_SHAPES):
        so = os.path.join(out_dir, f"probe_{shape}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DPROBE_SHAPE={i}",
               "-Xptxas", "-v", "-o", so, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            res[shape] = {"built": False, "error": proc.stderr[-600:]}
            print(f"mma probe {shape}: refused", flush=True)
            continue
        lib = ctypes.CDLL(so)
        lib.probe_run.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.probe_flops_per_mma.restype = ctypes.c_longlong
        buf = torch.empty(blocks * threads, dtype=torch.float64,
                          device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            assert lib.probe_run(buf.data_ptr(), blocks, threads, iters,
                                 stream) == 0
        ms = cuda_ms(run, 5)
        flops = (lib.probe_flops_per_mma() * lib.probe_chains() * iters
                 * blocks * (threads // 32))
        res[shape] = {"built": True, "ms": ms,
                      "tflop_s": flops / (ms * 1e-3) / 1e12,
                      "sm_clock": smi("clocks.sm")}
        print(f"mma probe {shape}: {json.dumps(res[shape])}", flush=True)
    return res


def run_cell(group, frames, W, Kc, fs, dtype, mode, reps, clocked=None):
    cdtype = solver.complex_dtype(dtype)
    N = 2 * W + 1
    B = min(frames, engine._batch_frames(CHUNK, N, Kc, cdtype, "cuda"))
    inp = make_inputs(B, W, Kc, fs, dtype, seed=W + Kc)
    steps_fn = iqhm_steps if mode == "iqhm" else eaqhm_steps
    steps_fn(inp, W, Kc, fs, dtype)                     # warm
    runs = []
    for _ in range(reps):
        st, out, AB, fns = steps_fn(inp, W, Kc, fs, dtype)
        runs.append(st.ms())
    step_ms = OrderedDict((k, sum(r[k] for r in runs) / reps)
                          for k in runs[0])
    ref = fns["plain"]()
    diff = max((a - b).abs().max().item() for a, b in zip(out, ref))
    got = fns["kernels"]()
    err = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(got, ref))
    A, Bm = AB
    Ah, Bh = A.mH, Bm.mH
    library_ms = cuda_ms(lambda: (torch.matmul(Ah, A), torch.matmul(Ah, Bm),
                                  torch.matmul(Bh, Bm)), reps)
    del out, ref, got, AB, A, Bm, Ah, Bh, st
    timed, peaks = {}, {}
    for name in ("plain", "kernels", "basis", "gram"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        timed[name] = cuda_ms(fns[name], reps)
        peaks[name] = torch.cuda.max_memory_allocated() - base
    Kc2 = 2 * Kc + 1
    flops = 3 * 8 * Kc2 * Kc2 * N * B          # three full Grams
    M = 2 * Kc2
    csz = 16 if dtype == torch.float64 else 8
    isz = csz // 2
    least = 3 * M * M * N * B                  # one triangle of each Gram
    ratio = fit.gram_work_ratio(Kc)
    gram_bound = max(least / PEAK_FLOP_S,
                     (B * N * Kc2 + B * M * M) * csz / HBM_BYTES_S) * 1e3
    rows_read = min(inp["L"], B * STEP + N)   # the rows the windows cover
    ea = mode == "eaqhm"
    basis_bytes = (rows_read * (isz * (1 + (2 * Kc if ea else 0)) + ea)
                   + B * (N * Kc2 + 5 * M) * csz + B * M * isz + B * Kc2)
    extra = {"gram_work_over_least": ratio,
             "fit_gram_tflop_s_least": least / (timed["gram"] * 1e-3) / 1e12,
             "fit_gram_tflop_s_executed":
                 ratio * least / (timed["gram"] * 1e-3) / 1e12,
             "fit_gram_bound_ms": gram_bound,
             "fit_basis_bound_ms": basis_bytes / HBM_BYTES_S * 1e3,
             "fit_gram_over_library": timed["gram"] / library_ms}
    if clocked is not None:
        rname = str(dtype).split(".")[-1]
        lib = fit.library("cuda")
        extra["blocks_per_sm"] = {
            "fit_basis": lib.fit_occupancy(OCC_IDS[(mode, rname)], N),
            "fit_gram": lib.fit_occupancy(OCC_IDS[("gram", rname)], N)}
        b_clk, g_clk, c_ms = clocked_run(clocked, fns)
        extra.update(clocks_fit_basis=b_clk, clocks_fit_gram=g_clk,
                     clocked_ms=c_ms, sm_clock_under_load=smi("clocks.sm"))
    row = {"group": group, "mode": mode, "dtype": str(dtype).split(".")[-1],
           "B": B, "N": N, "Kc": Kc, "M": 2 * Kc2, "tier_frames": frames,
           "batches_per_tier": -(-frames // B), "step_ms": step_ms,
           "steps_total_ms": sum(step_ms.values()),
           "plain_ms": timed["plain"], "kernels_ms": timed["kernels"],
           "fit_basis_ms": timed["basis"], "fit_gram_ms": timed["gram"],
           "plain_peak_bytes_above_inputs": peaks["plain"],
           "kernels_peak_bytes_above_inputs": peaks["kernels"],
           "library_ms": library_ms,
           "grams_tflop_s": flops / (library_ms * 1e-3) / 1e12,
           "max_abs_diff_vs_plain": diff, "kernels_max_rel_err": err,
           **extra}
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "fit_phases.json"))
    ap.add_argument("--cells", nargs="+", default=["sa19", "stress", "wide"])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "float64"])
    ap.add_argument("--modes", nargs="+", default=["iqhm", "eaqhm"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--clocks", action="store_true",
                    help="phase clocks from a FIT_PHASE_CLOCKS build, "
                         "ptxas registers and blocks per SM")
    ap.add_argument("--probe", action="store_true",
                    help="time the FP64 mma.sync shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_fit_phases: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    extra = {}
    clocked = None
    if args.probe:
        extra["mma_probe"] = probe_mma()
    if args.clocks:
        fit.library("cuda")
        clocked = build.load("fit", ("FIT_PHASE_CLOCKS",))
        assert clocked.fit_prepare() == 0
        extra["ptxas"] = ptxas_report()
        extra["ptxas_clocked"] = ptxas_report(("FIT_PHASE_CLOCKS",))
        print("ptxas " + json.dumps(extra["ptxas"]), flush=True)
    rows = []
    for group, frames, W, Kc, fs in CELLS:
        if group not in args.cells:
            continue
        for dt in args.dtypes:
            for mode in args.modes:
                rows.append(run_cell(group, frames, W, Kc, fs,
                                     getattr(torch, dt), mode, args.reps,
                                     clocked))
                torch.cuda.empty_cache()
    report = {"card": smi("name,power.limit"), "torch": torch.__version__,
              "seconds": time.time() - t0, **extra, "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])


if __name__ == "__main__":
    main()
