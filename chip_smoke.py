#!/usr/bin/env python3
"""Smoke test of the PyTorch port (eaqhm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Setup: the card's name and power limit, torch/CUDA versions, the build of
   every CUDA kernel from the sources in this checkout (one nvcc per source,
   each from a thread of its own, started together); TF32 must be off.
2. Kernel phase: each hand kernel against its plain PyTorch version on the
   card (random equilibrated HPD systems drawn on the card from a seed), in
   both pivot rules ("guard", "nan"), on the paths M <= 258 takes, for
   the fused solve and the kept factor's substitution (routed, and on each
   of its two paths, one-block and tiled), with the tolerance asserted and
   the paths and times printed (the substitution's beside
   torch.cholesky_solve and its byte bound).
   The block-inverse kernel (JAX's float32 default solve) against its plain
   version at (B, M) = (512, 98-238), (512, 386), (256, 514), (64, 770)
   and (16, 1294) in both types (x to 1e-4 / 1e-10), with its path, the
   plain version's, the library's (torch.linalg.inv_ex and the same five
   matrix-vector products) and its own ms, the bound and the launches per
   call (the wrapper's formula and the nodes of the call captured into a
   CUDA graph), the residual ratios against the plain version's.
   Non-PD phase: the "nan" rule returns NaN on exactly the systems whose
   cuSOLVER factorization fails, and so does the substitution with its
   kept factor on both paths; solve_gram(float32, "cholesky") and
   solve_gram(float32, "block_inverse") on the card take the ridged rerun
   as the same calls on the CPU do.  float64 solve_method="block_inverse"
   on the 1 s tone of the fixture's engine_options group held to JAX's
   recorded SRER (1e-6 dB) and waveform (1e-8).
3. Main path, float64: eaqhm_torch.analyze on the golden SA19 resynthesis
   (tests/golden/sa19_golden.npz, female preset) held against the JAX
   package's float64 result (tests/golden/torch_smoke_ref.npz): the same
   adaptation count, SRER within 1e-6 dB, s_recon and det_ak within 1e-8.
4. Main path, float32, solve_method="pallas" (the kernel's guard rule and
   substitution): finite SRER and final SRER >= reference - 0.1 dB; then the
   float32 default ("block_inverse" on its kernel, no call served by the
   plain version, its ridged rerun on the Cholesky kernel) under the same
   gate; every float32 default path below asserts the block-inverse kernel
   launched and its plain version served nothing.
5. Fused loop (fused_adapt_loop): float64 held to the fixture as in 3,
   float32 under the gate; a first call (adaptation 1 eager, then the
   capture) and a warm call, whose every eaQHM adaptation is one graph
   replay with the kernel launched inside the graph and nothing launched
   eagerly after adaptation 0.
6. Device DSP: float64 filtfilt on the card against scipy, and the device
   VAD against the host VAD on the SA19 resynthesis (its lfilter launches
   counted); the lfilter kernel is held bit for bit to its plain version at
   those launches' shapes in the kernels line.
7. The CLI as a subprocess on a wav of the resynthesis (--json): its final
   SRER equals the API's on the same file.
8. Corpus paths, on the JAX benchmark's corpus inputs (16 two-second
   utterances, parallel.corpus.corpus_signals on the resynthesis; female,
   max_adaptations=6): streams (the sequential float64 run, then
   run_streams with 1 and 4 workers on the card, a 64-sample signal
   failing alone, and the fused loop over 4 workers with utterances listed
   twice: every final SRER within 1e-9 dB of the sequential run); batch
   (analyze_batch on utterances 0-7, float64 held to the JAX package's
   analyze_batch, fixture group batch/*, float32 under the gate, audio-s/s
   against the sequential engine) and the kernel at the batch's tiers;
   mesh (a world-size-1 NCCL group from torchrun's environment, make_mesh,
   analyze_batch equal to mesh=None, run_corpus_sharded with resume);
   determinism (``chip_smoke.py --determinism`` as a subprocess: two runs
   under determinism.apply() bitwise equal; each substitution path at
   8 x 1950 bitwise equal from run to run and for a system alone as in
   its batch).
9. Stress (the JAX benchmark's config 4, eaqhm_torch.benchmarks): the 60 s
   signal at f0 76-84 Hz with the male preset, max_adaptations=10, at full
   width (tiers Kc = 96 and 128: M = 386 and 514), once in float64 (host
   loop) and once in float32 (the default "block_inverse"): per adaptation
   the wall, the engine's spans on the device timeline (pitch, fit, solve,
   tracks) and the SRER, the peak device memory; float32's final SRER under
   the -0.1 dB gate against float64's, the TPU's recorded float32 final
   beside them as context.  Then float64 on the stress slice (samples
   32,000-40,000, all 470 frames at M = 514, max_adaptations=2) held to the
   JAX fixture (tests/golden/torch_parity_ref.npz, group stress/*) as in 3,
   and the kernel at the stress paths' (B, M) cells against its plain
   version and cuSOLVER.
10. Presets (the JAX benchmark's config 2: fc=30, full_waveform=True) on
   the resynthesis, per preset (female, male, child): float64 on the
   fixture's high-passed input held to its presets/* group as in 3 (the
   host high-pass, scipy's filtfilt, moves with the scipy version), then
   config 2 itself in float64 (printed against the fixture) and float32
   (under the gate).
11. Corpus-64 (config 3's scale): benchmarks.bench_config3(batch=64) in
   float64 on one card (the sequential per-utterance path, JAX's rule for
   one device), then analyze_batch on the same 64 utterances (audio-s/s,
   launches, per-utterance final-SRER gaps to the sequential run), then
   bench_config3 in float32 (the default solve) under the gate against
   float64's final SRERs.
12. Wide tiers (sample rates and pitch floors whose top tier passes Kc =
   128): the kernel at (B, M) = (64, 770), (32, 1026), (16, 1294), (8,
   1950), (2, 6146) and (2, 6657) against its plain versions in both rules
   (errors to 2e-5 / 1e-12), the kept factor's substitution too, beside
   cuSOLVER and the bound; the M = 194-514 cells timed on every path that
   fits them beside the route's choice; the "nan" rule on the tiled path,
   and the substitution with its failed factor on both paths.
   Then analyze on tones built as config 4's signal at other rates: 22.05
   kHz male, 0.5 s (M = 770), float64 host loop and fused loop held to the
   JAX fixture (wide/fs22050) as in 3, float32 default under the gate
   against float64; 44.1 kHz male, 0.5 s, max_adaptations=2 (M = 1294) and
   48 kHz with gender (50, 180), 0.15 s, max_adaptations=2 (M = 1950;
   float32 "pallas"), float64 and float32 with float32 under the gate;
   wall, peak device memory and launches per path printed.
13. Fit phase: every path above asserts that both fit kernels (fit_basis,
   fit_gram: ops.fit) launched, once each per fit, graph replays included
   (the fused loops' warm calls launch them only inside replays), and that
   the plain version served no fit.  Then both kernels against the plain
   version (the torch-op gather and overlay, then the torch-op fit) at
   every fit shape the paths launched (B, N, Kc, mode, type), on table
   inputs drawn on the card (two utterances in one table, dead centres,
   windows clamped at both ends): R, rhs, dinv and fit_basis's A to 1e-12
   (complex128) / 3e-5 (complex64) of their largest entry, R exactly
   Hermitian; per shape fit_basis's and fit_gram's ms beside their halves
   of the plain version and their bounds, cuBLAS's three Grams beside
   fit_gram, and fit_gram's executed work over the least from the
   library's own plan (asserted <= 1.35); the stress fit per eaQHM
   adaptation through the kernels and the plain version at the stress
   runs' batches, beside the kernels before their redesign for Hopper.
14. Tracks phase: every path above asserts that the three tracks kernels
   (track_spline, track_synth, track_srer: ops.tracks) launched, spline and
   synth once each per adaptation, graph replays included (each replay of
   a fused loop launches the three), and that the plain version served no
   stage; stress prints the tracks span per eaQHM adaptation and the peak
   device memory of the stage beside the torch-op stage's.  Then the
   kernels against the plain version at every launch shape and mode the
   paths made (G, n, K, L, step, fs, type) and at edge shapes (two anchors,
   fewer than one spline tile, runs across many tiles), on seeded anchor
   grids of that shape (tests/torch_track_cases.py): track_spline's M,
   every output of the stage and the SRER, to 1e-10 (float64) / 2e-5
   (float32) of the largest entry and 1e-9 / 1e-4 dB, float32's flipped
   segments (the phase-end round at a tie) counted, fewer than 1 in 10^4;
   at the engine's shapes the tiers read through the frame map
   (stage_tiers) equal bit for bit to the dense form; per shape each
   kernel's ms beside the plain version's and its bound, its registers,
   spilled bytes (asserted 0) and blocks a SM; kernel ms from a CUDA
   graph of launches replayed (the device's time, no host gap).
15. Pitch phase: every path above asserts that both pitch kernels
   (swipe_loudness, swipe_pick: ops.pitch) launched, swipe_loudness's two
   launches (every window size's DFT, then the ERB epilogue) and one
   swipe_pick a call, swipe_pick writing the engines' f0 grid,
   the batch engine's paths one call a batch, that no DFT basis was built
   or kept on the card (the loudness reads the compact tables of the
   needed bins) and that the plain version served nothing; a plan's later
   calls (the warm calls) build no device plan, basis or table, so the
   stage uploads nothing.  Then both kernels against their plain versions
   at every (plan, batch, type) the paths ran, on seeded voices of that
   shape (tests/torch_pitch_cases.py): Ln from the signal to 1e-12 / 1e-5
   of its largest entry against the plain version on the full DFT bases,
   swipe_pick on the plain version's Si bit for bit (every step and the
   f0 grid), the kernel route against the plain route with the f0 steps
   that moved to another grid point counted (near ties; at most 0.1% of
   the steps, in float64 only where the strength agrees); per plan each
   kernel's ms beside the plain version's, its bound and the torch-op part
   of the parent's route (CUDA graphs replayed).
16. One JSON line of the kernels (each kernel at every launch the paths
   made: the Cholesky factor + solve and the substitution with a kept
   factor as two entries, the substitution's device launches a call
   counted from a captured call's graph nodes, both its paths timed at
   every shape the paths made beside torch.cholesky_solve and the two
   triangular solves; the block inverse per type at every call, fit_basis and fit_gram
   over every shape, the tracks kernels over every shape, the pitch kernels
   over every plan, launches counted
   per entry point and per path, counts set to 0 just before each path and
   read just after), the nvidia-smi line, and as the last line
   {"ok": true, "device": {...}}.

    python3 chip_smoke.py --phases stress presets    # some phases only

runs the setup and the phases named (base: 2-7; corpus: 8; stress: 9;
presets: 10; corpus64: 11; wide: 12), the fit, tracks and pitch phases over
their launches and a kernels line over them; the default is all of them.  Any
failure raises and exits non-zero before the last line.
Without CUDA, or outside a checkout of the repository, it fails.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
FS = 16000
# peak rates of an H100 SXM (NVIDIA data sheet): HBM bandwidth, and the
# highest rate at which each type's multiply-adds run (float32 outside the
# tensor cores, since TF32 stays off; float64 on the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"complex64": 67e12, "complex128": 67e12,
               # outside the tensor cores (the IIR recursion, the tracks)
               "float64": 34e12, "float32": 67e12}
# the pitch loudness's DFT: float64 on the FP64 tensor cores, float32 on
# FFMA (no TF32)
DFT_FLOP_S = {"float64": 67e12, "float32": 67e12}
KERNEL_TOL = {"complex64": 2e-4, "complex128": 1e-10}
RIDGED_TOL = 1e-2
SRER_TOL_DB = 1e-6
WAVE_TOL = 1e-8
F32_GATE_DB = 0.1
STREAM_TOL_DB = 1e-9        # tests/test_streams.py:40-43
MESH_SRER_TOL_DB = 1e-8     # tests/test_batch_engine.py:55-58
MESH_WAVE_TOL = 1e-9
CORPUS_N = 16               # utterances of the corpus phases
BATCH_N = 8                 # utterances of the batch phases
PHASES = ("base", "corpus", "stress", "presets", "corpus64", "wide")
STRESS_SECONDS = 60.0       # config 4's full signal
STRESS_SLICE = (32000, 40000)
# the JAX package's config 4 on its TPU v5e in float32 (tools/out/
# benchmarks_r5.json): printed as context, not a gate
TPU_STRESS_FINAL_DB = 29.6676
PRESETS = ("female", "male", "child")
CORPUS64_N = 64
# the block-inverse kernel against its plain version: x to 1e-4 relative in
# complex64 (float32 rounding of a recursion over cond(R) ~ 10 systems,
# tests/test_torch_solver.py _BI_TOL), 1e-10 in complex128
BI_TOL = {"complex64": 1e-4, "complex128": 1e-10}
# the kernel's residual ratio against the plain version's, and against the
# plain gate of the kernel's own x: about ten times the largest difference
# of the sound runs on the H100 (complex64 3.6e-7 against the plain
# version, 5.3e-7 against its own x; complex128 8.5e-16 and 1.7e-15)
BI_RATIO_TOL = {"complex64": 4e-6, "complex128": 1e-14}
BI_CELLS = ((512, 98), (512, 118), (512, 119), (512, 130), (512, 162),
            (512, 168), (512, 169), (154, 194), (512, 194), (512, 238),
            (512, 386), (256, 514), (64, 770), (16, 1294))
# the kernel's ms at these cells before its redesign for Hopper (this
# script's kernel phase, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): printed
# beside each cell's ms, not a gate
BI_BEFORE_MS = {
    "complex64": {(512, 98): 0.438, (512, 130): 0.9794, (512, 162): 1.644,
                  (512, 194): 1.795, (512, 238): 2.696, (512, 386): 7.381,
                  (256, 514): 8.395, (64, 770): 8.44, (16, 1294): 15.57},
    "complex128": {(512, 98): 0.9465, (512, 130): 1.167, (512, 162): 2.06,
                   (512, 194): 3.119, (512, 238): 4.507, (512, 386): 10.96,
                   (256, 514): 9.348, (64, 770): 9.319, (16, 1294): 15.75}}
# block-inverse calls per path of the main runs: name -> (calls (B, M,
# kernel path), kernel launches, launches in graph replays)
BI_RUNS = {}
# fit kernel launches per path: name -> (fit_basis shapes (B, N, Kc, mode,
# type), fit_basis launches, fit_gram launches, launches in graph replays)
FIT_RUNS = {}
STRESS_EAQHM = {}           # eaQHM adaptations of each stress run
# wrapper calls a stress tracks span (track_spline, track_synth, track_srer):
# the tracks phase turns them into device launches
STRESS_SPAN_CALLS = {}
# the fit kernels against the plain version (relative to the largest entry
# of R, rhs, dinv and A): complex128 to rounding; complex64 also sums the
# phase's fractional cumsum in a tree order (the integer one in row order
# where it is inexact, as torch.cumsum) and R over up to 2897 rows in
# float32: about 5x the largest gap of the card runs, 6.1e-6
FIT_TOL = {"float64": 1e-12, "float32": 3e-5}
# the stress fit per eaQHM adaptation through the fit kernels' first design,
# before their redesign for Hopper (the spans, PERF.md, NVIDIA H100 80GB
# HBM3, 700.00 W)
FIT_BEFORE_S = {"float32": "1.3488", "float64": "1.8904"}
# tracks kernel launches per path: name -> (track_spline shapes, track_synth
# shapes (G, n, K, L, step, type), track_srer shapes, launches in graph
# replays)
TRACK_RUNS = {}
# pitch kernels' launches by path: name -> (swipe_loudness shapes,
# swipe_pick shapes, (device plans, bases, compact tables) built); and the
# builds' counts when the counts were last set to 0
PITCH_RUNS = {}
PITCH_BUILDS = [0, 0, 0]
PITCH_TOL = {"float64": 1e-12, "float32": 1e-5}
# the tracks kernels against their plain version (of the largest entry of
# each output): float64 to rounding; float32 composes M's affine maps, the
# in-segment phase sum and the K-sum in other orders (a few float32 ulps of
# the phase, times fs / 2 pi in fm_current), about ten times the largest
# gap of the CUDA tests; a segment whose phase-end round flips at a float32
# tie (fm_current off by more than 1e-3 fs) is counted and left out
TRACK_TOL = {"float64": 1e-10, "float32": 2e-5}
TRACK_SRER_TOL_DB = {"float64": 1e-9, "float32": 1e-4}
# shapes the tracks phase checks beside the paths' own (no launch of the
# paths, so no share of the kernels line's sums): (G, n, K, L, step, fs,
# mode, type) and the acceptance rate of the grid.  Two anchors; fewer
# anchors than one spline tile; runs of up to ~100 anchors across several
# 32-anchor tiles; SA19's grid with runs across many tiles
TRACK_EDGES = tuple(
    ((1, n, K, (n - 1) * 15 + 1 + extra, 15, 16000.0,
      ("sum", True, False, True, True), t), p_acc)
    for n, K, extra, p_acc in ((2, 1, 7, 0.8), (20, 7, 20, 0.8),
                               (200, 9, 21, 0.99), (2185, 48, 7, 0.99))
    for t in ("float64", "float32"))
# the stress stage per eaQHM adaptation and its peak device memory as torch
# ops, before the kernels (tools/profile_torch_adapt.py --signal stress
# --peaks, PERF.md, NVIDIA H100 80GB HBM3, 700.00 W)
TRACKS_BEFORE = {"float64": ("0.1594 s", "18.53 GiB"),
                 "float32": ("0.1315 s", "10.05 GiB")}


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


def graph_ms(fn, reps):
    """Mean milliseconds of fn on the device timeline: reps calls captured
    into one CUDA graph, replayed (no host gap between the launches, which
    at small shapes take less time than the host needs to issue them)."""
    import torch
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


def hpd_batch(B, M, seed, dtype, device):
    """Random equilibrated HPD systems, as tests/test_ops.py builds them (A
    A^H / M + I, scaled to a unit diagonal), drawn on ``device`` from a
    seeded generator and built in complex128 there."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    c128 = torch.complex128
    A = torch.randn((B, M, M), dtype=c128, generator=g, device=device)
    b = torch.randn((B, M), dtype=c128, generator=g, device=device)
    R = A @ A.mH / M + torch.eye(M, dtype=c128, device=device)
    d = torch.diagonal(R, dim1=-2, dim2=-1).real.sqrt()
    R = R / (d[:, :, None] * d[:, None, :]).to(c128)
    return R.to(dtype).contiguous(), b.to(dtype).contiguous()


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


KERNEL_CELLS = ((9, 37), (512, 98), (512, 130), (512, 162), (512, 194),
                (512, 258))


def kernel_phase(torch, chol, cells=KERNEL_CELLS, what="kernel",
                 tols=KERNEL_TOL, reps=5):
    """Each (dtype, B, M) cell, both pivot rules: the fused solve and the
    kept factor's substitution against the plain versions on the card;
    times of the fused solve ("nan" rule, no factor kept) and of the
    cuSOLVER route.  cells: (B, M) pairs for both types, or a dict of them
    per type name."""
    worst = {}
    for dt in (torch.complex64, torch.complex128):
        cname = str(dt).split(".")[-1]
        tol = tols[cname]
        for B, M in (cells[cname] if isinstance(cells, dict) else cells):
            R, b = hpd_batch(B, M, seed=M, dtype=dt, device="cuda")
            path = chol.path_for(dt, M)
            errs = {}
            for mode in chol.MODES:
                x, f = chol.chol_solve(R, b, mode=mode, keep_factor=True)
                # the routed substitution, then each path by name
                xs = [chol.chol_subst(f, b)] + [
                    chol.chol_subst(f, b, path=p) for p in chol.SUBST_PATHS]
                torch.cuda.synchronize()
                xr = chol.chol_solve_reference(R, b, mode=mode)
                errs[mode] = (rel_err(x, xr),
                              *(rel_err(v, xr) for v in xs))
                r = torch.matmul(R, x[..., None])[..., 0] - b
                resid = (r.norm() / b.norm()).item()
                assert max(errs[mode]) <= tol, (cname, B, M, mode, errs)
                assert resid <= 10 * tol, (cname, B, M, mode, resid)
                worst[cname] = max(worst.get(cname, 0.0), *errs[mode])
            k_ms = cuda_ms(lambda: chol.chol_solve(R, b, mode="nan"), reps)
            lib_ms = cuda_ms(lambda: chol.chol_solve_reference(R, b), reps)
            bnd, by = bound_ms(*factor_cost(B, M, R.element_size(), False),
                               cname)
            s_ms = {p: cuda_ms(lambda: chol.chol_subst(f, b, path=p), reps)
                    for p in chol.SUBST_PATHS}
            Lf = chol.unpack_factor(f)

            def library():
                return torch.cholesky_solve(b[..., None], Lf)
            try:     # the library's batched cholesky_solve refuses M = 6146
                s_lib = f"{cuda_ms(library, reps):.4f}"
            except RuntimeError as e:
                s_lib = f"failed ({str(e).splitlines()[0]})"
            s_bnd, _ = bound_ms(*subst_cost(B, M, R.element_size()), cname)
            spath = chol.subst_path_for(M)
            log(f"{what} chol_solve {cname} B={B} M={M} path={path} "
                f"({chol.launches_per_call(M, path, B)} launches): "
                f"kernel_ms={k_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bnd:.4f} ({by}) max_rel_err (solve, subst "
                f"routed, {', '.join(chol.SUBST_PATHS)}) "
                f"guard={','.join(f'{e:.3e}' for e in errs['guard'])} "
                f"nan={','.join(f'{e:.3e}' for e in errs['nan'])} "
                f"(asserted <= {tol:g}); chol_subst routed to {spath} "
                f"({chol.subst_launches_per_call(M, spath, B)} launches) "
                f"ms {', '.join(f'{p} {v:.4f}' for p, v in s_ms.items())}, "
                f"cholesky_solve {s_lib}, bound {s_bnd:.4f}")
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
            x, f = chol.chol_solve(R, b, mode="nan", keep_factor=True)
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
            subst_nan_check(torch, chol, f, b,
                            [i in bad for i in range(64)], "non-PD")


def non_pd_bi_phase(torch, chol, solver, pref):
    """solve_gram(float32, "block_inverse") on the two non-PD batches of
    tests/test_torch_solver.py (fixture block_inverse/nonpd/*): on the card
    as on the CPU, the residual gate ("nonpd": the inverse stays finite) or
    the finite test ("zero_pivot") reruns the batch ridged (one Cholesky
    solve and one substitution); the healthy systems agree with the CPU to
    1e-4 relative and the finite pattern is the CPU's."""
    from eaqhm_torch.ops import block_inverse as bi
    for case in ("nonpd", "zero_pivot"):
        p = f"block_inverse/nonpd/{case}/"
        R = torch.as_tensor(pref[p + "R"])
        b = torch.as_tensor(pref[p + "b"])
        reset_counts(chol)
        xg = solver.solve_gram(R.cuda(), b.cuda(), torch.float32,
                               method="block_inverse").cpu()
        n_card = (chol.chol_solve.launches, chol.chol_subst.launches,
                  bi.block_inverse_solve.launches)
        assert bi.block_inverse_solve.plain_calls == 0
        xc = solver.solve_gram(R, b, torch.float32, method="block_inverse")
        ok = [0, 1, 2, 4, 5, 6, 7]
        e_ok = rel_err(xg[ok], xc[ok])
        log(f"non-PD block_inverse float32 {case}: card vs CPU healthy "
            f"max_rel_err {e_ok:.3e} (<= 1e-4), finite pattern equal "
            f"{bool(torch.equal(torch.isfinite(xg), torch.isfinite(xc)))}; "
            f"launches (chol_solve, chol_subst, block_inverse) {n_card}")
        assert n_card[:2] == (1, 1) and n_card[2] > 0, n_card
        assert e_ok <= 1e-4, e_ok
        assert torch.equal(torch.isfinite(xg), torch.isfinite(xc))


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
    (B, M, path) per substitution): error asserted, each shape's device
    launches counted from its captured call's graph nodes (and held to the
    wrapper's plan), times, launches and bound summed over all calls; one
    entry for the factor + solve, one for the substitution where the paths
    made one (subst_line_entry).  library_ms of the factor + solve is the
    cuSOLVER route for the same work: a Cholesky plus two triangular
    solves."""
    cname = str(dt).split(".")[-1]
    k_ms = p_ms = l_ms = nbytes = flops = err = 0.0

    pools = {}

    def systems(B, M, seed, shapes):
        """The first B systems of one seeded batch per (M, seed), drawn at
        the largest B launched at that M: the paths launch hundreds of
        distinct (B, M) shapes."""
        if (M, seed) not in pools:
            pools[(M, seed)] = hpd_batch(
                max(x[0] for x in shapes if x[1] == M), M, seed=seed + M,
                dtype=dt, device="cuda")
        R, b = pools[(M, seed)]
        return R[:B].contiguous(), b[:B].contiguous()

    def check(what, x, xr, n):
        rel = rel_err(x, xr)
        log(f"main-path {what} x{n}: max_rel_err={rel:.3e} "
            f"(asserted <= {KERNEL_TOL[cname]:g})")
        assert rel <= KERNEL_TOL[cname], (cname, what, rel)
        return (x - xr).abs().max().item()

    per_call = {}
    device_launches = 0
    for (B, M, path, mode, keep), n in sorted(Counter(fused).items()):
        R, b = systems(B, M, 1000, fused)
        x = chol.chol_solve(R, b, mode=mode, keep_factor=keep)
        x = x[0] if keep else x
        err = max(err, check(
            f"chol_solve {cname} B={B} M={M} {path} {mode} keep={keep}",
            x, chol.chol_solve_reference(R, b, mode=mode), n))
        # device launches of this shape's call, counted on the card
        got = graph_launches(torch, lambda: chol.chol_solve(
            R, b, mode=mode, keep_factor=keep))
        assert got == chol.launches_per_call(M, path, B), (B, M, path, got)
        per_call.setdefault(f"{M} {path}", set()).add(got)
        device_launches += n * got
        k_ms += n * cuda_ms(
            lambda: chol.chol_solve(R, b, mode=mode, keep_factor=keep), 3)
        p_ms += n * cuda_ms(
            lambda: chol.chol_solve_reference(R, b, mode=mode), 3)
        l_ms += n * cuda_ms(lambda: chol.chol_solve_reference(R, b), 3)
        cb, cf = factor_cost(B, M, R.element_size(), keep)
        nbytes += n * cb
        flops += n * cf
    bnd, by = bound_ms(nbytes, flops, cname)
    entries = [{"name": f"chol_solve[{cname}]", "route": "cuda",
                "source": "eaqhm_torch/kernels/csrc/chol_solve.cu",
                "replaces": "eaqhm_tpu/ops/pallas_chol.py:68",
                "launches": len(fused), "device_launches": device_launches,
                "device_launches_per_call": {k: sorted(v) for k, v
                                             in per_call.items()},
                "paths": dict(Counter(s[2] for s in fused)),
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": l_ms}]
    if subst:
        entries.append(subst_line_entry(torch, chol, dt, subst, systems,
                                        check))
    return entries


def subst_line_entry(torch, chol, dt, subst, systems, check):
    """The substitution with a kept factor ("guard" factors of seeded
    systems) at every (B, M, path) the main paths launched: each path held
    to the plain version, device launches a call counted from a captured
    call's graph nodes (held to the wrapper's plan), the routed path's ms,
    both paths' ms (the one-block kernel as the yardstick the tiled
    substitution must not lose to), and the two library
    routes: torch.cholesky_solve on the unpacked factor (one PyTorch call
    for the same function: library_ms) and the plain version's two
    torch.linalg.solve_triangular calls; all summed over the calls.  The
    shapes and counts also go to eaqhm_torch/kernels/build/
    subst_line_<type>.json for tools/torch_chol_route.py --subst-line."""
    cname = str(dt).split(".")[-1]
    scratch = os.path.join(ROOT, "eaqhm_torch", "kernels", "build")
    os.makedirs(scratch, exist_ok=True)        # listed in .gitignore
    calls = sorted(Counter(subst).items())
    with open(os.path.join(scratch, f"subst_line_{cname}.json"), "w") as f:
        json.dump([[cname, B, M, n] for (B, M, _), n in calls], f)
    ms = {"routed": 0.0, **dict.fromkeys(chol.SUBST_PATHS, 0.0)}
    lib = {"cholesky_solve": 0.0, "two_solve_triangular": 0.0}
    nbytes = flops = err = 0.0
    per_call, device_launches, slower = {}, 0, []
    for (B, M, path), n in calls:
        R, b = systems(B, M, 2000, subst)
        _, f = chol.chol_solve(R, b, mode="guard", keep_factor=True)
        L = chol.unpack_factor(f)
        xr = chol.chol_subst_reference(L, b)
        assert path == chol.subst_path_for(M), (B, M, path)
        for p in chol.SUBST_PATHS:
            err = max(err, check(f"chol_subst {cname} B={B} M={M} {p}"
                                 f"{' (routed)' if p == path else ''}",
                                 chol.chol_subst(f, b, path=p), xr, n))
        got = graph_launches(torch, lambda: chol.chol_subst(f, b))
        assert got == chol.subst_launches_per_call(M, path, B), (B, M, got)
        per_call[f"{B}x{M} {path}"] = got
        device_launches += n * got
        t = {p: cuda_ms(lambda: chol.chol_subst(f, b, path=p), 3)
             for p in chol.SUBST_PATHS}
        tl = {"cholesky_solve": cuda_ms(
                  lambda: torch.cholesky_solve(b[..., None], L), 3),
              "two_solve_triangular": cuda_ms(
                  lambda: chol.chol_subst_reference(L, b), 3)}
        if t[path] > t["one_block"]:
            slower.append(f"{B}x{M}")
        log(f"main-path chol_subst {cname} B={B} M={M} x{n}: routed {path} "
            f"({got} device launches a call); ms "
            f"{', '.join(f'{p} {v:.4f}' for p, v in t.items())}; library "
            f"{', '.join(f'{p} {v:.4f}' for p, v in tl.items())}")
        ms["routed"] += n * t[path]
        for p, v in t.items():
            ms[p] += n * v
        for p, v in tl.items():
            lib[p] += n * v
        cb, cf = subst_cost(B, M, R.element_size())
        nbytes += n * cb
        flops += n * cf
    bnd, by = bound_ms(nbytes, flops, cname)
    faster = min(lib, key=lib.get)
    log(f"chol_subst {cname} over the main paths: routed {ms['routed']:.3f}"
        f" ms, {', '.join(f'{p} {ms[p]:.3f}' for p in chol.SUBST_PATHS)},"
        f" library {', '.join(f'{p} {v:.3f}' for p, v in lib.items())} "
        f"(faster {faster}), bound {bnd:.3f} ({by}); shapes where the "
        f"routed path read slower than the one-block kernel: {slower}")
    return {"name": f"chol_subst[{cname}]", "route": "cuda",
            "source": "eaqhm_torch/kernels/csrc/chol_solve.cu",
            "replaces": "eaqhm_tpu/ops/pallas_chol.py:68",
            "launches": len(subst), "device_launches": device_launches,
            "device_launches_per_call": per_call,
            "paths": dict(Counter(x[2] for x in subst)),
            "max_abs_err": err, "ms": ms["routed"],
            "ms_by_path": {p: ms[p] for p in chol.SUBST_PATHS},
            "plain_ms": lib["two_solve_triangular"], "bound_ms": bnd,
            "bound_by": by, "library_ms": lib["cholesky_solve"],
            "library_ms_by_route": lib, "faster_library": faster}


def bi_line_entry(torch, bi, cname):
    """The block-inverse kernel and its plain version at every call the
    main paths made in one type (BI_RUNS): error asserted, launches per call
    of every (B, M, path) counted on the card (graph_launches, held to the
    wrapper's formula), times and bound summed over the calls; library_ms is
    torch.linalg.inv_ex plus the same five matrix-vector products."""
    runs = {k: v for k, v in BI_RUNS.items()
            if v[0] and v[0][0][3] == cname}
    if not runs:
        return None
    calls = Counter(c[:3] for v in runs.values() for c in v[0])
    dt = getattr(torch, cname)
    top = {}
    for B, M, _ in calls:
        top[M] = max(top.get(M, 0), B)
    pools = {M: hpd_batch(B, M, seed=3000 + M, dtype=dt, device="cuda")
             for M, B in top.items()}
    k_ms = p_ms = l_ms = nbytes = flops = err = 0.0
    per_call = {}
    for (B, M, path), n in sorted(calls.items()):
        R, b = (t[:B].contiguous() for t in pools[M])
        sol = bi.block_inverse_solve(R, b)
        ref = bi.solve_reference(R, b)
        rel = rel_err(sol.x, ref.x)
        prof = graph_launches(torch, lambda: bi.block_inverse_solve(R, b))
        per_call[f"{B}x{M} {path}"] = prof
        log(f"main-path block_inverse {cname} B={B} M={M} {path} x{n}: "
            f"max_rel_err={rel:.3e} (asserted <= {BI_TOL[cname]:g}); "
            f"launches per call {prof} (graph nodes; the wrapper's "
            f"formula {bi.launches_per_call(dt, M)})")
        assert rel <= BI_TOL[cname], (cname, B, M, rel)
        assert prof == bi.launches_per_call(dt, M), (cname, B, M, prof)
        assert prof <= 100 and (path == "hybrid" or prof <= 3), prof
        err = max(err, (sol.x - ref.x).abs().max().item())
        k_ms += n * cuda_ms(lambda: bi.block_inverse_solve(R, b), 3)
        p_ms += n * cuda_ms(lambda: bi.solve_reference(R, b), 1)
        l_ms += n * cuda_ms(lambda: bi_library(torch, R, b), 3)
        cb, cf = bi_cost(B, M, R.element_size())
        nbytes += n * cb
        flops += n * cf
    bnd, by = bound_ms(nbytes, flops, cname)
    return {"name": f"block_inverse[{cname}]", "route": "cuda",
            "source": "eaqhm_torch/kernels/csrc/block_inverse.cu",
            "replaces": "eaqhm_tpu/ops/solver.py:89",
            "launches": sum(v[1] for v in runs.values()),
            "launches_by_path": {k: v[1] for k, v in runs.items()},
            "replayed": sum(v[2] for v in runs.values()),
            "calls": sum(calls.values()),
            "calls_by_shape": {f"{B}x{M} {path}": n for (B, M, path), n
                               in sorted(calls.items())},
            "launches_per_call": per_call,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": l_ms}


def run_path(torch, chol, eaqhm_torch, sig, name, **kw):
    """One path of analyze: counts set to 0, a first call (counted launches
    and their shapes, read just after), then two warm calls for the time.
    Returns (first result, warm result, (fused shapes, subst shapes),
    launch record, first-call seconds)."""
    cfg = eaqhm_torch.EaqhmConfig(gender="female", **kw)
    reset_counts(chol)
    t0 = time.time()
    res = eaqhm_torch.analyze(sig, FS, cfg, device="cuda")
    torch.cuda.synchronize()
    first_s = time.time() - t0
    rec = {"launches": chol.chol_solve.launches,
           "replayed": chol.chol_solve.replayed,
           "subst": chol.chol_subst.launches,
           "subst_replayed": chol.chol_subst.replayed}
    shapes = (list(chol.chol_solve.shapes), list(chol.chol_subst.shapes))
    bi_calls, rec["bi"], rec["bi_replayed"] = take_bi(name)
    rec["fit"] = take_fit(name)[1]
    rec["tracks"] = len(take_tracks(name)[1])
    rec["pitch"] = take_pitch(name)[2]
    assert len(shapes[0]) == rec["launches"]
    assert len(shapes[1]) == rec["subst"]
    assert chol.chol_solve.plain_calls == chol.chol_subst.plain_calls == 0
    warm_s = []
    for _ in range(2):
        reset_counts(chol)
        t0 = time.time()
        warm = eaqhm_torch.analyze(sig, FS, cfg, device="cuda")
        torch.cuda.synchronize()
        warm_s.append(time.time() - t0)
    _, fit_warm, _, fit_replayed = take_fit(name + " (warm)", keep=False)
    tr_warm = take_tracks(name + " (warm)", keep=False)
    take_pitch(name + " (warm)", keep=False, warm=True, calls=1)
    from eaqhm_torch.ops import block_inverse
    rec["warm"] = {"launches": chol.chol_solve.launches,
                   "replayed": chol.chol_solve.replayed,
                   "subst": chol.chol_subst.launches,
                   "subst_replayed": chol.chol_subst.replayed,
                   "bi": block_inverse.block_inverse_solve.launches,
                   "bi_replayed": block_inverse.block_inverse_solve.replayed,
                   "fit": fit_warm, "fit_replayed": fit_replayed,
                   "tracks": len(tr_warm[1]), "tracks_replayed": tr_warm[3]}
    log(f"path {name}: srer={res.srer} launches (first call): chol_solve "
        f"{rec['launches']} ({rec['replayed']} in graph replays) chol_subst "
        f"{rec['subst']} ({rec['subst_replayed']} in replays) block_inverse "
        f"{rec['bi']} ({rec['bi_replayed']} in replays) over {len(bi_calls)}"
        f" calls {dict(Counter(bi_calls))}, fit_basis and fit_gram "
        f"{rec['fit']} each, track_spline and track_synth {rec['tracks']} "
        f"each; warm call "
        f"{rec['warm']} (B, M, path) "
        f"{dict(Counter(x[:3] for x in shapes[0]))} "
        f"first_call_s={first_s:.3f} warm_s={[round(w, 4) for w in warm_s]} "
        f"audio_s_per_s={len(sig) / FS / min(warm_s):.3f} "
        f"fused={res.fused} warm_fused={warm.fused} "
        f"stages={ {k: round(v, 4) for k, v in warm.timings.items()} } "
        f"tiers={res.tiers}")
    return res, warm, shapes, rec, first_s


def check_fixture(res, ref, what):
    """float64: the JAX fixture's adaptation count, SRER within 1e-6 dB,
    s_recon and det_ak within 1e-8."""
    d_srer = float(np.max(np.abs(np.asarray(res.srer) - ref["srer"]))) \
        if len(res.srer) == len(ref["srer"]) else float("inf")
    d_wave = float(np.max(np.abs(res.s_recon - ref["s_recon"])))
    d_ak = float(np.max(np.abs(res.det_ak - ref["det_ak"])))
    log(f"{what} vs JAX fixture: adaptations {len(res.srer)} vs "
        f"{len(ref['srer'])}, max|dSRER|={d_srer:.3e} dB (<= {SRER_TOL_DB}), "
        f"max|ds_recon|={d_wave:.3e} (<= {WAVE_TOL}), "
        f"max|ddet_ak|={d_ak:.3e} (<= {WAVE_TOL})")
    assert len(res.srer) == len(ref["srer"])
    assert d_srer <= SRER_TOL_DB and d_wave <= WAVE_TOL and d_ak <= WAVE_TOL


def check_gate(res, ref, what):
    """float32: finite, the fixture's shape, final SRER >= reference - 0.1
    dB (bench.py:89)."""
    final, final_ref = max(res.srer), float(np.max(ref["srer"]))
    log(f"{what}: final SRER {final:.6f} dB vs reference {final_ref:.6f} dB "
        f"(gate >= -{F32_GATE_DB} dB: delta {final - final_ref:+.6f}); "
        f"trajectory {res.srer}")
    assert np.all(np.isfinite(res.srer))
    assert final >= final_ref - F32_GATE_DB
    assert np.all(np.isfinite(res.s_recon))
    assert res.s_recon.shape == ref["s_recon"].shape


def check_fused(torch, chol, eaqhm_torch, sig, res, warm, rec, **kw):
    """The fused loop ran every eaQHM adaptation after the capture as one
    graph replay.  First call: adaptations 0 and 1 eager, then one replay
    per further adaptation; warm call (graph cached): adaptation 0 eager and
    every eaQHM adaptation a replay, the kernel launched inside each replay,
    and no eager launch beyond those of adaptation 0 alone (counted on a
    max_adaptations=0 run of the same configuration)."""
    n = len(res.srer)
    assert res.fused["eager"] == 2 and res.fused["replays"] == n - 2, \
        res.fused
    assert warm.fused["eager"] == 1 and warm.fused["replays"] == n - 1, \
        warm.fused
    assert warm.fused["cached_graph"] and len(warm.srer) == n
    w = rec["warm"]
    per_replay = w["replayed"] // warm.fused["replays"]
    assert per_replay > 0 and w["replayed"] == per_replay * (n - 1), w
    assert w["fit_replayed"] > 0 and \
        w["fit_replayed"] % warm.fused["replays"] == 0, w
    # each replay launches the three tracks kernels
    assert w["tracks_replayed"] == 3 * warm.fused["replays"], w
    reset_counts(chol)
    eaqhm_torch.analyze(sig, FS, eaqhm_torch.EaqhmConfig(
        gender="female", max_adaptations=0, **kw), device="cuda")
    torch.cuda.synchronize()
    adapt0 = (chol.chol_solve.launches, chol.chol_subst.launches)
    eager = (w["launches"] - w["replayed"], w["subst"] - w["subst_replayed"])
    assert eager == adapt0, (eager, adapt0)
    log(f"fused: {warm.fused['replays']} graph replays for {n - 1} eaQHM "
        f"adaptations, {per_replay} factor + solve launches and "
        f"{w['subst_replayed'] // warm.fused['replays']} substitutions "
        f"inside each replay; eager launches {eager} == adaptation 0's "
        f"{adapt0}; capture {res.fused['capture_s']:.3f} s")


def dsp_phase(torch, filters, vad, sig):
    """float64 filtfilt on the card against scipy (the VAD's two filters on
    the resynthesis), and the device VAD against the host VAD.  Returns the
    lfilter launches of the VAD path (counts set to 0 just before it)."""
    from scipy.signal import filtfilt
    x = torch.as_tensor(sig, dtype=torch.float64, device="cuda")
    for fc, ftype in ((30, "highpass"), (1500, "lowpass")):
        b, a, zi = filters.design_ellip(float(FS), float(fc), ftype)
        y = filters.filtfilt(b, a, zi, x).cpu().numpy()
        err = float(np.max(np.abs(y - filtfilt(b, a, sig))))
        log(f"dsp filtfilt float64 {fc} Hz {ftype} on the card vs scipy: "
            f"max_abs_err={err:.3e} (asserted <= 1e-10)")
        assert err <= 1e-10, (fc, err)
    filters.reset_counts()
    ti, sp, vo, fstep = vad.voiced_unvoiced_frames(x, FS, False)
    torch.cuda.synchronize()
    shapes = list(filters.lfilter.shapes)
    assert filters.lfilter.launches == len(shapes) == 4
    assert filters.lfilter.plain_calls == 0
    t0 = time.time()
    vad.voiced_unvoiced_frames(x, FS, False)
    torch.cuda.synchronize()
    vad_s = time.time() - t0
    hti, hsp, hvo, hstep = vad.voiced_unvoiced_frames_host(sig, FS, False)
    flips = (int((sp.cpu().numpy() != hsp).sum()),
             int((vo.cpu().numpy() != hvo).sum()))
    log(f"device VAD on the card vs host VAD: {len(ti)} frames, flag flips "
        f"(speech, voiced) {flips} (asserted 0), lfilter launches "
        f"{len(shapes)} {sorted(set(shapes))}, warm_s={vad_s:.4f}")
    assert np.array_equal(ti, hti) and fstep == hstep and flips == (0, 0)
    return shapes


def cli_phase(torch, eaqhm_torch, io, sig):
    """python -m eaqhm_torch.cli on a wav of the resynthesis, as a
    subprocess on the card (float32, the default solve), against the API on
    the same file."""
    import tempfile
    scratch = os.path.join(ROOT, "eaqhm_torch", "kernels", "build")
    os.makedirs(scratch, exist_ok=True)        # listed in .gitignore
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        wav = os.path.join(d, "sa19_resynth.wav")
        io.write_wav(wav, FS, sig)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "eaqhm_torch.cli", wav, "--gender",
             "female", "--json", "--quiet", "--out",
             os.path.join(d, "out.wav")], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        cli_s = time.time() - t0
        assert proc.returncode == 0, proc.stderr[-3000:]
        payload = json.loads(proc.stdout.strip().splitlines()[-1])
        fs, s = io.read_wav(wav)
        api = eaqhm_torch.analyze(s, fs, eaqhm_torch.EaqhmConfig(
            gender="female"), device="cuda")
        out = io.read_wav(os.path.join(d, "out.wav"))[1]
    d_final = abs(payload["final_srer_db"] - max(api.srer))
    log(f"cli: subprocess {cli_s:.2f} s (process start, kernel load, first "
        f"call), final SRER {payload['final_srer_db']:.6f} dB vs API "
        f"{max(api.srer):.6f} dB (|d| {d_final:.3e}, asserted <= 1e-9), "
        f"trajectory {payload['srer_db']}, output {out.shape}")
    assert d_final <= 1e-9 and len(payload["srer_db"]) == len(api.srer)
    assert out.shape == api.s_recon.shape


def corpus_config(eaqhm_torch, **kw):
    """The corpus configurations of the JAX benchmark (configs 3, 5, 6):
    female preset, max_adaptations=6."""
    return eaqhm_torch.EaqhmConfig(gender="female", max_adaptations=6, **kw)


def chol_shapes(chol):
    return list(chol.chol_solve.shapes), list(chol.chol_subst.shapes)


def reset_counts(chol):
    """Every kernel count of the fit, the solve, the tracks stage and the
    pitch stage to 0: the fit kernels', the Cholesky kernel's, the block
    inverse's, the tracks kernels' and the pitch kernels'; and the pitch
    stage's builds (device plans, DFT bases, compact DFT tables) so far,
    for take_pitch."""
    from eaqhm_torch.models import swipe
    from eaqhm_torch.ops import block_inverse, fit, pitch, stft, tracks
    chol.reset_counts()
    block_inverse.reset_counts()
    fit.reset_counts()
    tracks.reset_counts()
    pitch.reset_counts()
    PITCH_BUILDS[:] = [swipe.device_plans_built, stft.bases_built,
                       stft.columns_built]


def take_fit(name, keep=True):
    """The fit kernels' launches since the counts were set to 0: both
    kernels launched, once each per fit (graph replays included), none
    served by the plain version; kept in FIT_RUNS under name (keep) for the
    fit phase and the kernels line."""
    from eaqhm_torch.ops import fit
    fb, fg = fit.fit_basis, fit.fit_gram
    assert fit.plain_fits() == 0, (name, fit.plain_fits())
    assert fb.launches > 0 and fg.launches > 0, (name, fb.launches,
                                                 fg.launches)
    assert fb.launches == fg.launches == len(fb.shapes) == len(fg.shapes), (
        name, fb.launches, fg.launches)
    rec = (list(fb.shapes), fb.launches, fg.launches, fb.replayed)
    if keep:
        FIT_RUNS[name] = rec
    return rec


def take_tracks(name, keep=True):
    """The tracks kernels' launches since the counts were set to 0: each of
    the three launched (graph replays included), spline and synth once
    each per stage, none served by the plain version; kept in TRACK_RUNS
    under name (keep) for the tracks phase and the kernels line."""
    from eaqhm_torch.ops import tracks
    sp, sy, sr = tracks.track_spline, tracks.track_synth, tracks.track_srer
    assert tracks.plain_calls() == 0, (name, tracks.plain_calls())
    assert sp.launches == sy.launches > 0 and sr.launches > 0, (
        name, sp.launches, sy.launches, sr.launches)
    assert len(sy.shapes) == sy.launches and len(sr.shapes) == sr.launches
    rec = (list(sp.shapes), list(sy.shapes), list(sr.shapes),
           sp.replayed + sy.replayed + sr.replayed)
    if keep:
        TRACK_RUNS[name] = rec
    return rec


def take_pitch(name, keep=True, warm=False, calls=None):
    """The pitch kernels' launches since the counts were set to 0: both
    launched, swipe_loudness twice (its two device launches) for each
    swipe_pick call, of the same plan, every swipe_pick launch writing the
    engines' f0 grid, none served
    by the plain version, no DFT basis built and none kept on the card
    (the kernels read the compact tables); with calls, that many pitch
    calls (the batch engine: one per batch); with warm (a plan's later
    call), no device plan and no compact table built either, so the stage
    uploaded nothing (the signal is uploaded before it).  Kept in
    PITCH_RUNS under name (keep) for the pitch phase and the kernels
    line."""
    from eaqhm_torch.models import swipe
    from eaqhm_torch.ops import pitch, stft
    lo, pk = pitch.swipe_loudness, pitch.swipe_pick
    assert pitch.plain_calls() == 0, (name, pitch.plain_calls())
    assert lo.launches > 0 and pk.launches > 0, (name, lo.launches,
                                                 pk.launches)
    assert lo.launches == 2 * len(lo.shapes) == 2 * pk.launches, (
        name, lo.launches, pk.shapes)
    assert len(pk.shapes) == pk.launches
    assert [sh[3] for sh in lo.shapes] == [sh[5] for sh in pk.shapes], name
    assert all(sh[6] for sh in pk.shapes), (name, "f0 grid", pk.shapes)
    if calls is not None:
        assert pk.launches == calls, (name, pk.launches, calls)
    built = (swipe.device_plans_built - PITCH_BUILDS[0],
             stft.bases_built - PITCH_BUILDS[1],
             stft.columns_built - PITCH_BUILDS[2])
    assert built[1] == 0 and stft.basis_cache_bytes() == 0, (
        name, built, stft.basis_cache_bytes())
    if warm:
        assert built == (0, 0, 0), (name, built)
    rec = (list(lo.shapes), list(pk.shapes), built)
    if keep:
        PITCH_RUNS[name] = rec
    return rec


def take_bi(name, expect=False):
    """The block-inverse calls since the counts were set to 0, kept in
    BI_RUNS under name: none served by the plain version; with expect (a
    float32 default path), at least one kernel launch."""
    from eaqhm_torch.ops import block_inverse
    f = block_inverse.block_inverse_solve
    assert f.plain_calls == 0, (name, f.plain_calls)
    BI_RUNS[name] = (list(f.shapes), f.launches, f.replayed)
    if expect:
        assert f.shapes and f.launches > 0, (name, f.launches)
    return BI_RUNS[name]


def bi_cost(B, M, itemsize):
    """(bytes, real flops) of one block-inverse solve: R read once and x
    written once (rhs too); M^3/2 complex multiply-adds for the inverse
    (at each level of order n, T = P^-1 Q and U = T Sc^-1 take n^3/8 each,
    the Hermitian Sc and P^-1 + U T^H n^3/16 each as one triangle; summed
    over the levels, 3n^3/8 * 4/3) and 6 M^2 for the products with Ri and
    R, 8 real flops each.  The least the recursion needs: the kernel takes
    Sc and P^-1 + U T^H in full, as JAX rounds them (2M^3/3)."""
    return (B * (M * M + 2 * M) * itemsize,
            B * 8 * (M ** 3 / 2 + 6 * M * M))


def bi_library(torch, R, b):
    """The library route: torch.linalg.inv_ex and the same five batched
    matrix-vector products."""
    Ri = torch.linalg.inv_ex(R)[0]

    def mv(A, v):
        return torch.matmul(A, v[..., None])[..., 0]
    x = mv(Ri, b)
    for _ in range(2):
        x = x + mv(Ri, b - mv(R, x))
    return x


def graph_launches(torch, fn):
    """Device launches of one call of fn, counted on the card: fn is run
    once on a side stream, then captured into a CUDA graph on that stream,
    and the graph's kernel, memcpy and memset nodes are counted with
    libcuda's cuGraphGetNodes and cuGraphNodeGetType.  A graph with none
    fails."""
    import ctypes

    from eaqhm_torch.ops import block_inverse, chol, tracks
    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=side):
        fn()
    block_inverse.take_captured()         # launches of a capture, not a run
    tracks.take_captured()
    chol.take_captured()
    h = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(h, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)) == 0
    kinds = Counter()
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(t)) == 0
        kinds[t.value] += 1
    del g
    # CU_GRAPH_NODE_TYPE_KERNEL 0, _MEMCPY 1, _MEMSET 2
    launched = kinds[0] + kinds[1] + kinds[2]
    assert launched > 0, ("no kernel, memcpy or memset node", dict(kinds))
    return launched


def bi_kernel_phase(torch, bi):
    """The block-inverse kernel against its plain version (today's torch
    ops) on random equilibrated HPD batches, both types, every path, at
    BI_CELLS: x to BI_TOL, the gate's inputs, per cell the path, the
    kernel's, the plain version's and the library's ms, the bound and the
    launches per call (counted on the card by graph_launches, held to the
    wrapper's formula)."""
    worst = {}
    for dt in (torch.complex64, torch.complex128):
        cname = str(dt).split(".")[-1]
        for B, M in BI_CELLS:
            R, b = hpd_batch(B, M, seed=M, dtype=dt, device="cuda")
            path = bi.path_for(dt, M)
            n0 = bi.block_inverse_solve.launches
            sol = bi.block_inverse_solve(R, b)
            torch.cuda.synchronize()
            n_kernel = bi.block_inverse_solve.launches - n0
            ref = bi.solve_reference(R, b)
            err = rel_err(sol.x, ref.x)
            d_ratio = (sol.resid_ratio - ref.resid_ratio).abs().max().item()
            d_own = (sol.resid_ratio - bi.gate_inputs(R, b, sol.x).resid_ratio
                     ).abs().max().item()
            assert err <= BI_TOL[cname], (cname, B, M, err)
            assert bool(sol.ok) and bool(sol.finite.all()), (cname, B, M)
            assert d_ratio <= BI_RATIO_TOL[cname], (cname, B, M, d_ratio)
            assert d_own <= BI_RATIO_TOL[cname], (cname, B, M, d_own)
            worst[cname] = max(worst.get(cname, 0.0), err)
            want = bi.launches_per_call(dt, M)
            prof = graph_launches(
                torch, lambda: bi.block_inverse_solve(R, b))
            assert prof == want, (cname, M, prof, want)
            assert prof <= 100 and (path == "hybrid" or prof <= 3), prof
            k_ms = cuda_ms(lambda: bi.block_inverse_solve(R, b), 3)
            p_ms = cuda_ms(lambda: bi.solve_reference(R, b), 1)
            l_ms = cuda_ms(lambda: bi_library(torch, R, b), 3)
            bnd, by = bound_ms(*bi_cost(B, M, R.element_size()), cname)
            before = BI_BEFORE_MS[cname].get((B, M))
            log(f"bi kernel {cname} B={B} M={M} path={path}: kernel_ms="
                f"{k_ms:.4f} (before the redesign "
                f"{'not measured' if before is None else before}) "
                f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                f"bound_ms={bnd:.4f} ({by}) launches/call {prof} "
                f"(graph nodes; the wrapper's formula {want}; kernel "
                f"launches {n_kernel}) max_rel_err={err:.3e} (asserted <= "
                f"{BI_TOL[cname]:g}) max|d ratio| vs plain {d_ratio:.1e}, vs "
                f"the plain gate of its own x {d_own:.1e} (asserted <= "
                f"{BI_RATIO_TOL[cname]:g}) max ratio "
                f"{sol.resid_ratio.max().item():.2e}")
    return worst


def bi_fixture_phase(torch, chol, eaqhm_torch, pref):
    """float64 analyze with solve_method="block_inverse" (the kernel in
    complex128) on the 1 s tone of the fixture's engine_options group, held
    to JAX's recorded SRER (1e-6 dB) and waveform (1e-8)."""
    p = "engine_options/block_inverse/"
    cfg = eaqhm_torch.config_from_dict(json.loads(str(pref[p + "config"])))
    # "auto" is float64 where JAX recorded it (x64 on the CPU), float32 on
    # the card
    assert cfg.dtype == "auto" and cfg.solve_method == "block_inverse"
    cfg = dataclasses.replace(cfg, dtype="float64")
    reset_counts(chol)
    res = eaqhm_torch.analyze(pref[p + "signal"], FS, cfg, device="cuda")
    torch.cuda.synchronize()
    calls, launches, _ = take_bi("float64_block_inverse", expect=True)
    take_fit("float64_block_inverse")
    take_tracks("float64_block_inverse")
    take_pitch("float64_block_inverse")
    assert chol.chol_solve.launches == 0
    d_srer = float(np.max(np.abs(np.asarray(res.srer) - pref[p + "srer"])))
    d_wave = float(np.max(np.abs(res.s_recon - pref[p + "s_recon"])))
    log(f"float64 block_inverse (tone, 1 s) vs JAX fixture: adaptations "
        f"{len(res.srer)} vs {len(pref[p + 'srer'])}, max|dSRER|="
        f"{d_srer:.3e} dB (<= {SRER_TOL_DB}), max|ds_recon|={d_wave:.3e} "
        f"(<= {WAVE_TOL}); {len(calls)} calls, {launches} kernel launches "
        f"{dict(Counter(calls))}")
    assert len(res.srer) == len(pref[p + "srer"])
    assert d_srer <= SRER_TOL_DB and d_wave <= WAVE_TOL


def check_streams(out, seq, idx, what):
    """Every utterance of the run: the sequential run's adaptation count and
    final SRER within STREAM_TOL_DB (tests/test_streams.py:40-43)."""
    worst = 0.0
    for k, i in enumerate(idx):
        got, ref = out.done[k], seq[i]
        assert got["n_adaptations"] == len(ref.srer), (what, k, got)
        worst = max(worst, abs(got["final_srer_db"] - max(ref.srer)))
    log(f"{what}: {len(idx)} utterances, max|dfinal SRER| vs sequential "
        f"{worst:.3e} dB (asserted <= {STREAM_TOL_DB:g})")
    assert worst <= STREAM_TOL_DB, (what, worst)


def streams_phase(torch, chol, eaqhm_torch, streams, corpus):
    """The corpus sequentially (a warm-up pass, then a timed one: the
    float64 reference), then through run_streams with one worker and with
    four workers on the card (a 64-sample signal added, which must fail
    alone; kernel launches counted over this run), then the fused loop over
    four workers with two utterances listed twice, so that two workers
    capture and then replay one geometry at once.  Returns (sequential
    results, their seconds, launch shapes of the four-worker run)."""
    cfg = corpus_config(eaqhm_torch, dtype="float64")
    audio = sum(len(s) for s in corpus) / FS
    for s in corpus:
        eaqhm_torch.analyze(s, FS, cfg, device="cuda")
    seq, seq_s = [], []
    for s in corpus:
        t0 = time.time()
        seq.append(eaqhm_torch.analyze(s, FS, cfg, device="cuda"))
        seq_s.append(time.time() - t0)
    rates = {"sequential": audio / sum(seq_s)}
    idx = list(range(len(corpus)))
    one = streams.run_streams(corpus, FS, cfg, devices=["cuda:0"])
    check_streams(one, seq, idx, "streams 1 worker")
    rates["1 worker"] = one.audio_seconds_per_second
    reset_counts(chol)
    four = streams.run_streams(corpus + [np.zeros(64)], FS, cfg,
                               devices=["cuda:0"] * 4)
    torch.cuda.synchronize()
    shapes = chol_shapes(chol)
    assert chol.chol_solve.plain_calls == chol.chol_subst.plain_calls == 0
    take_fit("float64_streams")
    take_tracks("float64_streams")
    take_pitch("float64_streams")
    assert set(four.failed) == {len(corpus)}, four.failed
    check_streams(four, seq, idx, "streams 4 workers")
    rates["4 workers"] = four.audio_seconds_per_second
    fidx = [0, 0, 2, 2, 1, 3]
    fcfg = corpus_config(eaqhm_torch, dtype="float64", fused_adapt_loop=True)
    for rep in range(2):
        reset_counts(chol)
        fused = streams.run_streams([corpus[i] for i in fidx], FS, fcfg,
                                    devices=["cuda:0"] * 4)
        assert not fused.failed, fused.failed
        check_streams(fused, seq, fidx, f"fused streams 4 workers, run "
                      f"{rep + 1} (utterances {fidx})")
        log(f"fused streams run {rep + 1}: {chol.chol_solve.replayed} "
            f"factor + solve launches inside graph replays, "
            f"{chol.chol_solve.launches - chol.chol_solve.replayed} eager; "
            f"per worker {fused.per_device}")
        assert chol.chol_solve.replayed > 0
        assert take_fit(f"float64_fused_streams_{rep}", keep=False)[3] > 0
        assert take_tracks(f"float64_fused_streams_{rep}", keep=False)[3] > 0
        take_pitch(f"float64_fused_streams_{rep}", keep=False, warm=True)
    log(f"streams: audio-s/s over {len(corpus)} utterances ({audio:.1f} s "
        f"of audio, float64, female, max_adaptations=6): "
        f"{ {k: round(v, 3) for k, v in rates.items()} }; per worker "
        f"(1 worker) {one.per_device}, (4 workers) {four.per_device}; "
        f"elapsed 1 worker {one.elapsed:.3f} s, 4 workers "
        f"{four.elapsed:.3f} s, sequential {sum(seq_s):.3f} s")
    return seq, seq_s, shapes


def batch_phase(torch, chol, eaqhm_torch, batch_engine, corpus, ref, seq,
                seq_s):
    """analyze_batch (mesh=None) on utterances 0-7: float64 held to the JAX
    package's analyze_batch on the same input (the fixture's batch group);
    srer_mean against mean(final_srer); each utterance's gap to its
    per-utterance analyze, printed (not gated: the batch's common length,
    pitch-floor bounds and lockstep loop may move it; the fixture is the
    parity check); float32 (default solve) under the -0.1 dB gate against
    the float64 final SRERs; audio-s/s of a warm call against the
    sequential engine on the same utterances."""
    sigs = corpus[:BATCH_N]
    cfg64 = corpus_config(eaqhm_torch, dtype="float64")
    reset_counts(chol)
    t0 = time.time()
    out = batch_engine.analyze_batch(sigs, FS, cfg64, device="cuda")
    torch.cuda.synchronize()
    first_s = time.time() - t0
    sh64 = chol_shapes(chol)
    assert chol.chol_solve.plain_calls == 0
    take_fit("float64_batch")
    take_tracks("float64_batch")
    take_pitch("float64_batch", calls=1)
    t0 = time.time()
    warm = batch_engine.analyze_batch(sigs, FS, cfg64, device="cuda")
    warm_s = time.time() - t0
    n_ref = int(ref["batch/n_adaptations"])
    assert out.n_adaptations == n_ref, (out.n_adaptations, n_ref)
    d_srer = float(np.max(np.abs(out.srer - ref["batch/srer"])))
    d_wave = float(np.max(np.abs(out.s_recon - ref["batch/s_recon"])))
    log(f"batch float64 vs JAX fixture: adaptations {out.n_adaptations} vs "
        f"{n_ref}, max|dSRER|={d_srer:.3e} dB (<= {SRER_TOL_DB}), "
        f"max|ds_recon|={d_wave:.3e} (<= {WAVE_TOL}); final SRER "
        f"{np.round(out.final_srer, 6).tolist()}; warm call bit-identical "
        f"{bool(np.array_equal(warm.srer, out.srer))}")
    assert d_srer <= SRER_TOL_DB and d_wave <= WAVE_TOL
    d_mean = abs(out.srer_mean - float(np.mean(out.final_srer)))
    assert d_mean <= 1e-9, d_mean
    gaps = [float(out.final_srer[i] - max(seq[i].srer))
            for i in range(BATCH_N)]
    log(f"batch vs per-utterance analyze, final SRER gap per utterance "
        f"(batch - analyze, dB, not gated): {np.round(gaps, 4).tolist()}")
    cfg32 = corpus_config(eaqhm_torch, dtype="float32")
    reset_counts(chol)
    out32 = batch_engine.analyze_batch(sigs, FS, cfg32, device="cuda")
    torch.cuda.synchronize()
    sh32 = chol_shapes(chol)
    take_fit("float32_batch")
    take_tracks("float32_batch")
    take_pitch("float32_batch", calls=1)
    bi32 = take_bi("float32_batch", expect=True)
    d32 = out32.final_srer - out.final_srer
    log(f"batch float32 (default solve): final SRER "
        f"{np.round(out32.final_srer, 6).tolist()}, minus float64 "
        f"{np.round(d32, 6).tolist()} (gate >= -{F32_GATE_DB} dB), "
        f"adaptations {out32.n_adaptations}")
    assert np.all(np.isfinite(out32.srer)) and np.all(d32 >= -F32_GATE_DB)
    audio = sum(len(s) for s in sigs) / FS
    log(f"batch: first call {first_s:.3f} s, warm call {warm_s:.3f} s = "
        f"{audio / warm_s:.3f} audio-s/s against the sequential engine's "
        f"{audio / sum(seq_s[:BATCH_N]):.3f} audio-s/s on the same "
        f"{BATCH_N} utterances ({sum(seq_s[:BATCH_N]):.3f} s); launches "
        f"float64 {len(sh64[0])} (B, M) "
        f"{dict(Counter(x[:2] for x in sh64[0]))}, float32 factor + solve "
        f"{len(sh32[0])}, substitutions {len(sh32[1])}, block_inverse "
        f"{bi32[1]} launches over {len(bi32[0])} calls "
        f"{dict(Counter(bi32[0]))}")
    return out, sh64, sh32


def mesh_phase(torch, chol, eaqhm_torch, batch_engine, corpus_mod, mesh_mod,
               io, corpus, out_none):
    """A world-size-1 NCCL group from torchrun's environment
    (multihost_init) and make_mesh(1): analyze_batch over the mesh equals
    mesh=None within 1e-8 dB and 1e-9 of the waveform
    (tests/test_batch_engine.py:49-60); run_corpus_sharded over the 16
    utterances as wavs with a checkpoint: all done, none failed, and a
    second run skips them all.  Returns the launch shapes of the mesh
    call."""
    import datetime
    import socket
    import tempfile
    import torch.distributed as dist
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0"}
    os.environ.update(env)
    try:
        assert mesh_mod.multihost_init(
            timeout=datetime.timedelta(seconds=120)) is True
        assert dist.get_backend() == "nccl"
        mesh = mesh_mod.make_mesh(1)
        cfg64 = corpus_config(eaqhm_torch, dtype="float64")
        reset_counts(chol)
        out = batch_engine.analyze_batch(corpus[:BATCH_N], FS, cfg64,
                                         mesh=mesh, device="cuda")
        torch.cuda.synchronize()
        shapes = chol_shapes(chol)
        take_fit("float64_mesh")
        take_tracks("float64_mesh")
        take_pitch("float64_mesh", calls=1)
        d_srer = float(np.max(np.abs(out.srer - out_none.srer)))
        d_wave = float(np.max(np.abs(out.s_recon - out_none.s_recon)))
        log(f"mesh {tuple(mesh.shape)} (NCCL, world 1) vs mesh=None: "
            f"max|dSRER|={d_srer:.3e} dB (<= {MESH_SRER_TOL_DB}), "
            f"max|ds_recon|={d_wave:.3e} (<= {MESH_WAVE_TOL})")
        assert out.n_adaptations == out_none.n_adaptations
        assert d_srer <= MESH_SRER_TOL_DB and d_wave <= MESH_WAVE_TOL
        scratch = os.path.join(ROOT, "eaqhm_torch", "kernels", "build")
        os.makedirs(scratch, exist_ok=True)        # listed in .gitignore
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            paths = []
            for i, s in enumerate(corpus):
                paths.append(os.path.join(d, f"utt{i:03d}.wav"))
                io.write_wav(paths[-1], FS, s)
            ckpt = os.path.join(d, "ckpt")
            t0 = time.time()
            r1 = corpus_mod.run_corpus_sharded(paths, cfg64, mesh=mesh,
                                               checkpoint_dir=ckpt,
                                               device="cuda")
            t1 = time.time() - t0
            r2 = corpus_mod.run_corpus_sharded(paths, cfg64, mesh=mesh,
                                               checkpoint_dir=ckpt,
                                               device="cuda")
        log(f"run_corpus_sharded (mesh of one rank: run_corpus): "
            f"{len(r1.done)} done, {len(r1.failed)} failed in {t1:.3f} s "
            f"({r1.audio_seconds_per_second:.3f} audio-s/s); resumed run "
            f"skipped {len(r2.skipped)}, analyzed {len(r2.done)}")
        assert len(r1.done) == len(corpus) and not r1.failed
        assert sorted(r2.skipped) == sorted(r1.done) and not r2.done
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    return shapes


def determinism_child():
    """``python3 chip_smoke.py --determinism``: determinism.apply() before
    any CUDA matmul, then analyze_batch twice on utterances 0-7 (float64);
    prints one JSON line."""
    import torch
    sys.path.insert(0, ROOT)
    from eaqhm_torch.parallel import determinism
    applied = determinism.apply()
    import eaqhm_torch
    from eaqhm_torch.parallel import batch_engine
    from eaqhm_torch.parallel.corpus import corpus_signals
    sig = np.load(os.path.join(GOLDEN, "sa19_golden.npz"))["s_recon"]
    sigs = corpus_signals(sig, BATCH_N, FS)
    cfg = corpus_config(eaqhm_torch, dtype="float64")
    runs, secs = [], []
    for _ in range(2):
        t0 = time.time()
        runs.append(batch_engine.analyze_batch(sigs, FS, cfg, device="cuda"))
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    # the substitution's sums in a fixed order: each path bitwise equal
    # from run to run, and a system's x the same alone as in a batch of 8
    from eaqhm_torch.ops import chol
    subst = {}
    for dt in (torch.complex64, torch.complex128):
        R, b = hpd_batch(8, 1950, seed=1950, dtype=dt, device="cuda")
        _, f = chol.chol_solve(R, b, mode="guard", keep_factor=True)
        one = chol.Factor(f.L[1:2].contiguous(), f.d[1:2].contiguous())
        for p in chol.SUBST_PATHS:
            xa = chol.chol_subst(f, b, path=p)
            xb = chol.chol_subst(f, b, path=p)
            x1 = chol.chol_subst(one, b[1:2].contiguous(), path=p)
            subst[f"{str(dt).split('.')[-1]} {p}"] = bool(
                torch.equal(xa, xb) and torch.equal(xa[1:2], x1))
    print(json.dumps({
        "applied": applied, "seconds": secs, "subst_bitwise": subst,
        "srer_bitwise": bool(np.array_equal(runs[0].srer, runs[1].srer)),
        "s_recon_bitwise": bool(np.array_equal(runs[0].s_recon,
                                               runs[1].s_recon)),
        "final_srer": runs[0].final_srer.tolist(),
        "n_adaptations": runs[0].n_adaptations}), flush=True)


def determinism_phase(out64):
    """The determinism child as a subprocess (apply() is process-wide and
    CUBLAS_WORKSPACE_CONFIG must precede the first cuBLAS handle): its two
    runs' SRER arrays must be bitwise equal."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--determinism"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    d = float(np.max(np.abs(np.asarray(rep["final_srer"])
                            - out64.final_srer)))
    log(f"determinism: subprocess {time.time() - t0:.2f} s, applied "
        f"{rep['applied']}, analyze_batch x2 {np.round(rep['seconds'], 3)}"
        f" s, SRER bitwise equal {rep['srer_bitwise']}, s_recon bitwise "
        f"equal {rep['s_recon_bitwise']}, adaptations "
        f"{rep['n_adaptations']}, max|dfinal SRER| vs the default mode "
        f"{d:.3e} dB; chol_subst at 8 x 1950 bitwise equal from run to run "
        f"and alone as in the batch {rep['subst_bitwise']}")
    assert rep["srer_bitwise"], rep
    assert all(rep["subst_bitwise"].values()), rep


class SpanTimer:
    """The engine's spans (eaqhm/pitch, fit, solve, tracks) timed on the
    device timeline: while it is entered, engine.record_function also
    records a CUDA event on the current stream at each span's start and
    end, so a span's seconds are the device time from the first of its
    launches to the end of its last, gaps included.  per_adaptation() sums
    them per adaptation (each ends with its one tracks span; the pitch
    span falls in adaptation 0)."""

    def __init__(self, torch, engine):
        self.torch = torch
        self.engine = engine
        self.events = []

    def __enter__(self):
        torch, events = self.torch, self.events
        orig = self.orig = self.engine.record_function

        @contextlib.contextmanager
        def span(name):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            with orig(name):
                yield
            e1.record()
            events.append((name.split("/")[-1], e0, e1))

        self.engine.record_function = span
        return self

    def __exit__(self, *exc):
        self.engine.record_function = self.orig

    def per_adaptation(self):
        self.torch.cuda.synchronize()
        out, cur = [], {}
        for name, e0, e1 in self.events:
            cur[name] = cur.get(name, 0.0) + e0.elapsed_time(e1) / 1e3
            if name == "tracks":
                out.append(cur)
                cur = {}
        return out


class StagePeak:
    """The peak device memory of the tracks stage (engine._Adapter._finish)
    and of the whole call: the allocator's peak is reset just before every
    stage call and read just after it (the allocator counts on the host,
    so nothing synchronizes); ``call`` folds every reading in."""

    def __init__(self, torch, engine):
        self.torch = torch
        self.engine = engine
        self.stage = 0
        self.call = 0

    def __enter__(self):
        torch, adapter = self.torch, self.engine._Adapter
        orig = self.orig = adapter._finish

        def finish(ad, *a, **kw):
            self.call = max(self.call, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = orig(ad, *a, **kw)
            self.stage = max(self.stage, torch.cuda.max_memory_allocated())
            return out

        adapter._finish = finish
        return self

    def __exit__(self, *exc):
        self.engine._Adapter._finish = self.orig
        self.call = max(self.call, self.stage,
                        self.torch.cuda.max_memory_allocated())


def fixture_group(ref, prefix):
    """The entries of one fixture group, keys without the prefix."""
    return {k[len(prefix):]: ref[k] for k in ref.files
            if k.startswith(prefix)}


def solve_cells(engine, res, cdtype, chunk):
    """The (B, M) of the largest batch the solve gets per tier of a result:
    the tier's frames, cut at the batch budget (engine._batch_frames)."""
    return sorted({(min(n, engine._batch_frames(chunk, 2 * W + 1, Kc, cdtype,
                                                "cuda")), 2 * (2 * Kc + 1))
                   for n, W, Kc in res.tiers})


def stress_phase(torch, chol, eaqhm_torch, engine, benchmarks, pref):
    """Config 4 at full width, float64 (host loop) then float32 (the
    default solve), each once with the counts set to 0 just before it:
    wall, peak device memory, launches, and per adaptation the wall, the
    spans' device seconds and the SRER; float32's final SRER under the gate
    against float64's.  Then float64 on the stress slice held to the JAX
    fixture.  Returns ({path: launch shapes}, kernel cells per type)."""
    s = benchmarks.stress_signal(STRESS_SECONDS)
    results, shapes, cells = {}, {}, {}
    for dt, cname in (("float64", "complex128"), ("float32", "complex64")):
        cfg = benchmarks.stress_config(benchmarks.Run("cuda", dtype=dt))
        assert cfg.dtype == dt
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(chol)
        with SpanTimer(torch, engine) as spans, \
                StagePeak(torch, engine) as stage_peak:
            t0 = time.time()
            res = eaqhm_torch.analyze(s, FS, cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
        sh = chol_shapes(chol)
        assert chol.chol_solve.plain_calls == chol.chol_subst.plain_calls == 0
        shapes[f"{dt}_stress"] = sh
        bi_calls, bi_n, _ = take_bi(f"{dt}_stress", expect=dt == "float32")
        take_fit(f"{dt}_stress")
        tr = take_tracks(f"{dt}_stress")
        take_pitch(f"{dt}_stress", calls=1)
        peak = stage_peak.call
        per = spans.per_adaptation()
        assert len(per) == len(res.srer) == len(res.metrics), (len(per),
                                                                res.srer)
        log(f"stress {dt}: {STRESS_SECONDS:g} s of audio (male, "
            f"max_adaptations=10), wall {wall:.3f} s = "
            f"{STRESS_SECONDS / wall:.4f} audio-s/s, peak device memory "
            f"{peak / 2**30:.2f} GiB, tiers {res.tiers}, {len(res.srer)} "
            f"adaptations, launches chol_solve {len(sh[0])} chol_subst "
            f"{len(sh[1])} (B, M, path) {dict(Counter(x[:3] for x in sh[0]))}"
            f", block_inverse {bi_n} launches over {len(bi_calls)} calls "
            f"{dict(Counter(bi_calls))}; stages before the loop "
            f"{ {k: round(v, 3) for k, v in res.timings.items() if not k.startswith('adaptation')} }")
        for a, m in enumerate(res.metrics):
            log(f"stress {dt} adaptation {a}: wall {m['seconds']:.3f} s, SRER "
                f"{m['srer_db']:.6f} dB, device spans (s) "
                f"{ {k: round(v, 4) for k, v in per[a].items()} }")
        eaqhm = per[1:] or per
        STRESS_EAQHM[dt] = len(res.srer) - 1
        STRESS_SPAN_CALLS[dt] = tuple(len(x) / len(per) for x in tr[:3])
        log(f"stress {dt} per eaQHM adaptation (mean of {len(eaqhm)}): solve "
            f"{np.mean([p.get('solve', 0.0) for p in eaqhm]):.4f} s beside "
            f"fit {np.mean([p.get('fit', 0.0) for p in eaqhm]):.4f} s and "
            f"tracks {np.mean([p.get('tracks', 0.0) for p in eaqhm]):.4f} s "
            f"in {STRESS_SPAN_CALLS[dt][0]:g} / {STRESS_SPAN_CALLS[dt][1]:g}"
            f" / {STRESS_SPAN_CALLS[dt][2]:g} calls a span of track_spline / "
            f"track_synth / track_srer (the wrappers' counts; the tracks "
            f"phase counts their device launches) "
            f"(the torch-op stage before the kernels: "
            f"{TRACKS_BEFORE[dt][0]}); peak device memory of the tracks "
            f"stage {stage_peak.stage / 2**30:.2f} GiB (before the kernels "
            f"{TRACKS_BEFORE[dt][1]}), of the call {peak / 2**30:.2f} GiB")
        assert np.all(np.isfinite(res.srer))
        assert np.all(np.isfinite(res.s_recon))
        results[dt] = res
        cells[cname] = solve_cells(engine, res, getattr(torch, cname),
                                   cfg.chunk)
    f64, f32 = max(results["float64"].srer), max(results["float32"].srer)
    log(f"stress final SRER: float32 {f32:.6f} dB vs float64 {f64:.6f} dB "
        f"(delta {f32 - f64:+.6f}, gate >= -{F32_GATE_DB}); the JAX "
        f"package's float32 on its TPU recorded {TPU_STRESS_FINAL_DB} dB "
        f"over 7 adaptations (tools/out/benchmarks_r5.json: context, not a "
        f"gate)")
    assert f32 >= f64 - F32_GATE_DB, (f32, f64)
    # the solve batches the float64 path launched are the cells computed
    # from its tiers
    launched = {}
    for B, M, *_ in shapes["float64_stress"][0]:
        launched[M] = max(launched.get(M, 0), B)
    assert sorted((B, M) for M, B in launched.items()) \
        == cells["complex128"], (launched, cells)
    a, b = STRESS_SLICE
    ref = fixture_group(pref, "stress/")
    assert np.array_equal(s[a:b], ref["signal"])
    cfg = eaqhm_torch.config_from_dict(json.loads(str(ref["config"])))
    reset_counts(chol)
    t0 = time.time()
    res = eaqhm_torch.analyze(s[a:b], FS, cfg, device="cuda")
    torch.cuda.synchronize()
    shapes["float64_stress_slice"] = chol_shapes(chol)
    take_fit("float64_stress_slice")
    take_tracks("float64_stress_slice")
    take_pitch("float64_stress_slice")
    log(f"stress slice (samples {a}-{b}, max_adaptations="
        f"{cfg.max_adaptations}): {time.time() - t0:.3f} s, tiers "
        f"{res.tiers}, srer {res.srer}")
    assert res.tiers == [(470, 344, 128)], res.tiers
    check_fixture(res, ref, "stress slice float64 (M = 514)")
    return shapes, cells


def presets_phase(torch, chol, eaqhm_torch, filters, benchmarks, sig,
                  pref):
    """Config 2 on the resynthesis, per preset.  Its 30 Hz high-pass runs
    on the host (scipy's filtfilt, in both packages), and its output moves
    with the installed scipy; so the float64 parity check analyzes the
    high-passed signal the JAX fixture analyzed (presets/highpassed, fc=0:
    the same input to everything after the filter) and is held to
    presets/<gender>/* as in 3.  Then config 2 itself (fc=30, this
    machine's filter): float64 printed against the fixture (not gated),
    float32 (the default solve) under the gate.  Returns {path: launch
    shapes}."""
    from scipy.signal import filtfilt
    run = benchmarks.Run("cuda", dtype="float64")
    hp = pref["presets/highpassed"]
    b, a, _ = filters.design_ellip(float(FS), 30.0, "highpass")
    log(f"presets: this machine's 30 Hz high-pass of the resynthesis vs the "
        f"fixture's: max|d| {np.abs(filtfilt(b, a, sig) - hp).max():.3e} "
        f"(host scipy; not gated)")
    shapes = {"float64_presets": ([], []), "float32_presets": ([], [])}

    def call(g, what, s, cfg, path):
        reset_counts(chol)
        t0 = time.time()
        res = eaqhm_torch.analyze(s, FS, cfg, device="cuda")
        torch.cuda.synchronize()
        el = time.time() - t0
        sh = chol_shapes(chol)
        assert chol.chol_solve.plain_calls == 0
        shapes[path][0].extend(sh[0])
        shapes[path][1].extend(sh[1])
        name = f"{path}_{g}_{'fc0' if cfg.fc == 0 else 'fc30'}"
        bi = take_bi(name, expect=path.startswith("float32"))
        take_fit(name)
        take_tracks(name)
        take_pitch(name)
        log(f"presets {g} {what}: {el:.3f} s, tiers {res.tiers}, srer "
            f"{res.srer}, launches {len(sh[0])} + {len(sh[1])} (B, M) "
            f"{dict(Counter(x[:2] for x in sh[0]))}, block_inverse {bi[1]} "
            f"over {len(bi[0])} calls {dict(Counter(bi[0]))}")
        return res

    for g in PRESETS:
        ref = fixture_group(pref, f"presets/{g}/")
        cfg = eaqhm_torch.config_from_dict(json.loads(str(ref["config"])))
        assert cfg == run.config(gender=g, fc=30.0,
                                 full_waveform=True), cfg
        res = call(g, "float64 on the fixture's high-passed input", hp,
                   dataclasses.replace(cfg, fc=0.0), "float64_presets")
        check_fixture(res, ref, f"presets {g} float64")
        res = call(g, "float64 (fc=30 on this machine)", sig, cfg,
                   "float64_presets")
        d = (float(np.max(np.abs(np.asarray(res.srer) - ref["srer"])))
             if len(res.srer) == len(ref["srer"]) else float("nan"))
        log(f"presets {g} float64 with this machine's high-pass vs the "
            f"fixture: max|dSRER| {d:.3e} dB, adaptations {len(res.srer)} "
            f"vs {len(ref['srer'])} (not gated)")
        res = call(g, "float32 (fc=30, default solve)", sig,
                   dataclasses.replace(cfg, dtype="float32"),
                   "float32_presets")
        check_gate(res, ref, f"presets {g} float32 (default solve)")
    return shapes


def corpus64_phase(torch, chol, benchmarks, batch_engine):
    """Config 3 at BASELINE.json's scale: bench_config3(batch=64) in
    float64 on one card (JAX's rule: the sequential per-utterance engine),
    then analyze_batch (float64) on the same 64 utterances, first and warm
    call, with the per-utterance final-SRER gaps to the sequential run.
    Returns {path: launch shapes of analyze_batch's first call}."""
    run = benchmarks.Run("cuda", dtype="float64")
    line, seq = benchmarks.bench_config3(run, batch=CORPUS64_N, repeats=1)
    assert line["path"] == "sequential_per_utterance", line
    assert line["kernels"]["chol_solve"]["launches"] > 0
    for k in ("fit_basis", "fit_gram", "track_spline", "track_synth",
              "track_srer", "swipe_loudness", "swipe_pick"):
        assert line["kernels"][k]["launches"] > 0, line["kernels"]
        assert line["kernels"][k]["plain_calls"] == 0, line["kernels"]
    sigs, fs, _ = benchmarks.corpus(run, CORPUS64_N, 2.0)
    cfg = benchmarks.corpus_config(run)
    reset_counts(chol)
    t0 = time.time()
    out = batch_engine.analyze_batch(sigs, fs, cfg, device="cuda")
    torch.cuda.synchronize()
    first_s = time.time() - t0
    sh = chol_shapes(chol)
    assert chol.chol_solve.plain_calls == 0
    take_fit("float64_batch64")
    take_tracks("float64_batch64")
    take_pitch("float64_batch64", calls=1)
    t0 = time.time()
    batch_engine.analyze_batch(sigs, fs, cfg, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    gaps = np.asarray(out.final_srer) - np.asarray(seq["final_srer"])
    audio = CORPUS64_N * 2.0
    log(f"corpus-64: sequential (bench_config3, float64) "
        f"{line['value']} audio-s/s ({line['elapsed_s']} s); analyze_batch "
        f"first call {first_s:.3f} s, warm call {warm_s:.3f} s = "
        f"{audio / warm_s:.3f} audio-s/s, {out.n_adaptations} lockstep "
        f"adaptations, launches {len(sh[0])} (B, M) "
        f"{dict(Counter(x[:2] for x in sh[0]))}; final SRER gap per "
        f"utterance (batch - sequential, dB, not gated): max |gap| "
        f"{np.abs(gaps).max():.3e}, {np.round(gaps, 4).tolist()}")
    assert np.all(np.isfinite(out.srer)) and len(gaps) == CORPUS64_N
    reset_counts(chol)
    line32, seq32 = benchmarks.bench_config3(
        benchmarks.Run("cuda", dtype="float32"), batch=CORPUS64_N, repeats=1)
    bi = take_bi("float32_corpus64", expect=True)
    take_fit("float32_corpus64")
    take_tracks("float32_corpus64")
    take_pitch("float32_corpus64", calls=CORPUS64_N)
    d32 = np.asarray(seq32["final_srer"]) - np.asarray(seq["final_srer"])
    d_mean = line32["srer_mean_db"] - line["srer_mean_db"]
    log(f"corpus-64 float32 (default solve, sequential): {line32['value']} "
        f"audio-s/s ({line32['elapsed_s']} s) against float64's "
        f"{line['value']}; config 3's metric srer_mean_db "
        f"{line32['srer_mean_db']} against float64's {line['srer_mean_db']} "
        f"(delta {d_mean:+.3f}, gate >= -{F32_GATE_DB}); per utterance "
        f"final SRER minus float64 (float32 trajectories are chaotic, not "
        f"gated one by one) min {d32.min():+.6f} max {d32.max():+.6f} dB, "
        f"{int(np.sum(d32 < -F32_GATE_DB))} of {len(d32)} below -"
        f"{F32_GATE_DB}; block_inverse {bi[1]} launches over {len(bi[0])} "
        f"calls of the timed pass; kernels {line32['kernels']}")
    assert np.all(np.isfinite(d32)) and d_mean >= -F32_GATE_DB, d_mean
    return {"float64_batch64": sh}


WIDE_KERNEL_CELLS = ((64, 770), (32, 1026), (16, 1294), (8, 1950), (2, 6146),
                     (2, 6657))
# PERF.md's per-M batches, timed on every path that fits them
ROUTE_CELLS = {"complex64": ((512, 194), (512, 258), (512, 386), (256, 514)),
               "complex128": ((512, 194), (512, 258), (256, 386),
                              (128, 514))}
# (name, f0 of the tone, gender, seconds, max_adaptations, float32 solve):
# the fixture group wide/<name> holds 22.05 kHz's float64 result
WIDE_RUNS = (("fs22050", 80.0, "male", 0.5, None, None),
             ("fs44100", 80.0, "male", 0.5, 2, None),
             ("fs48000", 55.0, (50.0, 180.0), 0.15, 2, "pallas"))


def route_phase(torch, chol):
    """The M = 194-514 cells on every path that takes them (the resident
    path where the kernel routes M to it, the tiled path everywhere; a
    launch that fails fails the phase), beside the path the kernel takes:
    the kind of timings path_of in chol_solve.cu came from, printed, not
    gated."""
    for dt in (torch.complex64, torch.complex128):
        cname = str(dt).split(".")[-1]
        for B, M in ROUTE_CELLS[cname]:
            R, b = hpd_batch(B, M, seed=M, dtype=dt, device="cuda")
            xr = chol.chol_solve_reference(R, b)
            ms = {}
            routed = chol.path_for(dt, M)
            # the tiled path takes every order, the resident one its own
            for path in chol.PATHS if routed == "resident" else ("tiled",):
                x = chol.chol_solve(R, b, path=path)
                assert rel_err(x, xr) <= KERNEL_TOL[cname], (cname, M, path)
                ms[path] = round(cuda_ms(
                    lambda: chol.chol_solve(R, b, path=path), 5), 4)
            log(f"route {cname} B={B} M={M}: routed to {routed}; ms {ms}")


def subst_nan_check(torch, chol, f, b, bad, what):
    """The substitution with a "nan" rule factor that failed on the systems
    flagged in bad: each path gives NaN on exactly those (every entry) and
    chol_subst_reference on the unpacked factor the same; the healthy
    systems to KERNEL_TOL of it."""
    cname = str(b.dtype).split(".")[-1]
    b2 = (b * (0.5 + 1j)).contiguous()
    xr = chol.chol_subst_reference(chol.unpack_factor(f), b2)
    want = torch.isnan(xr).any(dim=1).tolist()
    ok = [i for i, v in enumerate(bad) if not v]
    for p in chol.SUBST_PATHS:
        xs = chol.chol_subst(f, b2, path=p)
        got = torch.isnan(xs).any(dim=1).tolist()
        err = rel_err(xs[ok], xr[ok])
        log(f"{what} nan rule chol_subst {cname} B={b.shape[0]} "
            f"M={b.shape[1]} {p}: NaN systems "
            f"{[i for i, v in enumerate(got) if v]} (plain "
            f"{[i for i, v in enumerate(want) if v]}), healthy max_rel_err "
            f"{err:.3e}")
        assert got == want == bad, (p, got, want, bad)
        bad_rows = [i for i, v in enumerate(bad) if v]
        assert torch.isnan(xs[bad_rows]).all(), p
        assert err <= KERNEL_TOL[cname], (p, err)


def wide_nan_phase(torch, chol):
    """The "nan" rule at the wide orders: a negative diagonal entry fails a
    factorization in the first panel of system 1 and in the last panel of
    system 3; NaN on exactly the systems cuSOLVER fails on, finite
    elsewhere."""
    for dt in (torch.complex64, torch.complex128):
        for B, M in ((4, 770), (4, 1950), (4, 6657)):
            R, b = hpd_batch(B, M, seed=M + 1, dtype=dt, device="cuda")
            R[1, 17, 17] = -1.0
            R[3, M - 5, M - 5] = -1.0
            x, f = chol.chol_solve(R, b, mode="nan", keep_factor=True)
            bad = torch.isnan(x).any(dim=1)
            ref = torch.isnan(chol.chol_solve_reference(R, b)).any(dim=1)
            log(f"wide nan rule {dt} B={B} M={M} path="
                f"{chol.path_for(dt, M)}: NaN systems {bad.tolist()}")
            assert bad.tolist() == [False, True, False, True] \
                == ref.tolist()
            diag = torch.diagonal(chol.unpack_factor(f), dim1=-2, dim2=-1)
            assert torch.isnan(diag[[1, 3]]).all()
            assert torch.isfinite(x[[0, 2]]).all()
            subst_nan_check(torch, chol, f, b, bad.tolist(), "wide")


def wide_phase(torch, chol, eaqhm_torch, benchmarks, pref):
    """The widest tiers.  Kernel cells at M = 770-6657 (both rules against
    the plain versions, errors to 2e-5 / 1e-12 relative, times beside
    cuSOLVER and the bound), the route's
    timings at M = 194-514, the "nan" rule on the wide paths.  Then
    analyze on 0.5 s tones (benchmarks.stress_signal at another rate and
    f0): 22.05 kHz male (M = 770), float64 host loop and fused loop held to
    the fixture's wide/fs22050, float32 default under the gate; 44.1 kHz
    male (M = 1294, max_adaptations=2) and 48 kHz gender=(50, 180)
    (M = 1950, 0.15 s, max_adaptations=2; float32 "pallas"), float64 and
    float32 with float32 under the gate, peak device memory printed.
    Returns {path: launch shapes}."""
    kernel_phase(torch, chol, cells=WIDE_KERNEL_CELLS, what="wide kernel",
                 tols={"complex64": 2e-5, "complex128": 1e-12}, reps=2)
    route_phase(torch, chol)
    wide_nan_phase(torch, chol)
    shapes = {}
    for name, f0, gender, seconds, max_ad, solve32 in WIDE_RUNS:
        fs = int(name[2:])
        s = benchmarks.stress_signal(seconds, fs, f0)
        kw = {} if max_ad is None else {"max_adaptations": max_ad}
        out = {}
        runs = [("float64", {}), ("float32", {} if solve32 is None
                                  else {"solve_method": solve32})]
        if name == "fs22050":          # the fixture's case: the fused loop too
            runs.insert(1, ("float64", {"fused_adapt_loop": True}))
        for dt, extra in runs:
            fused = extra.get("fused_adapt_loop", False)
            what = f"wide {name} {dt}{' fused' if fused else ''}"
            cfg = eaqhm_torch.EaqhmConfig(gender=gender, dtype=dt, **kw,
                                          **extra)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(chol)
            t0 = time.time()
            res = eaqhm_torch.analyze(s, fs, cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
            sh = chol_shapes(chol)
            assert chol.chol_solve.plain_calls == 0
            path = f"{dt}_wide_{name}" + ("_fused" if fused else "")
            shapes[path] = sh
            bi = take_bi(path, expect=dt == "float32" and solve32 is None)
            take_fit(path)
            take_tracks(path)
            take_pitch(path, calls=1)
            log(f"{what}: {seconds:g} s at {fs} Hz, wall {wall:.3f} s, peak "
                f"device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, tiers "
                f"{res.tiers}, srer {res.srer}, launches chol_solve "
                f"{len(sh[0])} chol_subst {len(sh[1])} (B, M, path) "
                f"{dict(Counter(x[:3] for x in sh[0]))} block_inverse "
                f"{bi[1]} launches over {len(bi[0])} calls "
                f"{dict(Counter(bi[0]))} fused={res.fused}")
            assert np.all(np.isfinite(res.srer))
            assert np.all(np.isfinite(res.s_recon))
            out[what] = res
        f64 = out[f"wide {name} float64"]
        if name == "fs22050":
            ref = fixture_group(pref, f"wide/{name}/")
            assert np.array_equal(s, ref["signal"])
            check_fixture(f64, ref, f"wide {name} float64 host loop")
            fused = out[f"wide {name} float64 fused"]
            assert fused.fused["replays"] > 0, fused.fused
            check_fixture(fused, ref, f"wide {name} float64 fused loop")
        check_gate(out[f"wide {name} float32"], {
            "srer": np.asarray(f64.srer), "s_recon": f64.s_recon},
            f"wide {name} float32 against float64")
    return shapes


# the sampling rate of each main-path window length (the wide tiers);
# 16 kHz otherwise
FIT_FS = {961: 22050.0, 1905: 44100.0, 2897: 48000.0}


def fit_inputs(torch, B, N, Kc, dtype, seed):
    """One batch of both fits' inputs as the engines hand them over, drawn
    on the card: two utterances of L = 3N samples in one table, fm / am
    tables of Kc + 5 columns (the fit reads the first Kc through the
    stride), harmonic tracks of an f0 per utterance inside the band, zero
    gaps and a run to an utterance's end, frames with windows clamped at
    both ends of each utterance, dead centres left of, at and right of
    frames' centres, dead frames, a frame with every harmonic masked, wl <
    W on most frames, fm at exact halves on one track."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, f64 = "cuda", torch.float64
    W = (N - 1) // 2
    L = 3 * N
    fs = FIT_FS.get(N, 16000.0)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev, dtype=f64)
    utt = torch.arange(B, device=dev) % 2
    ctr = torch.randint(0, L, (B,), generator=g, device=dev)
    ctr[0] = W // 3
    if B > 1:
        ctr[1] = L - 1 - W // 4
    t = torch.arange(L, device=dev, dtype=f64)
    f0 = (0.5 + 0.5 * rand(2, 1)) * (fs / 2 / Kc)
    f0_t = f0 * (1.0 + 0.05 * torch.sin(2 * np.pi * t / (L / 3.0)))
    k = torch.arange(1, Kc + 6, device=dev, dtype=f64)
    fm = f0_t[..., None] * k + 2.0 * torch.randn(
        (2, L, Kc + 5), generator=g, device=dev, dtype=f64)
    fm[0, ::7, 0] = torch.round(fm[0, ::7, 0]) + 0.5
    am = 0.01 + 0.49 * rand(2, L, Kc + 5)
    gaps = rand(2, L, Kc + 5) < 0.1
    gaps[1, L - N:, 1 % Kc] = True
    gaps[:, :, 0] |= rand(2, L) < 0.2
    fm = torch.where(gaps, 0.0, fm)
    am = torch.where(gaps, 0.0, am)
    dead = rand(2, L) < 0.05
    for d in (-7, 0, 5):
        dead[utt[2:], (ctr[2:] + d).clamp(0, L - 1)] = True
    dd = rand(B) < 0.5
    f0b = f0[utt, 0] * (1.0 + 0.05 * torch.sin(2 * np.pi * ctr / (L / 3.0)))
    K = torch.clamp(torch.floor(fs / 2 / f0b), max=Kc).long()
    colmask = fm[utt, ctr, :Kc] != 0
    colmask[:, 0] = True
    if B > 2:
        colmask[B - 1] = False
    wl = torch.randint(max(1, W // 2), W + 1, (B,), generator=g, device=dev)
    return dict(s=torch.randn((2, L), generator=g, device=dev,
                              dtype=f64).to(dtype), fm=fm.to(dtype),
                am=am.to(dtype), dead=dead, utt=utt, ctr=ctr, dd=dd, W=W,
                wl=wl, f0=f0b.to(dtype), K=K, colmask=colmask, fs=fs)


def fit_costs(torch, d, B, N, Kc, mode, isz):
    """(bytes, real flops) of fit_basis and of fit_gram on these inputs.
    fit_basis: the table rows its windows cover read once (s; fm and am's
    Kc columns and the dead centres in eaQHM mode) and the per-frame
    values, A, rhs, dinv, the mask and R's entries against the DC written
    once.  fit_gram: A, dinv and the mask read, R but the DC entries
    written; one triangle of each Gram, 3 M^2 N real flops a frame."""
    Kc2 = 2 * Kc + 1
    M = 2 * Kc2
    L = d["s"].shape[1]
    o = torch.arange(-d["W"], d["W"] + 1, device="cuda")
    rows = d["utt"][:, None] * L + (d["ctr"][:, None] + o).clamp(0, L - 1)
    covered = torch.unique(rows).numel()
    per_row = isz * (1 + 2 * Kc) + 1 if mode == "eaqhm" else isz
    frame = B * (8 + 8 + isz + (1 + Kc if mode == "eaqhm" else isz + 8))
    outs = B * (N * Kc2 * 2 * isz + 5 * M * 2 * isz + M * isz + Kc2)
    basis = (covered * per_row + frame + outs, 0)
    gram = (B * (N * Kc2 * 2 * isz + M * isz + Kc2
                 + (M * M - 4 * M) * 2 * isz), 3 * M * M * N * B)
    return basis, gram


def fit_phase(torch, fit):
    """Both fit kernels against the plain version (the torch-op gather and
    overlay, then the torch-op fit) at every fit shape the paths launched
    (FIT_RUNS), on table inputs drawn on the card (fit_inputs): R, rhs and
    dinv, and fit_basis's A, to FIT_TOL of their largest entry, R exactly
    Hermitian.  Per shape: fit_basis's and fit_gram's ms, each beside its
    half of the plain version (the gather and basis; build_gram_split) and
    its bound, cuBLAS's three Grams on materialized A and B beside
    fit_gram, and fit_gram's executed work over the least from the
    library's own plan (fit_gram_plan), asserted <= 1.35.  Then the stress
    fit per eaQHM adaptation: the kernels and the plain version at the
    stress runs' batches, beside the kernels' first design.  Returns the two
    kernels-line entries."""
    import ctypes
    lib = fit.library("cuda")
    plan = (ctypes.c_longlong * 3)()
    counts = Counter(sh for rec in FIT_RUNS.values() for sh in rec[0])
    keys = ("ms", "plain_ms", "library_ms", "t_bytes", "t_ops")
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("basis", "gram")}
    err = {"basis": 0.0, "gram": 0.0}
    per_shape = {}
    for i, (shape, count) in enumerate(sorted(counts.items())):
        B, N, Kc, mode, rname = shape
        dt = getattr(torch, rname)
        d = fit_inputs(torch, B, N, Kc, dt, seed=4000 + i)
        W, fs = d["W"], d["fs"]
        o = torch.arange(-W, W + 1, device="cuda")
        tab = (d["s"], d["utt"], d["ctr"], W)
        if mode == "iqhm":
            kw = dict(Kc=Kc, f0=d["f0"], K=d["K"])
            kern = lambda: fit.iqhm_gram_tables(  # noqa: E731
                *tab, d["wl"], d["f0"], d["K"], fs, Kc, dtype=dt)

            def plain_basis():
                s_win = fit.gather_windows(*tab)
                E1, w, cm = fit._iqhm_basis(o, d["wl"], d["f0"], d["K"], fs,
                                            Kc, dt)
                return E1, w, cm, s_win
        else:
            kw = dict(fm=d["fm"], am=d["am"], dead=d["dead"], dd=d["dd"],
                      colmask_k=d["colmask"])
            kern = lambda: fit.eaqhm_gram_tables(  # noqa: E731
                d["s"], d["fm"], d["am"], d["dead"], d["utt"], d["ctr"],
                d["dd"], W, d["wl"], d["colmask"], fs, dtype=dt)

            def plain_basis():
                s_win, fm_win, am_win = fit.gather_windows(
                    *tab, d["fm"], d["am"], d["dead"], d["dd"], Kc)
                E1, w, cm = fit._eaqhm_basis(fm_win, am_win, o, d["wl"],
                                             d["colmask"], fs, dt, 1e-4)
                return E1, w, cm, s_win

        def plain_gram(pb):
            E1, w, cm, s_win = pb
            return fit.build_gram_split(E1, w, o, s_win.to(dt), cm)

        def basis():
            return fit.fit_basis(mode, *tab, d["wl"], dt, fs=fs, **kw)
        fit.reset_counts()
        got = kern()
        pb = plain_basis()
        want = plain_gram(pb)
        out_b = basis()
        torch.cuda.synchronize()
        assert fit.plain_fits() == 0 and fit.fit_basis.launches == 2
        assert torch.equal(got[0], got[0].mH), shape
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        A_plain = pb[0] * pb[1][..., None].to(pb[0].dtype)
        errs.append(rel_err(out_b[0], A_plain))
        assert max(errs) <= FIT_TOL[rname], (shape, errs)
        err["gram"] = max(err["gram"], (got[0] - want[0]).abs().max().item())
        err["basis"] = max(err["basis"], max(
            (g - w).abs().max().item() for g, w in
            ((got[1], want[1]), (got[2], want[2]), (out_b[0], A_plain))))
        del got, want
        reps = 3 if count > 1 else 1
        A, R, _, dinv, mask = out_b
        k_ms = cuda_ms(kern, reps)
        b_ms = cuda_ms(basis, reps)
        g_ms = cuda_ms(lambda: fit.fit_gram(A, R, dinv, mask), reps)
        pb_ms = cuda_ms(plain_basis, reps)
        pg_ms = cuda_ms(lambda: plain_gram(pb), reps)
        Bm = A * o[None, :, None].to(A.dtype)
        Ah, Bh = A.mH, Bm.mH
        l_ms = cuda_ms(lambda: (torch.matmul(Ah, A), torch.matmul(Ah, Bm),
                                torch.matmul(Bh, Bm)), reps)
        del A, R, dinv, mask, out_b, Bm, Ah, Bh, pb, A_plain
        assert lib.fit_gram_plan(Kc, plan) == 0
        Kc2 = 2 * Kc + 1
        ratio = plan[1] * 16 * 16 * 24 / (12 * Kc2 * Kc2)
        assert ratio <= 1.35, (shape, ratio)
        cname = "complex128" if rname == "float64" else "complex64"
        costs = fit_costs(torch, d, B, N, Kc, mode,
                          8 if rname == "float64" else 4)
        del d
        per_shape[shape] = (k_ms, pb_ms + pg_ms)
        line = {}
        for key, ms, pms, lms, (nbytes, flops) in (
                ("basis", b_ms, pb_ms, 0.0, costs[0]),
                ("gram", g_ms, pg_ms, l_ms, costs[1])):
            t_b = nbytes / HBM_BYTES_S * 1e3
            t_o = flops / PEAK_FLOP_S[cname] * 1e3
            for k2, v in zip(keys, (ms, pms, lms, t_b, t_o)):
                tot[key][k2] += count * v
            line[key] = max(t_b, t_o)
        log(f"fit kernels {mode} {rname} B={B} N={N} Kc={Kc} (M = "
            f"{2 * Kc2}) x{count}: fit_basis {b_ms:.3f} ms (plain "
            f"{pb_ms:.3f}, bound {line['basis']:.4f} bytes), fit_gram "
            f"{g_ms:.3f} ms (plain {pg_ms:.3f}, cuBLAS's three Grams "
            f"{l_ms:.3f}, bound {line['gram']:.4f}), executed work over the "
            f"least {ratio:.3f} ({plan[1]} live pieces, {plan[0]} tiles a "
            f"frame); the fit {k_ms:.3f} ms; max_rel_err R, rhs, dinv, A "
            f"{[f'{e:.2e}' for e in errs]} (asserted <= {FIT_TOL[rname]})")
        torch.cuda.empty_cache()
    for dt, n_ad in STRESS_EAQHM.items():
        shapes = [sh for sh in FIT_RUNS[f"{dt}_stress"][0]
                  if sh[3] == "eaqhm"]
        k_s = sum(per_shape[sh][0] for sh in shapes) / 1e3 / n_ad
        p_s = sum(per_shape[sh][1] for sh in shapes) / 1e3 / n_ad
        log(f"stress {dt} fit per eaQHM adaptation ({n_ad} adaptations, "
            f"{len(shapes) // n_ad} batches each): the kernels {k_s:.4f} s "
            f"against the plain version's {p_s:.4f} s at the same batches "
            f"(this run's fit phase); the kernels' first design "
            f"{FIT_BEFORE_S[dt]} s "
            f"(PERF.md)")
    entries = []
    for key, name, replaces, also in (
            ("basis", "fit_basis", "eaqhm_tpu/ops/solver.py:508",
             ["eaqhm_tpu/ops/solver.py:402", "eaqhm_tpu/ops/solver.py:441",
              "eaqhm_tpu/models/engine.py:149"]),
            ("gram", "fit_gram", "eaqhm_tpu/ops/solver.py:212", [])):
        t = tot[key]
        by_path = {n: rec[1 if key == "basis" else 2]
                   for n, rec in FIT_RUNS.items()}
        entries.append({
            "name": name, "route": "cuda",
            "source": "eaqhm_torch/kernels/csrc/fit.cu",
            "replaces": replaces, "replaces_also": also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["t_bytes"], t["t_ops"]),
            "bound_by": ("bytes" if t["t_bytes"] >= t["t_ops"]
                         else "operations"),
            "library_ms": t["library_ms"] if key == "gram" else None})
    return entries


def tracks_inputs(torch, key, seed, p_acc=0.8):
    """The anchors of one tracks launch (the shape and mode the paths
    launched) on the card: tests/torch_track_cases.anchor_case at that
    shape, masked as the launch's caller masks them."""
    from torch_track_cases import anchor_case
    G, n, K, L, step, fs, (dc, anchors, dense, acc, voiced), tname = key
    dt = getattr(torch, tname)
    c = anchor_case(seed, G=G, n=n, K=K, step=step,
                    extra=L - (n - 1) * step - 1, fs=fs, p_acc=p_acc)
    t = {k: torch.as_tensor(c[k], device="cuda") for k in c
         if isinstance(c[k], np.ndarray)}
    for k in ("am", "fm", "ph", "a0", "det"):
        t[k] = t[k].to(dt)
    if not acc:
        for k in ("am", "fm", "ph"):
            t[k] = torch.where(t["acc"], t[k], 0)
    if not voiced:
        t["a0"] = torch.where(t["voiced"], t["a0"], 0)
    args = (t["am"], t["fm"], t["ph"], t["a0"], step, fs, L)
    kw = dict(acc=t["acc"] if acc else None,
              voiced=t["voiced"] if voiced else None)
    mode = dict(dc=dc, anchors=anchors, dense=dense)
    return t, args, kw, mode


def srer_inputs(torch, t, got, dc):
    """The SRER call after one tracks launch, as the engines make it: one
    utterance (std_det, n_valid) after the sequential engine's stage
    (dc "sum"), the groups (lens) after the batch engine's.  Returns (det,
    s, keyword arguments of masked_srer)."""
    if dc == "sum":
        det, s_rec = t["det"][0], got.s[0]
        nv = int(t["lens"][0])
        return det, s_rec, dict(std_det=torch.std(det[:nv], correction=0),
                                n_valid=nv)
    return t["det"], got.s + got.a0, dict(lens=t["lens"])


def tracks_costs(key, isz):
    """(bytes, operations) of track_spline, track_synth and track_srer at
    one launch: the anchors (and masks) read once and each output written
    once; the spline about 12 operations an anchor of a column, the synth
    one cos per (row, column), the SRER 4 operations a sample."""
    G, n, K, L, step, fs, (dc, anchors, dense, acc, voiced), _ = key
    C = G * K
    masks = (C * n if acc else 0) + (G * n if voiced else 0)
    spline = ((2 * C * n + G * n) * isz + masks + n * (C + G) * isz,
              12 * n * (C + G))
    outs = 2 + 2 * int(dense)
    synth = ((3 * C * n + G * n + n * (C + G)) * isz + masks
             + (outs * C * L + G * L * (1 + int(dc == "apart"))) * isz
             + (3 * C * n + G * n) * isz * int(anchors), C * L)
    srer = (2 * G * L * isz + G * isz, 4 * G * L)
    return spline, synth, srer


def tier_form(torch, tracks, t, kw, n):
    """The anchors of an engine launch as the sequential engine hands them
    to the stage: three tiers (Kb = K - 2, K - 1, K; the grid's frames in
    turn, one frame in no tier, an index past the grid) and the frame map.
    Returns (Tiers, voiced [1, n])."""
    K = t["am"].shape[2]
    dev = t["am"].device
    g = torch.Generator().manual_seed(n)
    frames = torch.randperm(n, generator=g)
    idx = [frames[1 + i::3].sort().values for i in range(3)]
    idx[2] = torch.cat([idx[2], torch.tensor([n])])
    parts = []
    for kb, ix in zip((max(K - 2, 0), max(K - 1, 0), K), idx):
        r = ix.clamp(max=n - 1).to(dev)
        parts.append((t["a0"][0, r], t["am"][0, r, :kb], t["fm"][0, r, :kb],
                      t["ph"][0, r, :kb], kw["acc"][0, r, :kb]))
    fmap = tracks.tier_map([ix.to(dev) for ix in idx], n, dev)
    return tracks.Tiers(fmap, tuple(parts), K), (fmap >= 0)[None]


def tracks_phase(torch, tracks):
    """The tracks kernels against their plain version at every launch shape
    and mode the paths made (TRACK_RUNS), and at TRACK_EDGES, on seeded
    anchor grids drawn at that shape (tests/torch_track_cases.py: runs of
    every length, a column with no run, runs to both ends, values outside
    the acceptance): M of track_spline against the plain spline, every
    output of the stage against the plain stage (TRACK_TOL of the largest
    entry; float32's flipped segments counted, asserted fewer than 1 in
    10^4 pair segments, and left out), the SRER against the plain SRER
    (TRACK_SRER_TOL_DB); at the engine's shapes the same anchors as tiers
    read through the frame map (stage_tiers) bit for bit equal to the
    dense form on the gathered grid.  Per shape the kernels' ms beside the
    plain version's and the bounds, each kernel's registers, spilled bytes
    and blocks a SM.  Returns the three kernels-line entries."""
    from torch_track_cases import stage_errors
    from eaqhm_torch.kernels import build
    counts = Counter(sh for rec in TRACK_RUNS.values() for sh in rec[1])
    ptx = build.ptxas_report("tracks")

    def regs(name):
        """(registers, spilled bytes) of each instantiation of a kernel."""
        return sorted({(v["registers"], v.get("spill_stores", 0))
                       for k, v in ptx.items() if name in k})
    log(f"tracks kernels ptxas (registers, spill bytes): spline_tiles "
        f"{regs('spline_tiles')}, spline_apply {regs('spline_apply')}, "
        f"track_synth {regs('track_synth')}, track_srer "
        f"{regs('track_srer')}")
    assert all(sp == 0 for name in ("spline_tiles", "spline_apply",
                                    "track_synth")
               for _, sp in regs(name)), ptx
    keys = ("ms", "plain_ms", "t_bytes", "t_ops")
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("spline", "synth", "srer")}
    err = {"spline": 0.0, "synth": 0.0, "srer": 0.0}
    flips_all = pairs_all = 0
    launches_per_call = {"spline": set(), "synth": set(), "srer": set()}
    cases = [(key, count, 0.8) for key, count in
             sorted(counts.items(), key=str)]
    cases += [(key, 0, p_acc) for key, p_acc in TRACK_EDGES]
    # the kernels line's shapes, counts and seeds, for
    # tools/bench_tracks_phases.py --line (another commit's kernels timed
    # on the same inputs, summed the same way)
    scratch = os.path.join(ROOT, "eaqhm_torch", "kernels", "build")
    os.makedirs(scratch, exist_ok=True)        # listed in .gitignore
    with open(os.path.join(scratch, "tracks_line_shapes.json"), "w") as f:
        json.dump([list(key) + [count, 6000 + i]
                   for i, (key, count, _) in enumerate(cases) if count], f)
    for i, (key, count, p_acc) in enumerate(cases):
        G, n, K, L, step, fs, mode_t, tname = key
        t, args, kw, mode = tracks_inputs(torch, key, seed=6000 + i,
                                          p_acc=p_acc)
        am, fm, ph, a0 = args[:4]
        tracks.reset_counts()
        M = tracks.track_spline(am, fm, kw["acc"], a0, kw["voiced"], step)
        M_ref = tracks.spline_reference(am, fm, a0, step, **kw)
        got = tracks.stage(*args, **kw, **mode)
        want = tracks.stage_reference(*args, **kw, **mode)
        torch.cuda.synchronize()
        assert tracks.plain_calls() == 0 and tracks.track_synth.launches == 1
        assert all(bool(torch.isfinite(x).all())
                   for x in (M, got.am, got.fm_cur, got.s)), key
        e_m = ((M - M_ref).abs().max().double()
               / M_ref.abs().max().double().clamp(min=1e-300)).item() \
            if M_ref.numel() else 0.0
        errs, flips, e_abs = stage_errors(got, want, step, n, flip_hz=(
            1e-3 * fs if tname == "float32" else None))
        pairs = int((t["acc"][:, :-1] & t["acc"][:, 1:]).sum())
        flips_all += count * flips
        pairs_all += count * pairs
        worst = max([e_m] + list(errs.values()))
        assert worst <= TRACK_TOL[tname], (key, e_m, errs)
        assert flips * 1e4 < max(pairs, 1), (key, flips, pairs)
        err["spline"] = max(err["spline"], (M - M_ref).abs().max().item())
        err["synth"] = max(err["synth"], e_abs)
        tiers_eq = None
        if G == 1 and mode_t[3] and mode_t[4] and mode["anchors"] and \
                not mode["dense"]:
            tiers, voiced = tier_form(torch, tracks, t, kw, n)
            a0_g, am_g, fm_g, ph_g, acc_g = tracks.gather_tiers_reference(
                tiers)
            via_map = tracks.stage_tiers(tiers, step, fs, L, voiced=voiced,
                                         **mode)
            on_grid = tracks.stage(am_g[None], fm_g[None], ph_g[None],
                                   a0_g[None], step, fs, L, acc=acc_g[None],
                                   voiced=voiced, **mode)
            tiers_eq = all(x is None or torch.equal(x, y)
                           for x, y in zip(via_map, on_grid))
            assert tiers_eq and tracks.plain_calls() == 0, key
            # the sequential engine's call: its device launches, counted
            tiers_launches = graph_launches(torch, lambda: tracks.stage_tiers(
                tiers, step, fs, L, voiced=voiced, **mode))
            assert tiers_launches == 3, (key, tiers_launches)
        det, s_rec, skw = srer_inputs(torch, t, got, mode["dc"])
        srer = tracks.masked_srer(det, s_rec, **skw)
        srer_ref = tracks.masked_srer_reference(det, s_rec, **skw)
        d_srer = (srer - srer_ref).abs().max().item()
        assert d_srer <= TRACK_SRER_TOL_DB[tname], (key, d_srer)
        err["srer"] = max(err["srer"], d_srer)
        reps = 10 if count > 1 else 3
        ms = {"spline": graph_ms(lambda: tracks.track_spline(
                  am, fm, kw["acc"], a0, kw["voiced"], step), reps),
              "synth": graph_ms(lambda: tracks.track_synth(
                  am, fm, ph, kw["acc"], a0, kw["voiced"], M, step, fs, L,
                  **mode), reps),
              "srer": graph_ms(lambda: tracks.masked_srer(det, s_rec, **skw),
                               reps)}
        tracks.take_captured()
        # device launches of one call of each wrapper, counted on the card
        # from a captured graph's nodes (the counts count calls)
        per_call = {
            "spline": graph_launches(torch, lambda: tracks.track_spline(
                am, fm, kw["acc"], a0, kw["voiced"], step)),
            "synth": graph_launches(torch, lambda: tracks.track_synth(
                am, fm, ph, kw["acc"], a0, kw["voiced"], M, step, fs, L,
                **mode)),
            "srer": graph_launches(torch, lambda: tracks.masked_srer(
                det, s_rec, **skw))}
        assert per_call == {"spline": 2, "synth": 1,
                            "srer": tracks.srer_plan(
                                s_rec.shape[-1]).launches}, (key, per_call)
        for k, v in per_call.items():
            launches_per_call[k].add(v)
        pms = {"spline": cuda_ms(lambda: tracks.spline_reference(
                   am, fm, a0, step, **kw), 1),
               "synth": cuda_ms(lambda: tracks.stage_reference(
                   *args, **kw, **mode), 1),
               "srer": cuda_ms(lambda: tracks.masked_srer_reference(
                   det, s_rec, **skw), 1)}
        costs = tracks_costs(key, t["am"].element_size())
        line = {}
        for k, (nbytes, ops) in zip(("spline", "synth", "srer"), costs):
            t_b = nbytes / HBM_BYTES_S * 1e3
            t_o = ops / PEAK_FLOP_S[tname] * 1e3
            for k2, v in zip(keys, (ms[k], pms[k], t_b, t_o)):
                tot[k][k2] += count * v
            line[k] = max(t_b, t_o)
        occ = {**tracks.occupancy("track_spline", G, n, K, step, L,
                                  t["am"].dtype),
               **tracks.occupancy("track_synth", G, n, K, step, L,
                                  t["am"].dtype)}
        R, tiles, _ = tracks.spline_plan(G, n, K)
        plan = tracks.synth_plan(G, n, K, step, L, t["am"].element_size())
        log(f"tracks kernels {tname} G={G} n={n} K={K} L={L} step={step} "
            f"fs={fs:g} mode={mode_t} x{count}"
            f"{'' if count else f' (edge, p_acc={p_acc})'}: track_spline "
            f"{ms['spline']:.4f} ms (plain {pms['spline']:.3f}, bound "
            f"{line['spline']:.4f}; {tiles} tiles of {R} x "
            f"{-(-(G * K + G) // 32)} column tiles), track_synth "
            f"{ms['synth']:.4f} ms (the plain stage {pms['synth']:.3f}, bound "
            f"{line['synth']:.4f}; {plan.blocks} blocks of {plan.threads}, "
            f"S={plan.S} J={plan.J} kept={plan.kept}), track_srer "
            f"{ms['srer']:.3f} ms (plain {pms['srer']:.3f}, bound "
            f"{line['srer']:.4f}); device launches a call {per_call}; "
            f"blocks a SM {occ}; max_rel_err M "
            f"{e_m:.2e}, stage { {k: f'{v:.2e}' for k, v in errs.items()} } "
            f"(asserted <= {TRACK_TOL[tname]:g}), SRER |d| {d_srer:.2e} dB; "
            f"flipped segments {flips} of {pairs} pairs; tiers through the "
            f"frame map equal to the dense form: {tiers_eq}")
        del t, args, got, want, M, M_ref
        torch.cuda.empty_cache()
    log(f"tracks phase: flipped segments (float32 phase-end ties) "
        f"{flips_all} of {pairs_all} pair segments over every launch")
    pc = [max(launches_per_call[k]) for k in ("spline", "synth", "srer")]
    for dt, calls in STRESS_SPAN_CALLS.items():
        log(f"stress {dt} tracks span: "
            f"{sum(c * p for c, p in zip(calls, pc)):g} device launches "
            f"(calls {calls} of track_spline / track_synth / track_srer x "
            f"device launches a call {pc}, counted from captured graphs' "
            f"nodes; stage_tiers, the engine's call: 3)")
    entries = []
    for key, name, replaces, also in (
            ("spline", "track_spline", "eaqhm_tpu/models/tracks.py:43",
             ["eaqhm_tpu/ops/interp.py:161"]),
            ("synth", "track_synth", "eaqhm_tpu/models/tracks.py:143",
             ["eaqhm_tpu/ops/interp.py:124", "eaqhm_tpu/ops/interp.py:161",
              "eaqhm_tpu/models/engine.py:424",
              "eaqhm_tpu/models/engine.py:549",
              "eaqhm_tpu/parallel/batch_engine.py:321"]),
            ("srer", "track_srer", "eaqhm_tpu/models/engine.py:451",
             ["eaqhm_tpu/parallel/batch_engine.py:419"])):
        t = tot[key]
        idx = {"spline": 0, "synth": 1, "srer": 2}[key]
        by_path = {n: len(rec[idx]) for n, rec in TRACK_RUNS.items()}
        entries.append({
            "name": name, "route": "cuda",
            "source": "eaqhm_torch/kernels/csrc/tracks.cu",
            "replaces": replaces, "replaces_also": also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "kernel_launches_per_call": max(launches_per_call[key]),
            "max_abs_err": err[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["t_bytes"], t["t_ops"]),
            "bound_by": ("bytes" if t["t_bytes"] >= t["t_ops"]
                         else "operations"),
            "library_ms": None})
    return entries


def pitch_costs(dp, x, Si, isz):
    """What one call's swipe_loudness launches and its grid swipe_pick
    launch need on this call's data (x [B, L]; Si [B, nf, nj] per window):
    (loudness bytes, DFT flops, other loudness flops, pick bytes, pick
    flops).  Loudness: the signal read once, each window's compact table,
    window and tables read once, Ln written once; the DFT's
    4 frames nfft bins flops (re and im, a multiply-add each); x * w once a
    sample of a frame; per frame and needed bin |X|^2 times its factor (4);
    per ERB point the lerp (3), sqrt(max(0, .)) (2), the square and the
    norm's sum (2) and the division (1); per frame the norm's sqrt and its
    test (2).  Pick, at the grid's steps only (the union of its points' two
    steps): the Si rows those steps lerp between, their tables, the plan's
    and the grid's tables read once, [B, Q, 3] written once; per step each
    window's candidates lerped and weighted (4 each; 1 - tw once a (window,
    step)), a candidate's windows' terms added, the argmax (nc - 1
    compares); at the steps whose argmax is inside the candidates the
    parabola (15), that candidate's valid fine-grid points (6 each, one
    compare fewer) and the octave step and pow (3 + 20); per grid point the
    resample of two columns (7)."""
    import torch
    from eaqhm_torch.ops import pitch
    B, L = x.shape
    lb, ldft, lother = B * L * isz, 0, 0
    for w in dp.windows:
        nu, nerb = w.scale_c.shape[0], w.erb_c.shape[0]
        M = B * w.nf
        lb += (w.nfft + 2 * w.nfft * nu + nu + M * nerb) * isz \
            + nerb * (4 + isz)
        ldft += 4 * M * w.nfft * nu
        lother += M * w.nfft + M * (4 * nu + 8 * nerb + 2)
    nc, gmax = dp.nftc.shape
    Q = dp.t_grid.shape[0]
    steps = np.union1d(dp.grid.pc.cpu().numpy(), dp.grid.nx.cpu().numpy())
    n = len(steps)
    pb = nc * (10 + gmax) * isz + nc * 4 + Q * (17 + 2 * isz) \
        + B * Q * 3 * isz
    pf = 7 * B * Q
    covered = np.zeros(nc, bool)
    for s, w in zip(Si, dp.windows):
        nj = s.shape[2]
        tlo = w.t_lo.cpu().numpy()[steps]
        frames = len(np.union1d(tlo, tlo + 1))
        pb += B * nj * frames * isz + nj * isz + n * (8 + isz)
        pf += B * n + B * n * 4 * nj
        covered[w.j0:w.j0 + nj] = True
    terms = sum(s.shape[2] for s in Si)
    pf += B * n * (terms - int(covered.sum()) + nc - 1)
    S = pitch.blend_reference(Si, dp)[:, torch.as_tensor(steps).to(
        Si[0].device), :]
    i = S.argmax(dim=-1)
    inner = (i > 0) & (i < nc - 1)
    nin = int(inner.sum().item())
    points = int(dp.nftc_len.long()[i.clamp(1, nc - 2)][inner].sum().item())
    pf += nin * 38 + 6 * points - nin
    return lb, ldft, lother, pb, pf


def pitch_phase(torch):
    """The pitch kernels (ops.pitch: swipe_loudness, swipe_pick) against
    their plain versions at every plan, batch and type the paths ran (each
    path asserted both kernels launched, the grid written by swipe_pick,
    no DFT basis built or kept and the plain version serving nothing), on
    seeded voices of that shape drawn for the phase
    (tests/torch_pitch_cases.py; a silent tenth): Ln from the signal to
    1e-12 / 1e-5 (float64 / float32) of its largest entry against
    loudness_reference on the full DFT bases; swipe_pick on the plain
    version's Si equal bit for bit to pick_reference (every step) and to
    grid_reference (the f0 grid); the whole kernel route against the plain
    route, the steps that moved counted (f0 to another grid point, or the
    coarse pick to another candidate: at most 0.1% of the steps, and in
    float64 only where the strength agrees; every coarse move a near tie
    proven on the blended strengths, which at both argmaxes agree to the
    tolerance in each route; every step's strength but those ties' to the
    tolerance above).  Per plan each kernel's ms beside the plain version's, its
    bound and the torch-op part of the parent's route (the loudness: pad,
    unfold, window and the DFT product on the full bases, ops.stft.spectrum;
    the pick: every step, then resample_f0_grid's torch ops): the device's
    time of 5 calls captured into a CUDA graph and replayed (the eager
    time, which the host's issue of the launch sets at these shapes,
    printed beside).  Returns the kernels line's two entries."""
    from eaqhm_torch.models import engine, swipe
    from eaqhm_torch.ops import pitch, stft
    from torch_pitch_cases import coarse_moves, compare_picks, voices
    cells = Counter()
    for rec in PITCH_RUNS.values():
        for B, items, nc, nwin, dt, key, grid in rec[1]:
            cells[(key, B, dt)] += 1
    tot = {k: dict(ms=0.0, plain_ms=0.0, parent_ms=0.0, t_bytes=0.0,
                   t_ops=0.0, err=0.0) for k in ("loudness", "pick")}
    moved = {"float64": [0, 0], "float32": [0, 0]}
    for i, ((key, B, dt), count) in enumerate(sorted(cells.items())):
        dtype = getattr(torch, dt)
        tol, isz = PITCH_TOL[dt], 8 if dt == "float64" else 4
        plan = swipe.make_plan(*key)
        x = torch.as_tensor(voices(B, key[3], key[0], key[1], key[2],
                                   4000 + i), dtype=dtype, device="cuda")
        dp = swipe.device_plan(plan, dtype, x.device)
        Si_k, Si_p, l_err = [], [], 0.0

        def kern():
            return pitch.loudness(x, dp)

        def dft_route():
            return [stft.spectrum(x, w.nfft, w.hop, w.window, w.pad_pre,
                                  w.pad_post) for w in dp.windows]

        def plain():
            return [pitch.loudness_reference(s, w)
                    for s, w in zip(dft_route(), dp.windows)]

        for w, ln, ref in zip(dp.windows, kern(), plain()):
            e = (ln - ref).abs().max().item()
            assert e <= tol * ref.abs().max().item(), (key, B, dt, w.nfft, e)
            l_err = max(l_err, e)
            Si_k.append(torch.matmul(ln, w.kernel.t()))
            Si_p.append(torch.matmul(ref, w.kernel.t()))
        l_ms = graph_ms(kern, 5)
        lp_ms = graph_ms(plain, 5)
        ld_ms = graph_ms(dft_route, 5)
        le_ms = cuda_ms(kern, 5)
        rows_want = pitch.pick_reference(Si_p, dp)
        grid_want = pitch.grid_reference(Si_p, dp)
        rows_eq = torch.equal(pitch.pick(Si_p, dp), rows_want)
        grid_eq = torch.equal(pitch.pick(Si_p, dp, grid=True), grid_want)
        assert rows_eq and grid_eq, (key, B, dt, rows_eq, grid_eq)
        route = compare_picks(pitch.pick(Si_k, dp).cpu().numpy(),
                              rows_want.cpu().numpy(), dt, coarse_moves(
                                  pitch.blend_reference(Si_k, dp),
                                  pitch.blend_reference(Si_p, dp), tol))
        assert route["t_equal"] and route["strength_rel_err"] <= tol, route
        assert route["coarse_ties"] == route["coarse_moved"], route
        assert route["f0_moved"] <= 1e-3 * route["steps"], route
        if dt == "float64":
            assert route["f0_moved_strength_rel_err"] <= tol, route
        moved[dt][0] += route["f0_moved"]
        moved[dt][1] += route["steps"]
        p_ms = graph_ms(lambda: pitch.pick(Si_p, dp, grid=True), 5)
        pp_ms = graph_ms(lambda: pitch.grid_reference(Si_p, dp), 5)
        pr_ms = graph_ms(lambda: engine.resample_f0_grid(
            pitch.pick(Si_p, dp), dp.t_grid), 5)
        pe_ms = cuda_ms(lambda: pitch.pick(Si_p, dp, grid=True), 5)
        p_err = float((pitch.pick(Si_p, dp, grid=True)
                       - grid_want).abs().max().item())
        lb, ldft, lother, pb, pf = pitch_costs(dp, x, Si_p, isz)
        l_ops = (ldft / DFT_FLOP_S[dt] + lother / PEAK_FLOP_S[dt]) * 1e3
        p_ops = pf / PEAK_FLOP_S[dt] * 1e3
        for k, ms, pms, par, nb, t_ops, err in (
                ("loudness", l_ms, lp_ms, ld_ms, lb, l_ops, l_err),
                ("pick", p_ms, pp_ms, pr_ms, pb, p_ops, p_err)):
            t = tot[k]
            t["ms"] += count * ms
            t["plain_ms"] += count * pms
            t["parent_ms"] += count * par
            t["t_bytes"] += count * nb / HBM_BYTES_S * 1e3
            t["t_ops"] += count * t_ops
            t["err"] = max(t["err"], err)
        log(f"pitch {dt} fs={key[0]:g} plim=({key[1]:g}, {key[2]:g}) "
            f"L={key[3]} B={B} windows {[w.nfft for w in dp.windows]} ks "
            f"{[pitch.loudness_splits(B * w.nf, w.scale_c.shape[0], w.nfft,
                                      pitch.sm_count(x.device))
                for w in dp.windows]} "
            f"x{count} calls: swipe_loudness {l_ms:.4f} ms a call (eager "
            f"{le_ms:.4f}; plain {lp_ms:.4f}; the parent's DFT route "
            f"{ld_ms:.4f}; bound {max(lb / HBM_BYTES_S * 1e3, l_ops):.4f}, "
            f"max_abs_err {l_err:.2e}), swipe_pick (grid) {p_ms:.4f} ms "
            f"(eager {pe_ms:.4f}; plain {pp_ms:.4f}; every step + torch "
            f"resample {pr_ms:.4f}; bound "
            f"{max(pb / HBM_BYTES_S * 1e3, p_ops):.4f}); pick on the same "
            f"Si bit for bit: rows {rows_eq}, grid {grid_eq}; kernel route "
            f"against the plain route {route}")
        del Si_k, Si_p, x
        torch.cuda.empty_cache()
    log(f"pitch: f0 moved to another grid point (near ties), kernel route "
        f"against the plain route: {moved} (steps moved, steps); DFT bases "
        f"cached for the plain versions {stft.basis_cache_bytes() / 2**20:.1f}"
        f" MiB; compact tables {stft.columns_cache_bytes() / 2**20:.1f} MiB")
    entries = []
    for k, name, replaces, also, parent in (
            ("loudness", "swipe_loudness", "eaqhm_tpu/models/swipe.py:203",
             ["eaqhm_tpu/ops/stft.py:46"], "dft_route_ms"),
            ("pick", "swipe_pick", "eaqhm_tpu/models/swipe.py:230",
             ["eaqhm_tpu/models/swipe.py:203", "eaqhm_tpu/models/swipe.py:258",
              "eaqhm_tpu/models/engine.py:39"], "steps_then_resample_ms")):
        t = tot[k]
        per_call = 2 if k == "loudness" else 1
        by_path = {n: per_call * len(rec[0 if k == "loudness" else 1])
                   for n, rec in PITCH_RUNS.items()}
        entries.append({
            "name": name, "route": "cuda",
            "source": "eaqhm_torch/kernels/csrc/swipe.cu",
            "replaces": replaces, "replaces_also": also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "kernel_launches_per_call": per_call,
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            parent: t["parent_ms"],
            "bound_ms": max(t["t_bytes"], t["t_ops"]),
            "bound_by": ("bytes" if t["t_bytes"] >= t["t_ops"]
                         else "operations"),
            "library_ms": None})
    entries[1]["f0_moved_by_type"] = moved
    return entries


def lfilter_line_entry(torch, filters, shapes):
    """The lfilter kernel at every launch the VAD path made, on seeded
    inputs of each launch's shape (the 30 Hz high-pass): held bit for bit
    to its plain version on the card (the same roundings in the same order),
    timed against it.  Bound: x read and y written once, 2 * order + 1
    products and 2 * order sums per sample, FP64 outside the tensor cores."""
    b, a, zi = filters.design_ellip(float(FS), 30.0, "highpass")
    bn, an = b / a[0], a / a[0]
    k_ms = p_ms = err = 0.0
    for i, ((rows, n, order, dt), count) in enumerate(
            sorted(Counter(shapes).items())):
        rng = np.random.default_rng(3000 + i)
        x = torch.as_tensor(rng.normal(size=(rows, n)), device="cuda")
        z0 = torch.as_tensor(zi.copy(), device="cuda").expand(
            rows, order).contiguous()
        y, zf = filters.lfilter_with_state(b, a, x, zi=z0)
        t0 = time.time()
        yr, zr = filters.lfilter_reference(bn, an, x, z0)
        torch.cuda.synchronize()
        p_ms += count * (time.time() - t0) * 1e3
        e = max((y - yr).abs().max().item(), (zf - zr).abs().max().item())
        log(f"kernel lfilter {dt} rows={rows} n={n} order={order} "
            f"x{count}: max_abs_err={e:.3e} (asserted == 0)")
        assert e == 0.0, e
        err = max(err, e)
        k_ms += count * cuda_ms(
            lambda: filters.lfilter_with_state(b, a, x, zi=z0), 5)
    nbytes = sum(rows * n * 16 for rows, n, _, _ in shapes)
    flops = sum(rows * n * (4 * order + 2) for rows, n, order, _ in shapes)
    bnd, by = bound_ms(nbytes, flops, "float64")
    return {"name": "lfilter[float64]", "route": "cuda",
            "source": "eaqhm_torch/kernels/csrc/lfilter.cu",
            "replaces": "eaqhm_tpu/ops/filters.py:59",
            "launches": len(shapes),
            "launches_by_path": {"vad_device": len(shapes)},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def main(phases=PHASES):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import eaqhm_torch
    from eaqhm_torch import benchmarks
    from eaqhm_torch.kernels import build
    from eaqhm_torch.models import engine, vad
    from eaqhm_torch.ops import block_inverse, chol, filters, fit, solver
    from eaqhm_torch.ops import tracks
    from eaqhm_torch.parallel import batch_engine, streams
    from eaqhm_torch.parallel import corpus as corpus_mod
    from eaqhm_torch.parallel import mesh as mesh_mod
    from eaqhm_torch.parallel.corpus import corpus_signals
    from eaqhm_torch.utils import io

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    import scipy
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} scipy {scipy.__version__} numpy "
        f"{np.__version__} device {torch.cuda.get_device_name(0)}; "
        f"phases {list(phases)}")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"

    t0 = time.time()
    with ThreadPoolExecutor(len(build.KERNELS)) as ex:
        list(ex.map(build.load, build.KERNELS))
    build_s = time.time() - t0
    log(f"kernel build: {build_s:.2f} s ({list(build.KERNELS)}, one nvcc "
        f"per source, started together from one thread each)")

    ref = np.load(os.path.join(GOLDEN, "torch_smoke_ref.npz"))
    pref = np.load(os.path.join(GOLDEN, "torch_parity_ref.npz"))
    sig = np.load(os.path.join(GOLDEN, "sa19_golden.npz"))["s_recon"]
    shapes = {"complex128": {}, "complex64": {}}
    lf_shapes = None

    def keep(by_path):
        for path, sh in by_path.items():
            shapes["complex128" if path.startswith("float64")
                   else "complex64"][path] = sh

    if "base" in phases:
        worst = kernel_phase(torch, chol)
        log(f"kernel phase max relative error: {worst}")
        worst = bi_kernel_phase(torch, block_inverse)
        log(f"block-inverse kernel phase max relative error: {worst}")
        non_pd_nan_phase(torch, chol)
        non_pd_ridge_phase(torch, chol, solver)
        non_pd_bi_phase(torch, chol, solver, pref)
        bi_fixture_phase(torch, chol, eaqhm_torch, pref)

        res, _, shapes["complex128"]["float64_host"], _, first64 = run_path(
            torch, chol, eaqhm_torch, sig, "float64 host loop",
            dtype="float64")
        log(f"float64 warm-up (kernel build + first call): "
            f"{build_s + first64:.3f} s")
        check_fixture(res, ref, "float64 host loop")

        res, _, sh, rec, _ = run_path(
            torch, chol, eaqhm_torch, sig, "float32 pallas",
            dtype="float32", solve_method="pallas")
        shapes["complex64"]["float32_pallas"] = sh
        check_gate(res, ref, "float32 pallas")
        # "pallas": one factorization and one substitution per batch
        assert rec["launches"] == rec["subst"] > 0, rec

        res, _, sh, rec, _ = run_path(
            torch, chol, eaqhm_torch, sig, "float32 block_inverse (default)",
            dtype="float32")
        shapes["complex64"]["float32_block_inverse"] = sh
        check_gate(res, ref, "float32 block_inverse")
        assert rec["bi"] > 0, rec

        res, warm, sh, rec, _ = run_path(
            torch, chol, eaqhm_torch, sig, "float64 fused loop",
            dtype="float64", fused_adapt_loop=True)
        shapes["complex128"]["float64_fused"] = sh
        check_fixture(res, ref, "float64 fused loop (first call)")
        check_fixture(warm, ref, "float64 fused loop (warm call)")
        check_fused(torch, chol, eaqhm_torch, sig, res, warm, rec,
                    dtype="float64", fused_adapt_loop=True)

        res, warm, sh, rec, _ = run_path(
            torch, chol, eaqhm_torch, sig, "float32 fused loop",
            dtype="float32", fused_adapt_loop=True)
        shapes["complex64"]["float32_fused"] = sh
        check_gate(res, ref, "float32 fused loop (first call)")
        check_gate(warm, ref, "float32 fused loop (warm call)")
        check_fused(torch, chol, eaqhm_torch, sig, res, warm, rec,
                    dtype="float32", fused_adapt_loop=True)
        assert rec["bi"] > 0 and rec["warm"]["bi_replayed"] > 0, rec

        lf_shapes = dsp_phase(torch, filters, vad, sig)
        cli_phase(torch, eaqhm_torch, io, sig)

    if "corpus" in phases:
        corpus = corpus_signals(sig, CORPUS_N, FS)
        seq, seq_s, shapes["complex128"]["float64_streams"] = streams_phase(
            torch, chol, eaqhm_torch, streams, corpus)
        out64, shapes["complex128"]["float64_batch"], \
            shapes["complex64"]["float32_batch"] = batch_phase(
                torch, chol, eaqhm_torch, batch_engine, corpus, ref, seq,
                seq_s)
        batch_ms = sorted({x[1] for x in
                           shapes["complex128"]["float64_batch"][0]})
        kernel_phase(torch, chol, cells=[
            (max(x[0] for x in shapes["complex128"]["float64_batch"][0]
                 if x[1] == M), M) for M in batch_ms], what="batch-M kernel")
        shapes["complex128"]["float64_mesh"] = mesh_phase(
            torch, chol, eaqhm_torch, batch_engine, corpus_mod, mesh_mod, io,
            corpus, out64)
        determinism_phase(out64)

    if "stress" in phases:
        t0 = time.time()
        by_path, cells = stress_phase(torch, chol, eaqhm_torch, engine,
                                      benchmarks, pref)
        keep(by_path)
        kernel_phase(torch, chol, cells=cells, what="stress kernel")
        log(f"stress phase: {time.time() - t0:.1f} s")

    if "presets" in phases:
        t0 = time.time()
        keep(presets_phase(torch, chol, eaqhm_torch, filters, benchmarks,
                           sig, pref))
        log(f"presets phase: {time.time() - t0:.1f} s")

    if "corpus64" in phases:
        t0 = time.time()
        keep(corpus64_phase(torch, chol, benchmarks, batch_engine))
        log(f"corpus-64 phase: {time.time() - t0:.1f} s")

    if "wide" in phases:
        t0 = time.time()
        keep(wide_phase(torch, chol, eaqhm_torch, benchmarks, pref))
        log(f"wide phase: {time.time() - t0:.1f} s")

    t0 = time.time()
    fit_entries = fit_phase(torch, fit)
    log(f"fit phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    track_entries = tracks_phase(torch, tracks)
    log(f"tracks phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    pitch_entries = pitch_phase(torch)
    log(f"pitch phase: {time.time() - t0:.1f} s")
    kernels = []
    for cname, dt in (("complex128", torch.complex128),
                      ("complex64", torch.complex64)):
        fused = [x for sh in shapes[cname].values() for x in sh[0]]
        subst = [x for sh in shapes[cname].values() for x in sh[1]]
        if not fused and not subst:
            continue
        entries = kernel_line_entry(torch, chol, dt, fused, subst)
        for entry, i in zip(entries, (0, 1)):
            entry["launches_by_path"] = {k: len(sh[i]) for k, sh
                                         in shapes[cname].items()
                                         if sh[i]}
        kernels.extend(entries)
    for cname in ("complex128", "complex64"):
        entry = bi_line_entry(torch, block_inverse, cname)
        if entry is not None:
            kernels.append(entry)
    if lf_shapes is not None:
        kernels.append(lfilter_line_entry(torch, filters, lf_shapes))
    kernels.extend(fit_entries)
    kernels.extend(track_entries)
    kernels.extend(pitch_entries)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--determinism"]:
        determinism_child()
    elif sys.argv[1:2] == ["--phases"]:
        unknown = set(sys.argv[2:]) - set(PHASES)
        if unknown or not sys.argv[2:]:
            raise SystemExit(f"chip_smoke: phases are {PHASES}")
        main(tuple(sys.argv[2:]))
    elif sys.argv[1:]:
        raise SystemExit(__doc__)
    else:
        main()
