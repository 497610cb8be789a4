"""Write tests/golden/torch_parity_ref.npz: float64 results of the JAX
package that the PyTorch port's CPU tests are held to, for the cases whose
JAX side is too costly to recompute in every test run (each JAX analyze
compiles for ~10 s, the Pallas kernel in interpret mode for ~20-30 s).

Cases (inputs made here with numpy from a seed, stored in the file):
- engine/<case>: eaqhm_tpu.analyze on 1 s synthetic tones under three
  configs, with the tier tensors it builds (captured at its first device
  call) and its result arrays;
- chol/<B>x<M>: eaqhm_tpu.ops.pallas_chol.chol_solve in interpret mode on
  equilibrated HPD complex64 systems;
- pallas_f64/<B>x<M>: eaqhm_tpu.ops.solver.solve_gram(..., jnp.float64,
  method="pallas") on equilibrated HPD complex128 systems (complex64 Pallas
  solves in interpret mode, refinement residual in complex128);
- block_inverse/<dtype>/<B>x<M>: gj_inverse, hpd_block_inverse and
  solve_gram(..., method="block_inverse") on equilibrated HPD systems (at
  M >= 130 only the seed the test rebuilds R and b from with numpy,
  hpd_block_inverse times a seeded 4-column probe, and solve_gram's x:
  whole matrices there would grow the file by megabytes), and
  block_inverse/nonpd/<case>: float32 solve_gram(..., "block_inverse") on
  the non-PD batch of tests/test_torch_solver.py (smallest eigenvalue -3e-6:
  the inverse stays finite) and on the same batch with a zero pivot (the
  inverse is not finite: the ridged rerun);
- engine_options/<case>: eaqhm_tpu.analyze on the 1 s tone with
  solve_method="block_inverse" (float64), and on its first 0.5 s with
  stop_on_decline=False and collect_metrics=True (partials=12 keeps the
  four adaptations cheap);
- batch/: eaqhm_tpu.parallel.batch_engine.analyze_batch (mesh=None) on the
  two 9,601-sample harmonic utterances of tests/test_batch_engine.py (f0
  205 and 230 Hz, partials=10, max_adaptations=3, float64);
- stress/: the stress slice, samples 32,000-40,000 of the JAX benchmark's
  config-4 signal (eaqhm_tpu/benchmarks.py:177-183, captured from
  bench_config4 itself; f0 below 81.25 Hz there, so every frame lies in
  the Kc = 128 tier, M = 514), male preset, float64, max_adaptations=2:
  the slice, its tier tensors, the adaptation-0 fit of the tier's first 8
  frames (rhs, dinv, the Gram's diagonal and its products with 4 seeded
  vectors, since the [8, 514, 514] Gram itself is 34 MB, and the
  solve_gram solution) and eaqhm_tpu.analyze's srer, s_recon and det_ak
  (~3 min on the CPU);
- presets/<gender>/: eaqhm_tpu.analyze on `s_recon` of
  tests/golden/sa19_golden.npz (the reference's SA19 resynthesis) under the
  JAX benchmark's config 2 (eaqhm_tpu/benchmarks.py:71-85: fc=30,
  full_waveform=True) for the female, male and child presets, float64:
  srer, s_recon and det_ak; and presets/highpassed, the 30 Hz high-passed
  resynthesis those runs analyzed (eaqhm_tpu/models/engine.py:690-695:
  scipy's filtfilt on the host, whose output moves with the scipy version
  by ~1e-5, so a machine with another scipy can feed the recorded one);
- wide/<case>/: 0.5 s tones built as config 4's signal (eleven harmonics of
  f0 + 4 sin(2 pi 0.3 t) Hz, 1/k amplitudes, noise of std 0.01, numpy seed
  1) at the sample rates whose top tier passes Kc = 128: 22.05 kHz and
  44.1 kHz at f0 = 80 Hz with the male preset (Kc = 192 and 323: M = 770
  and 1294), 48 kHz at f0 = 55 Hz with gender=(50, 180) (Kc = 487: M =
  1950); per case the tier tensors, the adaptation-0 fit of the top tier's
  first frames (rhs, dinv, the Gram's diagonal and its products with 4
  seeded vectors, and solve_gram's float64 solution); for 22.05 kHz also
  eaqhm_tpu.analyze's srer, s_recon and det_ak in float64 (~5 min).  JAX's
  float32 "pallas" solve is not recorded at these orders: its Pallas kernel
  in interpret mode compiles for 14 min at M = 770 and 48 min at M = 1294
  on the CPU, with 24-34 GB of host memory.

    JAX_PLATFORMS=cpu python tools/make_torch_parity_ref.py [--cases ...]

With --cases, only those groups are recomputed; the file's other entries
are kept as they are.
"""
import argparse
import dataclasses
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import time  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from eaqhm_tpu import benchmarks  # noqa: E402
from eaqhm_tpu.config import EaqhmConfig  # noqa: E402
from eaqhm_tpu.models import engine  # noqa: E402
from eaqhm_tpu.ops import solver  # noqa: E402
from eaqhm_tpu.ops.pallas_chol import chol_solve  # noqa: E402
from eaqhm_tpu.parallel import batch_engine  # noqa: E402
from tests.test_batch_engine import _harmonic_utterance  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "golden", "torch_parity_ref.npz")
FS = 16000


def tone(n=FS):
    """The 4-harmonic 210 Hz tone of tests/test_aux_subsystems.py:158-160
    (n samples; 1 s there)."""
    t = np.arange(n) / FS
    return sum(0.3 / k * np.sin(2 * np.pi * k * 210 * t) for k in range(1, 5))


def gated_tone():
    """The tone between 0.15 s and 0.8 s and faint noise elsewhere, so the
    voiced run closes before the end (fullWaveform=False keeps it)."""
    t = np.arange(FS) / FS
    noise = 1e-4 * np.random.default_rng(0).normal(size=FS)
    return tone() * ((t > 0.15) & (t < 0.8)) + noise


ENGINE_CASES = {
    "default": (tone, dict(gender=(150.0, 250.0), max_adaptations=3)),
    "deterministic_part": (gated_tone, dict(
        gender=(150.0, 250.0), max_adaptations=1, full_waveform=False)),
    "unquantized_fc_partials": (tone, dict(
        gender=(150.0, 250.0), max_adaptations=1, quantize_geometry=False,
        fc=60.0, partials=20)),
}
CHOL_SHAPES = ((5, 50), (3, 32), (9, 37))
PALLAS_F64_SHAPES = ((4, 37),)
BLOCK_INVERSE_SHAPES = ((4, 16), (4, 37), (4, 64))
# orders of the port's kernel paths (complex64 resident up to 169 and
# hybrid beyond; complex128 resident up to 119): recorded with a probe
BLOCK_INVERSE_PROBED = ((4, 130), (4, 194), (3, 258), (2, 514))
BLOCK_INVERSE_PROBES = 4
OPTION_CASES = {
    "block_inverse": (FS, dict(gender=(150.0, 250.0), max_adaptations=3,
                               solve_method="block_inverse")),
    "no_stop_metrics": (FS // 2, dict(
        gender=(150.0, 250.0), max_adaptations=3, partials=12,
        stop_on_decline=False, collect_metrics=True)),
}
BATCH_CONFIG = dict(gender="female", partials=10, max_adaptations=3,
                    dtype="float64")
STRESS_SLICE = (32000, 40000)
STRESS_FIT_FRAMES = 8
STRESS_PROBES = 4
PRESETS = ("female", "male", "child")
WIDE_CASES = {   # name: (fs, f0, gender, top-tier frames fitted)
    "fs22050": (22050, 80.0, "male", 4),
    "fs44100": (44100, 80.0, "male", 3),
    "fs48000": (48000, 55.0, (50.0, 180.0), 2),
}
WIDE_SECONDS = 0.5
CASES = ("engine", "chol", "pallas_f64", "block_inverse", "engine_options",
         "batch", "stress", "presets", "wide")
RESULT_FIELDS = ("srer", "s_recon", "det_ti", "det_is_speech",
                 "det_is_voiced", "det_a0", "det_ak", "det_frange", "det_pk",
                 "f0_grid")


class _Stop(Exception):
    pass


def tier_tensors(s, cfg, fs=FS):
    """The tier tensors eaqhm_tpu.analyze builds, captured at its first
    device call: per tier (idx, centers, f0, K, wl) without the capacity
    padding, and (W, Kc)."""
    orig = engine._adapt0_full

    def stop(*args, **kw):
        raise _Stop(args, kw)

    engine._adapt0_full = stop
    try:
        engine.analyze(s, fs, cfg)
    except _Stop as e:
        args, kw = e.args
    finally:
        engine._adapt0_full = orig
    No = kw["No"]
    tiers = []
    for (idx, c, f0, K, wl), (W, Kc) in zip(args[1], kw["geom"]):
        real = np.asarray(idx) < No
        tiers.append([np.asarray(a)[real] for a in (idx, c, f0, K, wl)]
                     + [W, Kc])
    return No, tiers


def hpd_systems(B, M, seed=0, dtype=np.complex64):
    """Equilibrated HPD systems, as tests/test_ops.py builds them."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = (R / (d[:, :, None] * d[:, None, :])).astype(dtype)
    b = (rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))).astype(dtype)
    return R, b


def engine_cases(out):
    for name, (make, kw) in ENGINE_CASES.items():
        s = make()
        cfg = EaqhmConfig(**kw)
        p = f"engine/{name}/"
        out[p + "signal"] = s
        out[p + "config"] = json.dumps(dataclasses.asdict(cfg))
        No, tiers = tier_tensors(s, cfg)
        write_tiers(out, p, No, tiers)
        res = engine.analyze(s, FS, cfg)
        for f in RESULT_FIELDS:
            out[p + f] = np.asarray(getattr(res, f))
        print(name, "srer", res.srer, "tiers", [(len(t[0]), t[5], t[6])
                                                for t in tiers])


def chol_cases(out):
    for B, M in CHOL_SHAPES:
        R, b = hpd_systems(B, M)
        x = np.asarray(chol_solve(jnp.asarray(R), jnp.asarray(b),
                                  interpret=True))
        out[f"chol/{B}x{M}/R"] = R
        out[f"chol/{B}x{M}/b"] = b
        out[f"chol/{B}x{M}/x"] = x


def pallas_f64_cases(out):
    for B, M in PALLAS_F64_SHAPES:
        R, b = hpd_systems(B, M, seed=M, dtype=np.complex128)
        x = np.asarray(solver.solve_gram(jnp.asarray(R), jnp.asarray(b),
                                         jnp.float64, method="pallas"))
        out[f"pallas_f64/{B}x{M}/R"] = R
        out[f"pallas_f64/{B}x{M}/b"] = b
        out[f"pallas_f64/{B}x{M}/x"] = x


def nonpd_batch(zero_pivot=False):
    """The float32 non-PD batch of tests/test_torch_solver.py (B = 8, Kc = 12,
    seed 6): system 3 shifted to smallest eigenvalue -3e-6; with
    zero_pivot, its first diagonal entry set to 0 as well."""
    B, M = 8, 2 * (2 * 12 + 1)
    rng = np.random.default_rng(6)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = R / (d[:, :, None] * d[:, None, :])
    b = rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))
    lam = np.linalg.eigvalsh(R[3]).min()
    R[3] = R[3] - (lam + 3e-6) * np.eye(M)
    if zero_pivot:
        R[3, 0, 0] = 0.0
    return R.astype(np.complex64), b.astype(np.complex64)


def block_inverse_probe(M, dtype):
    """The [M, BLOCK_INVERSE_PROBES] probe the inverse is recorded against
    (numpy seed M + 1)."""
    rng = np.random.default_rng(M + 1)
    V = (rng.normal(size=(M, BLOCK_INVERSE_PROBES))
         + 1j * rng.normal(size=(M, BLOCK_INVERSE_PROBES)))
    return V.astype(dtype)


def block_inverse_cases(out):
    for name, cdt, rdt in (("float64", np.complex128, jnp.float64),
                           ("float32", np.complex64, jnp.float32)):
        for B, M in BLOCK_INVERSE_SHAPES:
            R, b = hpd_systems(B, M, seed=M, dtype=cdt)
            p = f"block_inverse/{name}/{B}x{M}/"
            out[p + "R"] = R
            out[p + "b"] = b
            out[p + "gj"] = np.asarray(solver.gj_inverse(jnp.asarray(R)))
            out[p + "inv"] = np.asarray(
                solver.hpd_block_inverse(jnp.asarray(R)))
            out[p + "x"] = np.asarray(solver.solve_gram(
                jnp.asarray(R), jnp.asarray(b), rdt, method="block_inverse"))
        for B, M in BLOCK_INVERSE_PROBED:
            R, b = hpd_systems(B, M, seed=M, dtype=cdt)
            p = f"block_inverse/{name}/{B}x{M}/"
            out[p + "seed"] = np.asarray(M)
            V = block_inverse_probe(M, cdt)
            out[p + "inv_probe"] = np.asarray(
                solver.hpd_block_inverse(jnp.asarray(R))) @ V
            out[p + "x"] = np.asarray(solver.solve_gram(
                jnp.asarray(R), jnp.asarray(b), rdt, method="block_inverse"))
            print("block_inverse", name, B, M)
    for case, zp in (("nonpd", False), ("zero_pivot", True)):
        R, b = nonpd_batch(zp)
        p = f"block_inverse/nonpd/{case}/"
        out[p + "R"] = R
        out[p + "b"] = b
        out[p + "inv_finite"] = np.isfinite(np.asarray(
            solver.hpd_block_inverse(jnp.asarray(R)))).all()
        out[p + "x"] = np.asarray(solver.solve_gram(
            jnp.asarray(R), jnp.asarray(b), jnp.float32,
            method="block_inverse"))


def engine_option_cases(out):
    for name, (n, kw) in OPTION_CASES.items():
        s = tone(n)
        cfg = EaqhmConfig(**kw)
        res = engine.analyze(s, FS, cfg)
        p = f"engine_options/{name}/"
        out[p + "signal"] = s
        out[p + "config"] = json.dumps(dataclasses.asdict(cfg))
        for f in ("srer", "s_recon"):
            out[p + f] = np.asarray(getattr(res, f))
        if cfg.collect_metrics:
            out[p + "accepted_harmonics"] = np.asarray(
                [m["accepted_harmonics"] for m in res.metrics])
        print(name, "srer", res.srer)


def batch_signals():
    """The inputs of tests/test_batch_engine.py's batch_setup."""
    return [_harmonic_utterance(9601, FS, f0=205.0, seed=0),
            _harmonic_utterance(9601, FS, f0=230.0, seed=1, jitter=0.01)]


def batch_cases(out):
    sigs = batch_signals()
    cfg = EaqhmConfig(**BATCH_CONFIG)
    res = batch_engine.analyze_batch(sigs, FS, cfg, mesh=None)
    p = "batch/"
    out[p + "signals"] = np.stack(sigs)
    out[p + "config"] = json.dumps(dataclasses.asdict(cfg))
    for f in ("srer", "final_srer", "s_recon", "n_adaptations",
              "srer_mean"):
        out[p + f] = np.asarray(getattr(res, f))
    print("batch srer", res.srer)


def jax_stress_signal():
    """The config-4 signal and config as eaqhm_tpu.benchmarks.bench_config4
    builds them (its analyze call intercepted)."""
    got = {}

    def capture(s, fs, cfg, repeats=3):
        got.update(s=s, fs=fs, cfg=cfg)
        raise _Stop()

    orig = benchmarks._timed_analyze
    benchmarks._timed_analyze = capture
    try:
        benchmarks.bench_config4()
    except _Stop:
        pass
    finally:
        benchmarks._timed_analyze = orig
    return got["s"], got["fs"], got["cfg"]


def write_tiers(out, p, No, tiers):
    out[p + "No"] = No
    out[p + "n_tiers"] = len(tiers)
    for i, (idx, c, f0, K, wl, W, Kc) in enumerate(tiers):
        for key, val in (("idx", idx), ("centers", c), ("f0", f0),
                         ("K", K), ("wl", wl), ("W", W), ("Kc", Kc)):
            out[f"{p}tier{i}/{key}"] = val


def stress_cases(out):
    full, fs, cfg4 = jax_stress_signal()
    assert fs == FS and len(full) == 60 * FS
    a, b = STRESS_SLICE
    s = np.asarray(full[a:b], np.float64)
    cfg = dataclasses.replace(cfg4, max_adaptations=2, dtype="float64")
    p = "stress/"
    out[p + "signal"] = s
    out[p + "slice"] = np.asarray(STRESS_SLICE)
    out[p + "config4"] = json.dumps(dataclasses.asdict(cfg4))
    out[p + "config"] = json.dumps(dataclasses.asdict(cfg))
    No, tiers = tier_tensors(s, cfg)
    write_tiers(out, p, No, tiers)
    # adaptation-0 fit of the first frames of tier 0, windows gathered from
    # the signal padded to its length page as the engine does
    idx, c, f0, K, wl, W, Kc = tiers[0]
    n = STRESS_FIT_FRAMES
    Lpad = -(-len(s) // 4096) * 4096
    s_pad = np.pad(s, (0, Lpad - len(s)))
    o = np.arange(-W, W + 1)
    rows = np.clip(c[:n, None] + o[None, :], 0, Lpad - 1)
    R, rhs, dinv = solver.iqhm_gram(
        jnp.asarray(s_pad[rows]), jnp.asarray(o),
        jnp.asarray(np.maximum(wl[:n], 1)), jnp.asarray(f0[:n]),
        jnp.asarray(K[:n]), float(FS), int(Kc), dtype=jnp.float64)
    x = solver.solve_gram(R, rhs, jnp.float64)
    M = R.shape[-1]
    rng = np.random.default_rng(514)
    v = (rng.normal(size=(M, STRESS_PROBES))
         + 1j * rng.normal(size=(M, STRESS_PROBES)))
    out[p + "fit/probes"] = v
    out[p + "fit/R_diag"] = np.asarray(jnp.diagonal(R, axis1=-2, axis2=-1))
    out[p + "fit/R_probes"] = np.asarray(R) @ v
    out[p + "fit/rhs"] = np.asarray(rhs)
    out[p + "fit/dinv"] = np.asarray(dinv)
    out[p + "fit/x"] = np.asarray(x)
    t0 = time.time()
    res = engine.analyze(s, FS, cfg)
    print(f"stress slice: {time.time() - t0:.1f} s, srer {res.srer}, tiers",
          [(len(t[0]), t[5], t[6]) for t in tiers])
    for f in ("srer", "s_recon", "det_ak"):
        out[p + f] = np.asarray(getattr(res, f))


def preset_cases(out):
    from scipy.signal import filtfilt
    from eaqhm_tpu.ops import filters
    s = np.load(os.path.join(os.path.dirname(OUT),
                             "sa19_golden.npz"))["s_recon"]
    b, a, _ = filters.design_ellip(FS, 30.0, "highpass")
    out["presets/highpassed"] = filtfilt(b, a, s)
    for gender in PRESETS:
        cfg = EaqhmConfig(gender=gender, fc=30.0, full_waveform=True,
                          dtype="float64")
        t0 = time.time()
        res = engine.analyze(s, FS, cfg)
        print(f"preset {gender}: {time.time() - t0:.1f} s, srer {res.srer}")
        p = f"presets/{gender}/"
        out[p + "config"] = json.dumps(dataclasses.asdict(cfg))
        for f in ("srer", "s_recon", "det_ak"):
            out[p + f] = np.asarray(getattr(res, f))


def wide_signal(fs, f0, seconds=WIDE_SECONDS):
    """Config 4's signal construction (eaqhm_tpu/benchmarks.py:177-183) at
    another sample rate and f0."""
    t = np.arange(int(fs * seconds)) / fs
    f = f0 + 4.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f) / fs
    s = sum((0.25 / k) * np.sin(k * phase) for k in range(1, 12))
    return s + 0.01 * np.random.default_rng(1).normal(size=len(s))


def fit_top_tier(out, p, s, fs, tiers, n):
    """Adaptation-0 fit of the first n frames of the top tier, as
    stress_cases does for its one tier."""
    idx, c, f0, K, wl, W, Kc = tiers[-1]
    Lpad = -(-len(s) // 4096) * 4096
    s_pad = np.pad(s, (0, Lpad - len(s)))
    o = np.arange(-W, W + 1)
    rows = np.clip(c[:n, None] + o[None, :], 0, Lpad - 1)
    R, rhs, dinv = solver.iqhm_gram(
        jnp.asarray(s_pad[rows]), jnp.asarray(o),
        jnp.asarray(np.maximum(wl[:n], 1)), jnp.asarray(f0[:n]),
        jnp.asarray(K[:n]), float(fs), int(Kc), dtype=jnp.float64)
    x = solver.solve_gram(R, rhs, jnp.float64)
    M = R.shape[-1]
    rng = np.random.default_rng(M)
    v = (rng.normal(size=(M, STRESS_PROBES))
         + 1j * rng.normal(size=(M, STRESS_PROBES)))
    out[p + "fit/n"] = n
    out[p + "fit/probes"] = v
    out[p + "fit/R_diag"] = np.asarray(jnp.diagonal(R, axis1=-2, axis2=-1))
    out[p + "fit/R_probes"] = np.asarray(R) @ v
    out[p + "fit/rhs"] = np.asarray(rhs)
    out[p + "fit/dinv"] = np.asarray(dinv)
    out[p + "fit/x"] = np.asarray(x)


def wide_cases(out):
    for name, (fs, f0, gender, n) in WIDE_CASES.items():
        p = f"wide/{name}/"
        s = wide_signal(fs, f0)
        cfg = EaqhmConfig(gender=gender, dtype="float64")
        out[p + "signal"] = s
        out[p + "fs"] = fs
        out[p + "config"] = json.dumps(dataclasses.asdict(cfg))
        No, tiers = tier_tensors(s, cfg, fs)
        print(f"{p}: tiers", [(len(t[0]), t[5], t[6]) for t in tiers],
              flush=True)
        write_tiers(out, p, No, tiers)
        fit_top_tier(out, p, s, fs, tiers, n)
        if fs == 22050:
            t0 = time.time()
            res = engine.analyze(s, fs, cfg)
            print(f"{p}: analyze {time.time() - t0:.1f} s, srer {res.srer}",
                  flush=True)
            for f in ("srer", "s_recon", "det_ak"):
                out[p + f] = np.asarray(getattr(res, f))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES))
    args = ap.parse_args()
    out = {}
    if set(args.cases) != set(CASES) and os.path.exists(OUT):
        with np.load(OUT) as old:
            out = {k: old[k] for k in old.files
                   if k.split("/")[0] not in args.cases}
    for case in args.cases:
        {"engine": engine_cases, "chol": chol_cases,
         "pallas_f64": pallas_f64_cases,
         "block_inverse": block_inverse_cases,
         "engine_options": engine_option_cases,
         "batch": batch_cases, "stress": stress_cases,
         "presets": preset_cases, "wide": wide_cases}[case](out)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT, os.path.getsize(OUT) // 1024, "KB")


if __name__ == "__main__":
    main()
